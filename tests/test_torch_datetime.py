"""Port parity for the timestamp parser and formatter (ops/datetime_k.py,
format_k.int2timestamp_device) against custrings_tpu on the same host
rows, exactly, with the JAX calls inside `jax.enable_x64(True)`.  The
cases of tests/test_datetime_parity.py and tests/test_format.py: every
format in the reference's compiler map with its quirks (%y = +1900 /
-1900, %j sets the DAY field, %p adds 12 when hour <= 12, %Z only
matches UTC, %z is added, %a/%A/%b/%B/%w/%U/%W parse every row to 0, %f
width follows units), an unknown specifier raising, every unit of the
formatter, negative values (floor division), nulls; and the port's copies
of the host oracles held to the JAX originals."""

import jax
import numpy as np
import pytest
import torch

from custrings_tpu import column as jcol
from custrings_tpu.ops import datetime_k as jdt
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import datetime_k as tdt

from test_torch_split_ws import fast_reference_compiles  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

FORMATS = [
    (None, "s"),
    ("%Y-%m-%d", "D"),
    ("%Y-%m-%dT%H:%M:%S.%f", "us"),
    ("%Y-%m-%dT%H:%M:%S.%f", "ms"),
    ("%Y-%m-%dT%H:%M:%S.%f", "ns"),
    ("%m/%d/%y %I:%M %p", "m"),
    ("%Y-%m-%dT%H:%M:%S%z", "s"),
    ("%Y-%m-%dT%H:%M:%S%z", "h"),
    ("%Y-%m-%dT%H:%M:%S %Z", "s"),
    ("%Y %j %H", "h"),
    ("%Y", "Y"),
    ("%Y-%m", "M"),
    ("100%% %Y", "Y"),
]
UNITS = ["s", "ms", "us", "ns", "D", "h", "m", "Y", "M"]
RANGES = {"s": 10**11, "ms": 10**14, "us": 10**17, "ns": 10**18, "D": 10**6, "h": 3 * 10**7, "m": 2 * 10**9,
          "Y": 8000, "M": 96000}


def _rows(fmt, seed):
    """Rows of the format from seeded values (before and after the epoch),
    then the quirk rows: zone signs, PM/pm/AM, a row shorter than any
    span, empty, null, garbage digits, %Z of UTC, utc and EST, 9
    subsecond digits, month 0."""
    rng = np.random.default_rng(seed)
    items = tdt._compile(fmt or tdt.DEFAULT_FORMAT)
    rows = [tdt._format_one(int(v), "s", items) for v in rng.integers(-3 * 10**9, 4 * 10**9, 12)]
    return rows + ["2019-03-20T12:34:56+0530", "2019-03-20T12:34:56-0130", "1969-12-31T23:59:59-0001",
                   "05/20/19 12:30 PM", "05/20/19 02:30 pm", "05/20/19 02:30 AM", "2020 366 23", "20", "", None,
                   "x" * 30, "2019-03-20T12:34:56 UTC", "2019-03-20T12:34:56 utc", "2019-03-20T12:34:56 EST",
                   "2019-03-20T12:34:56.123456789", "2019-00-20", "1900-02-29T01:02:03Z"]


def _jax(fn, *args):
    with jax.enable_x64(True):
        return np.asarray(fn(*args))


@pytest.mark.parametrize("fmt,units", FORMATS)
def test_timestamp2int_matches_jax(fmt, units):
    rows = _rows(fmt, len(fmt or "") * 7 + len(units))
    got = tdt.timestamp2int(tcol.from_host_strings(rows, "cpu"), fmt, units).numpy().tolist()
    want = _jax(jdt.timestamp2int, jcol.from_host_strings(rows), fmt, units).tolist()
    assert got == want
    assert got == tdt.timestamp2int_host_oracle(tcol.from_host_strings(rows, "cpu"), fmt, units)


def test_parse_error_specs_zero():
    rows = ["Mon 2019", "Tue 2020", None]
    for fmt in ("%a %Y", "%A %Y", "%b %Y", "%B %Y", "%w %Y", "%U %Y", "%W %Y"):
        got = tdt.timestamp2int(tcol.from_host_strings(rows, "cpu"), fmt, "s").numpy().tolist()
        assert got == _jax(jdt.timestamp2int, jcol.from_host_strings(rows), fmt, "s").tolist() == [0, 0, 0]


def test_unknown_specifier_raises():
    with pytest.raises(ValueError):
        tdt.timestamp2int(tcol.from_host_strings(["2019"], "cpu"), "%Q", "s")
    with pytest.raises(ValueError):
        jdt.timestamp2int(jcol.from_host_strings(["2019"]), "%Q", "s")
    with pytest.raises(ValueError):
        tdt.int2timestamp([0], "s", "%Y %Q", device="cpu")


@pytest.mark.parametrize("units", UNITS)
def test_int2timestamp_matches_jax(units):
    """The full specifier matrix at every unit, on values before and after
    the epoch, with null rows."""
    rng = np.random.default_rng(11)
    r = RANGES[units]
    vs = np.concatenate([rng.integers(-r // 40, r, 40), np.array([0, -1, 1])])
    nulls = np.zeros(len(vs), bool)
    nulls[::9] = True
    fmt = "%Y-%m-%dT%H:%M:%S.%f %p %j %I %y%z%Z"
    got = tdt.int2timestamp(vs, units, fmt, nulls, device="cpu")
    with jax.enable_x64(True):
        want = jdt.int2timestamp(vs, units=units, fmt=fmt, nulls=nulls)
        assert tcol.to_host_strings(got) == jcol.to_host_strings(want)
        assert got.offsets.numpy().tolist() == np.asarray(want.offsets).tolist()
    items = tdt._compile(fmt)
    assert tcol.to_host_strings(got) == [None if z else tdt._format_one(int(v), units, items)
                                         for v, z in zip(vs, nulls)]


def test_int2timestamp_facade_default_format():
    got = tnv.int2timestamp([0, 86400, 1553085296, 1582934400], nulls=np.array([True, False, False, False]),
                            device="cpu")
    assert got.to_host() == [None, "1970-01-02T00:00:00Z", "2019-03-20T12:34:56Z", "2020-02-29T00:00:00Z"]
    assert tnv.int2timestamp([], device="cpu").to_host() == []


def test_roundtrip_default():
    vals = [0, 1, 86399, 1553085296, 1583020799, -1, -2208988800]
    s = tnv.int2timestamp(vals, device="cpu")
    assert s.timestamp2int() == vals


def test_facade_timestamp2int_matches_jax():
    import custrings_tpu.nvstrings as jnv

    rows = ["2019-03-20T12:34:56Z", "2020-02-29T23:59:59Z", None, "", "05/20/2019 02:30 PM"]
    s, js = tnv.to_device(rows, device="cpu"), jnv.to_device(rows)
    with jax.enable_x64(True):
        for fmt, units in ((None, "s"), (None, "ms"), ("%m/%d/%Y %I:%M %p", "m")):
            assert s.timestamp2int(format=fmt, units=units) == js.timestamp2int(format=fmt, units=units)


def test_host_oracle_copies_match_jax():
    """_compile, _fixed_layout, _parse_one, _format_one, _dissect_py and
    _civil_from_days_py of the port equal the JAX package's."""
    rng = np.random.default_rng(5)
    for fmt, units in FORMATS + [("%a %b %d", "s"), ("%U-%W-%w", "s")]:
        items = tdt._compile(fmt or tdt.DEFAULT_FORMAT)
        assert items == jdt._compile(fmt or jdt.DEFAULT_FORMAT)
        assert tdt._fixed_layout(items, units) == jdt._fixed_layout(items, units)
        for s in _rows(fmt, 3):
            if s:
                assert tdt._parse_one(s, items, units) == jdt._parse_one(s, items, units), (fmt, s)
        for v in rng.integers(-RANGES[units] // 40, RANGES[units], 20).tolist():
            assert tdt._format_one(v, units, items) == jdt._format_one(v, units, items)
            assert tdt._dissect_py(v, units) == jdt._dissect_py(v, units)
    for d in rng.integers(-10**6, 10**6, 200).tolist():
        assert tdt._civil_from_days_py(d) == jdt._civil_from_days_py(d)
    assert tdt._SPEC_LEN == jdt._SPEC_LEN and tdt._PARSE_ERROR_SPECS == jdt._PARSE_ERROR_SPECS
