"""Port parity for the number <-> string conversions (ops/convert.py,
ops/format_k.py) against custrings_tpu on the same host rows, with the
JAX calls inside `jax.enable_x64(True)` (the JAX parsers would otherwise
switch 64-bit mode on for the whole worker process).  Compared exactly:
integers, booleans, valid rows' bytes, offsets and validity.  Two
tolerances, both on floats:

- stod within 2 ulp of float64 a row, stof within 1 ulp of float32:
  both packages compute sign * digits * 10**exp, and torch's pow and
  XLA's differ by up to 1 ulp at some exponents, which moves the product
  by up to 2 ulp when the pow lies low in its binade and the product high
  in its own.  Only there: on rows where the two pows agree, stod is
  exact.  NaN, the infinities and the sign are exact.
- none elsewhere, but XLA on the CPU flushes float64 subnormals to zero:
  where 10**exp is subnormal the JAX stod gives 0 and its ftos prints a
  subnormal as "0.0".  Those rows are held to the formula in numpy
  (chip_smoke.stod_py) and to the JAX package's own host oracle
  (`_float_to_string`), whose semantics the port keeps; float32
  subnormals likewise.

Also here: chip_smoke.py's convert phase on the CPU at a small size, with
its oracles held to custrings_tpu, and its captured kernel calls."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import custrings_tpu.nvstrings as jnv
from custrings_tpu import column as jcol
from custrings_tpu.ops import convert as jconv
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import convert as tconv

from test_torch_split_ws import CS, fast_reference_compiles  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

TABLE = CS.make_convert_rows(1024, seed=3)
INT_EDGES = ["9223372036854775807", "-9223372036854775808", "9223372036854775808", "-9223372036854775809",
             "99999999999999999999999", "+12", "-0", "+", "-", "", None, "00042", "12ab", " 7", "+-1", "1e5"]
HEX_EDGES = ["0x1F", "0X1f", "x1F", "1x2", "zz12", "12g3", "ffffffffffffffff", "1ffffffffffffffff", "0x",
             "", None, "-1f", "DEADBEEF", "0xdeadbeef"]
FLOAT_EDGES = ["nan", "NaN", "inf", "-inf", "Inf", "-Inf", "-0", "-0.0", "0.0", "-e5", "1.2.3", ".5", "-.02",
               "1e308", "1.7976931348623157e308", "2e308", "1e-300", "4.9e-324", "2.2250738585072014e-308",
               "1e-310", "0e400", "1" + "0" * 40, "123456789012345678901234", "1e2147483648", "", None]
IP_EDGES = ["0.0.0.0", "255.255.255.255", "1.2.3", "1.2.3.4.5", "300.1.1.1", "a.b", "", None, "10.0.0.1"]


def _jax(fn, *args):
    with jax.enable_x64(True):
        out = fn(*args)
        return np.asarray(out)


def _cols(rows):
    return tcol.from_host_strings(rows, "cpu"), jcol.from_host_strings(rows)


def _same_column(t, j):
    """Valid rows' bytes, offsets and validity of the two columns."""
    assert tcol.to_host_strings(t) == jcol.to_host_strings(j)
    assert t.offsets.numpy().tolist() == np.asarray(j.offsets).tolist()
    assert t.validity.numpy().tolist() == np.asarray(j.validity).tolist()


@pytest.mark.parametrize("parser,rows", [
    ("stol", TABLE["int"] + INT_EDGES), ("stoi", TABLE["int"] + INT_EDGES),
    ("htoi", TABLE["hex"] + HEX_EDGES), ("ip2int", TABLE["ip"] + IP_EDGES),
    ("to_booleans", TABLE["bool"] + ["True", "true", "True ", "", None])])
def test_parsers_match_jax(parser, rows):
    t, j = _cols(rows)
    got = getattr(tconv, parser)(t).numpy()
    want = _jax(getattr(jconv, parser), j)
    assert got.tolist() == want.tolist()


def test_parsers_match_chip_smoke_oracles():
    """chip_smoke's per-row oracles (int(), the hex state machine,
    ipaddress) equal custrings_tpu on the seeded rows and the edges."""
    ints, hexes = TABLE["int"] + INT_EDGES, TABLE["hex"] + HEX_EDGES
    want = _jax(jconv.stol, jcol.from_host_strings(ints)).tolist()
    assert [0 if x is None else CS.stol_py(x) for x in ints] == want
    want = _jax(jconv.htoi, jcol.from_host_strings(hexes)).tolist()
    assert [0 if x is None else CS.htoi_py(x) for x in hexes] == want


def _flushed(jx, oracle):
    """Rows where XLA flushed a subnormal 10**exp to 0 (the product is
    then tiny: digits < 2^52 times a pow below 2.3e-308)."""
    f = (jx == 0) & (oracle != 0)
    assert np.all(np.abs(oracle[f]) < 1e-292)
    return f


def _pow10_xla(exp):
    return jnp.power(jnp.float64(10.0), jnp.asarray(exp))


def _held(got, want, pow_got, pow_want, rows):
    """stod's products on `rows`: equal wherever the two pows of 10**exp
    are equal, within 2 ulp where they are not, so a gap of any other
    cause fails."""
    gap = CS._ulps(got, want)
    same_pow = pow_got.view(np.int64) == pow_want.view(np.int64)
    assert np.all(gap[rows & same_pow] == 0)
    assert np.all(gap[rows] <= 2)


def test_stod_stof_match_jax():
    rows = TABLE["float"] + FLOAT_EDGES
    t, j = _cols(rows)
    got, want = tconv.stod(t).numpy(), _jax(jconv.stod, j)
    oracle = CS.stod_py(rows)
    valid = np.asarray([x is not None for x in rows])
    exp = CS.stod_parts(rows)[2]
    pow_torch = torch.pow(10.0, torch.from_numpy(exp)).numpy()
    pow_xla = _jax(_pow10_xla, exp)
    with np.errstate(over="ignore"):
        pow_np = np.power(10.0, exp)
    _held(got, oracle, pow_torch, pow_np, valid)
    keep = valid & ~_flushed(want, oracle)
    _held(got, want, pow_torch, pow_xla, keep)
    assert np.array_equal(np.isnan(got), np.isnan(want)) and np.array_equal(np.signbit(got), np.signbit(want))
    got32, want32 = tconv.stof(t).numpy(), _jax(jconv.stof, j)
    keep32 = keep & (np.abs(oracle) >= np.finfo(np.float32).tiny)
    assert np.all(CS._ulps(got32[keep32], want32[keep32]) <= 1)
    with np.errstate(over="ignore"):
        assert np.all(np.where(valid, CS._ulps(got32, oracle.astype(np.float32)), 0) <= 1)


def test_stod_edge_values():
    t, _ = _cols(["-0", "nan", "-Inf", "inf", "1e400", "-1e400", "0e400", "4.9e-324", "1e-310", None])
    got = tconv.stod(t).numpy()
    assert math.copysign(1.0, got[0]) == -1.0 and got[0] == 0
    assert math.isnan(got[1]) and got[2] == -math.inf and got[3] == math.inf
    assert got[4] == math.inf and got[5] == -math.inf and math.isnan(got[6])
    # 49 * 10**-325: the formula's pow underflows, where float() gives 5e-324
    assert got[7] == 0 and got[8] == 1e-310 and got[9] == 0


def test_itos_ltos_match_jax():
    rng = np.random.default_rng(0)
    ints = np.concatenate([rng.integers(-(10**18), 10**18, 300), np.array([0, -1, 1, 9, 10, -10, 2**63 - 1, -(2**63)])])
    nulls = rng.random(len(ints)) < 0.1
    got = tnv.ltos(ints, nulls=nulls, device="cpu")
    assert got.to_host() == [None if z else str(int(v)) for v, z in zip(ints, nulls)]
    _same_column(got._col, jnv.ltos(ints, nulls=nulls)._col)
    small = ints.astype(np.int32)
    _same_column(tnv.itos(small, device="cpu")._col, jnv.itos(small)._col)


def _float_cases():
    rng = np.random.default_rng(2)
    return np.concatenate([rng.normal(0, 1e3, 200), rng.normal(0, 1e-6, 60), rng.normal(0, 1e20, 60),
                           10.0 ** rng.integers(-300, 300, 60) * rng.random(60),
                           np.array([0.0, -0.0, 1.0, -1.0, 3.14159, 1e9, 1e9 + 1, 1e-4, 9.9999999995,
                                     1234567890.123, 1e-300, 1e300, 1.7976931348623157e308, np.nan, np.inf,
                                     -np.inf, 0.1, 0.99999999995, 999999999.5])]).astype(np.float64)


def test_ftos_dtos_match_jax():
    vals = _float_cases()
    nulls = np.zeros(len(vals), bool)
    nulls[::17] = True
    got = tnv.dtos(vals, nulls=nulls, device="cpu")
    _same_column(got._col, jnv.dtos(vals, nulls=nulls)._col)
    assert got.to_host() == [None if z else jconv._float_to_string(float(v)) for v, z in zip(vals, nulls)]
    _same_column(tnv.ftos(vals, device="cpu")._col, jnv.ftos(vals)._col)


def test_ftos_subnormals_follow_the_host_oracle():
    """XLA on the CPU prints a subnormal as "0.0"; the port keeps the
    reference formatter's semantics, as `_float_to_string` has them."""
    vals = np.array([5e-324, -1e-310, 2.2250738585072009e-308, 1e-320])
    got = tnv.dtos(vals, device="cpu").to_host()
    assert got == [jconv._float_to_string(float(v)) for v in vals] == [tconv._float_to_string(float(v))
                                                                       for v in vals]
    assert got[0] == "4.940656458e-324"


def test_int2ip_from_booleans_match_jax():
    rng = np.random.default_rng(1)
    ips = np.concatenate([rng.integers(0, 2**32, 300), np.array([0, 2**32 - 1, 1, 16909060])])
    bits = np.packbits(rng.random(len(ips)) < 0.9, bitorder="little")
    got = tnv.int2ip(ips.tolist(), nulls=bits, device="cpu")
    _same_column(got._col, jnv.int2ip(ips.tolist(), nulls=bits)._col)
    assert tnv.int2ip([3232235521, None, 700055553], device="cpu").to_host() == [
        "192.168.0.1", "0.0.0.0", "41.186.0.1"]
    flags = rng.random(50) < 0.5
    nulls = rng.random(50) < 0.2
    got = tnv.from_booleans(flags, "Yes", "Nope", nulls=nulls, device="cpu")
    _same_column(got._col, jnv.from_booleans(flags, "Yes", "Nope", nulls=nulls)._col)
    for true, false in (("True", "False"), ("é", ""), ("", "x")):
        got = tnv.from_booleans(flags, true, false, nulls=nulls, device="cpu").to_host()
        assert got == [None if z else true if f else false for f, z in zip(flags, nulls)]


def test_empty_and_all_null_columns():
    """Every parser and formatter on an empty and an all-null column (the
    JAX package's results: zeros, False, null rows; stol held to it
    directly)."""
    for rows in ([], [None, None, None]):
        t, j = _cols(rows)
        assert tconv.stol(t).numpy().tolist() == _jax(jconv.stol, j).tolist() == [0] * len(rows)
        for parser in ("stoi", "htoi", "stod", "ip2int", "to_booleans"):
            assert getattr(tconv, parser)(t).numpy().tolist() == [0] * len(rows), parser
    nulls = np.ones(3, bool)
    for fn in ("itos", "ltos", "ftos", "dtos", "int2ip", "from_booleans", "int2timestamp"):
        got = getattr(tnv, fn)(np.zeros(3, np.int64), nulls=nulls, device="cpu")
        assert got.to_host() == [None] * 3 and got._col.offsets.tolist() == [0] * 4, fn
    assert tnv.itos([], device="cpu").to_host() == []
    assert tnv.dtos(np.zeros(0), device="cpu").size() == 0


def test_float_to_string_copy_matches_jax():
    vals = _float_cases()
    vals = np.concatenate([vals, np.array([5e-324, 1e-310]), np.random.default_rng(5).random(500) * 1e6])
    for v in vals.tolist():
        assert tconv._float_to_string(v) == jconv._float_to_string(v)
        if math.isfinite(v) and v > 0:
            assert tconv._dissect_value(v) == jconv._dissect_value(v)
    for dec, places in ((5, 3), (123, 3), (0, 2), (987654321, 9)):
        assert tconv._dec_str(dec, places) == jconv._dec_str(dec, places)


def test_chip_smoke_convert_phase_cpu(tmp_path):
    """chip_smoke.py's convert phase at 8,192 rows on the CPU: every row of
    every op against its oracle, and every op of the phase checked."""
    table = CS.make_convert_rows(8192, seed=7)
    path = str(tmp_path / "convert.csv")
    CS.write_csv(table, path)
    res, times, _ = CS._run_convert(torch, path, device="cpu")
    bad, gaps = CS._check_convert(table, res)
    assert not any(bad.values()), {k: v for k, v in bad.items() if v}
    assert gaps["stod"] <= 2 and gaps["stof"] <= 1
    assert set(times) == set(bad)


def test_chip_smoke_oracles_match_jax():
    """The convert phase's hand-written oracles encode custrings_tpu's
    semantics: held to it on the seeded rows (stod on rows it does not
    flush), the timestamps and the url decode included."""
    from custrings_tpu.ops import datetime_k as jdt
    from custrings_tpu.ops import urlencode as jurl

    t = CS.make_convert_rows(2048, seed=11)
    want = CS.read_back_py(t)
    fl = want["float"]
    jx = _jax(jconv.stod, jcol.from_host_strings(fl))
    oracle = CS.stod_py(fl)
    keep = np.asarray([x is not None for x in fl]) & ~_flushed(jx, oracle)
    exp = CS.stod_parts(fl)[2]
    with np.errstate(over="ignore"):
        pow_np = np.power(10.0, exp)
    _held(oracle, jx, pow_np, _jax(_pow10_xla, exp), keep)
    for name, fmt, units, ms in (("ts", None, "s", False), ("ts_ms", CS.TS_MS_FORMAT, "ms", True)):
        rows = want[name]
        got = _jax(jdt.timestamp2int, jcol.from_host_strings(rows), fmt, units).tolist()
        assert [CS.ts_parse_py(x, ms) for x in rows] == got
        items = jdt._compile(CS.TS_MS_OUT if ms else jdt.DEFAULT_FORMAT)
        assert [CS.ts_format_py(v, ms) for v in got] == [jdt._format_one(v, units, items) for v in got]
    url = want["url"]
    dec = jurl.url_decode(jcol.from_host_strings(url))
    data, offs = np.asarray(dec.data).tobytes(), np.asarray(dec.offsets).tolist()
    assert [None if x is None else CS.url_decode_py(x) for x in url] == [
        data[a:b] if x is not None else None for a, b, x in zip(offs[:-1], offs[1:], url)]


@pytest.mark.parametrize("case", range(3))
def test_chip_smoke_convert_kernel_shapes_cpu(case):
    t = CS.make_convert_rows(4096, seed=7)
    want = CS.read_back_py(t)
    name, source, replaces, shapes = CS._convert_kernel_shapes(torch, want["url"], want["float"],
                                                                device="cpu")[case]
    assert name == ("route_expand", "compact_bytes", "window_bytes")[case] and source.startswith("csrc/")
    label, kern, plain, extra = shapes[0]
    got, ref = kern(), plain()
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(g, r), label
    nbytes, nops = extra["bound"]
    assert nbytes > 0 and nops == 0
    if name == "compact_bytes":  # the library call: the kept bytes, without the zero tail
        kept = extra["library"]()
        assert torch.equal(ref[: kept.shape[0]], kept)
