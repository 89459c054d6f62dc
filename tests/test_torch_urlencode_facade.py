"""Port parity for url_encode / url_decode (ops/urlencode.py), CSV ingest
(utils/csv.py), the column statistics (utils/stats.py) and the rest of
the nvstrings facade (its plain members and module functions) against
custrings_tpu on the same host rows.  Compared exactly: valid rows'
bytes, offsets and validity (decoded rows as bytes: they may be invalid
UTF-8), numbers and dicts.  CSV files are written under pytest's
tmp_path.  Also the mirrors of tests/test_api.py's facade cases, and the
facade's surface against the JAX facade's."""

import re

import jax
import numpy as np
import pytest
import torch

import custrings_tpu.nvstrings as jnv
from custrings_tpu import column as jcol
from custrings_tpu.ops import urlencode as jurl
from custrings_tpu.utils import csv as jcsv
from custrings_tpu_torch import column as tcol
from custrings_tpu_torch import nvstrings as tnv
from custrings_tpu_torch.ops import urlencode as turl
from custrings_tpu_torch.utils import csv as tcsv

from test_torch_split_ws import CS, fast_reference_compiles  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

URL_ROWS = CS.make_convert_rows(1024, seed=9)["url"] + [
    "hello world", "a/b?c=d", "héllo", None, "ok._~-", "", "%4", "%%41", "%zz", "100%", "%", "%%", "%C3",
    "%F0%9F%98%80", "%2Fhome%2fnfs", "987%20ZYX", "http://www.hellow.com?k1=acc%C3%A9nted&k2=a%2F/b.c",
    "x\x00y", "😀 🔥", "%25%32%35"]


def _same_facade(t, j):
    """Two facades' columns: valid rows' bytes, offsets and validity."""
    a, b = _bytes_of(t._col, j._col)
    assert a == b


def _bytes_of(col_t, col_j):
    """Each column's (valid rows' bytes, offsets, validity) on the host."""
    def host(data, offs, val):
        data, offs, val = np.asarray(data), np.asarray(offs).tolist(), np.asarray(val).tolist()
        return [data[a:b].tobytes() if v else None for a, b, v in zip(offs[:-1], offs[1:], val)], offs, val

    return (host(col_t.data.numpy(), col_t.offsets.numpy(), col_t.validity.numpy()),
            host(col_j.data, col_j.offsets, col_j.validity))


@pytest.mark.parametrize("rows", [URL_ROWS, [], [None, None], ["", ""]], ids=["seeded", "empty", "null", "blank"])
def test_url_encode_decode_match_jax(rows):
    t, j = tcol.from_host_strings(rows, "cpu"), jcol.from_host_strings(rows)
    enc_t, enc_j = turl.url_encode(t), jurl.url_encode(j)
    a, b = _bytes_of(enc_t, enc_j)
    assert a == b
    for src_t, src_j in ((t, j), (enc_t, enc_j)):
        a, b = _bytes_of(turl.url_decode(src_t), jurl.url_decode(src_j))
        assert a == b
    assert tcol.to_host_strings(turl.url_decode(enc_t)) == rows
    assert a[0] == [None if x is None else CS.url_decode_py(x) for x in tcol.to_host_strings(enc_t)]


def test_url_reference_corpora():
    """tests/test_ops.py's url cases through the port's facade."""
    import urllib.parse

    corpus = ["hello world", "a/b?c=d", "héllo", None, "ok._~-"]
    assert tnv.to_device(corpus, device="cpu").url_encode().to_host() == [
        None if s is None else urllib.parse.quote(s, safe="") for s in corpus]
    corpus = ["hello%20world", "a%2Fb", "h%C3%A9llo", None, "100%"]
    assert tnv.to_device(corpus, device="cpu").url_decode().to_host() == [
        None if s is None else urllib.parse.unquote(s) for s in corpus]
    urls = ["http://www.hellow.com?k1=acc%C3%A9nted&k2=a%2F/b.c", "%2Fhome%2fnfs", "987%20ZYX"]
    assert tnv.to_device(urls, device="cpu").url_decode().to_host() == [urllib.parse.unquote(u) for u in urls]


def test_url_decode_of_an_empty_column_is_the_column():
    col = tcol.from_host_strings([], "cpu")
    assert turl.url_decode(col) is col


def _line(rng):
    pieces = ["a", "b,c", '"', '""', ",", "x y", "é", '"q,r"', "", "12", "\t"]
    return "".join(pieces[i] for i in rng.integers(0, len(pieces), rng.integers(0, 9)))


def test_split_line_matches_jax():
    rng = np.random.default_rng(4)
    for line in [_line(rng) for _ in range(3000)] + ['"a,b",c', '""', '"', ',', '"x""y",z', 'a,"b']:
        assert tcsv._split_line(line) == jcsv._split_line(line), line


@pytest.mark.parametrize("flags", [0, tcsv.CSV_NULL_IS_EMPTY, tcsv.CSV_SORT_LENGTH, tcsv.CSV_SORT_NAME,
                                   tcsv.CSV_SORT_NAME | tcsv.CSV_NULL_IS_EMPTY])
def test_read_column_matches_jax(tmp_path, flags):
    """Quoted fields with commas and doubled quotes, blank fields, lines
    without the column, CRLF endings; every column, the `lines` limit."""
    rng = np.random.default_rng(flags)
    p = tmp_path / "t.csv"
    lines = ["h1,h2,h3"] + [",".join(_line(rng) for _ in range(rng.integers(1, 4))) for _ in range(300)]
    p.write_text("\r\n".join(lines[:150]) + "\n" + "\n".join(lines[150:]) + "\n", encoding="utf-8")
    for column in range(3):
        for limit in (0, 40):
            got = tcsv.read_column(str(p), column, limit, flags, device="cpu")
            want = jcsv.read_column(str(p), column, limit, flags)
            assert tcol.to_host_strings(got) == jcol.to_host_strings(want), (column, limit)


def test_from_csv(tmp_path):
    """Held to the JAX facade at flags 0 (which it drops: it passes no
    flags on), and to literals."""
    p = tmp_path / "t.csv"
    p.write_text('a,b\n1,x\n2,y\n3,\n"4,5","z""w"\n6\n')
    for column, lines in ((0, 0), (1, 0), (0, 2), (1, 3), (2, 0)):
        _same_facade(tnv.from_csv(str(p), column, lines, device="cpu"), jnv.from_csv(str(p), column, lines))
    assert tnv.from_csv(str(p), 1, device="cpu").to_host() == ["x", "y", None, 'z""w', None]
    assert tnv.from_csv(str(p), 1, flags=tcsv.CSV_NULL_IS_EMPTY, device="cpu").to_host() == ["x", "y", "", 'z""w', None]
    assert tnv.from_csv(str(p), 0, lines=2, device="cpu").to_host() == ["1", "2"]


def test_get_info_matches_jax():
    rows = CS.make_clean_rows(CS.make_corpus(600, seed=1))[-900:]
    for strs in (rows, ["Hello", "world", "Hello", None, ""], ["a"], ["", None]):
        got = tnv.to_device(strs, device="cpu").get_info()
        assert got == jnv.to_device(strs).get_info()
    info = tnv.to_device(["Hello", "world", "Hello", None, ""], device="cpu").get_info()
    assert info["unique_strings"] == 4 and info["uppercase_count"] == 2 and info["null_strings"] == 1


def test_get_info_matches_chip_smoke_oracle():
    rows = CS.make_convert_rows(2000, seed=2)["int"]
    s = tnv.to_device(rows, device="cpu")
    info = s.get_info()
    assert info.pop("device_memory") == s.memsize()
    assert info == CS.stats_py(rows)


def test_facade_surface():
    """Every public nvstrings method of the JAX facade (and __str__,
    __iter__, __getitem__), and all 14 module functions."""
    def methods(cls):
        return {m for m in dir(cls) if not m.startswith("_") or m in ("__str__", "__iter__", "__getitem__")}

    missing = methods(jnv.nvstrings) - methods(tnv.nvstrings)
    assert missing == set()
    src = open(jnv.__file__, encoding="utf-8").read()
    funcs = set(re.findall(r"^def ([a-z]\w*)\(", src, re.M))
    assert len(funcs) == 14 and all(callable(getattr(tnv, f, None)) for f in funcs)


def test_new_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """A column-making entry point defaults to device="cuda" and raises,
    never falling back to the CPU, where CUDA is missing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tmp_path / "t.csv"
    p.write_text("a\n1\n")
    calls = [lambda: tnv.itos([1]), lambda: tnv.ltos([1]), lambda: tnv.ftos([1.0]), lambda: tnv.dtos([1.0]),
             lambda: tnv.int2ip([1]), lambda: tnv.from_booleans([True]), lambda: tnv.int2timestamp([1]),
             lambda: tnv.from_offsets(np.frombuffer(b"ab", np.uint8), np.array([0, 2], np.int32), 1),
             lambda: tnv.from_csv(str(p), 0), lambda: tnv.create_from_ipc((b"a", b"\0\0\0\0\1\0\0\0", b"\1", 1))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---- tests/test_api.py's facade cases, through the port

TIPS_SAMPLE = [
    "16.99,1.01,Female,No,Sun,Dinner,2",
    "10.34,1.66,Male,No,Sun,Dinner,3",
    "21.01,3.5,Male,No,Sun,Dinner,3",
    "23.68,3.31,Male,No,Mon,Lunch,2",
    "24.59,3.61,Female,No,Tues,Dinner,4",
    "25.29,4.71,Male,No,Sat,Dinner,4",
    "8.77,2.0,Male,No,Thur,Lunch,2",
    "26.88,3.12,Male,No,Fri,Dinner,4",
]


def test_readme_tips_demo():
    from custrings_tpu_torch import nvcategory

    gpu_columns = tnv.to_device(TIPS_SAMPLE, device="cpu").split(",")
    day = gpu_columns[4]
    for idx, name in enumerate(["Sun", "Mon", "Tues", "Wed", "Thur", "Fri", "Sat"]):
        day = day.replace(name, str(idx), regex=False)
    assert nvcategory.from_strings(gpu_columns[4]).keys().to_host() == ["Fri", "Mon", "Sat", "Sun", "Thur", "Tues"]
    assert day.to_host() == ["0", "0", "0", "1", "2", "6", "4", "5"]
    tips = gpu_columns[1].stof()
    assert tips == pytest.approx([1.01, 1.66, 3.5, 3.31, 3.61, 4.71, 2.0, 3.12], rel=1e-6)


def test_getitem_and_iter():
    """Every kind of key held to the JAX facade, then to literals."""
    rows = ["a", None, "ccc", "", "dé"]
    s, js = tnv.to_device(rows, device="cpu"), jnv.to_device(rows)
    for key in (1, -1, np.int64(2), slice(1, 3), slice(5, None), slice(None, None, -2), slice(-2, None), [0, 3],
                [-1, 0, -5], np.array([3, -2]), np.array([True, False, False, True, True]), []):
        _same_facade(s[key], js[key])
    assert list(s) == list(js) and str(s) == str(js)
    s = tnv.to_device(["a", "b", "c", "d"], device="cpu")
    assert s[1].to_host() == ["b"]
    assert s[1:3].to_host() == ["b", "c"]
    assert s[[0, 3]].to_host() == ["a", "d"]
    assert s[np.array([True, False, False, True])].to_host() == ["a", "d"]
    assert s[-1].to_host() == ["d"] and s[5:].to_host() == []
    assert list(s) == ["a", "b", "c", "d"] and str(s) == str(["a", "b", "c", "d"])
    with pytest.raises(TypeError):
        s["x"]


PARSE_ROWS = ["1234", "-876", "5.3", "hello", "", None, "123456789012345", "1234.0", "-876.5", "5.3e2", ".5",
              "-.02", "nan", "inf", "-Inf", "-0", "ABCDEF", "0xDEADBEEF", "ff", "1A2", "cafe", "-0.12", ".55",
              "abc123", "123abc", "456e", "-1.78e+5", "192.168.0.1", "10.0.0.255", "0.0.0.0", "41.197.0.1",
              "True", "False", "true", "9223372036854775807", "-9223372036854775808"]


def test_number_parsers_match_the_jax_facade():
    """Every facade parser on one column (one width, as the JAX parsers'
    scan compiles a program per shape), held to the JAX facade under
    64-bit mode: ints, bools and null rows exactly; stod and stof as
    tests/test_torch_convert.py holds them, within 2 ulp and 1 ulp, NaN,
    the infinities and the sign exact."""
    s, js = tnv.to_device(PARSE_ROWS, device="cpu"), jnv.to_device(PARSE_ROWS)
    calls = [("stoi", {}), ("stol", {}), ("htoi", {}), ("ip2int", {}), ("to_booleans", {}),
             ("to_booleans", {"true": "true"}), ("stod", {}), ("stof", {})]
    with jax.enable_x64(True):
        want = [getattr(js, name)(**kw) for name, kw in calls]
    got = [getattr(s, name)(**kw) for name, kw in calls]
    for (name, _), g, w in zip(calls[:6], got, want):
        assert g == w, name
    for g, w, dtype, ulps in ((got[6], want[6], np.float64, 2), (got[7], want[7], np.float32, 1)):
        assert [v is None for v in g] == [v is None for v in w]
        gv, _ = CS._parts(g, dtype)
        wv, _ = CS._parts(w, dtype)
        assert np.all(CS._ulps(gv, wv) <= ulps)


def test_number_parsers_through_the_facade():
    """tests/test_api.py's parser cases and reference vectors (the op-level
    parity with the JAX package is tests/test_torch_convert.py's)."""
    def dev(rows):
        return tnv.to_device(rows, device="cpu")

    assert dev(["1234", "-876", "5.3", "hello", "", None]).stoi() == [1234, -876, 5, 0, 0, None]
    assert dev(["123456789012345"]).stol() == [123456789012345]
    got = dev(["1234.0", "-876.5", "5.3e2", ".5", "-.02", "", "nan", "inf"]).stod()
    exp = [1234.0, -876.5, 530.0, 0.5, -0.02, 0.0, float("nan"), float("inf")]
    assert all(np.isnan(g) if np.isnan(e) else g == pytest.approx(e, rel=1e-9) for g, e in zip(got, exp))
    assert dev(["1234", "ABCDEF", "0xDEADBEEF", "ff"]).htoi() == [0x1234, 0xABCDEF, 0xDEADBEEF, 0xFF]
    assert dev(["1234", "ABCDEF", "1A2", "cafe"]).htoi() == [4660, 11259375, 418, 51966]
    corpus = ["1234", "5678", "90", None, "-876", "543.2", "-0.12", ".55", "-.002", "", "de", "abc123", "123abc",
              "456e", "-1.78e+5"]
    assert dev(corpus).stoi() == [1234, 5678, 90, None, -876, 543, 0, 0, 0, 0, 0, 0, 123, 456, -1]
    exp = [1234.0, 5678.0, 90.0, None, -876.0, 543.2000122070312, -0.11999999731779099, 0.550000011920929,
           -0.0020000000949949026, 0.0, 0.0, 0.0, 123.0, 456.0, -178000.0]
    assert all((g is None and e is None) or g == pytest.approx(e, rel=1e-7) for g, e in zip(dev(corpus).stof(), exp))
    assert dev(["192.168.0.1", "10.0.0.255", "0.0.0.0"]).ip2int() == [3232235521, 167772415, 0]
    assert dev(["192.168.0.1", "10.0.0.1", None, "", "hello", "41.186.0.1", "41.197.0.1"]).ip2int() == [
        3232235521, 167772161, None, 0, 0, 700055553, 700776449]
    assert dev(["True", "False", "true", None]).to_booleans() == [True, False, False, None]
    s = dev(["true", "false", None, "", "true", "True"])
    assert s.to_booleans() == [False, False, None, False, False, True]
    assert s.to_booleans(true="true") == [True, False, None, False, True, False]


F64 = np.array([0.0, 1.5, -2.75, 1234567890.5, 103342.313, -25.4294, 839542223232.794248339, np.nan, -np.inf,
                -0.0, 1e-5, 123456.7])
FORMATTERS = {  # a facade function and its arguments, bool-array and Arrow-bitmask nulls among them
    "itos": ([0, -25, 314, 2**31 - 1, -(2**31)], {"nulls": np.array([False, False, True, False, False])}),
    "ltos": ([0, -25, 2**63 - 1, -(2**63), 7], {"nulls": np.packbits([1, 1, 1, 1, 0], bitorder="little")}),
    "ftos": (F64.astype(np.float32), {"nulls": np.packbits([1] * 11 + [0], bitorder="little")}),
    "dtos": (F64, {"nulls": np.arange(12) % 5 == 3}),
    "int2ip": ([3232235521, None, 167772161, 0, 2**32 - 1, 700055553], {"nulls": np.array([0b011011], np.uint8)}),
    "from_booleans": ([True, False, False, True], {"nulls": [11]}),
    "from_booleans(Yes)": ([True, False, True], {"true": "Yes", "false": "", "nulls": np.array([False, False, True])}),
    "int2timestamp": ([0, 86400, 1553085296, -1, 1582934400], {"nulls": np.array([True, False, False, False, False])}),
    "int2timestamp(ms)": ([0, 1553085296123, -1], {"units": "ms", "format": "%Y-%m-%d %H:%M:%S.%f %p",
                                                   "nulls": np.array([4], np.uint8)}),
}


@pytest.mark.parametrize("name", FORMATTERS)
def test_formatters_match_the_jax_facade(name):
    values, kw = FORMATTERS[name]
    fn = name.split("(")[0]
    got = getattr(tnv, fn)(values, device="cpu", **kw)
    with jax.enable_x64(True):
        want = getattr(jnv, fn)(values, **kw)
    _same_facade(got, want)


def test_formatters_through_the_facade():
    assert tnv.itos([0, -25, 314], device="cpu").to_host() == ["0", "-25", "314"]
    got = tnv.dtos(np.array([0.0, 1.5, -2.75, 1234567890.5]), device="cpu").to_host()
    assert got[:3] == ["0.0", "1.5", "-2.75"] and got[3].startswith("1.23456789") and got[3].endswith("e+09")
    assert tnv.ftos(np.array([1.5], np.float32), device="cpu").to_host() == ["1.5"]
    # tests/test_api.py's reference vectors
    vals = np.array([0, 103, -254848.5929, 8395794.248339, np.nan, np.inf], np.float32)
    assert tnv.ftos(vals, device="cpu").to_host() == ["0.0", "103.0", "-254848.5938", "8395794.0", "NaN", "Inf"]
    vals = np.array([0, 103342.313, -25.4294, 839542223232.794248339, np.nan])
    assert tnv.dtos(vals, device="cpu").to_host() == ["0.0", "103342.313", "-25.4294", "8.395422232e+11", "NaN"]
    assert tnv.from_booleans([True, False], device="cpu").to_host() == ["True", "False"]
    assert tnv.from_booleans([True, False, False, True], nulls=[11], device="cpu").to_host() == [
        "True", "False", None, "True"]
    ints = [3232235521, 167772161, None, 0, 0, 700055553, 700776449]
    assert tnv.int2ip(ints, device="cpu").to_host() == ["192.168.0.1", "10.0.0.1", "0.0.0.0", "0.0.0.0",
                                                        "0.0.0.0", "41.186.0.1", "41.197.0.1"]


def test_plain_members_match_jax():
    rows = ["dog and cat", None, "accénted", "", "x"]
    s, js = tnv.to_device(rows, device="cpu"), jnv.to_device(rows)
    for a, b in zip(s.to_offsets(), js.to_offsets()):
        assert np.array_equal(a, b)
    sbuf, obuf, nbuf = np.zeros(32, np.uint8), np.zeros(6, np.int32), np.zeros(1, np.uint8)
    s.to_offsets(sbuf, obuf, nbuf)
    assert obuf.tolist() == js.to_offsets()[1].tolist() and nbuf[0] == js.to_offsets()[2][0]
    assert s.memsize() == js.memsize() == s.device_memory() == js.device_memory()
    assert s.copy().to_host() == rows and s.get_cpointer() == js.get_cpointer() == 0
    for e in (False, True):
        assert s.get_nulls(e) == js.get_nulls(e)
    bits = np.packbits([1, 1, 0, 1, 0], bitorder="little")
    assert s.set_null_bitmask(bits).to_host() == js.set_null_bitmask(bits).to_host() == [
        "dog and cat", "", None, "", None]
    assert s.get_ipc_data() == js.get_ipc_data()
    tnv.free(s)
    with pytest.raises(NotImplementedError):
        tnv.bind_cpointer(0)


def test_ipc_offsets_and_concat_match_jax():
    """create_from_ipc, from_offsets (with and without a bitmask, and a
    count below the buffers') and from_strings held to the JAX facade,
    each package reading the other's IPC buffers too."""
    rows = ["dog and cat", None, "accénted", "", "x"]
    s, js = tnv.to_device(rows, device="cpu"), jnv.to_device(rows)
    _same_facade(tnv.create_from_ipc(s.get_ipc_data(), device="cpu"), jnv.create_from_ipc(js.get_ipc_data()))
    _same_facade(tnv.create_from_ipc(js.get_ipc_data(), device="cpu"), jnv.create_from_ipc(s.get_ipc_data()))
    data, offs, nulls = js.to_offsets()
    for count, bits in ((5, nulls), (5, None), (3, nulls), (2, None)):
        _same_facade(tnv.from_offsets(data, offs, count, bits, device="cpu"), jnv.from_offsets(data, offs, count, bits))
    s2, js2 = tnv.to_device(["a", None], device="cpu"), jnv.to_device(["a", None])
    _same_facade(tnv.from_strings(s, [s2, s]), jnv.from_strings(js, [js2, js]))
    _same_facade(tnv.from_strings(s2), jnv.from_strings(js2))


def test_ipc_offsets_and_concat_roundtrip():
    s = tnv.to_device(["a", None, "ccc"], device="cpu")
    assert tnv.create_from_ipc(s.get_ipc_data(), device="cpu").to_host() == ["a", None, "ccc"]
    data, offs, nulls = s.to_offsets()
    assert tnv.from_offsets(data, offs, 3, nulls, device="cpu").to_host() == ["a", None, "ccc"]
    assert tnv.from_offsets(data, offs, 2, device="cpu").to_host() == ["a", ""]
    s1 = tnv.to_device(["dog and cat", None, "accénted", ""], device="cpu")
    assert tnv.from_strings(s1, [s1, s]).to_host() == ["dog and cat", None, "accénted", ""] * 2 + [
        "a", None, "ccc"]
