"""nvstrings facade over the port's ops.

Port of `custrings_tpu/nvstrings.py`: every method of the JAX facade and
all 14 module functions.  Construction and export (`to_device`,
`to_host`, `to_offsets`, `get_ipc_data`, `__getitem__`, `__iter__`), row
attributes and predicates, search, `hash`, the number, address, boolean
and timestamp parsers (`stoi`, `stol`, `stof`, `stod`, `htoi`, `ip2int`,
`to_booleans`, `timestamp2int`) and their formatters (`itos`, `ltos`,
`ftos`, `dtos`, `int2ip`, `from_booleans`, `int2timestamp`), rewrites
(the case maps, strips, slices, paddings, `url_encode`, `url_decode`,
...), the regex ops (`count`, `findall`, `extract`, `replace`,
`replace_multi`, `replace_with_backrefs`, ...), joins, splits, row moves, `from_csv` and `get_info`.  Return
shapes are the JAX facade's, with None for a null row's value; there are
no `devptr` / `bdevmem` arguments (results are Python lists, and raw
device pointers are not part of the port's surface).  A function that
makes a column from host data takes `device`, "cuda" by default, and
raises where that device is missing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import column as _col
from .ops import array as _array
from .ops import attrs as _attrs
from .ops import case as _case
from .ops import combine as _combine
from .ops import convert as _convert
from .ops import datetime_k as _datetime
from .ops import find as _find
from .ops import hash as _hash
from .ops import modify as _modify
from .ops import pad as _pad
from .ops import split as _split
from .ops import strip as _strip
from .ops import substr as _substr
from .ops import urlencode as _url
from .ops.substr import _span_column
from .regex import ops as _rx
from .utils import csv as _csv
from .utils import stats as _stats


class nvstrings:
    """A column of strings on one device."""

    def __init__(self, col: _col.StringColumn):
        self._col = col

    def __repr__(self):
        return f"<custrings_tpu_torch.nvstrings count={self.size()} device={self._col.device}>"

    def __len__(self):
        return self._col.size

    def to_host(self):
        return _col.to_host_strings(self._col)

    def size(self):
        return self._col.size

    def __str__(self):
        return str(self.to_host())

    def __iter__(self):
        return iter(self.to_host())

    def __getitem__(self, key):
        """The rows at an index, a slice or a list of indexes (or of
        bools), as an nvstrings."""
        if isinstance(key, (int, np.integer)):
            return self.gather([int(key)])
        if isinstance(key, slice):
            return self.gather(list(range(*key.indices(self.size()))))
        if isinstance(key, (list, np.ndarray)):
            return self.gather(list(key))
        raise TypeError("key must be integer, slice, or list of integers")

    def to_offsets(self, sbuf=None, obuf=None, nbuf=None):
        """(bytes, int32 offsets, Arrow null bitmask) on the host; numpy
        `sbuf` / `obuf` / `nbuf` arrays are filled as well."""
        data, offsets, nulls = _col.to_offsets_np(self._col)
        for buf, arr, dtype in ((sbuf, data, np.uint8), (obuf, offsets, np.int32), (nbuf, nulls, np.uint8)):
            if isinstance(buf, np.ndarray):
                buf.view(dtype)[: len(arr)] = arr
        return data, offsets, nulls

    def memsize(self):
        return self._col.memsize()

    def device_memory(self):
        return self.memsize()

    def copy(self):
        return nvstrings(self._col)

    def get_nulls(self, emptyisnull=False):
        """Indexes of the null rows (and of the empty ones with
        `emptyisnull`)."""
        nulls = ~self._col.validity
        if emptyisnull:
            nulls = nulls | (self._col.lengths() == 0)
        return torch.nonzero(nulls).flatten().cpu().tolist()

    def set_null_bitmask(self, nbuf):
        """Replace the validity by an Arrow bitmask (bit set = valid); the
        rows keep their bytes."""
        bits = np.unpackbits(np.asarray(nbuf).view(np.uint8).ravel(), bitorder="little")[: self.size()]
        validity = torch.from_numpy(bits.astype(np.bool_)).to(self._col.device)
        self._col = _col.StringColumn(self._col.data, self._col.offsets, validity)
        return self

    def get_cpointer(self):
        """0: there is no host pointer to a device column."""
        return 0

    def get_ipc_data(self):
        """(bytes, offsets, null bitmask, count) as host buffers, from which
        any process rebuilds the column with create_from_ipc (in place of
        the reference's CUDA IPC handles)."""
        data, offsets, nulls = _col.to_offsets_np(self._col)
        return data.tobytes(), offsets.tobytes(), nulls.tobytes(), self.size()

    def get_info(self):
        """The column's statistics (utils.stats.compute_statistics)."""
        return _stats.compute_statistics(self._col)

    def _other(self, strs):
        """The column of an nvstrings, or of a list of str / None on this
        column's device."""
        return strs._col if isinstance(strs, nvstrings) else _col.from_host_strings(list(strs), self._col.device)

    # ---- attributes ----

    def len(self):
        """Per row: its char count (None for null rows)."""
        return self._masked(_attrs.len_chars(self._col))

    def byte_count(self, vals=0):
        """The column's total bytes; a numpy `vals` gets each row's (-1
        for null rows)."""
        out = _attrs.byte_count(self._col).cpu().numpy()
        if isinstance(vals, np.ndarray):
            vals[: len(out)] = out
        return int(np.maximum(out, 0).sum())

    def null_count(self, emptyisnull=False):
        return _col.null_count(self._col, emptyisnull)

    def isalnum(self):
        return self._masked(_attrs.isalnum(self._col))

    def isalpha(self):
        return self._masked(_attrs.isalpha(self._col))

    def isdigit(self):
        return self._masked(_attrs.isdigit(self._col))

    def isspace(self):
        return self._masked(_attrs.isspace(self._col))

    def isdecimal(self):
        return self._masked(_attrs.isdecimal(self._col))

    def isnumeric(self):
        return self._masked(_attrs.isnumeric(self._col))

    def islower(self):
        """Per row: non-empty with no upper-case letter ("123" is lower)."""
        return self._masked(_attrs.islower(self._col))

    def isupper(self):
        """Per row: non-empty with no lower-case letter."""
        return self._masked(_attrs.isupper(self._col))

    def is_empty(self):
        return self._masked(_attrs.is_empty(self._col))

    # ---- search ----

    def compare(self, str):
        """Per row: 0 equal to `str`, < 0 before it, > 0 after it, byte by
        byte (None for null rows)."""
        return self._masked(_find.compare(self._col, str))

    @staticmethod
    def _positions(res):
        return [None if x == -2 else x for x in res.cpu().tolist()]

    def find(self, sub, start=0, end=None):
        """Per row: the char position of the first `sub` in [start, end)
        (-1 none, None for null rows)."""
        return self._positions(_find.find(self._col, sub, start, end))

    def rfind(self, sub, start=0, end=None):
        return self._positions(_find.rfind(self._col, sub, start, end))

    def index(self, sub, start=0, end=None):
        """find, raising ValueError where a row has no `sub`."""
        out = self.find(sub, start, end)
        if -1 in out:
            raise ValueError("substring not found")
        return out

    def rindex(self, sub, start=0, end=None):
        out = self.rfind(sub, start, end)
        if -1 in out:
            raise ValueError("substring not found")
        return out

    def find_from(self, sub, starts=0, ends=0):
        """find with per-row char windows (0 for either: the whole row)."""
        s = None if isinstance(starts, int) and starts == 0 else starts
        e = None if isinstance(ends, int) and ends == 0 else ends
        return self._positions(_find.find_from(self._col, sub, s, e))

    def find_multiple(self, strs):
        """Per row: the first position of each of `strs` (None for null
        rows' entries)."""
        res = _find.find_multiple(self._col, self._other(strs))
        nulls = [None] * res.shape[1]
        # -2 marks a null row, in every column of it
        return [r if v else nulls[:] for r, v in zip(res.cpu().tolist(), self._col.validity.cpu().tolist())]

    def match_strings(self, strs):
        """Per row: equal to the same row of `strs` (two nulls match)."""
        return _find.match_strings(self._col, self._other(strs)).cpu().tolist()

    def startswith(self, pat):
        return self._masked(_find.startswith(self._col, pat))

    def endswith(self, pat):
        return self._masked(_find.endswith(self._col, pat))

    def contains(self, pat, regex=True):
        """Per row: does `pat` occur (None for null rows)."""
        if not regex:
            return self._masked(_find.contains(self._col, pat))
        return self._masked(_rx.contains_re(self._col, pat))

    def match(self, pat):
        """Per row: does `pat` match at its start (None for null rows)."""
        return self._masked(_rx.match_re(self._col, pat))

    def hash(self):
        """Per row: MurmurHash3_32 (seed 31) of its bytes, as a Python int
        (None for null rows)."""
        return self._masked(_hash.hash_mm3(self._col))

    def stoi(self):
        """Per row: its leading integer, as int32 (None for null rows)."""
        return self._masked(_convert.stoi(self._col))

    def stol(self):
        return self._masked(_convert.stol(self._col))

    def stof(self):
        """Per row: its leading float, as float32 (None for null rows)."""
        return self._masked(_convert.stof(self._col))

    def stod(self):
        return self._masked(_convert.stod(self._col))

    def htoi(self):
        """Per row: its hex digits' value (None for null rows)."""
        return self._masked(_convert.htoi(self._col))

    def ip2int(self):
        """Per row: its dotted-quad IPv4 address as an int (None for null
        rows)."""
        return self._masked(_convert.ip2int(self._col))

    def to_booleans(self, true="True"):
        """Per row: equal to `true` (None for null rows)."""
        return self._masked(_convert.to_booleans(self._col, true))

    def timestamp2int(self, format=None, units="s"):
        """Per row: its timestamp in `units` since the epoch, parsed by
        `format` (0 for null rows and rows that do not parse)."""
        return _datetime.timestamp2int(self._col, format, units).cpu().tolist()

    def _masked(self, res):
        vals = self._col.validity.cpu().tolist()
        return [b if v else None for b, v in zip(res.cpu().tolist(), vals)]

    def count(self, pat):
        """Per row: the number of non-overlapping matches (0 for null rows)."""
        return _rx.count_re(self._col, pat).cpu().tolist()

    def findall(self, pat):
        """nvstrings i holds each row's i-th match (null where none)."""
        return [nvstrings(c) for c in _rx.findall_columns(self._col, pat)]

    def findall_record(self, pat):
        """Per row: an nvstrings of its matches (None for null rows)."""
        return _records(_rx.findall_record(self._col, pat))

    def extract(self, pat):
        """nvstrings i holds each row's capture group i + 1 in its first
        match (null where none); [] for a pattern without groups."""
        return [nvstrings(c) for c in _rx.extract(self._col, pat)]

    def extract_record(self, pat):
        """Per row: an nvstrings of its first match's capture groups."""
        cols = _rx.extract_record(self._col, pat)
        return _transpose_records(cols) if cols else []

    def replace(self, pat, repl, n=-1, regex=True):
        """Replace occurrences of `pat` with `repl` in each row."""
        if regex:
            return nvstrings(_rx.replace_re(self._col, pat, repl, n))
        return nvstrings(_modify.replace_literal(self._col, pat, repl, n))

    def replace_multi(self, pats, repls, regex=True):
        """Replace each of `pats` with its entry of `repls` (a list, one
        str for all, or an nvstrings).  regex=True: one pass, the earliest
        match of any pattern first; regex=False: each literal in turn."""
        rep = repls.to_host() if isinstance(repls, nvstrings) else repls
        if regex:
            return nvstrings(_rx.replace_multi_re(self._col, pats, rep))
        cur = self._col
        rl = rep if isinstance(rep, (list, tuple)) else [rep] * len(pats)
        for p, r in zip(pats, rl):
            cur = _modify.replace_literal(cur, p, r)
        return nvstrings(cur)

    def replace_with_backrefs(self, pat, repl):
        """Replace every match with the template `repl`, \\N standing for
        group N's text (\\0 the whole match)."""
        return nvstrings(_rx.replace_with_backrefs(self._col, pat, repl))

    def join(self, sep=""):
        """The whole column as one string, the rows joined by `sep` (null
        rows skipped)."""
        return nvstrings(_combine.join(self._col, sep))

    def cat(self, others=None, sep=None, na_rep=None):
        """Row i joined to row i of `others` by `sep`; without `others`,
        the whole column joined; a list of columns is catted in turn."""
        if others is None:
            return nvstrings(_combine.join(self._col, sep or "", na_rep))
        if isinstance(others, (list, tuple)) and not all(o is None or isinstance(o, str) for o in others):
            cur = self
            for o in others:
                cur = cur.cat(o, sep=sep, na_rep=na_rep)
            return cur
        return nvstrings(_combine.cat(self._col, self._other(others), sep, na_rep))

    # ---- rewrites ----

    def get(self, i):
        """Per row: its char at position i."""
        return nvstrings(_substr.get_char(self._col, i))

    def slice(self, start, stop=None, step=None):
        return nvstrings(_substr.slice_chars(self._col, start, stop, step))

    def slice_from(self, starts=0, stops=0):
        """Per-row char windows (0 for either: the whole row)."""
        s = None if isinstance(starts, int) and starts == 0 else starts
        e = None if isinstance(stops, int) and stops == 0 else stops
        return nvstrings(_substr.slice_from(self._col, s, e))

    def slice_replace(self, start=None, stop=None, repl=None):
        return nvstrings(_modify.slice_replace(self._col, start or 0, stop, repl))

    def insert(self, start=0, repl=None):
        return nvstrings(_modify.insert(self._col, start, repl or ""))

    def fillna(self, repl):
        """Null rows become `repl` (a str, or the rows of an nvstrings)."""
        if isinstance(repl, nvstrings):
            return nvstrings(_modify.fillna_column(self._col, repl._col))
        return nvstrings(_modify.fillna_scalar(self._col, repl))

    def repeat(self, repeats):
        return nvstrings(_pad.repeat(self._col, repeats))

    def pad(self, width, side="left", fillchar=" "):
        return nvstrings(_pad.pad(self._col, width, side, fillchar))

    def ljust(self, width, fillchar=" "):
        return nvstrings(_pad.ljust(self._col, width, fillchar))

    def center(self, width, fillchar=" "):
        return nvstrings(_pad.center(self._col, width, fillchar))

    def rjust(self, width, fillchar=" "):
        return nvstrings(_pad.rjust(self._col, width, fillchar))

    def zfill(self, width):
        return nvstrings(_pad.zfill(self._col, width))

    def wrap(self, width):
        return nvstrings(_pad.wrap(self._col, width))

    def lstrip(self, to_strip=None):
        return nvstrings(_strip.lstrip(self._col, to_strip))

    def strip(self, to_strip=None):
        """Each row without its leading and trailing chars of `to_strip`
        (by default " \n\t")."""
        return nvstrings(_strip.strip(self._col, to_strip))

    def rstrip(self, to_strip=None):
        return nvstrings(_strip.rstrip(self._col, to_strip))

    def lower(self):
        return nvstrings(_case.lower(self._col))

    def upper(self):
        return nvstrings(_case.upper(self._col))

    def capitalize(self):
        return nvstrings(_case.capitalize(self._col))

    def swapcase(self):
        return nvstrings(_case.swapcase(self._col))

    def title(self):
        return nvstrings(_case.title(self._col))

    def translate(self, table):
        """Chars mapped through `table` ({char or ord: char, ord or None});
        None deletes the char."""
        return nvstrings(_modify.translate(self._col, table))

    def url_encode(self):
        """Every byte outside [0-9A-Za-z._~-] as %XX."""
        return nvstrings(_url.url_encode(self._col))

    def url_decode(self):
        """Every %XX escape as its byte."""
        return nvstrings(_url.url_decode(self._col))

    # ---- row moves ----

    def sort(self, stype=2, asc=True, nullfirst=True):
        """Rows sorted by byte length (stype 1), name (2) or both (3)."""
        return nvstrings(_array.sort(self._col, stype, asc, nullfirst))

    def order(self, stype=2, asc=True, nullfirst=True):
        """The row indices of sort(), ties in row order."""
        return _array.order(self._col, stype, asc, nullfirst).cpu().tolist()

    def sublist(self, indexes, count=0):
        return self.gather(indexes, count)

    def gather(self, indexes, count=0):
        """The rows at `indexes` (negative ones wrap), or where a boolean
        list is True."""
        arr = np.asarray(indexes)
        if arr.dtype == np.bool_:
            mask = torch.from_numpy(arr.copy()).to(self._col.device)
            return nvstrings(_array.gather_mask(self._col, mask))
        return nvstrings(_array.gather(self._col, arr.astype(np.int64)))

    def scatter(self, strs, indexes):
        """Rows at `indexes` replaced by the rows of `strs`."""
        return nvstrings(_array.scatter(self._col, self._other(strs), np.asarray(indexes)))

    def scalar_scatter(self, str, indexes, count=0):
        """Rows at `indexes` replaced by `str`."""
        return nvstrings(_array.scalar_scatter(self._col, self._other([str]), np.asarray(indexes)))

    def remove_strings(self, indexes, count=0):
        return nvstrings(_array.remove_strings(self._col, indexes))

    def add_strings(self, strs):
        """The rows of this column, then those of `strs` (an nvstrings, a
        list of str, or a list of nvstrings)."""
        items = strs if isinstance(strs, list) and any(isinstance(s, nvstrings) for s in strs) else [strs]
        return nvstrings(_array.append([self._col] + [self._other(s) for s in items]))

    def split_record(self, delimiter=None, n=-1):
        """Per row: an nvstrings of its tokens (None for null rows); on
        whitespace runs when `delimiter` is None."""
        return _records(_split.split_record(self._col, delimiter, n))

    def rsplit_record(self, delimiter=None, n=-1):
        """split_record with the limit n applied from the right."""
        return _records(_split.rsplit_record(self._col, delimiter, n))

    def split(self, delimiter=None, n=-1):
        """nvstrings i holds each row's i-th token (null where none)."""
        return [nvstrings(c) for c in _split.split_columns(self._col, delimiter, n)]

    def rsplit(self, delimiter=None, n=-1):
        """split with the limit n applied from the right."""
        return [nvstrings(c) for c in _split.rsplit_columns(self._col, delimiter, n)]

    def partition(self, delimiter=" "):
        """Per row: an nvstrings [before, delimiter, after] of its first
        occurrence."""
        return _transpose_records(_split.partition(self._col, delimiter))

    def rpartition(self, delimiter=" "):
        """Per row: an nvstrings [before, delimiter, after] of its last
        occurrence."""
        return _transpose_records(_split.rpartition(self._col, delimiter))


class _Row(nvstrings):
    """One row of a record op's result (split_record, findall_record,
    partition, ...): its strings, read back with every other row's in one
    batch.  The CPU column behind them is built at its first use, so a
    caller that reads the strings never pays for a column a row."""

    def __init__(self, strs):
        self._strs = strs

    @functools.cached_property
    def _col(self):
        return _col.from_host_strings(self._strs, "cpu")

    def __len__(self):
        return len(self._strs)

    def size(self):
        return len(self._strs)

    def to_host(self):
        return list(self._strs)


def _records(tc):
    """TokenColumn -> list of per-row nvstrings (None for null rows), from
    one batched copy of the tokens to the host."""
    toks = _col.to_host_strings(tc.tokens)
    row_off = tc.row_offsets.cpu().tolist()
    return [_Row(toks[row_off[i] : row_off[i + 1]]) if ok else None
            for i, ok in enumerate(tc.row_validity.cpu().tolist())]


def _transpose_records(cols):
    """Columns of equal size -> per row, an nvstrings of that row of each
    column (partition, rpartition): the columns' rows interleaved into one
    column on the device, then cut into records as split_record's are."""
    n, k, dev = cols[0].size, len(cols), cols[0].device
    shift = torch.tensor([0] + [c.capacity for c in cols[:-1]], device=dev).cumsum(0)
    starts = torch.stack([c.offsets[:-1] for c in cols], 1) + shift.to(torch.int32)
    sizes = torch.stack([c.lengths() for c in cols], 1)
    valid = torch.stack([c.validity for c in cols], 1)
    rows = _span_column(torch.cat([c.data for c in cols]), starts.flatten(), sizes.flatten(), valid.flatten())
    step = torch.arange(n + 1, dtype=torch.int32, device=dev) * k
    return _records(_split.TokenColumn(rows, step, torch.ones(n, dtype=torch.bool, device=dev)))


def to_device(strs, device="cuda"):
    """nvstrings from a list of Python str / None on `device`; raises
    where that device is missing."""
    return nvstrings(_col.from_host_strings(strs, device))


def from_strings(*args):
    """One nvstrings of the rows of the given ones (or lists of them), in
    turn."""
    cols = []
    for a in args:
        if isinstance(a, list):
            cols.extend(x._col for x in a)
        else:
            cols.append(a._col)
    return nvstrings(_array.append(cols))


def from_offsets(sbuf, obuf, scount, nbuf=None, ncount=0, device="cuda"):
    """nvstrings from Arrow host buffers: bytes, scount + 1 int32 offsets
    and an optional null bitmask (bit set = valid)."""
    return nvstrings(_col.from_offsets_np(sbuf, obuf, scount, nbuf, device=device))


def create_from_ipc(ipc_data, device="cuda"):
    """nvstrings from get_ipc_data()'s buffers."""
    data_b, offs_b, nulls_b, count = ipc_data
    return from_offsets(np.frombuffer(data_b, np.uint8), np.frombuffer(offs_b, np.int32), count,
                        np.frombuffer(nulls_b, np.uint8), device=device)


def from_csv(csv, column, lines=0, flags=0, device="cuda"):
    """Field `column` of a CSV file's lines after its header
    (utils.csv.read_column; `flags` as its CSV_* constants)."""
    return nvstrings(_csv.read_column(csv, column, lines, flags, device))


def itos(values, count=0, nulls=None, device="cuda"):
    """Host int32 values as decimal strings; `nulls` a bool array of the
    null rows or an Arrow bitmask."""
    return nvstrings(_convert.itos(np.asarray(values, np.int32), nulls, device))


def ltos(values, count=0, nulls=None, device="cuda"):
    return nvstrings(_convert.itos(np.asarray(values, np.int64), nulls, device))


def ftos(values, count=0, nulls=None, device="cuda"):
    """Host float32 values as strings of 10 significant digits (an
    exponent past 1e9 and below 1e-4)."""
    return nvstrings(_convert.ftos(np.asarray(values, np.float32), nulls, device))


def dtos(values, count=0, nulls=None, device="cuda"):
    return nvstrings(_convert.ftos(np.asarray(values, np.float64), nulls, device))


def int2ip(values, count=0, nulls=None, device="cuda"):
    """Host uint32 values (None as 0) as dotted-quad IPv4 addresses."""
    vals = [0 if v is None else int(v) for v in values]
    return nvstrings(_convert.int2ip(np.asarray(vals, np.uint32), nulls, device))


def from_booleans(values, true="True", false="False", nulls=None, device="cuda"):
    return nvstrings(_convert.from_booleans(values, true, false, nulls, device))


def int2timestamp(values, units="s", format=None, nulls=None, device="cuda"):
    """Host int64 epoch values in `units` as timestamps in `format`."""
    return nvstrings(_datetime.int2timestamp(np.asarray(values, np.int64), units, format, nulls, device))


def free(dstrs):
    """Nothing to do: a column's tensors are freed with it."""


def bind_cpointer(cptr, own=True):
    raise NotImplementedError("raw device pointers are not part of the port's surface")
