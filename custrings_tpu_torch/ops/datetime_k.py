"""Timestamp parse and format.

Port of `custrings_tpu/ops/datetime_k.py`: the format compiler
(`_compile`, `_SPEC_LEN`, `_PARSE_ERROR_SPECS`, `_fixed_layout`), the
parser `timestamp2int` (`timestamp2int_device`), the formatter
`int2timestamp` (through `format_k.int2timestamp_device`) and the host
oracles (`timestamp2int_host_oracle`, `_parse_one`, `_format_one`),
copied so that the port imports nothing of the JAX package.

A tiny strptime/strftime subset of cpp/src/strings/datetime.cu
(timestamp2long:351, long2timestamp:639): specifiers %Y %y %m %d %H %I %p
%M %S %f %z %Z %j and 9 time units.  Every specifier is fixed width, so a
format is a static layout of (specifier, position, length) and the parser
reads each field's digits at its positions from the rows' padded view
(K1, `layout.char_planes`).  The JAX package gathers that view with plain
XLA only because Mosaic's lowering recursed under x64; the port takes
the package's view.
"""

from __future__ import annotations

import numpy as np
import torch

from ..column import StringColumn, to_host_strings
from .format_k import _upload, int2timestamp_device
from .layout import char_planes

DEFAULT_FORMAT = "%Y-%m-%dT%H:%M:%SZ"

_UNITS_PER_SEC = {"s": 1, "ms": 1000, "us": 1000000, "ns": 1000000000}

#: the reference compiler's full specifier map (datetime.cu:78-85).  %f
#: length depends on units: 3 for ms, 9 for ns, else 6 (datetime.cu:132-138)
_SPEC_LEN = {
    "a": 0, "A": 0, "w": 1, "b": 0, "B": 0,
    "Y": 4, "y": 2, "m": 2, "d": 2,
    "H": 2, "I": 2, "M": 2, "S": 2, "f": 6,
    "p": 2, "z": 5, "Z": 3,
    "j": 3, "U": 2, "W": 2,
}

#: specifiers the compiler accepts but the PARSER's switch rejects
#: (datetime.cu:275-276 default: return 3): any format containing one
#: parses every row to 0
_PARSE_ERROR_SPECS = {"a", "A", "b", "B", "w", "U", "W"}


def _spec_len(spec: str, units: str) -> int:
    if spec not in _SPEC_LEN:
        raise ValueError(f"invalid specifier %{spec}")  # datetime.cu:128
    if spec == "f":
        return 3 if units == "ms" else (9 if units == "ns" else 6)
    return _SPEC_LEN[spec]


def _compile(fmt: str):
    """Format string -> list of (kind, char) items (DTFormatCompiler,
    datetime.cu:43-160; %% escapes)."""
    items = []
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            nxt = fmt[i + 1]
            if nxt == "%":
                items.append(("lit", "%"))
            else:
                if nxt not in _SPEC_LEN:
                    raise ValueError(f"invalid specifier %{nxt}")
                items.append(("spec", nxt))
            i += 2
        else:
            items.append(("lit", c))
            i += 1
    return items


def _fixed_layout(items, units: str = "s"):
    """Static (spec, position, length) layout of the specifier items."""
    pos = 0
    out = []
    for kind, v in items:
        if kind == "lit":
            pos += 1
            continue
        ln = _spec_len(v, units)
        out.append((v, pos, ln))
        pos += ln
    return out


def timestamp2int_device(col: StringColumn, layout, units: str) -> torch.Tensor:
    """int64[rows]: positional digit reads and civil-date arithmetic.

    parse_into_parts + timestamp_from_parts (datetime.cu:205-333): str2int
    stops at the first non-digit, a row shorter than an item's span parses
    to 0, %y adds 1900, %j sets the DAY field (the month stays 1: the
    reference's doy quirk), %p adds 12 when hour <= 12 and the field is PM,
    %Z accepts only UTC (any case), %z is a fixed sign+HHMM ADDED to the
    timestamp.  Floor division as in the JAX package."""
    n = col.size
    planes, lens = char_planes(col)

    def at(p):
        return planes[min(p, planes.shape[0] - 1)]

    def field(pos, ln):
        v = torch.zeros(n, dtype=torch.int64, device=col.device)
        alive = torch.ones(n, dtype=torch.bool, device=col.device)
        for k in range(ln):
            c = at(pos + k)
            alive &= (c >= ord("0")) & (c <= ord("9"))
            v = torch.where(alive, v * 10 + (c - ord("0")), v)
        return v

    zero = torch.zeros(n, dtype=torch.int64, device=col.device)
    Y, mo, d, H, M, S, sub, tzmin = zero, zero + 1, zero + 1, zero, zero, zero, zero, zero
    ok = col.validity & (lens > 0)
    for v, pos, ln in layout:
        ok = ok & (lens - pos >= ln)  # error 1: length < slen
        if v == "z":
            sign = torch.where(at(pos) == ord("-"), -1, 1)
            tzmin = sign * (field(pos + 1, 2) * 60 + field(pos + 3, 2))
        elif v == "Z":
            # error 2 unless the three bytes case-fold to UTC
            for k, want in enumerate(b"UTC"):
                c = at(pos + k)
                ok = ok & (torch.where((c >= 97) & (c <= 122), c - 32, c) == want)
        elif v == "p":
            c0, c1 = at(pos), at(pos + 1)
            is_pm = ((c0 == ord("P")) | (c0 == ord("p"))) & ((c1 == ord("M")) | (c1 == ord("m")))
            H = torch.where(is_pm & (H <= 12), H + 12, H)
        else:
            f = field(pos, ln)
            if v == "Y":
                Y = f
            elif v == "y":
                Y = f + 1900
            elif v == "m":
                mo = f
            elif v in ("d", "j"):
                d = f
            elif v in ("H", "I"):
                H = f
            elif v == "M":
                M = f
            elif v == "S":
                S = f
            elif v == "f":
                sub = f

    # timestamp_from_parts (datetime.cu:285-333)
    y = Y - (mo <= 2).to(torch.int64)
    era = y // 400
    yoe = y - era * 400
    mp = torch.where(mo > 2, mo - 3, mo + 9)
    doy = torch.where(mo == 0, d, (153 * mp + 2) // 5 + d - 1)
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    days = era * 146097 + doe - 719468
    if units == "Y":
        out = Y - 1970
    elif units == "M":
        out = (Y - 1970) * 12 + (mo - 1)
    elif units == "D":
        out = days
    elif units == "h":
        # C truncating division (datetime.cu:311 tzadjust/60)
        out = days * 24 + H + torch.sign(tzmin) * (tzmin.abs() // 60)
    elif units == "m":
        out = days * 1440 + H * 60 + M + tzmin
    else:
        ts = days * 86400 + H * 3600 + M * 60 + S + tzmin * 60
        out = ts if units == "s" else ts * _UNITS_PER_SEC[units] + sub  # raw subsecond add
    return torch.where(ok, out, 0)


def timestamp2int(col: StringColumn, fmt: str | None = None, units: str = "s") -> torch.Tensor:
    """int64[rows]: each row parsed by `fmt` into `units` since the epoch
    (0 for null rows and rows that do not parse)."""
    items = _compile(fmt or DEFAULT_FORMAT)
    if any(kind == "spec" and v in _PARSE_ERROR_SPECS for kind, v in items):
        # the reference parser rejects these at run time: every row 0
        # (datetime.cu:275-276)
        return torch.zeros(col.size, dtype=torch.int64, device=col.device)
    return timestamp2int_device(col, _fixed_layout(items, units), units)


def int2timestamp(values, units: str = "s", fmt: str | None = None, nulls=None,
                  device="cuda") -> StringColumn:
    """Host int64 epoch values -> a column of `fmt` timestamps on `device`."""
    items = _compile(fmt or DEFAULT_FORMAT)
    vals, valid = _upload(values, np.int64, nulls, device)
    return int2timestamp_device(vals, units, items, valid, _spec_len("f", units))


# ------------------------------------------------------------ host oracles


def _str2int(s: str, pos: int, ln: int) -> int:
    """Leading-digits int, stopping at the first non-digit or string end
    (parse_datetime::str2int, datetime.cu:171-184)."""
    v = 0
    for k in range(ln):
        if pos + k >= len(s) or not ("0" <= s[pos + k] <= "9"):
            break
        v = v * 10 + (ord(s[pos + k]) - 48)
    return v


def _timestamp_from_parts(Y, mo, d, H, M, S, sub, tzmin, units: str):
    """datetime.cu timestamp_from_parts:285-333, exact (incl. the month==0
    special case, raw subsecond add, truncating tz/60 for hours)."""
    if units == "Y":
        return Y - 1970
    if units == "M":
        return (Y - 1970) * 12 + (mo - 1)
    y = Y - (1 if mo <= 2 else 0)
    era = y // 400  # floor == the reference's (y>=0 ? y : y-399)/400
    yoe = y - era * 400
    mp = mo - 3 if mo > 2 else mo + 9
    doy = d if mo == 0 else (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    days = era * 146097 + doe - 719468
    if units == "D":
        return days
    if units == "h":
        tz_h = abs(tzmin) // 60 * (1 if tzmin >= 0 else -1)  # C trunc
        return days * 24 + H + tz_h
    if units == "m":
        return days * 1440 + H * 60 + M + tzmin
    ts = days * 86400 + H * 3600 + M * 60 + S + tzmin * 60
    if units == "s":
        return ts
    return ts * _UNITS_PER_SEC[units] + sub  # subsecond added RAW (datetime.cu:330-332)


def _parse_one(s: str, items, units: str = "s") -> int | None:
    """Host oracle: one string -> timestamp in `units`, or None on a parse
    error (-> 0).  Mirrors parse_into_parts (datetime.cu:205-283): defaults
    year 0 / month 1 / day 1, %y adds 1900, %j sets the DAY field, %p adds
    12 when hour <= 12 and the field is PM, %Z only accepts UTC, and
    %a/%A/%b/%B/%w/%U/%W error."""
    pos = 0
    Y, mo, d, H, M, S = 0, 1, 1, 0, 0, 0
    sub = 0
    tzmin = 0
    for kind, v in items:
        if kind == "lit":
            pos += 1
            continue
        ln = _spec_len(v, units)
        if len(s) - pos < ln:
            return None  # error 1
        if v == "Y":
            Y = _str2int(s, pos, ln)
        elif v == "y":
            Y = _str2int(s, pos, ln) + 1900
        elif v == "m":
            mo = _str2int(s, pos, ln)
        elif v in ("d", "j"):
            d = _str2int(s, pos, ln)
        elif v in ("H", "I"):
            H = _str2int(s, pos, ln)
        elif v == "M":
            M = _str2int(s, pos, ln)
        elif v == "S":
            S = _str2int(s, pos, ln)
        elif v == "f":
            sub = _str2int(s, pos, ln)
        elif v == "p":
            if H <= 12 and s[pos : pos + 2].upper() == "PM":
                H += 12
        elif v == "z":
            sign = -1 if s[pos] == "-" else 1
            tzmin = sign * (_str2int(s, pos + 1, 2) * 60 + _str2int(s, pos + 3, 2))
        elif v == "Z":
            if s[pos : pos + 3].upper() != "UTC":
                return None  # error 2
        else:
            return None  # error 3: a A b B w U W
        pos += ln
    return _timestamp_from_parts(Y, mo, d, H, M, S, sub, tzmin, units)


def timestamp2int_host_oracle(col: StringColumn, fmt=None, units="s") -> list[int]:
    """Per-row Python mirror of the parser, the tests' oracle."""
    items = _compile(fmt or DEFAULT_FORMAT)
    out = []
    for s in to_host_strings(col):
        if not s or any(k == "spec" and v in _PARSE_ERROR_SPECS for k, v in items):
            out.append(0)
            continue
        r = _parse_one(s, items, units)
        # C long wraparound (the reference computes in int64)
        out.append(((0 if r is None else r) + 2**63) % 2**64 - 2**63)
    return out


def _civil_from_days_py(days: int):
    """Host civil date from days since 1970-01-01 (Hinnant, floor-based)."""
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 if mp < 10 else mp - 9
    return y + (1 if m <= 2 else 0), m, d


def _dissect_py(v: int, units: str):
    """Host mirror of dissect_timestamp (datetime.cu:394-533): timestamp
    -> (Y, mo, d, H, M, S, sub), floor division and modulo."""
    if units == "Y":
        return 1970 + v, 1, 1, 0, 0, 0, 0
    if units == "M":
        return 1970 + v // 12, 1 + v % 12, 1, 0, 0, 0, 0
    per_day = {
        "D": 1, "h": 24, "m": 1440, "s": 86400,
        "ms": 86400 * 1000, "us": 86400 * 10**6, "ns": 86400 * 10**9,
    }[units]
    Y, mo, d = _civil_from_days_py(v // per_day)
    H = M = S = sub = 0
    if units == "h":
        H = v % 24
    elif units == "m":
        H, M = (v // 60) % 24, v % 60
    elif units == "s":
        H, M, S = (v // 3600) % 24, (v // 60) % 60, v % 60
    elif units in ("ms", "us", "ns"):
        k = _UNITS_PER_SEC[units]
        H = (v // (3600 * k)) % 24
        M = (v // (60 * k)) % 60
        S = (v // k) % 60
        sub = v % k
    return Y, mo, d, H, M, S, sub


def _i2s(v: int, ln: int) -> str:
    """int2str (datetime.cu:536-553): zero-padded to ln, low ln digits of
    larger values, all zeros for v <= 0."""
    v = 0 if v <= 0 else v
    return str(v % 10**ln).zfill(ln)


def _format_one(v: int, units: str, items) -> str:
    """Host oracle for long2timestamp's formatter (datetime.cu:553-624):
    %y writes year-1900, %I writes hour%12, %j writes the DAY-OF-MONTH at
    width 3 (it shares TP_DAY with %d), %p writes AM for hour <= 12, %z
    writes NOTHING, %Z writes UTC, and %a/%A/%b/%B/%w/%U/%W write nothing
    (formatter default: break)."""
    Y, mo, d, H, M, S, sub = _dissect_py(int(v), units)
    flen = _spec_len("f", units)
    out = []
    for kind, spec in items:
        if kind == "lit":
            out.append(spec)
        elif spec == "Y":
            out.append(_i2s(Y, 4))
        elif spec == "y":
            out.append(_i2s(Y - 1900, 2))
        elif spec == "m":
            out.append(_i2s(mo, 2))
        elif spec == "d":
            out.append(_i2s(d, 2))
        elif spec == "j":
            out.append(_i2s(d, 3))
        elif spec == "H":
            out.append(_i2s(H, 2))
        elif spec == "I":
            out.append(_i2s(H % 12, 2))
        elif spec == "M":
            out.append(_i2s(M, 2))
        elif spec == "S":
            out.append(_i2s(S, 2))
        elif spec == "f":
            out.append(_i2s(sub, flen))
        elif spec == "p":
            out.append("AM" if H <= 12 else "PM")
        elif spec == "Z":
            out.append("UTC")
        # z / a / A / b / B / w / U / W: the formatter writes nothing
    return "".join(out)
