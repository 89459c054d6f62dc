"""Number <-> string conversion: the parsers and the formatters' entry points.

Port of `custrings_tpu/ops/convert.py`: the parsers `stol`, `stoi`,
`htoi`, `stod`, `stof`, `ip2int` and `to_booleans`, the formatters
`itos`, `ftos`, `int2ip` and `from_booleans` (on `format_k`, whose
`_upload` / `_valid_from_bitmask` take their host values), and the host
oracle `_float_to_string` (`_dissect_value`, `_dec_str`), copied so that
the port imports nothing of the JAX package.  `hash_mm3` is `ops/hash.py`.

A parser reads each row's bytes from the column's padded view (K1,
`layout.char_planes`), transposed so that each byte position is one
contiguous plane, and runs the reference's per-character state machine
one position at a time over all rows, as the JAX package's `lax.scan`
does.  The loop runs over the longest row's bytes only: past a row's end
no state of that row changes, so the JAX package's bucketed width (there
for XLA's compile cache) changes nothing.  Arithmetic is int64 and wraps as
the JAX package's does; `ip2int` returns int64 holding the value in
[0, 2^32), where the JAX package returns uint32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..column import StringColumn
from . import format_k, layout
from .format_k import _upload
from .find import startswith

_I64 = torch.int64


def _is_digit(c):
    return (c >= ord("0")) & (c <= ord("9"))


# ---------------------------------------------------------------- parse


def stol(col: StringColumn) -> torch.Tensor:
    """int64[rows]: an optional sign, then digits up to the first non-digit
    (custring.inl stol); 0 for null rows."""
    planes, lens = layout.char_planes(col)
    n = col.size
    neg = planes[0] == ord("-")
    signed = neg | (planes[0] == ord("+"))
    val = torch.zeros(n, dtype=_I64, device=col.device)
    done = torch.zeros(n, dtype=torch.bool, device=col.device)
    for j in range(planes.shape[0]):
        c = planes[j]
        digit = _is_digit(c) & (j < lens)
        val = torch.where(~done & digit, val * 10 + (c - ord("0")), val)
        done |= ~digit & ~(signed & (j == 0))
    val = torch.where(neg, -val, val)
    return torch.where(col.validity, val, 0)


def stoi(col: StringColumn) -> torch.Tensor:
    return stol(col).to(torch.int32)


def _hexval(c):
    return torch.where(_is_digit(c), c - ord("0"),
                       torch.where((c >= ord("A")) & (c <= ord("F")), c - ord("A") + 10,
                                   torch.where((c >= ord("a")) & (c <= ord("f")), c - ord("a") + 10, -1)))


def htoi(col: StringColumn) -> torch.Tensor:
    """int64[rows]: hex digits with an optional 0x (convert.cu htoi:202).
    Non-hex bytes before the first hex digit are skipped, as are an x or X
    at positions 0 and 1."""
    planes, lens = layout.char_planes(col)
    n = col.size
    val = torch.zeros(n, dtype=_I64, device=col.device)
    done = torch.zeros(n, dtype=torch.bool, device=col.device)
    started = torch.zeros(n, dtype=torch.bool, device=col.device)
    for j in range(planes.shape[0]):
        c = planes[j]
        hv = torch.where(j < lens, _hexval(c), -1)
        skip = ((c == ord("x")) | (c == ord("X"))) & (j <= 1)
        ok = (hv >= 0) & ~done
        val = torch.where(ok, val * 16 + hv, val)
        done |= (hv < 0) & ~skip & started
        started |= ok | skip
    return torch.where(col.validity, val, 0)


#: the mantissa's digits stop accumulating above this (custr::stod)
_MAXM = 0x0FFFFFFFFFFFFF


def stod(col: StringColumn) -> torch.Tensor:
    """float64[rows] (custr::stod): nan/inf/-inf specials, a sign, a
    mantissa with '.', an optional e/E exponent; 0 for null rows.  The
    value is sign * digits * 10**exp, computed as the JAX package does."""
    planes, lens = layout.char_planes(col)
    n, dev = col.size, col.device
    # stages: 0 start, 1 mantissa, 2 exponent start, 3 exponent digits, 4 done
    sign = torch.ones(n, dtype=torch.float64, device=dev)
    digits = torch.zeros(n, dtype=_I64, device=dev)
    exp_off = torch.zeros(n, dtype=torch.int32, device=dev)
    dec = torch.zeros(n, dtype=torch.bool, device=dev)
    stage = torch.zeros(n, dtype=torch.int32, device=dev)
    esign = torch.ones(n, dtype=torch.int32, device=dev)
    e10 = torch.zeros(n, dtype=torch.int32, device=dev)
    for j in range(planes.shape[0]):
        c = planes[j]
        in_row = j < lens
        is_digit = _is_digit(c) & in_row
        d = (c - ord("0")).to(_I64)
        at_start = stage == 0
        sgn = (c == ord("-")) | (c == ord("+"))
        consumed_sign = at_start & sgn & in_row
        sign = torch.where(consumed_sign, torch.where(c == ord("-"), -1.0, 1.0), sign)
        stage = torch.where(at_start & in_row, 1, stage)
        is_dot = (c == ord(".")) & in_row & (stage <= 1)  # '.' enters decimal mode
        dec |= is_dot
        m_ok = is_digit & (stage == 1) & ~consumed_sign
        over = digits > _MAXM
        new_digits = torch.where(m_ok & ~over, digits * 10 + d, digits)
        re_over = new_digits > _MAXM
        digits = torch.where(m_ok & ~over & re_over, new_digits // 10, new_digits)
        step = torch.where(over | re_over, (~dec).to(torch.int32), -dec.to(torch.int32))
        exp_off = torch.where(m_ok, exp_off + step, exp_off)
        is_e = ((c == ord("e")) | (c == ord("E"))) & in_row & (stage == 1)
        stage = torch.where(is_e, 2, stage)
        # the mantissa breaks on anything else
        stage = torch.where((stage == 1) & ~m_ok & ~is_dot & ~is_e & ~consumed_sign, 4, stage)
        at_e = (stage == 2) & ~is_e
        esign = torch.where(at_e & sgn & in_row, torch.where(c == ord("-"), -1, 1).to(torch.int32), esign)
        stage = torch.where(at_e & in_row, 3, stage)
        e_ok = is_digit & (stage == 3) & ~(at_e & sgn)
        e10 = torch.where(e_ok, e10 * 10 + d.to(torch.int32), e10)
    exp = exp_off + esign * e10
    val = sign * digits.to(torch.float64) * torch.pow(10.0, exp.to(torch.float64))
    is_nan = startswith(col, "nan") | startswith(col, "NaN")
    is_inf = startswith(col, "inf") | startswith(col, "Inf")
    is_ninf = startswith(col, "-inf") | startswith(col, "-Inf")
    val = torch.where(is_nan, math.nan, val)
    val = torch.where(is_inf, math.inf, val)
    val = torch.where(is_ninf, -math.inf, val)
    return torch.where(col.validity, val, 0.0)


def stof(col: StringColumn) -> torch.Tensor:
    return stod(col).to(torch.float32)


def ip2int(col: StringColumn) -> torch.Tensor:
    """int64[rows] in [0, 2^32): 'a.b.c.d' IPv4 (convert.cu ip2int:739);
    each dot shifts the octet in, other non-digits are skipped."""
    planes, lens = layout.char_planes(col)
    n = col.size
    octet = torch.zeros(n, dtype=_I64, device=col.device)
    result = torch.zeros(n, dtype=_I64, device=col.device)
    for j in range(planes.shape[0]):
        c = planes[j]
        in_row = j < lens
        octet = torch.where(_is_digit(c) & in_row, octet * 10 + (c - ord("0")), octet)
        is_dot = (c == ord(".")) & in_row
        result = torch.where(is_dot, result * 256 + octet, result)
        octet = torch.where(is_dot, 0, octet)
    return torch.where(col.validity, result * 256 + octet, 0) & 0xFFFFFFFF


def to_booleans(col: StringColumn, true: str = "True") -> torch.Tensor:
    """bool[rows]: the row equals `true` (False for null rows).  The JAX
    package matches against a column of n copies of `true`; one literal
    compared with each row is the same result."""
    return startswith(col, true) & (col.lengths() == len(true.encode("utf-8")))


# ---------------------------------------------------------------- format


def itos(values, nulls=None, device="cuda") -> StringColumn:
    """Host integers -> a column of their decimal strings on `device`
    (convert.cu itos:257 / ltos:315)."""
    return format_k.itos_device(*_upload(values, np.int64, nulls, device))


def ftos(values, nulls=None, device="cuda") -> StringColumn:
    """Host floats -> a column of ftos_converter strings on `device`
    (`_float_to_string` is the oracle)."""
    return format_k.ftos_device(*_upload(values, np.float64, nulls, device))


def int2ip(values, nulls=None, device="cuda") -> StringColumn:
    """Host uint32 values -> a column of dotted quads on `device`."""
    return format_k.int2ip_device(*_upload(np.asarray(values, np.int64) & 0xFFFFFFFF, np.int64, nulls, device))


def from_booleans(values, true="True", false="False", nulls=None, device="cuda") -> StringColumn:
    """Host bools -> a column of `true` / `false` on `device`."""
    vals, valid = _upload([bool(v) for v in values], np.bool_, nulls, device)
    return format_k.from_booleans_device(vals, true, false, valid)


# ------------------------------------------------------------ host oracle


def _dissect_value(value: float):
    """ftos_converter::dissect_value (convert.cu), exact."""
    significant_digits = 10
    nine_digits = 1000000000
    upper_limit = 1000000000.0
    lower_limit = 0.0001
    upper10 = [10.0, 100.0, 10000.0, 1e8, 1e16, 1e32, 1e64, 1e128, 1e256]
    lower10 = [0.1, 0.01, 0.0001, 1e-8, 1e-16, 1e-32, 1e-64, 1e-128, 1e-256]
    blower10 = [1.0, 0.1, 0.001, 1e-7, 1e-15, 1e-31, 1e-63, 1e-127, 1e-255]
    decimal_places = significant_digits - 1
    exp10 = 0
    if value > upper_limit:
        fx = 256
        for idx in range(8, -1, -1):
            if value >= upper10[idx]:
                value *= lower10[idx]
                exp10 += fx
            fx >>= 1
    elif 0.0 < value < lower_limit:
        fx = 256
        for idx in range(8, -1, -1):
            if value < blower10[idx]:
                value *= upper10[idx]
                exp10 -= fx
            fx >>= 1
    max_digits = nine_digits
    integer = int(value)
    i = integer
    while i >= 10:
        decimal_places -= 1
        max_digits //= 10
        i //= 10
    remainder = (value - integer) * max_digits
    decimal = int(remainder)
    remainder -= decimal
    decimal += int(2.0 * remainder)
    if decimal >= max_digits:
        decimal = 0
        integer += 1
        if exp10 and integer >= 10:
            exp10 += 1
            integer = 1
    while decimal % 10 == 0 and decimal_places > 0:
        decimal //= 10
        decimal_places -= 1
    return integer, decimal, exp10, decimal_places


def _float_to_string(value: float) -> str:
    """ftos_converter::float_to_string, exact: the oracle of `ftos`."""
    if math.isnan(value):
        return "NaN"
    bneg = False
    if value < 0.0:
        value = -value
        bneg = True
    if math.isinf(value):
        return "-Inf" if bneg else "Inf"
    integer, decimal, exp10, decimal_places = _dissect_value(value)
    s = "-" if bneg else ""
    s += str(integer)
    s += "."
    if decimal_places:
        s += _dec_str(decimal, decimal_places)
    else:
        s += "0"
    if exp10:
        s += "e"
        s += "-" if exp10 < 0 else "+"
        e = abs(exp10)
        s += ("0" + str(e)) if e < 10 else str(e)
    return s


def _dec_str(decimal: int, decimal_places: int) -> str:
    digits = []
    for _ in range(decimal_places):
        digits.append(chr(ord("0") + decimal % 10))
        decimal //= 10
    return "".join(reversed(digits))
