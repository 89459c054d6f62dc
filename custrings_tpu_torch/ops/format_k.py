"""Number -> string writers: the formatting constructors of a column.

Port of `custrings_tpu/ops/format_k.py` (`itos_device`, `int2ip_device`,
`from_booleans_device`, `ftos_device` with `_dissect_vec`,
`int2timestamp_device` with `_civil_from_days`), with `_upload`, which
takes the host values and their nulls (`_valid_from_bitmask`) to the
device.  Each writer computes every row's byte size with compare ladders,
then builds the column with `column.build_column`: the offsets are one
prefix sum (K3) and every output byte finds its row and its offset in the
row (K3) and computes its character, as in the JAX package.

torch's unsigned 64-bit integers lack the arithmetic used here, so
everything is int64.  `itos` takes its digits from the non-positive value
(-|v| always fits, so INT64_MIN prints exactly); the other writers only
see values in [0, 2^63).
"""

from __future__ import annotations

import numpy as np
import torch

from ..column import StringColumn, _device, build_column, cumsum0, materialize_bytes
from ..config import bucket_bytes

_I64 = torch.int64
_POW10 = [10**e for e in range(19)]


def _valid_from_bitmask(nulls, count: int) -> np.ndarray:
    """Host bool[count] validity: all valid without `nulls`; a bool array
    of `count` marks the null rows; anything else is an Arrow bitmask
    (bit set = valid)."""
    if nulls is None:
        return np.ones(count, bool)
    arr = np.asarray(nulls)
    if arr.dtype == np.bool_ and arr.size == count:
        return ~arr
    bits = np.unpackbits(arr.view(np.uint8).ravel(), bitorder="little")
    return bits[:count].astype(bool)


def _upload(values, dtype, nulls, device):
    """(values as a `dtype` tensor, bool validity) on `device`."""
    dev = _device(device)
    vals = np.ascontiguousarray(values, dtype=dtype)
    valid = _valid_from_bitmask(nulls, len(vals))
    return torch.from_numpy(vals).to(dev), torch.from_numpy(valid).to(dev)


def _pow10(e: torch.Tensor) -> torch.Tensor:
    """10**e for e clamped into 0..18, int64."""
    table = torch.tensor(_POW10, dtype=_I64, device=e.device)
    return table[e.clamp(0, 18).to(_I64)]


def _ndigits(a: torch.Tensor) -> torch.Tensor:
    """Decimal digit count of a >= 0 (1 for 0), int32, by a compare ladder."""
    d = torch.ones(a.shape, dtype=torch.int32, device=a.device)
    for p in _POW10[1:]:
        d += (a >= p).to(torch.int32)
    return d


def _digit_at(a: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Decimal digit of a >= 0 at power-of-ten exponent e (clamped), uint8."""
    return ((a // _pow10(e)) % 10).to(torch.uint8)


# ------------------------------------------------------------------ itos


def itos_device(values: torch.Tensor, validity: torch.Tensor) -> StringColumn:
    """int -> decimal string column (convert.cu itos:257 / ltos:315)."""
    v = values.to(_I64)
    neg = v < 0
    m = torch.where(neg, v, -v)  # -|v|: exact for INT64_MIN
    nd = torch.ones(v.shape, dtype=torch.int32, device=v.device)
    for p in _POW10[1:]:
        nd += (m <= -p).to(torch.int32)
    sizes = torch.where(validity, nd + neg.to(torch.int32), 0)

    def produce(rows, k, valid, bcast):
        mr = m[rows.long()]  # int64 values exceed the int32 broadcast
        negr = bcast(neg) == 1
        kk = k - negr.to(torch.int32)
        q = torch.div(mr, _pow10(bcast(nd) - 1 - kk), rounding_mode="trunc")
        digit = (-torch.fmod(q, 10)).to(torch.uint8)
        return torch.where(negr & (k == 0), ord("-"), digit + ord("0")).to(torch.uint8)

    return build_column(sizes, validity, produce)


# ---------------------------------------------------------------- int2ip


def int2ip_device(values: torch.Tensor, validity: torch.Tensor) -> StringColumn:
    """uint32 -> dotted-quad column (convert.cu int2ip:791)."""
    v = values.to(_I64) & 0xFFFFFFFF
    octets = [(v >> s) & 255 for s in (24, 16, 8, 0)]
    nd = [_ndigits(o) for o in octets]
    sizes = torch.where(validity, nd[0] + nd[1] + nd[2] + nd[3] + 3, 0)
    starts = [torch.zeros_like(nd[0])]  # of each octet in the row: sum(nd[:i]) + i
    for i in range(3):
        starts.append(starts[i] + nd[i] + 1)

    def produce(rows, k, valid, bcast):
        r = rows.long()
        st, ndr, oc = ([x[r] for x in xs] for xs in (starts, nd, octets))
        seg = sum((k >= st[i]).to(torch.int32) for i in (1, 2, 3))

        def pick(xs):
            return torch.where(seg == 0, xs[0], torch.where(seg == 1, xs[1], torch.where(seg == 2, xs[2], xs[3])))

        kk, n_s = k - pick(st), pick(ndr)
        digit = _digit_at(pick(oc), n_s - 1 - kk)
        # the position right past an octet's digits is its dot
        return torch.where(kk >= n_s, ord("."), digit + ord("0")).to(torch.uint8)

    return build_column(sizes, validity, produce)


# ---------------------------------------------------------- from_booleans


def from_booleans_device(values: torch.Tensor, true: str, false: str,
                         validity: torch.Tensor) -> StringColumn:
    """bool -> true/false string column (convert.cu from_booleans:921)."""
    v = values.to(torch.bool)
    tb, fb = true.encode("utf-8"), false.encode("utf-8")
    w = max(len(tb), len(fb), 1)
    table = np.zeros((2, w), np.uint8)
    table[0, : len(fb)] = np.frombuffer(fb, np.uint8)
    table[1, : len(tb)] = np.frombuffer(tb, np.uint8)
    table_t = torch.from_numpy(table).to(v.device)
    sizes = torch.where(validity, torch.where(v, len(tb), len(fb)), 0).to(torch.int32)

    def produce(rows, k, valid, bcast):
        return table_t[bcast(v).to(_I64), k.clamp(0, w - 1).to(_I64)]

    return build_column(sizes, validity, produce)


# ------------------------------------------------------------------ ftos

_UPPER10 = [10.0, 100.0, 10000.0, 1e8, 1e16, 1e32, 1e64, 1e128, 1e256]
_LOWER10 = [0.1, 0.01, 0.0001, 1e-8, 1e-16, 1e-32, 1e-64, 1e-128, 1e-256]
_BLOWER10 = [1.0, 0.1, 0.001, 1e-7, 1e-15, 1e-31, 1e-63, 1e-127, 1e-255]


def _dissect_vec(value: torch.Tensor):
    """ftos_converter::dissect_value (convert.cu ftos path) over a tensor of
    positive finite float64: (integer, decimal, exp10, decimal_places)."""
    take_up = value > 1e9
    take_dn = (value > 0.0) & (value < 0.0001)
    exp10 = torch.zeros(value.shape, dtype=torch.int32, device=value.device)
    for idx in range(8, -1, -1):
        fx = 1 << idx
        c1 = take_up & (value >= _UPPER10[idx])
        value = torch.where(c1, value * _LOWER10[idx], value)
        exp10 += torch.where(c1, fx, 0).to(torch.int32)
        c2 = take_dn & (value < _BLOWER10[idx])
        value = torch.where(c2, value * _UPPER10[idx], value)
        exp10 -= torch.where(c2, fx, 0).to(torch.int32)
    integer = value.to(_I64)
    nd_int = _ndigits(integer)
    decimal_places = 10 - nd_int  # 9 - (nd_int - 1)
    max_digits = 1000000000 // _pow10(nd_int - 1)
    remainder = (value - integer.to(torch.float64)) * max_digits.to(torch.float64)
    decimal = remainder.to(_I64)
    remainder = remainder - decimal.to(torch.float64)
    decimal = decimal + (2.0 * remainder).to(_I64)
    roll = decimal >= max_digits
    decimal = torch.where(roll, 0, decimal)
    integer = torch.where(roll, integer + 1, integer)
    bump = roll & (exp10 != 0) & (integer >= 10)
    exp10 = torch.where(bump, exp10 + 1, exp10)
    integer = torch.where(bump, 1, integer)
    for _ in range(9):  # strip trailing zeros
        strip = (decimal % 10 == 0) & (decimal_places > 0)
        decimal = torch.where(strip, decimal // 10, decimal)
        decimal_places = torch.where(strip, decimal_places - 1, decimal_places)
    return integer, decimal, exp10, decimal_places


def ftos_device(values: torch.Tensor, validity: torch.Tensor) -> StringColumn:
    """float -> string column, byte-exact ftos_converter::float_to_string
    (convert.cu:613).  Layout per row:
        [-] int_digits . (dec_digits | 0) [e sign ee[e]]
    Specials: NaN -> "NaN", +/-Inf -> "Inf"/"-Inf"."""
    v = values.to(torch.float64)
    is_nan = torch.isnan(v)
    neg = (v < 0.0) & ~is_nan
    av = v.abs()
    is_inf = torch.isinf(av)
    finite = ~is_nan & ~is_inf
    integer, decimal, exp10, dec_places = _dissect_vec(torch.where(finite, av, 0.0))
    nd_int = _ndigits(integer)
    dec_len = dec_places.clamp(min=1)  # "0" when no places survive
    e_abs = exp10.abs()
    nd_e = torch.where(e_abs < 100, 2, 3).to(torch.int32)
    exp_len = torch.where(exp10 != 0, 2 + nd_e, 0)
    norm_len = neg.to(torch.int32) + nd_int + 1 + dec_len + exp_len
    sizes = torch.where(is_nan, 3, torch.where(is_inf, 3 + neg.to(torch.int32), norm_len))
    sizes = torch.where(validity, sizes, 0).to(torch.int32)
    dev = v.device
    nan_b = torch.tensor(list(b"NaN"), dtype=torch.uint8, device=dev)
    inf_b = torch.tensor(list(b"-Inf"), dtype=torch.uint8, device=dev)

    def produce(rows, k, valid, bcast):
        nanr, infr, negr = bcast(is_nan) == 1, bcast(is_inf) == 1, bcast(neg) == 1
        r = rows.long()
        ir, dr = integer[r], decimal[r]  # int64 digit payloads
        er, dpr, ndir, dlr = bcast(exp10), bcast(dec_places), bcast(nd_int), bcast(dec_len)
        ear, nder = bcast(e_abs), bcast(nd_e)
        s_int = negr.to(torch.int32)  # integer digits start
        s_dot = s_int + ndir  # '.' position
        s_dec = s_dot + 1  # decimal digits start
        s_exp = s_dec + dlr  # 'e' position
        in_int = (k >= s_int) & (k < s_dot)
        in_dec = (k >= s_dec) & (k < s_exp)
        int_digit = _digit_at(ir, ndir - 1 - (k - s_int))
        # decimal digits zero-padded to dec_places width, MSD first
        dec_digit = _digit_at(dr, dpr - 1 - (k - s_dec))
        dec_ch = torch.where(dpr > 0, dec_digit + ord("0"), ord("0"))
        e_digit = _digit_at(ear.to(_I64), nder - 1 - (k - s_exp - 2))
        exp_ch = torch.where(k == s_exp, ord("e"),
                             torch.where(k == s_exp + 1, torch.where(er < 0, ord("-"), ord("+")),
                                         e_digit + ord("0")))
        ch = torch.where((k == 0) & negr, ord("-"),
                         torch.where(in_int, int_digit + ord("0"),
                                     torch.where(k == s_dot, ord("."), torch.where(in_dec, dec_ch, exp_ch))))
        nan_ch = nan_b[k.clamp(0, 2).to(_I64)]
        inf_ch = inf_b[(k + (~negr).to(torch.int32)).clamp(0, 3).to(_I64)]
        return torch.where(nanr, nan_ch, torch.where(infr, inf_ch, ch.to(torch.uint8)))

    return build_column(sizes, validity, produce)


# ---------------------------------------------------------- int2timestamp


def _civil_from_days(days: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day), elementwise (Hinnant's
    civil_from_days, floor division as in the JAX package)."""
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return y + (m <= 2).to(_I64), m, d


_PER_DAY = {"D": 1, "h": 24, "m": 1440, "s": 86400,
            "ms": 86400 * 1000, "us": 86400 * 10**6, "ns": 86400 * 10**9}


def int2timestamp_device(values: torch.Tensor, units: str, items, validity: torch.Tensor,
                         sub_width: int) -> StringColumn:
    """int64 epoch values -> formatted timestamp column (datetime.cu
    long2timestamp:639).  Every specifier is fixed width, so the rows are
    one [rows, width] char matrix built a format item at a time, written
    out as the column's bytes.  `sub_width` is %f's width in `units`
    (`datetime_k._spec_len`): 3, 6 or 9 digits, a second being
    10**sub_width units for ms, us and ns."""
    v = values.to(_I64)
    n = v.shape[0]
    dev = v.device
    zero, one = torch.zeros_like(v), torch.ones_like(v)
    H = M = S = sub = zero
    # dissect_timestamp (datetime.cu:394-533), exact per units
    if units == "Y":
        Y, mo, d = 1970 + v, one, one
    elif units == "M":
        Y, mo, d = 1970 + v // 12, 1 + v % 12, one
    else:
        Y, mo, d = _civil_from_days(v // _PER_DAY[units])
        if units == "h":
            H = v % 24
        elif units == "m":
            H, M = (v // 60) % 24, v % 60
        elif units == "s":
            H, M, S = (v // 3600) % 24, (v // 60) % 60, v % 60
        elif units in ("ms", "us", "ns"):
            k = 10**sub_width
            H = (v // (3600 * k)) % 24
            M = (v // (60 * k)) % 60
            S = (v // k) % 60
            sub = v % k

    def digits(val, width):
        """uint8[n, width]: val's low `width` decimal digits, zero-padded
        (all zeros for val <= 0)."""
        a = val.clamp(min=0)
        return torch.stack([_digit_at(a, torch.full((n,), width - 1 - i, dtype=torch.int32, device=dev))
                            + ord("0") for i in range(width)], dim=1).to(torch.uint8)

    def const(b: bytes):
        return torch.tensor(list(b), dtype=torch.uint8, device=dev).expand(n, len(b))

    # format_from_parts (datetime.cu:553-624): %y = year-1900, %I =
    # hour%12, %j shares TP_DAY with %d (day of month at width 3), %p = AM
    # for hour <= 12, %z writes nothing, %Z = "UTC", a/A/b/B/w/U/W hit the
    # default case and write nothing
    fields = {"Y": (lambda: Y, 4), "y": (lambda: (Y - 1900).clamp(min=0) % 100, 2),
              "m": (lambda: mo, 2), "d": (lambda: d, 2), "H": (lambda: H, 2), "I": (lambda: H % 12, 2),
              "M": (lambda: M, 2), "S": (lambda: S, 2), "f": (lambda: sub, sub_width),
              "j": (lambda: d, 3)}
    segs = []
    for kind, spec in items:
        if kind == "lit":
            segs.append(const(spec.encode("utf-8")))
        elif spec in fields:
            fn, width = fields[spec]
            segs.append(digits(fn(), width))
        elif spec == "p":
            ampm = torch.tensor(list(b"AMPM"), dtype=torch.uint8, device=dev)
            sel = (H > 12).to(_I64) * 2
            segs.append(torch.stack([ampm[sel], ampm[sel + 1]], dim=1))
        elif spec == "Z":
            segs.append(const(b"UTC"))
    mat = torch.cat(segs, dim=1) if segs else torch.zeros((n, 0), dtype=torch.uint8, device=dev)
    width = mat.shape[1]
    sizes = torch.where(validity, width, 0).to(torch.int32)
    offsets = cumsum0(sizes)
    flat = mat.reshape(-1)

    def produce(rows, k, valid, bcast):
        idx = (rows.long() * width + k).clamp(0, max(flat.shape[0] - 1, 0))
        return flat[idx] if flat.shape[0] else torch.zeros_like(k, dtype=torch.uint8)

    data = materialize_bytes(offsets, bucket_bytes(n * width), produce)
    return StringColumn(data, offsets, validity)
