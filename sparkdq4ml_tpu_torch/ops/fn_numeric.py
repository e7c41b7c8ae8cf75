"""The numeric builtins (``sparkdq4ml_tpu/ops/expressions.py:1432-1480``,
``_fn_round`` ``:653-661``, ``_fn_coalesce`` ``:640-650``, ``_fn_nanvl``
``:936-939``, and the math batch ``:2531-2737``: ``bround``,
``factorial``, ``hex``/``unhex``/``bin``/``conv``, ``ascii``, ``crc32``,
the shifts, ``bitwise_not``, ``nullif``, ``nvl2``).

Where the JAX package runs a jnp op, the port runs the torch op on the
column's device; where it runs numpy on the host (``factorial``,
``conv``, the shifts, ``bitwise_not``, ``crc32``), so does the port, and
the numeric result is put on the evaluation device. Three functions need
more than the torch op of the same name:

- ``sign``/``signum``: ``torch.sign`` maps NaN to 0 and -0.0 to 0.0,
  where ``jnp.sign`` keeps both, so NaN and zeros pass through;
- ``cbrt``: torch has none, and sign·|x|^(1/3) is 3.0000000000000004 for
  27; the root is refined by one Newton step, which lands on the exact
  root of a perfect cube;
- ``round``: Spark's HALF_UP (a floor/ceil formula), where ``torch.round``
  is half-even like ``bround``.
"""

from __future__ import annotations

import builtins
import functools
import math
import zlib

import numpy as np
import torch

from ..config import float_dtype
from .cells import (_exact_int64_col, _nullable_int32_col, _null_mask,
                    _scalar_int, _str_map, as_float, as_tensor, const,
                    device_array, host_array, host_objects, is_host_column,
                    map_rows)

_MASK64 = 0xFFFFFFFFFFFFFFFF


def _nan_like(a: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("nan"), dtype=a.dtype, device=a.device)


def _sql_divide(a, b):
    """Spark's non-ANSI division: x / 0 is NULL (0 / 0 included)."""
    return torch.where(b == 0, _nan_like(a), a / b)


def _sql_mod(a, b):
    """Spark's % and mod(): the sign follows the dividend; x % 0 is
    NULL."""
    return torch.where(b == 0, _nan_like(a), torch.fmod(a, b))


def _pmod(a, b):
    """Spark's pmod: the sign follows the divisor (``jnp.mod``: a
    truncated remainder moved by the divisor when the signs differ);
    x pmod 0 is NULL."""
    a, b = as_float(a), as_float(b)
    m = torch.fmod(a, b)
    m = torch.where((m != 0) & ((m < 0) != (b < 0)), m + b, m)
    return torch.where(b == 0, _nan_like(m), m)


def _fn_round(v, digits=None):
    """Spark's round(): HALF_UP, floor(x·10^d + 0.5) for x >= 0 and
    ceil(x·10^d - 0.5) below, over 10^d; the product stays in the
    policy's float."""
    d = int(host_array(digits).ravel()[0]) if digits is not None else 0
    v = as_float(v)
    scale = 10.0 ** d
    scaled = v * scale
    return torch.where(v >= 0, torch.floor(scaled + 0.5),
                       torch.ceil(scaled - 0.5)) / const(v, scale)


def _fn_bround(v, *digits):
    """Spark's bround(): HALF_EVEN, ``torch.round``'s own mode."""
    d = _scalar_int(digits[0]) if digits else 0
    v = as_float(v)
    scale = 10.0 ** d
    return torch.round(v * scale) / const(v, scale)


def _fn_sign(v):
    """``jnp.sign``: -1, 1, and NaN and signed zeros kept as they are."""
    v = as_float(v)
    return torch.where(torch.isnan(v) | (v == 0), v, torch.sign(v))


def _fn_cbrt(v):
    """The real cube root: copysign(|x|^(1/3), x), then one Newton step
    r - (r³ - x) / (3r²) where r is finite and non-zero (0, ±inf and NaN
    pass through)."""
    x = as_float(v)
    r = torch.copysign(torch.pow(torch.abs(x), 1.0 / 3.0), x)
    step = r - (r * r * r - x) / (3.0 * r * r)
    return torch.where(torch.isfinite(r) & (r != 0), step, r)


def _fn_greatest(*vs):
    """``fmax`` over the operands: a NaN (null) operand is skipped, and
    NULL only when every operand is null; an int column stays int."""
    return functools.reduce(torch.fmax, [as_tensor(v) for v in vs])


def _fn_least(*vs):
    return functools.reduce(torch.fmin, [as_tensor(v) for v in vs])


def _fn_coalesce(*vals):
    """The first non-null operand a row: on the host if any operand is a
    host column, else on the device in the policy's float."""
    out = vals[-1]
    for v in reversed(vals[:-1]):
        m = _null_mask(v)
        if is_host_column(v) or is_host_column(out):
            out = np.where(host_array(m), host_objects(out),
                           host_objects(v))
        else:
            out = torch.where(m, as_float(out), as_float(v))
    return out


def _fn_nanvl(a, b):
    """``nanvl(a, b)``: b where a is NaN."""
    a = as_tensor(a)
    return torch.where(torch.isnan(a), as_tensor(b).to(a.dtype), a)


def _float_fn(op):
    return lambda v: op(as_float(v))


def _float_fn2(op):
    return lambda a, b: op(as_float(a), as_float(b))


def _int64_of(v):
    """Two's-complement int64 view of a numeric column (bit operations,
    radix text); NaN rows are tracked apart by the caller."""
    arr = host_array(v).astype(np.float64)
    mask = np.isnan(arr)
    return np.where(mask, 0, arr).astype(np.int64), mask


def _fn_factorial(v):
    """Defined on 0..20 (the long range), anything else NULL; exact host
    integers, since 20! is past float64's exact range."""
    arr = host_array(v).astype(np.float64)
    out = [None if (np.isnan(x) or x < 0 or x > 20 or x != int(x))
           else math.factorial(int(x)) for x in arr]
    return _exact_int64_col(out)


def _fn_hex(v):
    """Numbers as upper-case hex of the two's-complement long; strings as
    hex of their UTF-8 bytes."""
    if is_host_column(v):
        return _str_map(lambda x: x.encode().hex().upper(), v)
    z, mask = _int64_of(v)
    return np.asarray([None if m else format(int(x) & _MASK64, "X")
                       for x, m in zip(z, mask)], object)


def _fn_unhex(s):
    """Hex text to bytes shown as latin-1 text; malformed input NULL."""
    def u(x):
        try:
            return bytes.fromhex(x).decode("latin-1")
        except ValueError:
            return None
    return _str_map(u, s)


def _fn_bin(v):
    """Binary text of the two's-complement long (``Long.toBinaryString``)."""
    z, mask = _int64_of(v)
    return np.asarray([None if m else format(int(x) & _MASK64, "b")
                       for x, m in zip(z, mask)], object)


_DIGITS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _fn_conv(s, from_base, to_base):
    """Radix conversion of digit text, upper-case; malformed input NULL,
    the longest valid prefix kept (Hive). A negative ``to_base`` renders
    signed output, else the value is an unsigned 64-bit quantity."""
    fb = _scalar_int(from_base)
    tb = _scalar_int(to_base)
    if not (2 <= fb <= 36 and 2 <= builtins.abs(tb) <= 36):
        return np.asarray([None] * len(host_objects(s)), object)

    def one(x):
        t = str(x).strip().upper()
        neg = t.startswith("-")
        if neg:
            t = t[1:]
        try:
            val = int(t, fb) if t else None
        except ValueError:
            for j in range(len(t), 0, -1):
                try:
                    val = int(t[:j], fb)
                    break
                except ValueError:
                    continue
            else:
                val = None
        if val is None:
            return None
        if neg:
            val = -val
        if tb > 0:
            val &= _MASK64
            base, sign = tb, ""
        else:
            if val < -(1 << 63) or val >= (1 << 63):
                val &= _MASK64
                val -= (1 << 64) if val >= (1 << 63) else 0
            base, sign = -tb, ("-" if val < 0 else "")
            val = builtins.abs(val)
        if val == 0:
            return "0"
        out = []
        while val:
            val, r = divmod(val, base)
            out.append(_DIGITS[r])
        return sign + "".join(reversed(out))

    return _str_map(one, s)


def _fn_ascii(s):
    """The code point of the first character; '' gives 0."""
    return _nullable_int32_col(list(map_rows(
        lambda x: None if x is None else (ord(str(x)[0]) if str(x) else 0),
        s)))


def _fn_crc32(s):
    """CRC-32 of the text's UTF-8 bytes: a 64-bit column, since values
    past 2^31 must not wrap an int32."""
    return _exact_int64_col(list(map_rows(
        lambda x: None if x is None else zlib.crc32(str(x).encode()), s)))


def _int32_or_float_null(r: np.ndarray, mask: np.ndarray):
    if mask.any():
        return device_array(np.where(mask, np.nan, r.astype(np.float64)),
                            float_dtype())
    return device_array(r)


def _shift_fn(which: str):
    """shiftleft / shiftright (arithmetic) / shiftrightunsigned (logical)
    over the int32 view, on the host as in the JAX package."""

    def f(v, n):
        k = _scalar_int(n) % 32
        arr = host_array(v).astype(np.float64)
        mask = np.isnan(arr)
        z = np.where(mask, 0, arr).astype(np.int32)
        if which == "left":
            r = np.left_shift(z, k)
        elif which == "right":
            r = np.right_shift(z, k)
        else:
            r = np.right_shift(z.view(np.uint32), k).view(np.int32)
        return _int32_or_float_null(r, mask)

    return f


def _fn_bitwise_not(v):
    arr = host_array(v).astype(np.float64)
    mask = np.isnan(arr)
    return _int32_or_float_null(~np.where(mask, 0, arr).astype(np.int32),
                                mask)


def _fn_nullif(a, b):
    """NULL where a equals b, else a."""
    if is_host_column(a) or is_host_column(b):
        return np.asarray(
            [None if (x is not None and y is not None and x == y) else x
             for x, y in zip(host_objects(a), host_objects(b))], object)
    va, vb = as_float(a), as_float(b)
    return torch.where(va == vb, _nan_like(va), va)


def _fn_nvl2(a, b, c):
    """b where a is not null, else c."""
    nulls = _null_mask(a)
    if is_host_column(b) or is_host_column(c):
        m = host_array(nulls)
        return np.asarray([y if keep else x for x, y, keep in
                           zip(host_objects(c), host_objects(b), ~m)],
                          object)
    return torch.where(as_tensor(nulls).to(torch.bool), as_float(c),
                       as_float(b))


NUMERIC_FNS = {
    "abs": lambda v: torch.abs(as_tensor(v)),
    "sqrt": _float_fn(torch.sqrt),
    "exp": _float_fn(torch.exp),
    "log": _float_fn(torch.log),
    "log10": _float_fn(torch.log10),
    "pow": _float_fn2(torch.pow),
    "power": _float_fn2(torch.pow),
    "floor": _float_fn(torch.floor),
    "ceil": _float_fn(torch.ceil),
    "round": _fn_round,
    "sign": _fn_sign,
    "signum": _fn_sign,
    "greatest": _fn_greatest,
    "least": _fn_least,
    "isnan": _float_fn(torch.isnan),
    "coalesce": _fn_coalesce,
    "sin": _float_fn(torch.sin),
    "cos": _float_fn(torch.cos),
    "tan": _float_fn(torch.tan),
    "asin": _float_fn(torch.asin),
    "acos": _float_fn(torch.acos),
    "atan": _float_fn(torch.atan),
    "atan2": _float_fn2(torch.atan2),
    "sinh": _float_fn(torch.sinh),
    "cosh": _float_fn(torch.cosh),
    "tanh": _float_fn(torch.tanh),
    "degrees": _float_fn(torch.rad2deg),
    "radians": _float_fn(torch.deg2rad),
    "cbrt": _fn_cbrt,
    "expm1": _float_fn(torch.expm1),
    "log1p": _float_fn(torch.log1p),
    "log2": _float_fn(torch.log2),
    "mod": _float_fn2(_sql_mod),
    "pmod": _pmod,
    "hypot": _float_fn2(torch.hypot),
    "rint": _float_fn(torch.round),
    "nanvl": _fn_nanvl,
    "bround": _fn_bround,
    "factorial": _fn_factorial,
    "hex": _fn_hex,
    "unhex": _fn_unhex,
    "bin": _fn_bin,
    "conv": _fn_conv,
    "ascii": _fn_ascii,
    "crc32": _fn_crc32,
    "shiftleft": _shift_fn("left"),
    "shiftright": _shift_fn("right"),
    "shiftrightunsigned": _shift_fn("unsigned"),
    "bitwise_not": _fn_bitwise_not,
    "nullif": _fn_nullif,
    "nvl2": _fn_nvl2,
    "ifnull": _fn_coalesce,
    "nvl": _fn_coalesce,
}
