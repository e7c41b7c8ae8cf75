"""Spark's hash functions and JSON (``sparkdq4ml_tpu/ops/expressions.py:
2810-3048``, ``JsonTuple`` ``:3136-3173``).

``hash`` (Murmur3_x86_32, seed 42) and ``xxhash64`` (XxHash64, seed 42)
are bit-exact to the JVM's: a numeric cell hashes as the double of its
value (``struct.pack("<d", float(x))`` of the cell as it is, a float32
one widened), a string as its UTF-8 bytes, and a null or NaN child is
skipped (the running hash passes through). Both fold in host Python
over exact integers, as the JAX package does (torch's int64 has no
logical right shift), once per distinct row. ``hash`` is an int32 column
on the evaluation device; ``xxhash64`` an int64 one under the float64
policy, else host Python ints (the JAX package's ``_exact_int64_col``
where x64 is off).

``get_json_object`` walks ``$.key[idx]...`` over each row's parsed text;
``json_tuple`` is a generator of one string column per field.
"""

from __future__ import annotations

import json
import re
import struct

import numpy as np

from . import strings
from .cells import (_exact_int64_col, _scalar_str, _str_map, device_array,
                    host_array, host_objects, is_host_column)

_M3_C1 = 0xCC9E2D51
_M3_C2 = 0x1B873593
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK32


def _m3_mix_k1(k1):
    k1 = (k1 * _M3_C1) & _MASK32
    k1 = _rotl32(k1, 15)
    return (k1 * _M3_C2) & _MASK32


def _m3_mix_h1(h1, k1):
    h1 ^= k1
    h1 = _rotl32(h1, 13)
    return (h1 * 5 + 0xE6546B64) & _MASK32


def _m3_fmix(h1, length):
    h1 ^= length
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _MASK32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _MASK32
    return h1 ^ (h1 >> 16)


def _m3_hash_long(value, seed):
    low = value & _MASK32
    high = (value >> 32) & _MASK32
    h1 = _m3_mix_h1(seed, _m3_mix_k1(low))
    h1 = _m3_mix_h1(h1, _m3_mix_k1(high))
    return _m3_fmix(h1, 8)


def _m3_hash_bytes(data: bytes, seed: int) -> int:
    """Spark's hashUnsafeBytes: 4-byte little-endian blocks, then each
    remaining byte a full mix round on its signed value (not the standard
    murmur3 tail)."""
    h1 = seed
    n_aligned = len(data) - len(data) % 4
    for i in range(0, n_aligned, 4):
        h1 = _m3_mix_h1(h1, _m3_mix_k1(int.from_bytes(data[i:i + 4],
                                                      "little")))
    for i in range(n_aligned, len(data)):
        b = data[i]
        signed = b - 256 if b >= 128 else b
        h1 = _m3_mix_h1(h1, _m3_mix_k1(signed & _MASK32))
    return _m3_fmix(h1, len(data))


_XX_P1 = 0x9E3779B185EBCA87
_XX_P2 = 0xC2B2AE3D27D4EB4F
_XX_P3 = 0x165667B19E3779F9
_XX_P4 = 0x85EBCA77C2B2AE63
_XX_P5 = 0x27D4EB2F165667C5


def _rotl64(x, r):
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _xx_fmix(h):
    h ^= h >> 33
    h = (h * _XX_P2) & _MASK64
    h ^= h >> 29
    h = (h * _XX_P3) & _MASK64
    return h ^ (h >> 32)


def _xx_round(acc, inp):
    acc = (acc + inp * _XX_P2) & _MASK64
    return (_rotl64(acc, 31) * _XX_P1) & _MASK64


def _xx_hash_long(value, seed):
    h = (seed + _XX_P5 + 8) & _MASK64
    h ^= _xx_round(0, value & _MASK64)
    h = (_rotl64(h, 27) * _XX_P1 + _XX_P4) & _MASK64
    return _xx_fmix(h)


def _xx_hash_bytes(data: bytes, seed: int) -> int:
    n = len(data)
    if n >= 32:
        v1 = (seed + _XX_P1 + _XX_P2) & _MASK64
        v2 = (seed + _XX_P2) & _MASK64
        v3 = seed
        v4 = (seed - _XX_P1) & _MASK64
        i = 0
        while i <= n - 32:
            v1 = _xx_round(v1, int.from_bytes(data[i:i + 8], "little"))
            v2 = _xx_round(v2, int.from_bytes(data[i + 8:i + 16], "little"))
            v3 = _xx_round(v3, int.from_bytes(data[i + 16:i + 24], "little"))
            v4 = _xx_round(v4, int.from_bytes(data[i + 24:i + 32], "little"))
            i += 32
        h = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12)
             + _rotl64(v4, 18)) & _MASK64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _xx_round(0, v)) * _XX_P1 + _XX_P4) & _MASK64
    else:
        h = (seed + _XX_P5) & _MASK64
        i = 0
    h = (h + n) & _MASK64
    while i <= n - 8:
        h ^= _xx_round(0, int.from_bytes(data[i:i + 8], "little"))
        h = (_rotl64(h, 27) * _XX_P1 + _XX_P4) & _MASK64
        i += 8
    if i <= n - 4:
        h ^= (int.from_bytes(data[i:i + 4], "little") * _XX_P1) & _MASK64
        h = (_rotl64(h, 23) * _XX_P2 + _XX_P3) & _MASK64
        i += 4
    while i < n:
        h ^= (data[i] * _XX_P5) & _MASK64
        h = (_rotl64(h, 11) * _XX_P1) & _MASK64
        i += 1
    return _xx_fmix(h)


def _row_keys(host):
    """An int64 key a cell of each column (a string's dictionary code; a
    number's float64 bits, every NaN one key), stacked by row; None where
    a column holds other cells."""
    keys = []
    for col in host:
        if col.dtype == object:
            try:
                keys.append(strings.codes(col)[0].astype(np.int64))
            except NotImplementedError:
                return None
        else:
            v = col.astype(np.float64)
            keys.append(np.where(np.isnan(v), np.nan, v).view(np.int64))
    return np.stack(keys, axis=1)


def _spark_hash(cols, seed, hash_long, hash_bytes, signed_bits):
    """HashExpression's fold: the running hash seeds each child's hash;
    null children pass through. Each distinct row hashes once."""
    host = [host_objects(c) if is_host_column(c) else host_array(c)
            for c in cols]
    n = len(host[0]) if host else 0

    def one(i):
        h = seed
        for col_vals in host:
            x = col_vals[i]
            if x is None or (isinstance(x, (float, np.floating))
                             and np.isnan(x)):
                continue
            if isinstance(x, str):
                h = hash_bytes(x.encode(), h)
            else:
                bits = struct.unpack("<q", struct.pack("<d", float(x)))[0]
                h = hash_long(bits, h)
        if h >= (1 << (signed_bits - 1)):      # two's complement back
            h -= (1 << signed_bits)
        return h

    keys = _row_keys(host) if n > 1 else None
    if keys is None:
        out = [one(i) for i in range(n)]
    else:
        _, first, inv = np.unique(keys, axis=0, return_index=True,
                                  return_inverse=True)
        lut = [one(i) for i in first]
        out = [lut[k] for k in inv.reshape(-1)]
    if signed_bits == 32:
        return device_array(np.asarray(out, np.int32))
    return _exact_int64_col(out)


def _fn_hash(*cols):
    return _spark_hash(cols, 42, _m3_hash_long, _m3_hash_bytes, 32)


def _fn_xxhash64(*cols):
    return _spark_hash(cols, 42, _xx_hash_long, _xx_hash_bytes, 64)


_JSON_SEG_RE = re.compile(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]")


def _json_traverse(doc, path: str):
    """Walk ``$.key[idx].key...``: the value wrapped in a 1-tuple, or None
    for a missing value or a malformed path (every character of the path
    must belong to a segment)."""
    if not path.startswith("$"):
        return None
    cur = doc
    pos = 1
    while pos < len(path):
        m = _JSON_SEG_RE.match(path, pos)
        if m is None:
            return None
        pos = m.end()
        key, idx = m.group(1), m.group(2)
        if key is not None:
            if not isinstance(cur, dict) or key not in cur:
                return None
            cur = cur[key]
        else:
            j = int(idx)
            if not isinstance(cur, list) or j >= len(cur):
                return None
            cur = cur[j]
    return (cur,)


def _json_render(v):
    """get_json_object's rendering: strings bare, scalars as their JSON
    lexeme, containers as compact JSON."""
    if v is None:
        return None
    if isinstance(v, str):
        return v
    if v is True or v is False:
        return "true" if v else "false"
    if isinstance(v, (dict, list)):
        return json.dumps(v, separators=(",", ":"))
    return repr(v) if not isinstance(v, float) else json.dumps(v)


def _fn_get_json_object(s, path):
    p = _scalar_str(path)

    def one(x):
        try:
            doc = json.loads(x)
        except (ValueError, TypeError):
            return None
        hit = _json_traverse(doc, p)
        return None if hit is None else _json_render(hit[0])

    return _str_map(one, s)


def json_tuple_columns(src, fields) -> list:
    """``[(name, object column), ...]`` of ``json_tuple``: the top-level
    ``fields`` of each row's JSON object, named c0...cN."""
    src = host_objects(src)
    cols = {f: np.empty(len(src), object) for f in fields}
    for i, x in enumerate(src):
        try:
            doc = json.loads(x) if x is not None else None
        except (ValueError, TypeError):
            doc = None
        for f in fields:
            cols[f][i] = (_json_render(doc[f])
                          if isinstance(doc, dict) and f in doc else None)
    return [(f"c{j}", cols[f]) for j, f in enumerate(fields)]


HASH_JSON_FNS = {
    "hash": _fn_hash,
    "xxhash64": _fn_xxhash64,
    "get_json_object": _fn_get_json_object,
}
