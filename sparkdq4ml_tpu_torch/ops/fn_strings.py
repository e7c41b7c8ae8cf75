"""The string builtins, computed on the host over object columns as in the
JAX package (``sparkdq4ml_tpu/ops/expressions.py:1482-1502``,
``:1514-1536``, ``:1549-1551``, their helpers ``:664-775``,
``:942-992`` and ``:1283-1365``, and ``:2739-2808``: ``substring_index``,
``soundex``, ``encode``/``decode``, ``octet_length``/``bit_length``).

Lengths and positions come back as int32 columns on the evaluation
device (the policy's float with NaN where a row is null). A float32 cell
renders as ``str(np.float32(x))`` ('0.1'), the numpy scalar's own
precision, as the JAX package iterates a numpy array.
"""

from __future__ import annotations

import base64 as _b64
import builtins
import hashlib
import re

import numpy as np

from .cells import (_cell_is_null, _int_or_null, _nullable_int32_col,
                    _scalar_int, _scalar_str, _str_map, device_array,
                    host_array, host_objects, is_host_column, map_rows)


def _fn_length(s):
    """Spark's length: NULL for a null cell (an int32 column widens to
    the policy's float with NaN); a number counts its text, a float32
    cell as numpy renders it."""
    if is_host_column(s):
        lens = list(map_rows(lambda x: None if x is None else len(str(x)),
                             s))
    else:
        a = host_array(s)
        if np.issubdtype(a.dtype, np.floating):
            lens = [None if np.isnan(x) else len(str(x)) for x in a]
        elif np.issubdtype(a.dtype, np.bool_):
            lens = [len(str(bool(x))) for x in a]
        else:
            lens = [len(str(int(x))) for x in a]
    return _int_or_null(lens)


def _fn_sha2(s, n):
    """``sha2(col, bits)`` for bits in {0, 224, 256, 384, 512} (0 is
    256); any other width gives NULL in every row."""
    bits = _scalar_int(n)
    if bits == 0:
        bits = 256
    if bits not in (224, 256, 384, 512):
        return np.full(len(host_objects(s)), None, dtype=object)
    algo = f"sha{bits}"
    return _str_map(lambda x: hashlib.new(algo, x.encode()).hexdigest(), s)


def _fn_substring(s, pos, length):
    """1-based; position 0 acts as 1. The position and length may be
    literals or per-row columns; a null one gives NULL."""
    pa = host_array(pos).ravel()
    la = host_array(length).ravel()
    if pa.dtype != object and la.dtype != object and pa.size and la.size \
            and (pa == pa[0]).all() and (la == la[0]).all():
        # literal bounds (a NaN never equals itself, so not here): one
        # slice a distinct string
        p, ln = int(pa[0]), int(la[0])
        start = max(p - 1, 0)
        return map_rows(lambda x: None if x is None
                        else x[start:start + ln], s)

    def at(a, i):
        v = a[i] if a.size > 1 else a[0]
        if isinstance(v, (float, np.floating)) and np.isnan(v):
            return None
        return int(v)

    out = []
    for i, x in enumerate(s):
        p, ln = at(pa, i), at(la, i)
        if x is None or p is None or ln is None:
            out.append(None)
            continue
        start = max(p - 1, 0)
        out.append(x[start:start + ln])
    return np.asarray(out, object)


def _fn_concat(*ss):
    """Spark's concat: NULL if any argument is null."""
    return _str_map(lambda *row: "".join(str(x) for x in row), *ss)


def _fn_concat_ws(sep, *ss):
    """Spark's concat_ws: the separator between the non-null arguments
    (it skips nulls, where concat is NULL)."""
    s = _scalar_str(sep)

    def null(x):
        return x is None or (isinstance(x, float) and x != x)

    return np.asarray([s.join(str(x) for x in row if not null(x))
                       for row in zip(*[host_objects(a) for a in ss])],
                      dtype=object)


def _fn_split(s, pattern):
    """An array cell of the pieces around each match of the regular
    expression ``pattern``."""
    pat = re.compile(_scalar_str(pattern))
    return _str_map(pat.split, s)


def _fn_format_number(x, d):
    nd = _scalar_int(d)
    if nd < 0:
        raise ValueError("format_number decimal places must be >= 0")
    vals = host_array(x).astype(np.float64)
    return np.asarray([None if np.isnan(v) else format(v, f",.{nd}f")
                       for v in vals], object)


def _fn_format_string(fmt, *cols):
    """printf formatting; a null argument in a row nulls that row."""
    fa = host_objects(fmt).ravel()
    f = fa[0] if fa.size else ""
    host = [host_objects(c) for c in cols]
    out = []
    for i in range(len(fa)):
        args = tuple(h[i] for h in host)
        if any(_cell_is_null(v) for v in args):
            out.append(None)
            continue
        out.append(f % args)
    return np.asarray(out, object)


def _fn_levenshtein(l, r):  # noqa: E741 - Spark's own argument names
    """Edit distance; an int32 column, a host object column when a row is
    null (as the JAX package returns it)."""
    def dist(a, b):
        if a is None or b is None:
            return None
        if len(a) < len(b):
            a, b = b, a
        prev = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            cur = [i]
            for j, cb in enumerate(b, 1):
                cur.append(min(prev[j] + 1, cur[-1] + 1,
                               prev[j - 1] + (ca != cb)))
            prev = cur
        return prev[-1]

    out = list(map_rows(dist, l, r))
    if any(v is None for v in out):
        return np.asarray(out, object)
    return device_array(np.asarray(out, np.int32))


def _fn_regexp_replace(s, pattern, replacement):
    pat = re.compile(_scalar_str(pattern))
    rep = _scalar_str(replacement)
    return _str_map(lambda x: pat.sub(rep, x), s)


def _fn_regexp_extract(s, pattern, idx):
    pat = re.compile(_scalar_str(pattern))
    gi = _scalar_int(idx)

    def one(x):
        m = pat.search(x)
        return "" if m is None else (m.group(gi) or "")

    return _str_map(one, s)


def _fn_instr(s, sub):
    needle = _scalar_str(sub)
    return _int_or_null(list(map_rows(
        lambda x: None if x is None else x.find(needle) + 1, s)))


def _fn_locate(sub, s, pos=None):
    """``locate(substr, str[, pos])``: note the flipped argument order."""
    needle = _scalar_str(sub)
    start = _scalar_int(pos) if pos is not None else 1
    return _int_or_null(list(map_rows(
        lambda x: None if x is None else x.find(needle, max(start - 1, 0))
        + 1, s)))


def _pad(left: bool):
    def f(s, length, pad):
        ln = _scalar_int(length)
        p = _scalar_str(pad)

        def one(x):
            if ln <= 0:
                return ""
            if len(x) >= ln:
                return x[:ln]
            fill = (p * ln)[:ln - len(x)] if p else ""
            return fill + x if left else x + fill

        return _str_map(one, s)
    return f


def _fn_translate(s, matching, replace):
    """The first occurrence of a repeated matching character wins."""
    mapping: dict = {}
    rep = _scalar_str(replace)
    for i, a in enumerate(_scalar_str(matching)):
        if a not in mapping:
            mapping[a] = rep[i] if i < len(rep) else None
    table = str.maketrans(mapping)
    return _str_map(lambda x: x.translate(table), s)


def _fn_left(s, n):
    k = _scalar_int(n)              # once, where the JAX package reads
    return _str_map(lambda x: x[:k] if k > 0 else "", s)   # it per row


def _fn_right(s, n):
    k = _scalar_int(n)
    return _str_map(lambda x: x[-k:] if k > 0 else "", s)


def _fn_overlay(s, r, pos, ln=None):
    p = _scalar_int(pos) - 1
    n = _scalar_int(ln) if ln is not None else None
    return _str_map(lambda x, y: x[:p] + y + x[p + (len(y) if n is None
                                                    else n):], s, r)


def _fn_substring_index(s, delim, count):
    """Everything before the count-th delimiter (from the left for a
    positive count, from the right for a negative one); count 0 is ''."""
    d = _scalar_str(delim)
    k = _scalar_int(count)

    def one(x):
        if k == 0 or not d:
            return ""
        parts = x.split(d)
        if k > 0:
            return d.join(parts[:k])
        return d.join(parts[builtins.max(len(parts) + k, 0):])

    return _str_map(one, s)


_SOUNDEX_CODES = {**{c: "1" for c in "BFPV"}, **{c: "2" for c in "CGJKQSXZ"},
                  **{c: "3" for c in "DT"}, "L": "4",
                  **{c: "5" for c in "MN"}, "R": "6"}


def _fn_soundex(s):
    """American Soundex (Spark/Hive variant): 4 characters, H and W
    transparent between same-coded consonants, non-alphabetic input
    passed through."""
    def one(x):
        if not x or not x[0].isalpha():
            return x
        u = x.upper()
        code = [u[0]]
        prev = _SOUNDEX_CODES.get(u[0], "")
        for ch in u[1:]:
            c = _SOUNDEX_CODES.get(ch)
            if c is None:
                if ch not in "HW":
                    prev = ""
                continue
            if c != prev:
                code.append(c)
                if len(code) == 4:
                    break
            prev = c
        return "".join(code).ljust(4, "0")

    return _str_map(one, s)


def _fn_encode(s, charset):
    cs = _scalar_str(charset)
    return _str_map(lambda x: x.encode(cs).decode("latin-1"), s)


def _fn_decode(s, charset):
    cs = _scalar_str(charset)
    return _str_map(lambda x: x.encode("latin-1").decode(cs), s)


def _fn_octet_length(s):
    return _nullable_int32_col(list(map_rows(
        lambda x: None if x is None else len(str(x).encode()), s)))


def _fn_bit_length(s):
    return _nullable_int32_col(list(map_rows(
        lambda x: None if x is None else len(str(x).encode()) * 8, s)))


def _fn_initcap(s):
    return _str_map(lambda x: " ".join(w.capitalize() for w in x.split(" ")),
                    s)


def _fn_repeat(s, n):
    k = _scalar_int(n)
    return _str_map(lambda x: x * k, s)


STRING_FNS = {
    "upper": lambda s: _str_map(str.upper, s),
    "lower": lambda s: _str_map(str.lower, s),
    "trim": lambda s: _str_map(str.strip, s),
    "ltrim": lambda s: _str_map(str.lstrip, s),
    "rtrim": lambda s: _str_map(str.rstrip, s),
    "length": _fn_length,
    "concat": _fn_concat,
    "md5": lambda s: _str_map(lambda x: hashlib.md5(x.encode()).hexdigest(),
                              s),
    "sha1": lambda s: _str_map(lambda x: hashlib.sha1(x.encode()).hexdigest(),
                               s),
    "sha2": _fn_sha2,
    "base64": lambda s: _str_map(
        lambda x: _b64.b64encode(x.encode()).decode(), s),
    # unbase64 yields bytes; a cell holds them as latin-1 text
    "unbase64": lambda s: _str_map(
        lambda x: _b64.b64decode(x.encode()).decode("latin-1"), s),
    "substring": _fn_substring,
    "substr": _fn_substring,
    "concat_ws": _fn_concat_ws,
    "split": _fn_split,
    "format_number": _fn_format_number,
    "format_string": _fn_format_string,
    "levenshtein": _fn_levenshtein,
    "regexp_replace": _fn_regexp_replace,
    "regexp_extract": _fn_regexp_extract,
    "instr": _fn_instr,
    "locate": _fn_locate,
    "lpad": _pad(left=True),
    "rpad": _pad(left=False),
    # LEFT/RIGHT are join keywords: the parser takes their call forms
    "left": _fn_left,
    "right": _fn_right,
    "overlay": _fn_overlay,
    "repeat": _fn_repeat,
    "initcap": _fn_initcap,
    "translate": _fn_translate,
    "substring_index": _fn_substring_index,
    "soundex": _fn_soundex,
    "encode": _fn_encode,
    "decode": _fn_decode,
    "bit_length": _fn_bit_length,
    "octet_length": _fn_octet_length,
}

