"""JAX's default random streams (``jax.random`` with the threefry PRNG and
``jax_threefry_partitionable`` on) as torch integer ops, so that a fit
draws the JAX package's numbers on the device of its data.

A key is an int64 tensor of shape ``(..., 2)`` holding the two uint32 key
words; leading axes are a batch of keys, and every draw from a batch of
keys has those axes first (one draw a key, as ``jax.vmap`` would give).
uint32 arithmetic runs in int64, masked to 32 bits after each add and
shift.

Bit for bit with ``jax.random``: ``PRNGKey``, ``split``, ``fold_in``,
``random_bits``, ``uniform`` (with ``minval``/``maxval``) and ``randint``.
``normal`` is √2·erfinv of a uniform on (nextafter(−1, 0), 1) and
``gamma`` is JAX's Marsaglia–Tsang loop with its own key splits per
element and per rejection; XLA's ``erf_inv`` polynomial is
reproduced, but torch's ``log1p``, ``log`` and ``pow`` round apart from
XLA's by an ulp here and there (``tests/test_torch_prng.py`` states the
bounds), so these two are held within ulps, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``x0``,
    ``x1`` under the key words ``k1``, ``k2``: uint32 values in int64
    tensors (broadcast together)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the high and low words of the 64-bit
    seed."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64, device=device)


def _words(key: torch.Tensor, ndim: int):
    """The key words shaped to broadcast against ``ndim`` trailing axes."""
    shape = tuple(key.shape[:-1]) + (1,) * ndim
    return key[..., 0].reshape(shape), key[..., 1].reshape(shape)


def _counters(shape: tuple, device):
    """``iota_2x32_shape``: the row-major index of each element of
    ``shape`` as its high and low uint32 words."""
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK


def _hash(key: torch.Tensor, shape: tuple):
    k1, k2 = _words(key, len(shape))
    c1, c2 = _counters(shape, key.device)
    return threefry2x32(k1, k2, c1, c2)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: shape ``key.shape[:-1] + (num, 2)``."""
    b1, b2 = _hash(key, (int(num),))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``data`` an int or an integer
    tensor, whose elements each fold into the key (a batch of keys, the
    data's shape first)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    k1, k2 = key[..., 0], key[..., 1]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple, bit_width: int = 32):
    """``jax.random.bits``: uint32 values in int64 (``bit_width`` 32), or
    for 64 the (high, low) uint32 words of each uint64 draw."""
    b1, b2 = _hash(key, tuple(shape))
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return b1, b2
    raise ValueError("bit_width must be 32 or 64")


def _unit(key: torch.Tensor, shape: tuple, dtype) -> torch.Tensor:
    """Floats in [0, 1): the draw's mantissa bits under exponent 0."""
    if dtype == torch.float64:
        b1, b2 = random_bits(key, shape, 64)
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _split_bits(x: torch.Tensor) -> tuple:
    """Veltkamp's split of ``x`` into a high and a low half whose
    products are exact."""
    c = x * (134217729.0 if x.dtype == torch.float64 else 4097.0)
    hi = c - (c - x)
    return hi, x - hi


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple:
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once, as XLA's CPU backend fuses it, from
    separately rounded torch ops: Dekker's exact product, an exact sum,
    and the low part rounded to odd before the last add (Boldo and
    Melquiond's emulation; exact barring overflow and underflow)."""
    p = a * b
    ah, al = _split_bits(a)
    bh, bl = _split_bits(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    v, err = _two_sum(tl, e)
    ints = torch.int64 if v.dtype == torch.float64 else torch.int32
    even = (v.view(ints) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(v, float("inf")),
                         torch.full_like(v, float("-inf")))
    v = torch.where((err != 0) & even, torch.nextafter(v, toward), v)
    return th + v


def uniform(key: torch.Tensor, shape=(), dtype=torch.float32,
            minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``; the
    scaling ``u·(maxval − minval) + minval`` is one fused multiply-add, as
    in XLA."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    shape = tuple(shape)
    floats = _unit(key, shape, dtype)
    if (minval, maxval) == (0.0, 1.0):
        return floats
    lo = torch.as_tensor(minval, dtype=dtype, device=key.device)
    hi = torch.as_tensor(maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, fma(floats, (hi - lo).expand_as(floats),
                                 lo.expand_as(floats)))


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            dtype=torch.int32) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype)`` for
    int32 (32-bit draws) or int64 (64-bit draws: the default integer
    under x64), ``maxval - minval`` below 2^31."""
    shape = tuple(shape)
    minval, maxval = int(minval), int(maxval)
    span = maxval - minval if maxval > minval else 1
    if span >= 1 << 31:
        raise ValueError("randint: the range must be below 2^31")
    keys = split(key, 2)
    hi_key, lo_key = keys[..., 0, :], keys[..., 1, :]
    if dtype == torch.int32:
        higher = random_bits(hi_key, shape)
        lower = random_bits(lo_key, shape)
        # uint32 products wrap: (2^16 mod span)² may reach 2^32
        mult = ((((1 << 16) % span) ** 2) & MASK) % span
    elif dtype == torch.int64:
        # a uint64 draw (h·2^32 + l) modulo span, exact in int64 for
        # span < 2^31
        words = (1 << 32) % span

        def mod64(k):
            h, lo = random_bits(k, shape, 64)
            return ((h % span) * words + lo % span) % span

        higher, lower = mod64(hi_key), mod64(lo_key)
        mult = (((1 << 32) % span) ** 2) % span
    else:
        raise TypeError(f"randint draws int32 or int64, not {dtype}")
    offset = (higher % span) * mult
    if dtype == torch.int32:            # uint32 products and sums wrap
        offset = ((offset & MASK) + lower % span) & MASK
    else:
        offset = offset + lower % span
    return (minval + offset % span).to(dtype)


# XLA's erf_inv: Giles' polynomials in w = −log1p(−x²) ("Approximating the
# erfinv function", GPU Computing Gems, 2011), highest order first; float32
# splits at w = 5, float64 at w = 6.25 and 16. Each Horner step is one
# fused multiply-add, as XLA's CPU backend contracts it.
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``erf_inv`` (Giles' approximation), ±inf at ±1."""
    def full(v):
        return torch.full_like(x, v)

    w = -torch.log1p(-x * x)
    if x.dtype == torch.float32:
        small, large = _ERFINV32
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        p = torch.where(lt, full(small[0]), full(large[0]))
        for a, b in zip(small[1:], large[1:]):
            p = fma(p, w, torch.where(lt, full(a), full(b)))
    else:
        c1, c2, c3 = _ERFINV64
        l6, l16 = w < 6.25, w < 16.0

        def coef(i):
            c = full(c1[i])
            if i < len(c2):
                c = torch.where(l6, c, full(c2[i]))
            if i < len(c3):
                c = torch.where(l16, c, full(c3[i]))
            return c

        w = torch.where(l6, w - 3.125, torch.sqrt(w) - torch.where(
            l16, full(3.25), full(5.0)))
        p = coef(0)
        for i in range(1, len(c3)):
            p = fma(p, w, coef(i))
        for i in range(len(c3), len(c2)):
            p = torch.where(l16, fma(p, w, coef(i)), p)
        for i in range(len(c2), len(c1)):
            p = torch.where(l6, fma(p, w, coef(i)), p)
    big = torch.finfo(x.dtype).max
    return torch.where(torch.abs(x) == 1.0, x * big, p * x)


def normal(key: torch.Tensor, shape=(), dtype=torch.float32):
    """``jax.random.normal``: √2·erfinv(u), u uniform on
    (nextafter(−1, 0), 1)."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    lo = float(np.nextafter(np_dt(-1.0), np_dt(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0)
    sqrt2 = torch.as_tensor(float(np_dt(np.sqrt(2))), dtype=dtype,
                            device=key.device)
    return sqrt2 * erfinv(u)


def gamma(key: torch.Tensor, a: float, shape, dtype=torch.float32):
    """``jax.random.gamma(key, a, shape, dtype)``: one key a element split
    from ``key`` (row-major), then Marsaglia–Tsang by rejection, each
    element's loop on its own keys as ``jax._src.random._gamma_one`` runs
    it; the rounds run on all pending elements at once, with one host read
    a round to stop."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    dev = key.device

    def c(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    zero, one = c(0.0), c(1.0)
    alpha = c(a).expand(n)
    boosted = alpha >= one
    alpha_b = torch.where(boosted, alpha, alpha + one)
    d = alpha_b - c(1.0 / 3.0)
    cc = c(1.0 / 3.0) / torch.sqrt(d)
    keys = split(key, n)                            # (n, 2)
    pair = split(keys, 2)
    state, boost_key = pair[:, 0], pair[:, 1]
    X, V, U = torch.zeros_like(alpha), one.expand(n), c(2.0).expand(n)

    def pending(X, V, U):
        return ((U >= one - c(0.0331) * (X * X))
                & (torch.log(U) >= X * c(0.5)
                   + d * ((one - V) + torch.log(V))))

    todo = pending(X, V, U)
    while bool(todo.any()):
        three = split(state, 3)
        nxt, kx, ku = three[:, 0], three[:, 1], three[:, 2]
        x, v = torch.zeros_like(alpha), -one.expand(n)
        redo = v <= zero
        while bool(redo.any()):
            two = split(kx, 2)
            xs = normal(two[:, 1], (), dtype)
            kx = torch.where(redo[:, None], two[:, 0], kx)
            x = torch.where(redo, xs, x)
            v = torch.where(redo, one + x * cc, v)
            redo = v <= zero
        Xn, Vn, Un = x * x, (v * v) * v, uniform(ku, (), dtype)
        state = torch.where(todo[:, None], nxt, state)
        X = torch.where(todo, Xn, X)
        V = torch.where(todo, Vn, V)
        U = torch.where(todo, Un, U)
        todo = todo & pending(X, V, U)
    samples = one - uniform(boost_key, (), dtype)
    boost = torch.where(boosted, one, torch.pow(samples, one / alpha))
    return ((d * V) * boost).reshape(shape)


def uniform_like_jax(seed: int, n: int, dtype) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype)`` as a
    numpy array, drawn on the CPU."""
    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    return uniform(PRNGKey(seed), (int(n),), tdt).numpy()
