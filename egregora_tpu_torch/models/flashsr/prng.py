"""JAX's default PRNG in numpy: threefry2x32, ``split``, ``fold_in`` and
the ``uniform`` / ``normal`` / ``bernoulli`` draws.

``FlashSRPipeline.chunk_forward`` draws its one-step noise latent as
``jax.random.normal(jax.random.PRNGKey(noise_seed), shape, float32)``.
No torch generator yields those numbers, so the draw is reproduced here
bit for bit: the threefry2x32 block cipher (20 rounds, Salmon et al.
2011), JAX's partitionable bit scheme (one cipher call per element,
counter = the element's row-major index as a (hi, lo) pair of 32-bit
words, bits = out_hi ^ out_lo), the mantissa-fill uniform draw on
``[nextafter(-1, 0), 1)`` (scaled with one rounding, as XLA's fused
multiply-add), and ``sqrt(2) * erfinv(u)`` with XLA's f32
erfinv (Giles' single-precision polynomial).  The trainers draw their
data and noise from the same keys as the JAX package's (``fold_in`` a
step, ``split``), so the same flags draw the same numbers.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds: ``key [2] uint32``, counters
    ``x0, x1`` uint32 arrays -> two uint32 arrays of the same shape."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for the threefry2x32 implementation
    (JAX's default 32-bit mode: seeds in ``[0, 2**32)``)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"prng_key: seed must be in [0, 2**32), got {seed}")
    return np.array([0, seed], np.uint32)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32-bit draws, ``jax_threefry_partitionable=True`` scheme."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key: np.ndarray, shape, minval: float, maxval: float) -> np.ndarray:
    """float32 uniform on ``[minval, maxval)`` from the mantissa bits."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(32 - 23)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # floats * (hi - lo) + lo rounded once, as the fused multiply-add XLA
    # emits (the float32 product is exact in float64)
    v = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, v.astype(np.float32))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv (Giles 2010 polynomial, |x| < 1)."""
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        # c + p*w rounded once, as the fused multiply-add XLA emits
        c = np.where(lt, np.float32(a), np.float32(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w.astype(np.float64)).astype(np.float32)
    out = p * x
    return np.where(np.abs(x) == 1.0, x * np.float32(np.inf), out).astype(np.float32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: key ``i`` is the cipher of the
    counter ``i`` as a (hi, lo) pair, both words kept -> ``[num, 2]``."""
    idx = np.arange(int(num), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def normal_from_key(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)`` for a raw key ``[2]``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, tuple(shape), lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)


def normal(seed: int, shape) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)``."""
    return normal_from_key(prng_key(seed), shape)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the cipher of the counter
    ``(0, data)`` (``data`` taken as uint32), both words kept -> ``[2]``."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, np.zeros(1, np.uint32),
                              np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def bernoulli(key: np.ndarray, p: float, shape=()) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)``: a float32 uniform draw on
    ``[0, 1)`` below ``p``."""
    return uniform(key, tuple(shape), 0.0, 1.0) < np.float32(p)


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    32-bit draws from ``split(key)``, ``(hi % span * (2**32 % span) + lo %
    span) % span`` in uint32 arithmetic, plus ``minval``."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(max(int(maxval) - int(minval), 1))
    with np.errstate(over="ignore"):
        mult = np.uint32(2 ** 16) % span
        mult = np.uint32(mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: ``arange(n)`` sorted by fresh
    32-bit keys, ``ceil(3 ln n / ln(2**32 - 1))`` rounds of ``split``."""
    x = np.arange(int(n), dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, int(n))) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, x.shape), kind="stable")]
    return x


def choice(key: np.ndarray, n: int, shape, replace: bool = True) -> np.ndarray:
    """``jax.random.choice(key, n, shape, replace)`` of an integer ``n``
    (uniform): ``randint`` with replacement, else the first draws of
    ``permutation``."""
    count = int(np.prod(shape, dtype=np.int64))
    if replace:
        return randint(key, shape, 0, n)
    if count > n:
        raise ValueError(f"choice: {count} draws without replacement from {n}")
    return permutation(key, n)[:count].reshape(shape)


# float32 erf(-sqrt 2) and erf(sqrt 2) as XLA computes them: the uniform
# bounds of a normal truncated to (-2, 2)
_ERF_LO = np.array(3212073496, np.uint32).view(np.float32)
_ERF_HI = np.array(1064589848, np.uint32).view(np.float32)


def truncated_normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.truncated_normal(key, -2, 2, shape, float32)``:
    ``sqrt(2) erfinv(u)`` of a uniform ``u`` on ``[erf(-sqrt 2), erf(sqrt
    2))``, clipped into the open interval."""
    u = uniform(key, tuple(shape), _ERF_LO, _ERF_HI)
    out = np.float32(np.sqrt(2)) * erfinv_f32(u)
    lo = np.nextafter(np.float32(-2.0), np.float32(np.inf))
    hi = np.nextafter(np.float32(2.0), np.float32(-np.inf))
    return np.clip(out, lo, hi).astype(np.float32)
