"""Threefry-2x32 key stream, bit-compatible with ``jax.random``.

The simulator's Trace-producer contract fixes its random draws: per clock
``split(rng, 3)``, worker keys ``split(k_upd, P)``, delivery from
``k_net``.  torch generators give other numbers from the same seed, so
this module re-implements JAX's default generator (threefry2x32 in its
*partitionable* mode, the default of jax >= 0.5) on tensors:

- a key is an ``int64`` tensor ``[..., 2]`` holding two uint32 words; a
  leading batch shape stands for a batch of keys (what ``vmap`` over keys
  gives in JAX) and every function here maps over it;
- torch's ``uint32`` has no add or shift on the CPU, so the hash runs in
  ``int64`` masked to 32 bits;
- raw bits, ``uniform``, ``bernoulli`` and ``randint`` are bit-equal to
  ``jax.random`` (asserted by ``tests/test_torch_rng.py``); ``normal``
  goes through XLA's float32 ``erf_inv`` polynomial, re-stated here, and
  matches to an ulp or two (``log1p`` and FMA contraction differ).

Keys live on the run's device, so drawing needs no host round trip.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# Counters hashed per pass when a draw is large (bounds int64 temporaries).
_CHUNK = 1 << 22


def _rotl(x, r: int):
    """32-bit rotate left of int64 words < 2**32.  The left shift is a
    multiply (``x · 2**r`` < 2**61): torch's CPU int64 left shift is ~25x
    slower than a multiply, and the tensor calls stay four."""
    return ((x * (1 << r)) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds), on int64 words < 2**32.

    Arguments broadcast; returns the two output words."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & _M32
    x2 = (x2 + k2) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (jax name)
    """``jax.random.PRNGKey(seed)`` for a seed in [-2**31, 2**32)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} is outside the 32-bit range")
    # filled on the device: a copy from the host would synchronize
    key = torch.zeros((2,), dtype=torch.int64, device=device)
    key[1].fill_(seed & _M32)
    return key


def _words(key):
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise TypeError(f"a key is an int64 tensor [..., 2]; got "
                        f"{key.dtype} {tuple(key.shape)}")
    return key[..., 0, None], key[..., 1, None]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2] -> [..., num, 2]``."""
    k1, k2 = _words(key)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a 32-bit integer ``data``."""
    k1, k2 = key[..., 0], key[..., 1]
    zero = torch.zeros_like(k1)
    y1, y2 = threefry2x32(k1, k2, zero, zero + (int(data) & _M32))
    return torch.stack([y1, y2], dim=-1)


def _draw(key, shape, fn, dtype) -> torch.Tensor:
    """Hash the row-major counters ``0 .. prod(shape)-1`` under ``key``
    (a batch of keys maps over its leading shape), pass each chunk of
    32-bit words through ``fn`` and assemble ``[*batch, *shape]``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    batch = tuple(key.shape[:-1])
    out = torch.empty(batch + (n,), dtype=dtype, device=key.device)
    for s in range(0, n, _CHUNK):
        e = min(n, s + _CHUNK)
        counts = torch.arange(s, e, dtype=torch.int64, device=key.device)
        out[..., s:e] = fn(counts)
    return out.reshape(batch + shape)


def _bits32(key, counts):
    k1, k2 = _words(key)
    y1, y2 = threefry2x32(k1, k2, counts >> 32, counts & _M32)
    return y1 ^ y2


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (32-bit), as int64 values in [0, 2**32)."""
    return _draw(key, shape, lambda cnt: _bits32(key, cnt), torch.int64)


def _unit_float(bits):
    """Uniform [0, 1) float32 from 32 random bits (JAX's mantissa fill)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def _scalar(x, device) -> torch.Tensor:
    # filled on the device: torch.tensor(x, device=cuda) copies from the
    # host and synchronizes the stream
    return torch.full((), x, dtype=torch.float32, device=device)


def _uniform_chunk(key, counts, minval, maxval):
    floats = _unit_float(_bits32(key, counts))
    # the bounds and their float32 difference, as JAX rounds them, taken on
    # the host: they are constants of the draw
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    lo = float(lo)
    # XLA contracts floats * span + lo into one fused multiply-add; the
    # float64 product is exact, so one rounding step replays it
    scaled = (floats.double() * span + lo).float()
    return torch.clamp(scaled, min=lo)


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [minval, maxval)."""
    return _draw(key, shape,
                 lambda cnt: _uniform_chunk(key, cnt, minval, maxval),
                 torch.float32)


def bernoulli(key: torch.Tensor, p, shape) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode "low"): ``uniform < p`` in float32."""
    if not isinstance(p, torch.Tensor):
        p = float(np.float32(p))        # JAX compares in float32
    return uniform(key, shape) < p


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` to int32, for 0 <= minval, maxval < 2**31.

    JAX draws two words per value and folds them modulo the span with
    uint32 wraparound; the masks below replay that arithmetic."""
    minval, maxval = int(minval), int(maxval)
    if not (0 <= minval and maxval < (1 << 31)):
        raise ValueError("randint supports 0 <= minval, maxval < 2**31")
    span = max(maxval - minval, 1)
    mult = (((1 << 16) % span) ** 2 & _M32) % span
    keys = split(key)
    k_hi, k_lo = keys[..., 0, :], keys[..., 1, :]

    def chunk(cnt):
        hi, lo = _bits32(k_hi, cnt), _bits32(k_lo, cnt)
        off = (((hi % span) * mult) & _M32) + (lo % span)
        return ((off & _M32) % span + minval).to(torch.int32)
    return _draw(key, shape, chunk, torch.int32)


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function"),
# as chlo.erf_inv lowers it: degree-9 polynomials in w = -log1p(-x^2).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's formula."""
    # XLA's log1p takes log(1 + a) for |a| >= sqrt(2) - 1: copy the split
    a = x * -x
    w = -torch.where(a.abs() < 0.41421356237309504880, torch.log1p(a),
                     torch.log(1.0 + a))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _scalar(_ERFINV_LT5[0], x.device),
                    _scalar(_ERFINV_GE5[0], x.device))
    w64 = w.double()
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:], strict=True):
        coef = torch.where(lt, _scalar(a, x.device), _scalar(b, x.device))
        # XLA contracts each step into a fused multiply-add; a float64
        # product is exact and rounds once (to double, then to float)
        p = (coef.double() + p.double() * w64).float()
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)``, with
    ``u`` uniform on (-1, 1)."""
    sqrt2 = float(np.float32(np.sqrt(2)))

    def chunk(cnt):
        u = _uniform_chunk(key, cnt, _NORMAL_LO, 1.0)
        return _scalar(sqrt2, key.device) * erfinv(u)
    return _draw(key, shape, chunk, torch.float32)


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape=()) -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32: ``sqrt(2)·erfinv(u)``
    with ``u`` uniform on ``[erf(lower/√2), erf(upper/√2))``, clamped to
    the open interval.  The bounds' ``erf`` is taken on the host in
    float64 and rounded to float32 (XLA's float32 ``erf`` may differ by an
    ulp), so draws agree with JAX's to a few ulp, not bit for bit."""
    sqrt2 = float(np.float32(np.sqrt(2)))
    a = float(np.float32(math.erf(float(np.float32(lower)) / sqrt2)))
    b = float(np.float32(math.erf(float(np.float32(upper)) / sqrt2)))
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))

    def chunk(cnt):
        u = _uniform_chunk(key, cnt, a, b)
        out = _scalar(sqrt2, key.device) * erfinv(u)
        return torch.clamp(out, lo, hi)
    return _draw(key, shape, chunk, torch.float32)
