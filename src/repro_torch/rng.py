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
  goes through XLA's float32 ``erf_inv`` polynomial on the replay of its
  ``log1p``, re-stated here, and matches to 2 ulp (a few draws in 10^5
  differ).

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


_TINY = float(np.finfo(np.float32).tiny)


def _f32c(x) -> float:
    """A constant rounded to float32, as XLA folds it."""
    return float(np.float32(x))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as XLA's contracted
    multiply-add: the float64 product of float32 values is exact, so the
    sum rounds once (to double, then to float).  ``b`` and ``c`` are
    float32 tensors or float32-exact Python floats."""
    def wide(x):
        return x.double() if isinstance(x, torch.Tensor) else x
    return (a.double() * wide(b) + wide(c)).float()


# XLA's float32 log on the CPU: the Cephes polynomial on the mantissa in
# [sqrt(1/2), sqrt(2)), with denormal inputs read as zero (the CPU runs
# with denormals flushed).  torch's own log differs from it by one ulp on
# many float32 inputs, enough to flip a Gumbel arg-max at a near tie.
_LOG_P = tuple(_f32c(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32c(-2.12194440e-4), _f32c(0.693359375)
_SQRTHF = _f32c(0.707106781186547524)


def log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log, bit-equal to XLA's on the CPU (with FMA
    contraction replayed in float64)."""
    m, e = torch.frexp(torch.clamp(x, min=_TINY))
    e = e.float()
    small = m < _SQRTHF
    # [0.5, 1) -> [sqrt(1/2) - 1, sqrt(2) - 1): both steps are exact
    m = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    out = ((m - x2 * 0.5) + y) + _LOG_Q2 * e
    out = torch.where(x < _TINY, -math.inf, out)    # 0 and denormals
    out = torch.where(x < 0, math.nan, out)
    return torch.where((x == math.inf) | torch.isnan(x), x, out)


# XLA's float32 log1p: a Cephes rational approximation for |x| < sqrt(2)-1
# (each polynomial in Horner form, contracted to multiply-adds), log(1+x)
# above it.
_LOG1P_NUM = tuple(_f32c(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_f32c(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))


def _horner(x, coeffs):
    out = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        out = _fma(out, x, c)
    return out


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log(1 + x)``, bit-equal to XLA's on the CPU."""
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + (x2 * -0.5 + small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       log(x + 1.0))


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
    w = -log1p(x * -x)
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


def _scaled(draw, scale, dtype):
    """``(scale * draw).astype(dtype)`` of one float32 chunk: the float32
    product, then one rounding, element by element, so a chunk written
    into a ``dtype`` output equals the cast of the whole float32 draw."""
    if scale is not None:
        draw = scale * draw
    return draw.to(dtype)


def normal(key: torch.Tensor, shape=(), scale=None,
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)``, with
    ``u`` uniform on (-1, 1); with ``scale`` and ``dtype``, ``(scale *
    draw).astype(dtype)`` made a chunk at a time (no float32 copy of the
    whole draw)."""
    sqrt2 = float(np.float32(np.sqrt(2)))

    def chunk(cnt):
        u = _uniform_chunk(key, cnt, _NORMAL_LO, 1.0)
        return _scaled(_scalar(sqrt2, key.device) * erfinv(u), scale, dtype)
    return _draw(key, shape, chunk, dtype)


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape=(), scale=None,
                     dtype=torch.float32) -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32: ``sqrt(2)·erfinv(u)``
    with ``u`` uniform on ``[erf(lower/√2), erf(upper/√2))``, clamped to
    the open interval.  The bounds' ``erf`` is taken on the host in
    float64 and rounded to float32 (XLA's float32 ``erf`` may differ by an
    ulp), so draws agree with JAX's to a few ulp, not bit for bit.  With
    ``scale`` and ``dtype``: ``(scale * draw).astype(dtype)``, a chunk at
    a time, as `normal`."""
    sqrt2 = float(np.float32(np.sqrt(2)))
    a = float(np.float32(math.erf(float(np.float32(lower)) / sqrt2)))
    b = float(np.float32(math.erf(float(np.float32(upper)) / sqrt2)))
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))

    def chunk(cnt):
        u = _uniform_chunk(key, cnt, a, b)
        out = _scalar(sqrt2, key.device) * erfinv(u)
        return _scaled(torch.clamp(out, lo, hi), scale, dtype)
    return _draw(key, shape, chunk, dtype)


def _gumbel_chunk(key, counts, dtype=torch.float32):
    # mode "low": -log(-log(u)), u uniform on [tiny, 1)
    if dtype == torch.float32:
        return -log(-log(_uniform_chunk(key, counts, _TINY, 1.0)))
    if dtype != torch.bfloat16:
        raise TypeError(f"gumbel draws float32 or bfloat16, not {dtype}")
    # bfloat16: JAX fills its 7 mantissa bits from 8 random bits, and
    # rounds each log back to bfloat16
    k = (_bits32(key, counts) & 0xFF) >> 1
    u = torch.clamp(k.float() * (1.0 / 128.0), min=_TINY)
    inner = log(u).to(dtype).float()
    return (-log(-inner)).to(dtype)


def gumbel(key: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32 or bfloat16."""
    return _draw(key, shape, lambda cnt: _gumbel_chunk(key, cnt, dtype),
                 dtype)


def exponential(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.exponential`` in float32: ``-log1p(-u)``."""
    return _draw(key, shape,
                 lambda cnt: -log1p(-_uniform_chunk(key, cnt, 0.0, 1.0)),
                 torch.float32)


def _argmax_rows(key, n_rows: int, n: int, row_logits) -> torch.Tensor:
    """``argmax(gumbel(key, (n_rows, n)) + logits, -1)`` as int32, hashed
    a block of rows at a time (the counters stay row-major), where
    ``row_logits(r0, r1)`` gives rows ``r0 .. r1-1`` of the logits
    (broadcast over a batch of keys)."""
    batch = tuple(key.shape[:-1])
    out = torch.empty(batch + (n_rows,), dtype=torch.int32,
                      device=key.device)
    step = max(1, _CHUNK // max(n, 1))
    for r0 in range(0, n_rows, step):
        r1 = min(n_rows, r0 + step)
        counts = torch.arange(r0 * n, r1 * n, dtype=torch.int64,
                              device=key.device)
        lg = row_logits(r0, r1)
        g = _gumbel_chunk(key, counts, lg.dtype).view(batch + (r1 - r0, n))
        out[..., r0:r1] = torch.argmax(g + lg, dim=-1)
    return out


def _check_shape(name, shape, *param_shapes):
    try:
        ok = tuple(torch.broadcast_shapes(shape, *param_shapes)) == \
            tuple(shape)
    except RuntimeError:
        ok = False
    if not ok:
        raise ValueError(f"{name}: shape {tuple(shape)} is not broadcast-"
                         f"compatible with {param_shapes}")


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1,
                shape=None, replace: bool = True) -> torch.Tensor:
    """``jax.random.categorical`` (Gumbel arg-max, mode "low"), int32,
    with noise in the logits' dtype (float32 or bfloat16).

    A batch of keys ``[*batch, 2]`` maps over the leading ``batch`` axes
    of ``logits``, as ``vmap`` over keys does.  ``shape`` may add leading
    sample axes that the logits broadcast over; ``replace=False`` takes
    the Gumbel top-k.  A draw along the last axis is hashed a block of
    rows at a time, so its noise never exists in one piece."""
    batch = tuple(key.shape[:-1])
    nb = len(batch)
    if tuple(logits.shape[:nb]) != batch:
        raise ValueError(f"logits {tuple(logits.shape)} do not start with "
                         f"the keys' batch shape {batch}")
    per = tuple(logits.shape[nb:])
    axis = axis % len(per)
    n = per[axis]
    batch_shape = per[:axis] + per[axis + 1:]
    shape = batch_shape if shape is None else tuple(int(s) for s in shape)
    _check_shape("categorical", shape, batch_shape)
    prefix = shape[:len(shape) - len(batch_shape)]
    if not replace:
        k = math.prod(prefix)
        if k > n:
            raise ValueError(f"Number of samples without replacement ({k}) "
                             f"cannot exceed number of categories ({n}).")
        noisy = (logits + gumbel(key, per, logits.dtype)).movedim(
            nb + axis, -1)
        idx = torch.topk(noisy, k, dim=-1).indices.to(torch.int32)
        # [*batch, *batch_shape, k] -> [*batch, k, *batch_shape] -> shape
        return idx.movedim(-1, nb).reshape(batch + shape)
    rest = list(shape[len(prefix):])
    rest.insert(axis, n)
    full = tuple(prefix) + tuple(rest)            # the noise's shape
    lg = logits.reshape(batch + (1,) * len(prefix) + per)
    if axis != len(per) - 1:
        noisy = gumbel(key, full, logits.dtype) + lg
        return torch.argmax(noisy, dim=nb + len(prefix) + axis).to(
            torch.int32)
    rows = math.prod(full[:-1])
    lg = lg.expand(batch + full).reshape(batch + (rows, n))
    out = _argmax_rows(key, rows, n, lambda r0, r1: lg[..., r0:r1, :])
    return out.reshape(batch + full[:-1])


def categorical_rows(key: torch.Tensor, table: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """``categorical(key, table[rows])`` (logits along the last axis of
    ``table``), without building ``table[rows]``: each block of rows
    gathers its own logits."""
    flat = rows.reshape(-1)
    n = table.shape[-1]
    out = _argmax_rows(key, flat.numel(), n,
                       lambda r0, r1: table[flat[r0:r1]])
    return out.reshape(rows.shape)


def _ftz(x):
    # the CPU runs XLA with denormals flushed to zero
    return torch.where(x.abs() < _TINY, 0.0, x)


def _gamma_loop(keys, alpha, log_space: bool):
    """Marsaglia–Tsang, as ``jax.random``'s ``_gamma_one`` runs it for
    each element with its own key: both rejection loops run vectorised
    over the elements still pending (the loop tests the host for any
    pending element once per round).  ``keys [n, 2]``, ``alpha [n]``."""
    one_third = _f32c(1.0 / 3.0)
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - one_third
    # XLA rewrites a / sqrt(d) as a * rsqrt(d), its rsqrt correctly rounded
    c = one_third * (1.0 / torch.sqrt(d.double())).float()
    ks = split(keys)
    key, sub = ks[:, 0].clone(), ks[:, 1]
    V = torch.ones_like(d)
    pending = torch.ones_like(d, dtype=torch.bool)
    while bool(pending.any()):
        idx = pending.nonzero().squeeze(1)
        k3 = split(key[idx], 3)
        key[idx] = k3[:, 0]
        xkey, ci = k3[:, 1].clone(), c[idx]
        x = torch.zeros_like(ci)
        v = torch.full_like(ci, -1.0)
        inner = torch.ones_like(ci, dtype=torch.bool)
        while bool(inner.any()):
            j = inner.nonzero().squeeze(1)
            k2 = split(xkey[j])
            xkey[j] = k2[:, 0]
            x[j] = normal(k2[:, 1])
            v[j] = _fma(x[j], ci[j], 1.0)              # 1 + x c
            inner = v <= 0.0
        X = x * x
        Vi = (v * v) * v
        U = uniform(k3[:, 2])
        V[idx] = Vi
        di = d[idx]
        reject = ((U >= _fma(X * X, -_f32c(0.0331), 1.0))
                  & (log(U) >= X * 0.5 + di * ((1.0 - Vi) + log(Vi))))
        pending[idx] = reject
    if log_space:
        # log U ~ -Exponential, taken as log1p(-u) so that both spaces
        # draw the same sample
        ls = -exponential(sub)
        lb = torch.where(boost | (ls == 0.0), 0.0,
                         ls * (torch.ones_like(alpha) / alpha))
        return (log(d) + log(V)) + lb
    u = 1.0 - uniform(sub)
    b = torch.where(boost, 1.0,
                    _ftz(torch.pow(u, torch.ones_like(alpha) / alpha)))
    return _ftz((d * V) * b)


def _gamma(key, a, shape, log_space):
    a = torch.as_tensor(a, dtype=torch.float32, device=key.device)
    shape = tuple(a.shape) if shape is None else tuple(int(s) for s in shape)
    _check_shape("gamma", shape, tuple(a.shape))
    n = math.prod(shape)
    alpha = a.expand(shape).reshape(n)
    if n == 0:
        return alpha.reshape(shape)
    # element i draws with split(key, n)[i], as JAX's random_gamma lowers
    return _gamma_loop(split(key, n), alpha, log_space).reshape(shape)


def gamma(key: torch.Tensor, a, shape=None) -> torch.Tensor:
    """``jax.random.gamma`` in float32.  The ``a < 1`` boost takes
    ``u ** (1/a)`` through torch's ``pow``, which may differ from XLA's
    by an ulp; :func:`loggamma` does not."""
    return _gamma(key, a, shape, log_space=False)


def loggamma(key: torch.Tensor, a, shape=None) -> torch.Tensor:
    """``jax.random.loggamma`` in float32 (the ``a < 1`` boost in log
    space)."""
    return _gamma(key, a, shape, log_space=True)


def dirichlet(key: torch.Tensor, alpha, shape=None) -> torch.Tensor:
    """``jax.random.dirichlet`` in float32: the softmax of log-gamma
    draws.  torch's ``exp`` and sum order differ from XLA's, so values
    agree to a few ulp; results under float32's smallest normal are
    flushed to zero, as on XLA's CPU."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=key.device)
    if alpha.ndim < 1:
        raise ValueError("dirichlet requires alpha.ndim >= 1")
    shape = tuple(alpha.shape[:-1]) if shape is None else tuple(shape)
    _check_shape("dirichlet", shape, tuple(alpha.shape[:-1]))
    lg = loggamma(key, alpha, shape + tuple(alpha.shape[-1:]))
    un = _ftz(torch.exp(lg - lg.amax(dim=-1, keepdim=True)))
    return _ftz(un / un.sum(dim=-1, keepdim=True))
