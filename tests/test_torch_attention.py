"""The port's attention (``repro_torch.kernels.ref.attention``, the plain
version of the CUDA ``flash_attention``) against the JAX package.

The same inputs, made with numpy from a seed, go through JAX's Pallas
``flash_attention`` in interpret mode (``block_q = block_k = 64``) and
its ``ref.attention_dense``, and through the port's blocked and dense
plain versions.  The cases are the JAX kernel test's ``ATTN_CASES``
(``tests/test_kernels.py:28-36``) and its tolerances: 3e-5 in float32,
6e-2 in bfloat16 (absolute and relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import launch, ops, ref

# B, Sq, Sk, H, Hkv, Dk, Dv, causal, window, dtype (tests/test_kernels.py)
ATTN_CASES = [
    (2, 128, 128, 4, 2, 32, 32, True, None, "f32"),
    (1, 200, 200, 8, 8, 64, 64, True, None, "f32"),
    (2, 64, 256, 4, 1, 32, 16, True, None, "f32"),     # MQA, Dv != Dk
    (2, 128, 128, 4, 2, 32, 32, True, 48, "f32"),      # sliding window
    (2, 128, 128, 4, 2, 32, 32, False, None, "f32"),
    (2, 128, 128, 8, 4, 64, 64, True, None, "bf16"),
]
TOL = {"f32": 3e-5, "bf16": 6e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(B, Sq, Sk, H, Hkv, Dk, Dv, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Sq, H, Dk)).astype(np.float32)
    k = r.standard_normal((B, Sk, Hkv, Dk)).astype(np.float32)
    v = r.standard_normal((B, Sk, Hkv, Dv)).astype(np.float32)
    qp = np.ascontiguousarray(np.broadcast_to(np.arange(Sk - Sq, Sk),
                                              (B, Sq)), dtype=np.int32)
    kp = np.ascontiguousarray(np.broadcast_to(np.arange(Sk), (B, Sk)),
                              dtype=np.int32)
    return q, k, v, qp, kp


def _both(q, k, v, qp, kp, dt):
    jx = [jnp.asarray(a, JDT[dt]) for a in (q, k, v)] + [jnp.asarray(qp),
                                                        jnp.asarray(kp)]
    tx = [torch.from_numpy(a).to(TDT[dt]) for a in (q, k, v)] + [
        torch.from_numpy(qp), torch.from_numpy(kp)]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_matches_jax_flash_interpret(case):
    B, Sq, Sk, H, Hkv, Dk, Dv, causal, window, dt = case
    (jq, jk, jv, jqp, jkp), (tq, tk, tv, tqp, tkp) = _both(
        *_inputs(B, Sq, Sk, H, Hkv, Dk, Dv), dt)
    scale = 1.0 / np.sqrt(Dk)
    want = jflash(jq, jk, jv, scale=scale, q_pos=jqp, kv_pos=jkp,
                  causal=causal, window=window, block_q=64, block_k=64,
                  interpret=True)
    want_dense = jref.attention_dense(jq, jk, jv, scale=scale, q_pos=jqp,
                                      kv_pos=jkp, causal=causal,
                                      window=window)
    got = ref.attention(tq, tk, tv, scale=scale, q_pos=tqp, kv_pos=tkp,
                        causal=causal, window=window)
    assert got.dtype == TDT[dt] and got.shape == (B, Sq, H, Dv)
    _close(got.float().numpy(), np.asarray(want, np.float32), TOL[dt])
    _close(got.float().numpy(), np.asarray(want_dense, np.float32), TOL[dt])
    dense = ref.attention_dense(tq, tk, tv, scale=scale, q_pos=tqp,
                                kv_pos=tkp, causal=causal, window=window)
    _close(dense.float().numpy(), np.asarray(want_dense, np.float32),
           TOL[dt])


@pytest.mark.parametrize(("kv_chunk", "q_chunk"), [(32, 32), (48, 64),
                                                    (1024, 2048)])
def test_blocked_attention_matches_dense(kv_chunk, q_chunk):
    """The blocked plain version, whatever its chunks (ragged last KV
    chunk included), equals the quadratic one."""
    _, (q, k, v, qp, kp) = _both(*_inputs(2, 96, 96, 4, 2, 32, 32), "f32")
    want = ref.attention_dense(q, k, v, scale=0.18, q_pos=qp, kv_pos=kp)
    got = ref.attention(q, k, v, scale=0.18, q_pos=qp, kv_pos=kp,
                        kv_chunk=kv_chunk, q_chunk=q_chunk)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_masked_rows_and_keys_match_jax():
    """kv_pos = -1 keys add nothing and a query that sees no key returns
    0, in the port as in JAX's Pallas kernel."""
    q, k, v, qp, kp = _inputs(1, 64, 64, 4, 2, 32, 32, seed=3)
    kp = kp + 8                      # the first 8 queries see no key
    kp[:, ::5] = -1
    (jq, jk, jv, jqp, jkp), (tq, tk, tv, tqp, tkp) = _both(q, k, v, qp, kp,
                                                           "f32")
    want = jflash(jq, jk, jv, scale=0.2, q_pos=jqp, kv_pos=jkp,
                  block_q=32, block_k=32, interpret=True)
    got = ref.attention(tq, tk, tv, scale=0.2, q_pos=tqp, kv_pos=tkp)
    _close(got.numpy(), np.asarray(want), TOL["f32"])
    assert not got[:, :8].any()


def test_ops_attention_cpu_goes_to_plain_version():
    _, (q, k, v, qp, kp) = _both(*_inputs(1, 40, 40, 4, 2, 32, 32), "bf16")
    before = dict(launch.launches)
    got = ops.attention(q, k, v, scale=0.2, q_pos=qp, kv_pos=kp, window=16)
    want = ref.attention(q, k, v, scale=0.2, q_pos=qp, kv_pos=kp, window=16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert launch.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.attention(*(t.to("meta") for t in (q, k, v)), scale=0.2,
                      q_pos=qp.to("meta"), kv_pos=kp.to("meta"))


def test_flash_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels import flash_attention as fa
    _, (q, k, v, qp, kp) = _both(*_inputs(1, 16, 16, 2, 1, 32, 32), "f32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, k, v, scale=0.2, q_pos=qp, kv_pos=kp)


def test_jax_is_on_the_cpu():
    assert jax.default_backend() == "cpu"


def _positions(kind, B, Sq, Sk, seed=0):
    """``(q_pos, kv_pos)`` int32: queries at the last Sq positions, keys
    at ``arange`` with a quarter masked ("holes"), a random permutation
    per batch row ("shuffled"), or every key 5 positions after the first
    query ("late_keys")."""
    r = np.random.default_rng(seed)
    qp = np.broadcast_to(np.arange(Sk - Sq, Sk), (B, Sq)).astype(np.int32)
    kp = np.broadcast_to(np.arange(Sk), (B, Sk)).astype(np.int32).copy()
    if kind == "holes":
        kp[:, r.choice(Sk, Sk // 4, replace=False)] = -1
    elif kind == "shuffled":
        kp = np.stack([r.permutation(Sk) for _ in range(B)]).astype(np.int32)
    elif kind == "late_keys":
        kp += 5 + Sk - Sq
    return torch.from_numpy(np.ascontiguousarray(qp)), torch.from_numpy(kp)


# (B, Sq, Sk, causal, window, positions, bq, bk): the kernel's tiles
# (128 x 128) on holes, shuffled keys, a window cutting through tiles,
# ragged Sq and Sk, and smaller tiles
TILE_CASES = {
    "holes": (2, 256, 256, True, None, "holes", 128, 128),
    "shuffled": (2, 256, 384, True, None, "shuffled", 128, 128),
    "window100": (2, 384, 384, True, 100, "arange", 128, 128),
    "ragged333": (1, 333, 333, True, None, "arange", 128, 128),
    "noncausal_holes": (2, 200, 300, False, None, "holes", 128, 128),
    "late_keys": (2, 200, 200, True, None, "late_keys", 128, 128),
    "shuffled_window_small_tiles": (2, 100, 150, True, 40, "shuffled", 32,
                                    16),
    "sq64_sk2048_window": (1, 64, 2048, True, 300, "arange", 128, 128),
}


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tile_classes_are_sound(case):
    """A skipped tile holds no visible (query, key) pair and a full tile
    only visible pairs (rows past Sq and keys past Sk left out, no key
    past Sk in a full tile), against ``ref._block_mask``."""
    B, Sq, Sk, causal, window, kind, bq, bk = TILE_CASES[case]
    qp, kp = _positions(kind, B, Sq, Sk, seed=5)
    cls = ref.attention_tile_classes(qp, kp, causal, window, bq, bk)
    assert cls.shape == (B, -(-Sq // bq), -(-Sk // bk))
    mask = ref._block_mask(qp, kp, causal, window)
    seen = set()
    for b, i, j in np.ndindex(*cls.shape):
        blk = mask[b, i * bq:(i + 1) * bq, j * bk:(j + 1) * bk]
        c = int(cls[b, i, j])
        seen.add(c)
        if c == ref.TILE_SKIP:
            assert not blk.any(), (b, i, j)
        elif c == ref.TILE_FULL:
            assert blk.all() and (j + 1) * bk <= Sk, (b, i, j)
    assert ref.TILE_PARTIAL in seen


def test_tile_classes_at_the_prefill_shape():
    """Causal ``arange`` positions: tiles before the diagonal are full,
    the diagonal partial, the rest skipped (qwen3's 2048-token prefill)."""
    qp, kp = _positions("arange", 2, 2048, 2048)
    cls = ref.attention_tile_classes(qp, kp, True, None, 128, 128)
    i, j = np.indices((16, 16))
    want = np.where(j < i, ref.TILE_FULL,
                    np.where(j == i, ref.TILE_PARTIAL, ref.TILE_SKIP))
    assert (cls.numpy() == want[None]).all()
