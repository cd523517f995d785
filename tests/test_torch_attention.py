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
