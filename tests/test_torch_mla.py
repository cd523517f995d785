"""The port's MLA (``repro_torch.models.attention``, DeepSeek-V2 latent
attention) against the JAX package's, on the CPU.

The same parameters (JAX's ``init_params`` of ``mla_spec``) and inputs
(numpy, from a seed) go through ``mla_forward``, the prefill (the port's
``mla_prefill`` against JAX's ``mla_prefill_cache`` and ``mla_forward``)
and ``mla_decode`` of both packages.  JAX's attention runs as
``tests/test_torch_attention.py`` runs it: its ``ops.attention`` on the
CPU (``ref.attention``), and its Pallas kernel in interpret mode for one
case; the port's ``ops.attention`` takes its plain version on the CPU.
The configs are deepseek-v2-lite's smoke heads (Dk = 64 + 16 = 80,
Dv = 64), a sliding window over them, and the published heads (512
latent, 128 + 64 query, 128 value: Dk = 576, Dv = 512) at d = 64.
Tolerances, of each output's largest magnitude:

- float32: 2e-5 (the same products in another order; the latent norm's
  ``rsqrt`` and the rope's ``cos``/``sin`` one rounding apart);
- bfloat16: 2e-2, as the serving tests' logits: both round every product
  to bfloat16 at the same points, but XLA keeps float32 inside a fused
  chain where torch rounds per op, so a value may land one bfloat16 step
  (2^-8) away, and five products in a row carry a few such steps.

The caches (``ckv``, ``krope``, ``pos``) are held at the same tolerances
and the positions exactly.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttnConfig as JAttnConfig
from repro.configs.base import MLAConfig as JMLAConfig
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models.params import init_params as jinit
from repro_torch.configs import AttnConfig, MLAConfig
from repro_torch.kernels import launch
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
D = 64
SMOKE = dict(n_heads=4, n_kv_heads=4, head_dim=32, rope_theta=1e4)
SMOKE_MLA = dict(kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                 v_head_dim=32)
FULL_MLA = dict(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                v_head_dim=128)
CASES = {"smoke": (SMOKE, SMOKE_MLA, None),
         "smoke_window": (SMOKE, SMOKE_MLA, 16),
         "published_heads": (dict(SMOKE, n_heads=2, n_kv_heads=2), FULL_MLA,
                             None)}


def _cfgs(case):
    attn, mla, window = CASES[case]
    return (JAttnConfig(**attn, window=window, mla=JMLAConfig(**mla)),
            AttnConfig(**attn, window=window, mla=MLAConfig(**mla)))


def _setup(case, dtype, B=2, S=24, seed=0):
    ja, ta = _cfgs(case)
    p = jax.tree.map(np.asarray, jinit(jattn.mla_spec(ja, D),
                                       jax.random.PRNGKey(seed)))
    # the latent norm's scale away from 1, so it is exercised
    p["kv_norm"] = (1 + 0.1 * np.random.default_rng(seed).standard_normal(
        p["kv_norm"].shape)).astype(np.float32)
    x = np.random.default_rng(seed + 1).standard_normal((B, S, D)).astype(
        np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return ja, ta, jp, tp, jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _positions(B, S):
    return np.ascontiguousarray(np.broadcast_to(np.arange(S, dtype=np.int32),
                                                (B, S)))


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


@contextlib.contextmanager
def _jax_backend(name):
    old = jops._BACKEND
    jops.set_backend(name)
    try:
        yield
    finally:
        jops.set_backend(old)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_mla_forward_matches_jax(case, dtype):
    ja, ta, jp, tp, jx, tx = _setup(case, dtype)
    pos = _positions(*jx.shape[:2])
    want = jattn.mla_forward(jp, ja, jx, jnp.asarray(pos))
    launch.reset_launches()
    got = tattn.mla_forward(tp, ta, tx, torch.from_numpy(pos))
    assert not any(launch.launches.values())     # the plain version on CPU
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, TOL[dtype], "mla_forward")


def test_mla_forward_matches_jax_pallas_interpret():
    """JAX's MLA through its Pallas flash attention (interpret mode), at
    the published heads (Dk = 576, Dv = 512), in float32."""
    ja, ta, jp, tp, jx, tx = _setup("published_heads", "float32", S=64)
    pos = _positions(*jx.shape[:2])
    with _jax_backend("pallas_interpret"):
        want = jattn.mla_forward(jp, ja, jx, jnp.asarray(pos))
    got = tattn.mla_forward(tp, ta, tx, torch.from_numpy(pos))
    _close(got, want, TOL["float32"], "mla_forward (pallas interpret)")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_mla_prefill_and_decode_match_jax(case, dtype):
    """The port's ``mla_prefill`` (its output against JAX's
    ``mla_forward``, its cache against JAX's ``mla_prefill_cache``) then 5
    ``mla_decode`` steps against JAX's: the caches after each step, and
    each step's output.  The ring holds 20 slots, so a windowed case
    (window 16) wraps it."""
    ja, ta, jp, tp, jx, tx = _setup(case, dtype, S=17)
    B, S = jx.shape[:2]
    max_len = 20 if ja.window else S + 5
    pos = _positions(B, S)
    jc = jattn.mla_prefill_cache(jp, ja, jx, jnp.asarray(pos),
                                 jattn.mla_init_cache(ja, B, max_len,
                                                      jx.dtype))
    out, tc = tattn.mla_prefill(tp, ta, tx, torch.from_numpy(pos),
                                tattn.mla_init_cache(ta, B, max_len,
                                                     tx.dtype, "cpu"))
    assert out.shape == tx.shape and out.dtype == tx.dtype
    _close(out, jattn.mla_forward(jp, ja, jx, jnp.asarray(pos)), TOL[dtype],
           "mla_prefill")
    r = np.random.default_rng(7)
    for step in range(5):
        for k in ("ckv", "krope"):
            _close(tc[k], jc[k], TOL[dtype], f"cache {k}, step {step}")
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        xs = r.standard_normal((B, 1, D)).astype(np.float32)
        want, jc = jattn.mla_decode(jp, ja, jnp.asarray(xs, jx.dtype), jc)
        got, tc = tattn.mla_decode(tp, ta, torch.from_numpy(xs).to(tx.dtype),
                                   tc)
        assert got.shape == (B, 1, D) and got.dtype == tx.dtype
        _close(got, want, TOL[dtype], f"mla_decode, step {step}")


@pytest.mark.parametrize(("Dk", "Dv"), [(576, 512), (80, 64), (80, 80)])
def test_ops_attention_takes_the_new_head_sizes_on_the_cpu(Dk, Dv):
    """``ops.attention`` at MLA's (576, 512), its smoke config's (80, 64)
    and stablelm-3b's (80, 80) goes to the plain version on the CPU (no
    launch) and equals ``ref.attention``."""
    from repro_torch.kernels import ref
    r = np.random.default_rng(Dk + Dv)
    B, S, H, Hkv = 1, 40, 4, 1 if Dk == 576 else 4
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
               for s in ((B, S, H, Dk), (B, S, Hkv, Dk), (B, S, Hkv, Dv)))
    pos = torch.from_numpy(np.array(_positions(B, S)))
    kw = dict(scale=Dk ** -0.5, q_pos=pos, kv_pos=pos, causal=True)
    launch.reset_launches()
    got = tops.attention(q, k, v, **kw)
    assert not any(launch.launches.values())
    assert torch.equal(got, ref.attention(q, k, v, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_blocked_passes_v_as_a_view_of_k(dtype, monkeypatch):
    """``_mla_blocked`` hands ``ops.attention`` the value as the key's
    first 512 columns (the same storage and strides, which the MLA kernel
    reads from its K tiles), and ``mla_forward`` still matches JAX's at
    the published heads."""
    seen = []
    attention = tops.attention

    def spy(q, k, v, **kw):
        seen.append((k, v))
        return attention(q, k, v, **kw)

    monkeypatch.setattr(tattn.ops, "attention", spy)
    ja, ta, jp, tp, jx, tx = _setup("published_heads", dtype)
    pos = _positions(*jx.shape[:2])
    got = tattn.mla_forward(tp, ta, tx, torch.from_numpy(pos))
    (k, v), = seen
    assert (k.shape[-1], v.shape[-1]) == (576, 512)
    assert v.data_ptr() == k.data_ptr() and v.stride() == k.stride()
    assert torch.equal(v, k[..., :512])
    want = jattn.mla_forward(jp, ja, jx, jnp.asarray(pos))
    _close(got, want, TOL[dtype], "mla_forward (v a view of k)")
