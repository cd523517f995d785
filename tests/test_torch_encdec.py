"""The port's audio family (whisper-medium: a non-causal encoder over
stub frame embeddings, a causal decoder cross-attending to its output in
every layer, the gelu MLP) against the JAX package, on the CPU, at its
smoke config (2 encoder and 2 decoder layers, 30 frames).

The holding rules are in ``tests/torch_memory_models.py``: the same
weights (the attention projections scaled to ``1/sqrt(d)``), the same
prompts and stub, each step held on the same inputs within
``LOGIT_TOL``.  The encoder goes through the port's blocked attention
(``causal=False``, rope at ``arange(n_ctx)``), as JAX's ``gqa_forward``
goes through its ``ops.attention``; the decoder's cross-attention prefill
through the port's blocked attention, JAX's through ``_sdpa``.  The gelu
``mlp`` is held as ``tests/test_torch_serve.py::test_layers_match_jax``
holds the swiglu one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.registry import build_model as jax_build_model
from repro_torch import rng
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import model_params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import encdec, layers
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import generate, generate_scan
from torch_memory_models import (B, check_forward,
                                 check_generate_scan,
                                 check_prefill_and_decode, check_stub,
                                 conditioned, hold)
from torch_memory_models import CPU_DRAW_CHUNK, jax_init
from torch_memory_models import pair as make_pair

ARCH = "whisper-medium"


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return make_pair(ARCH, request.param)


def test_configs_match_jax():
    """The published and smoke configs read field for field as JAX's."""
    for t, j in ((get_config(ARCH), jax_get_config(ARCH)),
                 (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        for f in ("name", "family", "n_layers", "d_model", "d_ff",
                  "vocab_size", "act", "param_dtype", "compute_dtype",
                  "tie_embeddings", "norm_eps", "source"):
            assert getattr(t, f) == getattr(j, f), f
        assert vars(t.attn) == vars(j.attn)
        assert vars(t.encoder) == vars(j.encoder)
        assert t.vision is None and j.vision is None
        assert t.head_dim == j.head_dim


def test_modality_stub_matches_jax():
    got = check_stub(get_smoke_config(ARCH), jax_smoke_config(ARCH), 3)
    assert got["frames"].shape == (3, 30, 256)
    full = get_config(ARCH)
    assert full.encoder.n_ctx == 1500 and full.d_model == 1024


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype):
    """``mlp(..., act="gelu")`` (``jax.nn.gelu``'s tanh approximation)
    against JAX's: 2e-6 of scale in float32; in bfloat16 one bfloat16 step
    (2^-7) and what the rounded hidden layer (``x W_i`` and its gelu, each
    rounded: 2^-7 relative) carries into the output product."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = 2e-6 if dtype == "float32" else 2.0 ** -7
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = {"wi": 0.2 * rng.standard_normal((32, 48)).astype(np.float32),
         "wo": 0.2 * rng.standard_normal((48, 32)).astype(np.float32)}
    assert set(layers.mlp_spec(32, 48, "gelu")) == set(w)
    hidden = torch.nn.functional.gelu(torch.from_numpy(h @ w["wi"]),
                                      approximate="tanh")
    carried = 0.0 if dtype == "float32" else 2.0 ** -7 * float(
        (hidden.abs() @ torch.from_numpy(np.abs(w["wo"]))).max())
    want = np.asarray(jlayers.mlp({k: jnp.asarray(v) for k, v in w.items()},
                                  jnp.asarray(h, jdt), "gelu"), np.float32)
    got = layers.mlp({k: torch.from_numpy(v) for k, v in w.items()},
                     torch.from_numpy(h).to(tdt), act="gelu")
    assert got.dtype == tdt
    assert np.abs(got.float().numpy() - want).max() <= (
        tol * np.abs(want).max() + carried)


def test_cross_attn_matches_jax(pair):
    """``cross_attn_kv`` and ``cross_attn`` (a prefill of S queries and a
    one-token step) of the first decoder layer, on the model's weights,
    with unit-variance queries and memory (the encoder's output is
    rms-normed)."""
    jd, td = jnp.dtype(pair.compute), getattr(torch, pair.compute)
    jp = {k: v[0] for k, v in pair.jp["decoder"]["xattn"].items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 24, 256)).astype(np.float32)
    mem = rng.standard_normal((B, 30, 256)).astype(np.float32)
    jk, jv = jax.jit(jattn.cross_attn_kv)(jp, jnp.asarray(mem, jd))
    tk, tv = tattn.cross_attn_kv(tp, torch.from_numpy(mem).to(td))
    for g, w in ((tk, jk), (tv, jv)):
        assert g.dtype == td and g.shape == (B, 30, 4, 64)
        hold(g.float().numpy(), np.asarray(w, np.float32), pair.tol,
             "cross_attn_kv")
    cross_attn = jax.jit(jattn.cross_attn, static_argnums=1)
    for s in (24, 1):
        want = cross_attn(jp, pair.jcfg.attn, jnp.asarray(x[:, :s], jd),
                          (jk, jv))
        got = tattn.cross_attn(tp, pair.tcfg.attn,
                               torch.from_numpy(x[:, :s]).to(td), (tk, tv))
        assert got.dtype == td and got.shape == (B, s, 256)
        hold(got.float().numpy(), np.asarray(want, np.float32), pair.tol,
             ("cross_attn", s))


def test_encode_matches_jax(pair):
    """The encoder on the stub frames, in the compute dtype."""
    jd, td = jnp.dtype(pair.compute), getattr(torch, pair.compute)
    want = jax.jit(jencdec.encode, static_argnums=1)(
        pair.jp, pair.jcfg, jnp.asarray(pair.stub, jd))
    got = encdec.encode(pair.tm.params, pair.tcfg,
                        pair.tstub()["frames"].to(td))
    assert got.dtype == td and got.shape == (B, 30, 256)
    hold(got.float().numpy(), np.asarray(want, np.float32), pair.tol,
         "encode")


def test_forward_matches_jax(pair):
    check_forward(pair)


def test_prefill_and_decode_match_jax(pair):
    check_prefill_and_decode(pair)


def test_generate_scan_matches_jax(pair):
    check_generate_scan(pair, generate, generate_scan)


def test_cross_path_is_live():
    """The frames reach the logits, in both packages by as much."""
    pair = make_pair(ARCH, "float32")
    toks = torch.from_numpy(pair.toks)
    other = 0.1 * np.random.default_rng(9).standard_normal(
        pair.stub.shape).astype(np.float32)
    base = pair.tm(toks, **pair.tstub())[0]
    moved = pair.tm(toks, **pair.tstub(other))[0]
    change = float((moved - base).abs().max() / base.abs().max())
    forward = pair.jit(pair.jm, "forward")
    want = np.asarray(forward(pair.jp, pair.jbatch(pair.toks))[0])
    jother = dict(pair.jbatch(pair.toks), frames=jnp.asarray(other))
    jchange = np.abs(np.asarray(forward(pair.jp, jother)[0])
                     - want).max() / np.abs(want).max()
    assert change > 1e-2 and abs(change - jchange) <= 0.1 * jchange


def test_memory_is_required_and_cached():
    """A prefill or forward without ``frames`` raises; the caches are
    ``{"self": {k, v, pos}, "cross_k", "cross_v"}`` with the decoder
    layers leading, the cross K/V of every frame, and a decode step needs
    no memory."""
    m = make_pair(ARCH, "float32").tm
    toks = torch.zeros((2, 5), dtype=torch.long)
    cache = m.init_cache(2, 8)
    with pytest.raises(ValueError, match="frames"):
        m.prefill(toks, cache)
    with pytest.raises(ValueError, match="frames"):
        m(toks)
    assert cache["self"]["k"].shape == (2, 2, 8, 4, 64)
    assert cache["self"]["pos"].shape == (2, 2)
    assert cache["cross_k"].shape == cache["cross_v"].shape == (2, 2, 30, 4,
                                                                64)
    _, cache = m.prefill(toks, cache, frames=torch.ones((2, 30, 256)))
    assert bool((cache["self"]["pos"] == 5).all())
    assert cache["cross_v"].abs().max() > 0
    logits, cache = m.decode_step(toks[:, :1], cache)
    assert logits.shape == (2, 1, 512)
    assert bool((cache["self"]["pos"] == 6).all())


def test_model_params_from_jax_covers_every_path():
    """Every path of the encoder-decoder tree (``enc_pos``, the encoder's
    and the decoder's stacks, ``enc_norm``) carries across bit for bit."""
    jp = conditioned(jax_init(ARCH, 0))
    tm = model_params_from_jax(get_smoke_config(ARCH), jp, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    names = {".".join(k.key for k in path): leaf for path, leaf in flat}
    state = tm.state_dict()
    assert set(state) == set(names)
    for name in ("enc_pos", "enc_norm.scale", "encoder.ffn.wi",
                 "decoder.xattn.wk", "decoder.lnx.scale", "lm_head"):
        assert name in names, name
    for name, leaf in names.items():
        np.testing.assert_array_equal(state[name].numpy(), leaf)
    assert tm.n_params == sum(v.size for v in names.values())


def test_init_draws_match_jax(monkeypatch):
    """The port's own init draws JAX's weights to a few ulp (``enc_pos``
    a normal at 0.02, the rest truncated normals)."""
    monkeypatch.setattr(rng, "_CHUNK", CPU_DRAW_CHUNK)
    jp = jax_init(ARCH, 7)
    tm = build_model(get_smoke_config(ARCH), seed=7, device="cpu")
    state = tm.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        want = np.asarray(leaf)
        got = state[".".join(k.key for k in path)].numpy()
        assert np.abs(got - want).max() <= 4 * np.spacing(
            np.float32(np.abs(want).max()))
