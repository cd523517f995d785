"""The port's vlm family (llama-3.2-vision-11b: gated cross-attention
blocks over image embeddings every fifth layer) against the JAX package,
on the CPU, at its smoke config (10 layers in 2 groups, 17 image tokens).

The holding rules are in ``tests/torch_memory_models.py``: the same
weights (the attention projections scaled to ``1/sqrt(d)``, every
cross-attention gate at 0.5), the same prompts and stub, each step held
on the same inputs within ``LOGIT_TOL``.  ``cross_attn`` is held as a
module too: its prefill goes through the port's blocked attention
(float32 logits), JAX's through ``_sdpa`` (logits rounded to bfloat16 in
bfloat16), and its decode step through ``_sdpa`` in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models.registry import build_model as jax_build_model
from repro_torch import rng
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import model_params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import generate, generate_scan
from torch_memory_models import (B, check_forward,
                                 check_generate_scan,
                                 check_prefill_and_decode, check_stub,
                                 conditioned, hold, with_gate)
from torch_memory_models import CPU_DRAW_CHUNK, jax_init
from torch_memory_models import pair as make_pair

ARCH = "llama-3.2-vision-11b"


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
        assert vars(t.vision) == vars(j.vision)
        assert t.encoder is None and j.encoder is None
        assert t.head_dim == j.head_dim


def test_modality_stub_matches_jax():
    cfg = get_smoke_config(ARCH)
    got = check_stub(cfg, jax_smoke_config(ARCH), 3)
    assert got["image_embeds"].shape == (3, 17, 256)
    full = get_config(ARCH)
    assert full.vision.n_image_tokens == 1601 and full.d_model == 4096


def test_cross_attn_matches_jax(pair):
    """``cross_attn_kv`` and ``cross_attn`` (a prefill of S queries and a
    one-token step) of the first group's block, on the model's weights,
    a unit-variance query input and the stub as the memory."""
    jd, td = jnp.dtype(pair.compute), getattr(torch, pair.compute)
    jp = {k: v[0] for k, v in pair.jp["blocks"]["cross"]["xattn"].items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    x = np.random.default_rng(5).standard_normal((B, 24, 256)).astype(
        np.float32)
    jk, jv = jax.jit(jattn.cross_attn_kv)(jp, jnp.asarray(pair.stub, jd))
    tk, tv = tattn.cross_attn_kv(tp, pair.tstub()[pair.name].to(td))
    for g, w in ((tk, jk), (tv, jv)):
        assert g.dtype == td and g.shape == (B, 17, 2, 64)
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


def test_forward_matches_jax(pair):
    check_forward(pair)


def test_prefill_and_decode_match_jax(pair):
    check_prefill_and_decode(pair)


def test_generate_scan_matches_jax(pair):
    check_generate_scan(pair, generate, generate_scan)


def test_cross_path_is_live():
    """With a nonzero gate the image embeddings reach the logits (in both
    packages, by as much); at the init's zero gate they do not."""
    pair = make_pair(ARCH, "float32")
    toks = torch.from_numpy(pair.toks)
    other = 0.1 * np.random.default_rng(9).standard_normal(
        pair.stub.shape).astype(np.float32)
    base = pair.tm(toks, **pair.tstub())[0]
    moved = pair.tm(toks, **pair.tstub(other))[0]
    change = float((moved - base).abs().max() / base.abs().max())
    forward = pair.jit(pair.jm, "forward")
    want = np.asarray(forward(pair.jp, pair.jbatch(pair.toks))[0])
    jother = dict(pair.jbatch(pair.toks), image_embeds=jnp.asarray(other))
    jchange = np.abs(np.asarray(forward(pair.jp, jother)[0])
                     - want).max() / np.abs(want).max()
    assert change > 1e-2 and abs(change - jchange) <= 0.1 * jchange
    shut = model_params_from_jax(pair.tcfg, with_gate(pair.jp, 0.0),
                                 device="cpu")
    assert torch.equal(shut(toks, **pair.tstub())[0],
                       shut(toks, **pair.tstub(other))[0])


def test_memory_is_required_and_cached():
    """A prefill or forward without ``image_embeds`` raises; the caches
    are ``{"self": {k, v, pos}, "cross_k", "cross_v"}`` with the groups
    (and, under ``self``, the self blocks) leading, and a decode step
    needs no memory."""
    m = make_pair(ARCH, "float32").tm
    toks = torch.zeros((2, 5), dtype=torch.long)
    cache = m.init_cache(2, 8)
    with pytest.raises(ValueError, match="image_embeds"):
        m.prefill(toks, cache)
    with pytest.raises(ValueError, match="image_embeds"):
        m(toks)
    assert cache["self"]["k"].shape == (2, 4, 2, 8, 2, 64)
    assert cache["self"]["pos"].shape == (2, 4, 2)
    assert cache["cross_k"].shape == cache["cross_v"].shape == (2, 2, 17, 2,
                                                                64)
    stub = torch.ones((2, 17, 256))
    _, cache = m.prefill(toks, cache, image_embeds=stub)
    assert bool((cache["self"]["pos"] == 5).all())
    assert cache["cross_k"].abs().max() > 0
    logits, cache = m.decode_step(toks[:, :1], cache)
    assert logits.shape == (2, 1, 512)
    assert bool((cache["self"]["pos"] == 6).all())


def test_model_params_from_jax_covers_every_path():
    """Every path of the VLM tree (the groups' self blocks and the cross
    block's ``gate``) carries across bit for bit."""
    jp = with_gate(conditioned(jax_init(ARCH, 0)))
    tm = model_params_from_jax(get_smoke_config(ARCH), jp, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    names = {".".join(k.key for k in path): leaf for path, leaf in flat}
    state = tm.state_dict()
    assert set(state) == set(names)
    assert "blocks.cross.gate" in names and "blocks.self.attn.wq" in names
    assert state["blocks.cross.gate"].shape == (2, 1)
    for name, leaf in names.items():
        np.testing.assert_array_equal(state[name].numpy(), leaf)
    assert tm.n_params == sum(v.size for v in names.values())


def test_init_draws_match_jax(monkeypatch):
    """The port's own init draws JAX's weights to a few ulp, the zero
    gates included."""
    monkeypatch.setattr(rng, "_CHUNK", CPU_DRAW_CHUNK)
    jp = jax_init(ARCH, 7)
    tm = build_model(get_smoke_config(ARCH), seed=7, device="cpu")
    state = tm.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        want = np.asarray(leaf)
        got = state[".".join(k.key for k in path)].numpy()
        assert np.abs(got - want).max() <= 4 * np.spacing(
            np.float32(np.abs(want).max()))
    assert not state["blocks.cross.gate"].any()
