"""The port's serving path (the dense qwen3-0.6b, llama3-8b, qwen3-4b and
stablelm-3b, the moe deepseek-v2-lite-16b (MLA, 2 shared experts) and
qwen3-moe-30b-a3b, and the ssm mamba2-130m) against the JAX package, on
the CPU, at their smoke configs.

JAX's ``build_model(cfg).init(PRNGKey(1))`` weights are carried across
(``convert.model_params_from_jax``), so both packages serve the very same
model.  Prompts come from ``token_batch``, bit-equal in both.  Tolerances:

- float32 compute (as ``tests/test_serve.py::_f32_cfg``): logits within
  1e-4 of their largest magnitude, greedy tokens equal;
- the configs' own bfloat16 compute: logits within 2e-2 of their largest
  magnitude.  Both packages round to bfloat16 at the same points, but
  XLA keeps float32 within a fused chain of bfloat16 ops where torch
  rounds after each op, so a value can land one bfloat16 step (2^-8
  relative) away; two layers carry a few such steps (observed: 0.6 %).
  Tokens must be equal wherever JAX's top-2 margin is wider than that.
- every step is held on the same inputs: the prefill is, and each decode
  step of JAX runs a second time from the port's own cache.  The port's
  cache stays within the tolerance of JAX's at every step.  In bfloat16
  a step's logits are held within the tolerance plus twice what the step
  makes of its own rounding (JAX's bfloat16 distance from JAX's float32
  run of the same step on the same inputs), which stays under the
  tolerance but in llama3-8b and stablelm-3b
  (`test_prefill_and_decode_match_jax`).
- the moe archs: a router near tie is a rounding decision, so each MoE
  layer's routing (``eidx``) is recorded in both packages (the port's
  ``moe.recording``, JAX's through an ordered ``jax.debug.callback`` on
  its ``moe_forward``) and compared first.  Logits are held in the
  sequences whose routing agreed at that step; each flip must be a near
  tie (JAX's logit margin at the first differing rank within the logit
  tolerance of the token's ``|x| @ |W_router|``), and at most
  ``FLIP_SHARE`` of the (step, sequence) pairs may be let go (1 of 10 in
  each moe arch in bfloat16).  A generated token may differ after a
  routing flip in its sequence.
- the layers (``rmsnorm``, ``head_rmsnorm``, ``rope``, ``mlp``): 2e-6 of
  scale in float32 (one rounding of the norms' mean and ``rsqrt``, and
  of ``rope``'s ``pow``/``cos``/``sin``); in bfloat16, one bfloat16 step
  (2^-7 of scale: both round once from float32 values an ulp apart), and
  for ``mlp`` also what its bfloat16 hidden layer carries into the output
  product: ``g``, ``u``, ``silu(g)`` and ``silu(g)·u`` are each rounded
  (2^-6 relative in all), so ``h @ wo`` may move by 2^-6 of
  ``|h| @ |wo|``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.params import init_params as jax_init_params
from repro.data.synthetic import TokenGenConfig as JTokenGenConfig
from repro.data.synthetic import token_batch as jax_token_batch
from repro.models import layers as jlayers
from repro.models.registry import build_model as jax_build_model
from repro.serve.decode import generate as jax_generate
from repro.serve.decode import generate_scan as jax_generate_scan
from repro_torch import rng
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.convert import model_params_from_jax
from repro_torch.data.synthetic import TokenGenConfig, token_batch
from repro_torch.kernels import launch
from repro_torch.launch import serve
from repro_torch.models import layers, moe
from repro_torch.models.params import init_params, param_count
from repro_torch.models.registry import FAMILIES, build_model, model_specs
from repro_torch.serve.decode import generate, generate_scan
from torch_memory_models import CPU_DRAW_CHUNK
from torch_routing import RoutingTap, jax_routing_tap  # noqa: F401

MOE = ("deepseek-v2-lite-16b", "qwen3-moe-30b-a3b")
SERVED = ("qwen3-0.6b", "mamba2-130m", "llama3-8b", "qwen3-4b",
          "stablelm-3b", *MOE)
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLIP_SHARE = 0.2
B, S, NEW = 2, 40, 6

@pytest.fixture(scope="module", params=[(a, c) for a in SERVED
                                        for c in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """(JAX model, JAX params, port model, prompts) for one arch and one
    compute dtype, on the same weights."""
    arch, compute = request.param
    jcfg = jax_smoke_config(arch).replace(compute_dtype=compute)
    tcfg = get_smoke_config(arch).replace(compute_dtype=compute)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
    toks = np.asarray(jax_token_batch(JTokenGenConfig(
        vocab_size=jcfg.vocab_size, seq_len=S, batch=B, seed=3), 0))
    return arch, compute, jm, jp, tm, toks


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max()), want


def _to_jax(cache, dtype=None):
    """A copy of the port's cache as JAX arrays, of their own dtype (bit for
    bit) or, for the floats, of ``dtype``; the port updates its cache in
    place, so nothing is shared."""
    def one(v):
        if not v.is_floating_point():
            return jnp.array(v.numpy(), copy=True)
        return jnp.array(v.float().numpy(), copy=True).astype(
            dtype or jnp.dtype(str(v.dtype).split(".")[1]))
    return {k: one(v) for k, v in cache.items()}


def _clear(want, tol):
    """Rows whose top-2 margin is wider than ``tol`` of the scale."""
    want = np.asarray(want, np.float32)
    top = np.sort(want[:, -1], axis=-1)
    return (top[:, -1] - top[:, -2]) > tol * np.abs(want).max()


def _rows(a, b, scale):
    """Each row's largest distance between ``a`` and ``b`` [B, 1, V], of
    ``scale``."""
    a, b = (v.float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, np.float32) for v in (a, b))
    return np.abs(a - b).max(axis=(1, 2)) / scale


def test_prefill_and_decode_match_jax(pair):
    """Prefill logits and 4 greedy decode steps, each held on the same
    inputs: the prefill is, and each decode step of JAX runs again from
    the port's own cache (fed the token of JAX's free-running run).  At
    every step the port's updated cache lies within the tolerance of
    JAX's, its logits within ``bound`` of JAX's, and its greedy token is
    JAX's wherever JAX's top-2 margin is wider than ``bound``.

    float32: ``bound`` is the tolerance.  bfloat16: JAX's step also runs
    in float32 on the same inputs, and ``d``, JAX's bfloat16 distance from
    it, is what the step makes of its own rounding; ``bound`` is the
    tolerance plus ``2 d`` (the two packages each lie about ``d`` from the
    float32 step).  ``d`` stays under the tolerance but in the archs
    without qk-norm (llama3-8b, stablelm-3b), whose steps amplify a
    rounding at random init (llama3-8b's first decode step: ``d`` 2.7 %,
    the port 3.4 % from JAX).  In the moe archs ``d`` counts only where
    JAX's float32 routing is its bfloat16 one (a different routing is not
    a rounding).

    The free-running distance (each package on its own cache) is held
    within ``bound`` plus the distance between JAX's two runs, what the
    caches' difference makes of the step.  In the moe archs the sequences
    whose routing flipped at a step (the port against JAX on the same
    inputs; every flip a near tie) are not held at that step, and at most
    ``FLIP_SHARE`` of the (step, sequence) pairs are let go."""
    arch, compute, jm, jp, tm, toks = pair
    tol = LOGIT_TOL[compute]
    bf16 = compute == "bfloat16"
    batch = {"tokens": jnp.asarray(toks)}
    jcache = jm.init_cache(B, S + NEW)
    with RoutingTap() as tap:
        lj, jcache = jax.jit(jm.prefill)(jp, batch, jcache)
        lt, tcache = tm.prefill(torch.from_numpy(toks),
                                tm.init_cache(B, S + NEW))
    same, same_cache = lj, jcache
    if bf16:
        jm32 = jax_build_model(jm.cfg.replace(compute_dtype="float32"))
        decode32 = jax.jit(jm32.decode_step)
        with RoutingTap() as tap32:
            exact, _ = jax.jit(jm32.prefill)(jp, batch,
                                             jm32.init_cache(B, S + NEW))
    decode = jax.jit(jm.decode_step)
    let_go = 0
    for step in range(5):
        held = tap.agreement(tol)
        if arch not in MOE:
            assert held.all() and not tap.jax
        let_go += int((~held).sum())
        for k, v in tcache.items():
            w = np.asarray(same_cache[k], np.float32)[:, held]
            g = v[:, held].float().numpy()
            assert np.abs(g - w).max() <= tol * np.abs(w).max(), (k, step)
        want = np.asarray(same, np.float32)
        scale = np.abs(want[held]).max()
        bound = np.full(B, tol)
        if bf16:
            routed = (moe.routing_agreement(tap32.jax, tap.jax, tol)[0]
                      .numpy() if tap.jax else np.ones(B, bool))
            bound += np.where(routed, 2 * _rows(same, exact, scale), 0.0)
        err = _rows(lt, same, scale)
        assert (err <= bound)[held].all(), (arch, compute, step, err, bound)
        free = _rows(lt, lj, scale)
        moved = _rows(lj, same, scale)
        assert (free <= bound + moved)[held].all(), (step, free, moved)
        top = np.sort(want[:, -1], axis=-1)
        clear = held & (top[:, -1] - top[:, -2] > bound * scale)
        np.testing.assert_array_equal(lt[:, -1].float().argmax(-1)[clear],
                                      want[:, -1].argmax(-1)[clear])
        if not bf16:
            assert clear.all()
        if step == 4:
            break
        nxt = jnp.argmax(lj[:, -1], axis=-1).astype(jnp.int32)[:, None]
        port_cache = _to_jax(tcache)
        if bf16:
            with RoutingTap() as tap32:
                exact, _ = decode32(jp, {"tokens": nxt},
                                    _to_jax(tcache, jnp.float32))
        lj, jcache = decode(jp, {"tokens": nxt}, jcache)
        with RoutingTap() as tap:
            same, same_cache = decode(jp, {"tokens": nxt}, port_cache)
            lt, tcache = tm.decode_step(
                torch.from_numpy(np.array(nxt)).long(), tcache)
    assert let_go <= FLIP_SHARE * 5 * B, (arch, compute, let_go)


def _flipped_before(tap, row, t, n_layers):
    """Whether sequence ``row``'s routing flipped in the prefill or the
    decode steps that produced its tokens 0..t (``n_layers`` calls each)."""
    if not tap.jax:
        return False
    return not tap.agreement(2e-2, slice(0, (t + 1) * n_layers))[row]


def test_generate_scan_matches_jax(pair):
    arch, compute, jm, jp, tm, toks = pair
    with RoutingTap() as tap:
        want = np.asarray(jax_generate_scan(jm, jp, jnp.asarray(toks), NEW))
        got = generate_scan(tm, torch.from_numpy(toks), NEW)
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(generate(tm, torch.from_numpy(toks), NEW),
                                  got)
    if compute == "float32":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    # bfloat16: up to each row's first differing token, equal; there JAX's
    # own top-2 margin must be within the tolerance, or the row's routing
    # flipped (a near tie) on the way there
    differ = got.numpy() != want
    for row in np.flatnonzero(differ.any(axis=1)):
        t = int(np.argmax(differ[row]))
        if _flipped_before(tap, row, t, tm.cfg.n_layers):
            continue
        ctx = np.concatenate([toks[row], want[row, :t]])[None]
        logits, _ = jm.forward(jp, {"tokens": jnp.asarray(ctx)})
        assert not _clear(np.asarray(logits, np.float32)[:, -1:],
                          LOGIT_TOL[compute]).any(), (arch, row, t)


@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_generate_at_temperature_matches_jax(pair, temperature):
    """Sampling draws JAX's key stream through ``rng.categorical``, with
    noise in the logits' dtype.  float32: tokens equal.  bfloat16: each
    row equal up to its first differing token, and there JAX's own top-2
    margin of ``logits / T + gumbel`` is within what the logit tolerance
    (over T) and a bfloat16 rounding of each noisy value can move."""
    arch, compute, jm, jp, tm, toks = pair
    with RoutingTap() as tap:
        want = np.asarray(jax_generate(jm, jp, jnp.asarray(toks), NEW,
                                       temperature=temperature,
                                       rng=jax.random.PRNGKey(5)))
        got = generate(tm, torch.from_numpy(toks), NEW,
                       temperature=temperature, rng=rng.PRNGKey(5))
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    if compute == "float32":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    rest, k0 = jax.random.split(jax.random.PRNGKey(5))
    keys = [k0, *jax.random.split(rest, NEW)[:-1]]
    dtype = jnp.bfloat16
    differ = got.numpy() != want
    for row in np.flatnonzero(differ.any(axis=1)):
        t = int(np.argmax(differ[row]))
        if _flipped_before(tap, row, t, tm.cfg.n_layers):
            continue
        ctx = np.concatenate([toks, want[:, :t]], axis=1)
        logits, _ = jm.forward(jp, {"tokens": jnp.asarray(ctx)})
        last = logits[:, -1].astype(dtype)
        noisy = np.asarray(
            (last / temperature + jax.random.gumbel(
                keys[t], last.shape, dtype)).astype(jnp.float32))[row]
        top = np.sort(noisy)
        scale = np.abs(np.asarray(last, np.float32)).max()
        near = (2 * LOGIT_TOL[compute] * scale / temperature
                + 2 * 2.0 ** -8 * np.abs(top).max())
        assert top[-1] - top[-2] <= near, (arch, row, t)


@pytest.mark.parametrize("arch", SERVED)
def test_forward_matches_jax(arch):
    jcfg = jax_smoke_config(arch).replace(compute_dtype="float32")
    tcfg = get_smoke_config(arch).replace(compute_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(4))
    tm = model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 37),
                                             dtype=np.int32)
    with RoutingTap() as tap:
        want, want_aux = jax.jit(jm.forward)(jp,
                                             {"tokens": jnp.asarray(toks)})
        got, aux = tm(torch.from_numpy(toks))
    assert tap.agreement(LOGIT_TOL["float32"]).all()
    if arch in MOE:     # the MoE layers' load-balance losses, summed
        assert aux.dtype == torch.float32 and aux.dim() == 0
        assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)
    else:
        assert aux == 0.0
    err, _ = _rel(got, want)
    assert err <= LOGIT_TOL["float32"]


@pytest.mark.parametrize("arch", SERVED)
def test_model_params_from_jax_covers_every_path(arch):
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    jp = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    tm = model_params_from_jax(cfg, jp, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    names = {".".join(k.key for k in path): leaf for path, leaf in flat}
    state = tm.state_dict()
    assert set(state) == set(names)
    for name, leaf in names.items():
        np.testing.assert_array_equal(state[name].numpy(), leaf)
    assert tm.n_params == sum(v.size for v in names.values())
    missing = dict(jp, final_norm={})
    with pytest.raises(ValueError, match="missing"):
        model_params_from_jax(cfg, missing, device="cpu")
    extra = dict(jp, unused={"scale": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="left over"):
        model_params_from_jax(cfg, extra, device="cpu")
    bad = dict(jp, final_norm={"scale": np.ones(cfg.d_model + 1,
                                                np.float32)})
    with pytest.raises(ValueError, match="shape"):
        model_params_from_jax(cfg, bad, device="cpu")


@pytest.mark.parametrize("arch", SERVED)
def test_init_draws_match_jax(arch, monkeypatch):
    """The port's own init draws JAX's weights to a few ulp (truncated
    normals through the port's threefry and erfinv)."""
    monkeypatch.setattr(rng, "_CHUNK", CPU_DRAW_CHUNK)
    jp = jax_build_model(jax_smoke_config(arch)).init(jax.random.PRNGKey(7))
    tm = build_model(get_smoke_config(arch), seed=7, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    state = tm.state_dict()
    for path, leaf in flat:
        want = np.asarray(leaf)
        got = state[".".join(k.key for k in path)].numpy()
        assert np.abs(got - want).max() <= 4 * np.spacing(
            np.float32(np.abs(want).max()))


@pytest.mark.parametrize(("V", "S_", "B_", "seed", "step"),
                         [(512, 40, 3, 0, 0), (151936, 2048, 2, 1, 3),
                          (50, 17, 4, 5, 1), (50280, 1, 2, 2, 0)])
def test_token_batch_bit_equal(V, S_, B_, seed, step):
    want = np.asarray(jax_token_batch(JTokenGenConfig(
        vocab_size=V, seq_len=S_, batch=B_, seed=seed), step))
    got = token_batch(TokenGenConfig(vocab_size=V, seq_len=S_, batch=B_,
                                     seed=seed), step, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _layer_inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = 2e-6 if dtype == "float32" else 2.0 ** -7

    def close(got, want, carried=0.0):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= (
            tol * np.abs(want).max() + carried)

    x = _layer_inputs((2, 7, 4, 64), 0)
    scale = 1 + 0.1 * _layer_inputs((64,), 1)
    close(layers.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(x).to(tdt)),
          jlayers.rmsnorm({"scale": jnp.asarray(scale)},
                          jnp.asarray(x, jdt)))
    close(layers.head_rmsnorm(torch.from_numpy(scale),
                              torch.from_numpy(x).to(tdt)),
          jlayers.head_rmsnorm(jnp.asarray(scale), jnp.asarray(x, jdt)))
    pos = np.arange(3, 10, dtype=np.int32)[None].repeat(2, 0)
    for theta in (1e4, 1e6):
        close(layers.rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
                          theta),
              jlayers.rope(jnp.asarray(x, jdt), jnp.asarray(pos), theta))
    h = _layer_inputs((2, 5, 32), 2)
    w = {k: 0.2 * _layer_inputs(s, i) for i, (k, s) in enumerate(
        (("wi_gate", (32, 48)), ("wi_up", (32, 48)), ("wo", (48, 32))))}
    hidden = torch.nn.functional.silu(torch.from_numpy(h @ w["wi_gate"])) \
        * torch.from_numpy(h @ w["wi_up"])
    carried = 0.0 if dtype == "float32" else 2.0 ** -6 * float(
        (hidden.abs() @ torch.from_numpy(np.abs(w["wo"]))).max())
    close(layers.mlp({k: torch.from_numpy(v) for k, v in w.items()},
                     torch.from_numpy(h).to(tdt)),
          jlayers.mlp({k: jnp.asarray(v) for k, v in w.items()},
                      jnp.asarray(h, jdt)), carried)


def test_serve_cli_runs_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(rng, "_CHUNK", CPU_DRAW_CHUNK)
    for arch in SERVED:
        launch.reset_launches()
        out = serve.main(["--arch", arch, "--batch", "2", "--prompt-len",
                          "20", "--new", "4", "--device", "cpu"])
        assert out.shape == (2, 4) and out.dtype == torch.int32
        # the CPU path runs the plain versions: no kernel launch
        assert not any(launch.launches.values())
    assert "tok/s" in capsys.readouterr().out


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-130m", "--new", "2"])


def test_only_ported_archs_are_served():
    """The port serves every arch of the JAX package: the text archs of
    this file, the vlm, audio and hybrid archs (their own files:
    tests/test_torch_vlm.py, tests/test_torch_encdec.py,
    tests/test_torch_hybrid.py, each of which builds its model).
    ``model_specs`` takes every family of the JAX package and counts its
    parameters as JAX does; an unknown arch or family raises."""
    from repro.configs import ARCHS as JAX_ARCHS
    others = {"llama-3.2-vision-11b": "vlm", "whisper-medium": "audio",
              "jamba-1.5-large-398b": "hybrid"}
    assert set(ARCHS) == set(JAX_ARCHS) == set(SERVED) | set(others)
    assert {jax_smoke_config(a).family for a in JAX_ARCHS} == set(FAMILIES)
    for arch in ARCHS:
        assert get_config(arch).n_layers > get_smoke_config(arch).n_layers
        cfg = get_smoke_config(arch)
        assert cfg.family == jax_smoke_config(arch).family
        assert param_count(model_specs(cfg)) == jax_build_model(
            jax_smoke_config(arch)).n_params
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")
    cfg = get_smoke_config("qwen3-0.6b")
    with pytest.raises(NotImplementedError, match="not a family"):
        model_specs(cfg.replace(family="rnn"))
    for arch, family in others.items():
        assert get_smoke_config(arch).family == family


@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_match_jax(arch):
    """The published and smoke configs read field for field as JAX's."""
    from repro.configs import get_config as jax_get_config
    for t, j in ((get_config(arch), jax_get_config(arch)),
                 (get_smoke_config(arch), jax_smoke_config(arch))):
        for sub in ("attn", "moe"):
            tv, jv = getattr(t, sub), getattr(j, sub)
            assert {k: v for k, v in vars(tv).items() if k != "mla"} == {
                k: v for k, v in vars(jv).items() if k != "mla"}
        assert (t.attn.mla is None) == (j.attn.mla is None)
        if t.attn.mla is not None:
            assert vars(t.attn.mla) == vars(j.attn.mla)
        for f in ("n_layers", "d_model", "d_ff", "vocab_size", "family",
                  "param_dtype", "compute_dtype", "tie_embeddings"):
            assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("arch", MOE)
def test_model_params_from_jax_keeps_the_router_float32(arch):
    """At the published param dtype (bfloat16) every leaf but the router
    is bfloat16, in both packages, and carries across bit for bit."""
    jcfg = jax_smoke_config(arch).replace(param_dtype="bfloat16")
    cfg = get_smoke_config(arch).replace(param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(2)))
    tm = model_params_from_jax(cfg, jp, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    state = tm.state_dict()
    for path, leaf in flat:
        name = ".".join(k.key for k in path)
        want_dt = torch.float32 if name.endswith("router") else torch.bfloat16
        assert str(leaf.dtype) == str(want_dt).split(".")[1], name
        assert state[name].dtype == want_dt, name
        np.testing.assert_array_equal(state[name].float().numpy(),
                                      leaf.astype(np.float32))


def test_chunked_init_is_bit_equal_to_the_whole_leaf_cast(monkeypatch):
    """A bfloat16 leaf drawn and rounded a chunk at a time equals the
    whole float32 draw, scaled and cast (the rounding works element by
    element), for chunks that split the leaf unevenly."""
    key = rng.fold_in(rng.PRNGKey(3), 11)
    shape, std = (3, 70, 50), 0.05
    whole = (std * rng.truncated_normal(key, -2.0, 2.0, shape)).to(
        torch.bfloat16)
    whole_normal = (std * rng.normal(key, shape)).to(torch.bfloat16)
    monkeypatch.setattr(rng, "_CHUNK", 997)
    got = rng.truncated_normal(key, -2.0, 2.0, shape, scale=std,
                               dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    assert torch.equal(got.view(torch.int16), whole.view(torch.int16))
    got = rng.normal(key, shape, scale=std, dtype=torch.bfloat16)
    assert torch.equal(got.view(torch.int16), whole_normal.view(torch.int16))


@pytest.mark.parametrize("arch", MOE)
def test_bf16_init_draws_match_jax(arch, monkeypatch):
    """``build_model``'s bfloat16 leaves (drawn a chunk at a time) against
    JAX's ``init_params`` at the smoke config with bfloat16 params: the
    float32 draws agree to a few ulp (``test_init_draws_match_jax``), so
    after rounding each value equals JAX's or lies one bfloat16 step away
    (where the two float32 values straddle a rounding boundary)."""
    monkeypatch.setattr(rng, "_CHUNK", 4093)
    jcfg = jax_smoke_config(arch).replace(param_dtype="bfloat16")
    cfg = get_smoke_config(arch).replace(param_dtype="bfloat16")
    jp = jax_init_params(jax_build_model(jcfg).param_specs,
                         jax.random.PRNGKey(7))
    tp = init_params(model_specs(cfg), rng.PRNGKey(7, device="cpu"))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    n = n_equal = 0
    for path, leaf in flat:
        got = tp
        for k in path:
            got = got[k.key]
        want = np.asarray(leaf).astype(np.float32)
        got = got.float().numpy()
        step = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
        assert (np.abs(got - want) <= step).all(), ".".join(
            k.key for k in path)
        n += want.size
        n_equal += int((got == want).sum())
    assert n_equal >= 0.999 * n
