"""The port's serving path (dense qwen3-0.6b and ssm mamba2-130m) against
the JAX package, on the CPU.

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
from repro_torch.models import layers
from repro_torch.models.registry import build_model, model_specs
from repro_torch.serve.decode import generate, generate_scan

SERVED = ("qwen3-0.6b", "mamba2-130m")
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
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


def _clear(want, tol):
    """Rows whose top-2 margin is wider than ``tol`` of the scale."""
    top = np.sort(want[:, -1], axis=-1)
    return (top[:, -1] - top[:, -2]) > tol * np.abs(want).max()


def test_prefill_and_decode_match_jax(pair):
    """Prefill logits and 4 greedy decode steps (both fed JAX's tokens)."""
    arch, compute, jm, jp, tm, toks = pair
    tol = LOGIT_TOL[compute]
    jcache = jm.init_cache(B, S + NEW)
    lj, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                     jcache)
    lt, tcache = tm.prefill(torch.from_numpy(toks), tm.init_cache(B, S + NEW))
    decode = jax.jit(jm.decode_step)
    for step in range(5):
        err, want = _rel(lt, lj)
        assert err <= tol, (arch, compute, step, err)
        clear = _clear(want, tol)
        got_tok = lt[:, -1].float().argmax(-1).numpy()
        want_tok = want[:, -1].argmax(-1)
        np.testing.assert_array_equal(got_tok[clear], want_tok[clear])
        if compute == "float32":
            assert clear.all()
        if step == 4:
            break
        nxt = jnp.asarray(want_tok, jnp.int32)[:, None]
        lj, jcache = decode(jp, {"tokens": nxt}, jcache)
        lt, tcache = tm.decode_step(torch.from_numpy(np.asarray(nxt)).long(),
                                    tcache)


def test_generate_scan_matches_jax(pair):
    arch, compute, jm, jp, tm, toks = pair
    want = np.asarray(jax_generate_scan(jm, jp, jnp.asarray(toks), NEW))
    got = generate_scan(tm, torch.from_numpy(toks), NEW)
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(generate(tm, torch.from_numpy(toks), NEW),
                                  got)
    if compute == "float32":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    # bfloat16: up to each row's first differing token, equal; there JAX's
    # own top-2 margin must be within the tolerance
    differ = got.numpy() != want
    for row in np.flatnonzero(differ.any(axis=1)):
        t = int(np.argmax(differ[row]))
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
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(toks), NEW,
                                   temperature=temperature,
                                   rng=jax.random.PRNGKey(5)))
    got = generate(tm, torch.from_numpy(toks), NEW, temperature=temperature,
                   rng=rng.PRNGKey(5))
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
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got, aux = tm(torch.from_numpy(toks))
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
    extra = dict(jp, lm_head=np.zeros((cfg.d_model, cfg.vocab_size),
                                      np.float32))
    with pytest.raises(ValueError, match="left over"):
        model_params_from_jax(cfg, extra, device="cpu")
    bad = dict(jp, final_norm={"scale": np.ones(cfg.d_model + 1,
                                                np.float32)})
    with pytest.raises(ValueError, match="shape"):
        model_params_from_jax(cfg, bad, device="cpu")


@pytest.mark.parametrize("arch", SERVED)
def test_init_draws_match_jax(arch):
    """The port's own init draws JAX's weights to a few ulp (truncated
    normals through the port's threefry and erfinv)."""
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


def test_serve_cli_runs_on_the_cpu(capsys):
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
    assert set(ARCHS) == set(SERVED)
    for arch in SERVED:
        assert get_config(arch).n_layers > get_smoke_config(arch).n_layers
    with pytest.raises(KeyError, match="ROADMAP queue 1, item 16"):
        get_config("llama3-8b")
    cfg = get_smoke_config("qwen3-0.6b")
    for family in ("moe", "hybrid", "vlm", "audio"):
        with pytest.raises(NotImplementedError, match="item 16"):
            model_specs(cfg.replace(family=family))
    with pytest.raises(NotImplementedError, match="MoE"):
        model_specs(cfg.replace(moe=object()))
