"""Shared holding of the port's memory-reading models (the vlm family's
llama-3.2-vision-11b and the audio family's whisper-medium) and of the
hybrid family's jamba-1.5-large-398b against the JAX package, on the CPU,
at their smoke configs.  Used by ``tests/test_torch_vlm.py``,
``tests/test_torch_encdec.py`` and ``tests/test_torch_hybrid.py``.

JAX's ``build_model(cfg).init(PRNGKey(1))`` weights are carried across
(``convert.model_params_from_jax``); the VLM's cross-attention gates are
set to ``GATE`` on both sides first (they start at 0, and ``tanh(0) = 0``
would keep the image path from the logits).  Prompts come from the
port's ``token_batch`` (bit-equal to JAX's) and the modality stub from
the port's ``modality_stub`` (within 2 ulp of JAX's); both packages take
the same arrays.  JAX's side is its ``generate``: its prefill and decode
step, each compiled once a `Pair` (`Pair.jax_run`).

Tolerances: ``LOGIT_TOL``, the serving tests', of each tensor's largest
magnitude, every step held on the same inputs (each JAX decode step runs
from the port's cache).  JAX's init draws a ``[d, heads, head_dim]``
projection at ``1/sqrt(heads)`` (its fan-in is the last-but-one axis), so
at random init the smoke models' attention logits run to the hundreds
and the softmax is near one-hot: a one-ulp move of a logit moves the
output by a whole weight (JAX's own float32 forward lies 2.2e-4 of scale
from the same function in float64, its bfloat16 one 40-70 % from its
float32 one), and no tolerance holds anything but tie-breaking.  The
parity tests scale those projections to ``1/sqrt(d)`` on both sides
(`conditioned`); then the logits are of order 1, the port stays within
9e-7 (float32) and 0.9 % (bfloat16) of JAX, and a misplaced cast or a
dropped path shows.  ``test_init_draws_match_jax`` holds the unscaled
draws.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.synthetic import modality_stub as jax_modality_stub
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_from_jax
from repro_torch.data.synthetic import (TokenGenConfig, modality_stub,
                                        token_batch)
from repro_torch.models.registry import MEMORY

LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# A chunk of the port's CPU weight draw (`rng._CHUNK`) under torch's
# parallel grain of 32,768 elements, for the tests that draw a model:
# each op of the threefry then runs on one thread.  Under the suite's
# ``-n 6`` the default chunk's multithreaded ops oversubscribe the cores
# (a smoke model's draw 50-190 s where it takes 2 s alone); the draws
# are bit-equal at any chunk
# (``test_torch_serve.py::test_chunked_init_is_bit_equal_to_the_whole_leaf_cast``).
CPU_DRAW_CHUNK = 1 << 14
GATE = 0.5
B, S, NEW = 2, 24, 5


def conditioned(tree):
    """JAX's params (numpy) with every ``[d, heads, head_dim]`` projection
    (``wq``, ``wk``, ``wv``) scaled by ``sqrt(heads / d)``: drawn at
    ``1/sqrt(d)`` instead of the init's ``1/sqrt(heads)`` (its fan-in is
    the last-but-one axis), so the attention logits are of order 1."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = conditioned(v)
        elif k in ("wq", "wk", "wv") and v.ndim >= 3:
            out[k] = (v * np.float32(np.sqrt(v.shape[-2] / v.shape[-3]))
                      ).astype(v.dtype)
        else:
            out[k] = v
    return out


def with_gate(jp, gate=GATE):
    """JAX's params (numpy) with every VLM cross-attention gate at
    ``gate`` (a copy; other families' params as they are)."""
    if "blocks" not in jp or "cross" not in jp["blocks"]:
        return jp
    blocks = dict(jp["blocks"])
    blocks["cross"] = dict(blocks["cross"], gate=np.full_like(
        blocks["cross"]["gate"], gate))
    return dict(jp, blocks=blocks)


@functools.lru_cache(maxsize=None)
def _jit_init(arch):
    return jax.jit(jax_build_model(jax_smoke_config(arch)).init)


def jax_init(arch, seed):
    """JAX's init of the smoke config (its params do not depend on the
    compute dtype) as numpy, one compiled init an arch."""
    return jax.tree.map(np.asarray, _jit_init(arch)(
        jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=None)
def jax_params(arch, seed):
    """`jax_init`, `conditioned`, the gates at `GATE`."""
    return with_gate(conditioned(jax_init(arch, seed)))


@functools.lru_cache(maxsize=None)
def pair(arch, compute):
    """The `Pair` of ``arch`` in ``compute``, made once per process."""
    return Pair(arch, compute)


class Pair:
    """The JAX model and the port's on the same weights (`conditioned`,
    gates at `GATE`), for one arch and one compute dtype, with the prompts
    and the modality stub (none for a family without memory: ``name`` and
    ``stub`` are ``None``)."""

    def __init__(self, arch, compute, seed=1):
        self.arch, self.compute = arch, compute
        self.tol = LOGIT_TOL[compute]
        self.jcfg = jax_smoke_config(arch).replace(compute_dtype=compute)
        self.tcfg = get_smoke_config(arch).replace(compute_dtype=compute)
        self.jm = jax_build_model(self.jcfg)
        self.jp = jax_params(arch, seed)
        self.tm = model_params_from_jax(self.tcfg, self.jp, device="cpu")
        self.toks = token_batch(TokenGenConfig(
            vocab_size=self.tcfg.vocab_size, seq_len=S, batch=B, seed=3),
            0, device="cpu").numpy()
        self.name = MEMORY.get(self.tcfg.family)    # None: no memory
        self.stub = None if self.name is None else modality_stub(
            self.tcfg, B, device="cpu")[self.name].numpy()
        self._jit = {}
        self._run = None

    def jit(self, model, fn):
        key = (id(model), fn)
        if key not in self._jit:
            self._jit[key] = jax.jit(getattr(model, fn))
        return self._jit[key]

    def jbatch(self, tokens, stub=True):
        batch = {"tokens": jnp.asarray(tokens)}
        if stub and self.name is not None:
            batch[self.name] = jnp.asarray(self.stub)
        return batch

    def tstub(self, stub=None):
        if self.name is None:
            return {}
        return {self.name: torch.from_numpy(
            np.array(self.stub if stub is None else stub, copy=True))}

    # ---- one step of each model on the same inputs ----------------------
    def jax_step(self, model, tokens, cache, dtype=None):
        """(last logits [B, 1, V] as float32 numpy, cache as numpy) of a JAX
        model's prefill (``cache`` a fresh one when ``None``) or decode
        step from a copy of ``cache`` (numpy, cast to ``dtype``)."""
        if cache is None:
            logits, cache = self.jit(model, "prefill")(
                self.jp, self.jbatch(tokens), model.init_cache(B, S + NEW))
        else:
            logits, cache = self.jit(model, "decode_step")(
                self.jp, self.jbatch(tokens, stub=False),
                to_jax(cache, dtype))
        return np.asarray(logits[:, -1:], np.float32), from_jax(cache)

    def port_step(self, model, tokens, cache, dtype=None):
        """The same for a port model (``cache`` a copy, cast to
        ``dtype``)."""
        t = torch.from_numpy(np.array(tokens, copy=True)).long()
        if cache is None:
            logits, cache = model.prefill(t, model.init_cache(B, S + NEW),
                                          **self.tstub())
        else:
            logits, cache = model.decode_step(t, to_torch(cache, dtype))
        return logits[:, -1:].float().numpy(), to_numpy(cache)

    def jax_run(self):
        """JAX's greedy run from the prompts, as its ``generate`` makes
        it: ``(steps, tokens)``, ``steps`` the prefill's and then each of
        ``NEW - 1`` decode steps' `jax_step` (``steps[t]``'s logits pick
        ``tokens[:, t]``), ``tokens`` ``[B, NEW]``; made once."""
        if self._run is None:
            jdt = jnp.dtype(self.compute)
            steps = [self.jax_step(self.jm, self.toks, None)]
            toks = [steps[0][0][:, -1].argmax(-1).astype(np.int32)]
            for _ in range(NEW - 1):
                steps.append(self.jax_step(self.jm, toks[-1][:, None],
                                           steps[-1][1], jdt))
                toks.append(steps[-1][0][:, -1].argmax(-1).astype(np.int32))
            self._run = steps, np.stack(toks, axis=1)
        return self._run


def to_numpy(tree):
    """A copy of a (nested) torch cache as numpy (bfloat16 as float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def from_jax(tree):
    """A JAX cache as numpy (bfloat16 as float32)."""
    def one(v):
        v = np.asarray(v)
        return v.astype(np.float32) if v.dtype == jnp.bfloat16 else v
    return jax.tree.map(one, tree)


def to_jax(tree, dtype):
    """A copy of a numpy cache as JAX arrays, the floats in ``dtype``."""
    def one(v):
        if not np.issubdtype(v.dtype, np.floating):
            return jnp.array(v, copy=True)
        return jnp.array(v, copy=True).astype(dtype)
    return jax.tree.map(one, tree)


def to_torch(tree, dtype):
    """A copy of a numpy cache as tensors, the floats in ``dtype``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True))
    return t.to(dtype) if t.is_floating_point() else t


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def hold(got, want, tol, what):
    """``got`` within ``tol`` of ``want``, of ``want``'s largest
    magnitude; returns the error."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err, tol)
    return err


def hold_step(pair, got, want, what):
    """A step's logits and every leaf of its cache (integer leaves
    exactly)."""
    hold(got[0], want[0], pair.tol, (what, "logits"))
    g, w = leaves(got[1]), leaves(want[1])
    assert set(g) == set(w), (set(g), set(w))
    for k in w:
        assert g[k].shape == w[k].shape, (what, k, g[k].shape, w[k].shape)
        if np.issubdtype(w[k].dtype, np.floating):
            hold(g[k], w[k], pair.tol, (what, k))
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=str((what,
                                                                   k)))


def check_prefill_and_decode(pair, n_steps=3):
    """The prefill and ``n_steps`` greedy decode steps, each held on the
    same inputs (each JAX decode step runs from the port's cache, fed
    JAX's free-running token), logits and caches (``cross_k`` and
    ``cross_v`` included); the free-running caches too."""
    jdt = jnp.dtype(pair.compute)
    tdt = getattr(torch, pair.compute)
    steps, toks = pair.jax_run()
    want = steps[0]
    got = pair.port_step(pair.tm, pair.toks, None)
    hold_step(pair, got, want, "prefill")
    for t in range(n_steps):
        nxt = toks[:, t:t + 1]
        free = steps[t + 1]
        want = pair.jax_step(pair.jm, nxt, got[1], jdt)
        got = pair.port_step(pair.tm, nxt, got[1], tdt)
        hold_step(pair, got, want, ("decode", t))
        hold_step(pair, got, free, ("free-running decode", t))


def check_forward(pair):
    want = np.asarray(pair.jit(pair.jm, "forward")(
        pair.jp, pair.jbatch(pair.toks))[0], np.float32)
    got, aux = pair.tm(torch.from_numpy(pair.toks), **pair.tstub())
    assert aux == 0.0 and got.shape == want.shape
    assert got.dtype == getattr(torch, pair.compute)
    return hold(got.float().numpy(), want, pair.tol, "forward")


def check_generate_scan(pair, generate, generate_scan):
    """Greedy tokens (``generate_scan`` and ``generate``) against JAX's
    (`Pair.jax_run`): float32 equal; bfloat16 each row equal up to its
    first differing token, and there JAX's top-2 margin (of the step that
    picked it) within the logit tolerance."""
    extra = pair.tstub()
    steps, want = pair.jax_run()
    got = generate_scan(pair.tm, torch.from_numpy(pair.toks), NEW,
                        extra_inputs=extra)
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(
        generate(pair.tm, torch.from_numpy(pair.toks), NEW,
                 extra_inputs=extra), got)
    if pair.compute == "float32":
        np.testing.assert_array_equal(got.numpy(), want)
        return
    differ = got.numpy() != want
    for row in np.flatnonzero(differ.any(axis=1)):
        t = int(np.argmax(differ[row]))
        logits = steps[t][0][:, -1]
        top = np.sort(logits[row])
        assert top[-1] - top[-2] <= pair.tol * np.abs(logits).max(), (
            pair.arch, row, t)


def check_stub(cfg, jcfg, batch):
    """``modality_stub`` against JAX's: the same key and shape, float32,
    within 2 ulp of the draw's scale."""
    want = jax_modality_stub(jcfg, batch)
    got = modality_stub(cfg, batch, device="cpu")
    assert set(got) == set(want) and len(got) == 1
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape
        ulp = np.abs(got[k].numpy().astype(np.float64) - w) / np.spacing(
            np.abs(w))
        assert ulp.max() <= 2.0, (k, ulp.max(), int((ulp > 0).sum()))
    return got
