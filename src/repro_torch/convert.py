"""Carry state between the JAX package and the port.

The port never imports JAX; the caller hands over numpy arrays (what
``np.asarray`` gives for a JAX array) and gets tensors back, and the
reverse for traces.  The parity tests use this to start both simulators
from the very same ``x0`` and ``local0``, both model zoos from the very
same weights, and both sharded runtimes from the very same mid-run state
(``psstate_from_jax``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .apps.lda import LDAConfig, lda_app
from .apps.matfact import MFConfig, mf_app
from .core.ps import PSApp, Trace
from .device import resolve_device
from .models.params import map_specs
from .models.registry import Model, model_specs


def to_tensors(arrays, device=None):
    """A numpy array, or a dict of them, as tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(arrays, dict):
        return {k: to_tensors(v, dev) for k, v in arrays.items()}
    return torch.from_numpy(np.array(arrays, copy=True)).to(dev)


def psapp_from_state(name: str, x0, local0: dict, worker_update, loss,
                     device=None) -> PSApp:
    """A port `PSApp` whose ``x0`` and ``local0`` (a dict of arrays with a
    leading worker axis) are the given numpy arrays."""
    x0, local0 = to_tensors(x0, device), to_tensors(local0, device)
    return PSApp(name=name, dim=int(x0.shape[0]),
                 n_workers=int(next(iter(local0.values())).shape[0]),
                 x0=x0, local0=local0, worker_update=worker_update,
                 loss=loss)


def mf_app_from_state(cfg: MFConfig, x0, local0: dict,
                      device=None) -> PSApp:
    """The port's MF app over the JAX MF app's ``x0`` and ``local0``
    (``{"ii", "jj", "vv"}``), as numpy arrays."""
    loc = to_tensors(local0, device)
    return mf_app(cfg, to_tensors(x0, device), loc["ii"], loc["jj"],
                  loc["vv"])


def lda_app_from_state(cfg: LDAConfig, x0, local0: dict,
                       device=None) -> PSApp:
    """The port's LDA app over the JAX LDA app's ``x0`` and ``local0``
    (``{"words", "docid", "z", "ndk"}``), as numpy arrays."""
    return lda_app(cfg, to_tensors(x0, device), to_tensors(local0, device))


def psstate_from_jax(state, device=None):
    """The port's `psrun.runtime.PSState` holding a JAX ``PSState`` whose
    leaves are numpy arrays (``jax.tree.map(np.asarray, state)``): the
    clock as an int, the uint32 key as the port's int64 words, every other
    leaf as a tensor of its dtype on ``device``.  The two runtimes share
    the padded layout, so the state resumes in the port where it stopped
    in the JAX package."""
    from .psrun.runtime import PSState
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    def tree(x):
        return None if x is None else {k: tree(v) if isinstance(v, dict)
                                       else t(v) for k, v in x.items()}
    return PSState(
        clock=int(np.asarray(state.clock)), base=t(state.base),
        uring=t(state.uring), uclock=t(state.uclock), cview=t(state.cview),
        local=tree(state.local),
        rng=t(np.asarray(state.rng).astype(np.int64)),
        comm=tree(state.comm))


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x


def trace_to_numpy(trace: Trace) -> Trace:
    """The same `Trace` with every tensor moved to the host as numpy."""
    return Trace(**{f.name: _to_numpy(getattr(trace, f.name))
                    for f in dataclasses.fields(trace)})


def _flatten(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}"))
    return out


def model_params_from_jax(cfg, params_np, device=None) -> Model:
    """The port's `Model` of ``cfg`` holding the JAX package's parameter
    tree ``params_np`` (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives).  Every path of the port's
    spec tree must be in ``params_np`` with the spec's shape, and no path
    may be left over."""
    dev = resolve_device(device)
    want = _flatten(map_specs(lambda _p, ps: ps, model_specs(cfg)))
    got = _flatten(params_np)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter paths differ: missing {missing}, "
                         f"left over {extra}")
    for path, ps in want.items():
        if tuple(np.shape(got[path])) != ps.shape:
            raise ValueError(f"{path}: shape {np.shape(got[path])}, "
                             f"expected {ps.shape}")
    tensors = map_specs(lambda path, ps: torch.from_numpy(
        np.array(got[path], dtype=np.float32, copy=True)).to(
            device=dev, dtype=ps.dtype), model_specs(cfg))
    return Model(cfg, tensors)
