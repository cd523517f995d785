"""Both packages' MoE routing, recorded for the parity tests.

A router near tie is a rounding decision that may flip between two
correct runs, so the serving tests compare each MoE layer's routing
first and hold logits only in the sequences whose routing agreed.  The
port records its own (``moe.recording``); JAX's ``moe_forward`` is
wrapped, for the module that imports `jax_routing_tap`, to send its
routing to `_JAX_ROUTES` through an ordered ``jax.debug.callback`` (the
same router products).  A JAX function traced inside that module keeps
the callback.  Used by ``tests/test_torch_serve.py`` and
``tests/test_torch_hybrid.py``.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe

# JAX's routing of every moe_forward run since the last RoutingTap
_JAX_ROUTES: list = []


def _record_jax_route(eidx, logits, bound):
    _JAX_ROUTES.append({"eidx": torch.from_numpy(np.array(eidx)).long(),
                        "logits": torch.from_numpy(np.array(logits)),
                        "bound": torch.from_numpy(np.array(bound))})


@contextlib.contextmanager
def tapped_jax_moe():
    """JAX's ``moe_forward`` with its routing sent to `_JAX_ROUTES` (the
    same router products, an ordered callback) inside the ``with``."""
    orig = jmoe.moe_forward

    def tapped(p, cfg, x):
        xf = x.astype(jnp.float32)
        logits = xf @ p["router"]
        _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
        bound = (jnp.abs(xf) @ jnp.abs(p["router"])).max(-1)
        jax.debug.callback(_record_jax_route, eidx, logits, bound,
                           ordered=True)
        return orig(p, cfg, x)

    jmoe.moe_forward = tapped
    try:
        yield
    finally:
        jmoe.moe_forward = orig


@pytest.fixture(scope="module", autouse=True)
def jax_routing_tap():
    """`tapped_jax_moe` for the module that imports this fixture."""
    with tapped_jax_moe():
        yield


class RoutingTap:
    """Both packages' MoE routing of the calls made inside one ``with``
    (``port`` and ``jax``, a list entry per layer call, in order), for a
    batch of ``batch`` sequences."""

    def __init__(self, batch=2):
        self.batch = batch

    def __enter__(self):
        jax.effects_barrier()       # no earlier call's routing leaks in
        del _JAX_ROUTES[:]
        self._rec = moe.recording()
        self.port = self._rec.__enter__()
        return self

    def __exit__(self, *exc):
        self._rec.__exit__(*exc)
        jax.effects_barrier()
        self.jax = list(_JAX_ROUTES)

    def agreement(self, tol, calls=None):
        """``[batch]`` bool, the sequences whose routing agreed in the
        calls ``calls`` (a slice; all by default); every flip a near
        tie."""
        calls = calls or slice(None)
        got, want = self.port[calls], self.jax[calls]
        assert len(got) == len(want)
        if not want:
            return np.ones(self.batch, bool)
        same, flips = moe.routing_agreement(got, want, tol)
        assert all(margin <= budget for *_, margin, budget in flips), flips
        return same.numpy()
