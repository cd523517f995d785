"""The port's MF-SGD app against the JAX package's, on the CPU.

The port draws its synthetic data from its own threefry stream: the
observed indices must equal the JAX app's, the values and the initial
parameters agree to 1e-6 (``normal`` is within 3 ulp, and the
ground-truth product sums in another order).  The batched worker update
and the loss are held to the JAX versions on the same inputs.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.apps import matfact as jmf  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.apps import matfact as tmf  # noqa: E402
from repro_torch.psrun import validate as tval  # noqa: E402

CFGS = {
    "default": {},
    "small": dict(n_rows=32, n_cols=24, rank=6, true_rank=3, n_workers=4,
                  batch=16, density=0.3, seed=3),
}


@pytest.fixture(scope="module", params=list(CFGS))
def pair(request):
    kw = CFGS[request.param]
    return (jmf.make_mf_app(jmf.MFConfig(**kw)),
            tmf.make_mf_app(tmf.MFConfig(**kw), device="cpu"))


def test_data_matches_jax(pair):
    japp, tapp = pair
    for k in ("ii", "jj"):
        np.testing.assert_array_equal(tapp.local0[k].numpy(),
                                      np.asarray(japp.local0[k]))
    np.testing.assert_allclose(tapp.local0["vv"].numpy(),
                               np.asarray(japp.local0["vv"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tapp.x0.numpy(), np.asarray(japp.x0), rtol=0,
                               atol=1e-6)
    assert (tapp.dim, tapp.n_workers) == (japp.dim, japp.n_workers)


def test_worker_update_and_loss_match_jax():
    """Same views, same keys: the batched update equals the vmapped JAX
    update to float rounding (the scatter of duplicate rows sums in index
    order in both)."""
    kw = CFGS["small"]
    japp = jmf.make_mf_app(jmf.MFConfig(**kw))
    tapp = tmf.make_mf_app(tmf.MFConfig(**kw), device="cpu")
    P, d = japp.n_workers, japp.dim
    r = np.random.default_rng(0)
    views = (np.asarray(japp.x0)[None, :]
             + 0.01 * r.standard_normal((P, d))).astype(np.float32)
    jkeys = jax.random.split(jax.random.PRNGKey(4), P)
    clock = 5
    want, _ = jax.vmap(japp.worker_update, in_axes=(0, 0, 0, None, 0))(
        jnp.asarray(views), japp.local0, jnp.arange(P), jnp.int32(clock),
        jkeys)
    tlocal = {k: torch.from_numpy(np.array(v))
              for k, v in japp.local0.items()}
    got, _ = tapp.worker_update(torch.from_numpy(views), tlocal,
                                torch.arange(P), clock, rng.split(
                                    rng.PRNGKey(4), P))
    want = np.asarray(want)
    scale = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got.numpy() - want).max() <= 8 * scale
    assert (np.abs(want) > 0).sum() > 0
    for x in (views[0], np.asarray(japp.x0)):
        jl = float(japp.loss(jnp.asarray(x), japp.local0))
        tl = float(tapp.loss(torch.from_numpy(np.ascontiguousarray(x)),
                             tlocal))
        assert abs(tl - jl) <= 8 * np.spacing(np.float32(jl))


def test_sequential_baseline_matches_jax():
    cfg = CFGS["small"]
    want = jmf.sequential_baseline(jmf.MFConfig(**cfg), 6)
    got = tmf.sequential_baseline(tmf.MFConfig(**cfg), 6, device="cpu")
    for f in tval.INT_FIELDS:
        np.testing.assert_array_equal(tval._np(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
    ulps = tval.trace_max_ulp(got, want)
    assert max(ulps.values()) <= tval.VAP_ULP_BUDGET, ulps
    assert float(got.loss_ref[-1]) < float(got.loss_ref[0])


def test_no_decay_and_validation():
    cfg = dataclasses.replace(tmf.MFConfig(**CFGS["small"]), lr_decay=False)
    app = tmf.make_mf_app(cfg, device="cpu")
    assert app.dim == (cfg.n_rows + cfg.n_cols) * cfg.rank
    with pytest.raises(ValueError, match="divide"):
        tmf.make_mf_app(dataclasses.replace(cfg, n_rows=30), device="cpu")
