"""PodsRuntime: the psrun clock step on a 3-D ``("pod","data","model")``
mesh.

The port of ``repro/pods/runtime.py``.  The whole rank-local view and push
machinery is `psrun.runtime`'s (``make_run_fn`` takes the worker axes);
this module fixes the worker axes to ``("pod", "data")`` (the ``P``
workers partition pod-major, so the mesh's pod blocks are
``core.delays.pod_of``'s) and checks that the config's ``n_pods`` is the
mesh's pod axis: here the pod partition is placement, not only a channel
class.

What the layout means hierarchically:

- ``base``/``uring`` blocks are split over "model" and replicated over
  ``("pod","data")``: each pod holds a replica of the parameter shards;
- the per-clock ``all_gather`` of fresh updates over ``("pod","data")`` is
  the eager reconciliation channel: one ``[P, d]`` delta crosses the pod
  boundary per clock, never the ``[W, P, d]`` replica;
- ``cview`` rows live with their pod's workers and gate what each reader
  sees of the reconciled ring under the two-tier staleness bound.
"""
from __future__ import annotations

import torch.distributed as dist

from ..core.consistency import ConsistencyConfig
from ..core.ps import PSApp
from ..launch.mesh import ensure_world, make_pods_mesh, process_device
from ..psrun.runtime import PSRuntime


def default_pods_mesh(n_workers: int, n_pods: int = 2, device=None):
    """The widest ``("pod","data","model")`` mesh of the world for
    ``n_workers`` over ``n_pods`` that stays in the bit-identity regime:
    per pod, the data axis is the largest divisor of the pod's rank count
    that divides the pod's worker count while keeping >= 2 workers per
    shard; an even leftover becomes 2 model columns."""
    ensure_world(process_device(device))
    n = dist.get_world_size()
    if n % n_pods:
        raise ValueError(f"n_pods={n_pods} does not divide the {n} ranks")
    if n_workers % n_pods:
        raise ValueError(f"n_workers={n_workers} must divide by "
                         f"n_pods={n_pods}")
    per_pod_w, per_pod_dev = n_workers // n_pods, n // n_pods
    data = 1
    for cand in range(min(per_pod_dev, per_pod_w // 2), 0, -1):
        if per_pod_w % cand == 0 and per_pod_dev % cand == 0:
            data = cand
            break
    rest = per_pod_dev // data
    model = 2 if (rest > 1 and rest % 2 == 0) else 1
    return make_pods_mesh(pods=n_pods, data=data, model=model, device=device)


class PodsRuntime(PSRuntime):
    """Hierarchical PS: ``PodsRuntime(mesh).run(app, cfg, n_clocks)``.

    ``cfg.n_pods`` must equal the mesh's pod axis, and the app's workers
    must divide by ``pod x data``.  Everything else (the Trace schema,
    ``init_state``/``run_from``) is `psrun.runtime.PSRuntime`'s; the
    simulator's hierarchical mode is the oracle
    (`pods.validate.cross_validate_pods`)."""

    worker_axes = ("pod", "data")

    def _default_mesh(self, device):
        return make_pods_mesh(device=device)

    def run_fn(self, app: PSApp, cfg: ConsistencyConfig, n_clocks: int,
               record_views: bool = False, schedule=None, obs=None,
               faults=None):
        names = self.mesh.mesh_dim_names
        n_pods = self.mesh.size(names.index("pod"))
        if cfg.n_pods != n_pods:
            raise ValueError(
                f"cfg.n_pods={cfg.n_pods} must match the mesh pod axis "
                f"({n_pods}): on PodsRuntime the pod partition is physical "
                f"placement — use consistency.podded(cfg, {n_pods}) or a "
                f"matching make_pods_mesh")
        return super().run_fn(app, cfg, n_clocks, record_views, schedule,
                              obs, faults)
