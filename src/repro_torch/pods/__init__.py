"""pods — the hierarchical multi-pod parameter server, run for real.

`repro_torch.psrun` runs the PS on a flat ``("data","model")`` mesh; this
package lifts it one level: on a 3-D ``("pod","data","model")`` mesh each
pod holds a replica of the parameter shards serving its own workers, and
a cross-pod reconciliation channel keeps the replicas within a second
staleness bound (eager for ESSP/async/VAP, clock-gated for BSP/SSP).
``core.ps.simulate`` with ``cfg.n_pods > 1`` is the oracle
(`pods.validate.cross_validate_pods`); ``reconcile`` reads the replica
layer out of any `Trace`; ``elastic`` drops a pod and rejoins it from a
checkpoint, bit for bit.
"""
from .elastic import concat_traces, run_with_pod_rejoin, splice_rejoin_state
from .reconcile import (reconcile_stats, replica_clock, replica_divergence,
                        replica_value_divergence, xpod_channel_mask)
from .runtime import PodsRuntime, default_pods_mesh
from .validate import cross_validate_pods

__all__ = ["PodsRuntime", "default_pods_mesh", "cross_validate_pods",
           "replica_clock", "replica_divergence",
           "replica_value_divergence", "reconcile_stats",
           "xpod_channel_mask",
           "run_with_pod_rejoin", "splice_rejoin_state", "concat_traces"]
