"""psrun — an *executable* sharded parameter server on ``torch.distributed``.

Where ``core.ps.simulate`` reproduces the SSPTable/ESSPTable semantics in
one process with global knowledge, this package *runs* them, one process
per point of a ``("data", "model")`` mesh: parameter shards own column
blocks of the table on the ``"model"`` axis, the ``P`` workers are
partitioned over the ``"data"`` axis, and every clock the workers
materialize views against their rank's cache, compute updates, push them
to the owning shards and advance their per-channel ``cview`` clocks
lazily (SSP) or eagerly on push (ESSP) under the staleness gate.

The simulator is the *oracle*: both produce the same ``core.ps.Trace``,
seeded BSP, SSP and ESSP runs are bit-identical, VAP runs keep the value
bound with exact decisions (``psrun.validate.cross_validate``).  On the
card the runtime runs as a world of one NCCL rank; worlds of more ranks
run on the CPU over gloo (``launch.worlds``).
"""
from .runtime import PSRuntime, PSState, default_mesh, make_run_fn
from .validate import cross_validate, trace_max_diff, trace_max_ulp

__all__ = ["PSRuntime", "PSState", "default_mesh", "make_run_fn",
           "cross_validate", "trace_max_diff", "trace_max_ulp"]
