"""Telemetry: on-device metrics and the run's event stream.

The port of ``repro/obs``' device half, events and monitor:

- ``metrics``: the accumulator dict the simulator folds on the device
  every clock (``obs=ObsSpec()``; it comes back as ``Trace.obs``) and the
  host-side ``MetricsRegistry`` it drains into;
- ``events``: the versioned JSONL event stream of a run (schema 1.2) on
  the modeled timebase of ``core.timemodel.TimeModel.timeline_np``;
- ``monitor``: the online failure detector and the windowed SLO monitors
  over that stream.

With ``obs=None`` (the default) no accumulator exists and every other
`Trace` field is bit-equal to a run with ``obs=ObsSpec()``.  The
exporters (Perfetto, markdown reports, Prometheus text, stream diffs and
their CLI) are ported in a later slice.
"""
from .metrics import (DEFAULT_LAG_BUCKETS, MetricsRegistry, ObsSpec,
                      device_init, device_update, drain_device, obs_on,
                      record_timing)

__all__ = [
    "DEFAULT_LAG_BUCKETS", "MetricsRegistry", "ObsSpec", "device_init",
    "device_update", "drain_device", "obs_on", "record_timing",
]
