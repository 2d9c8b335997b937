"""Observability for the serving stack.

  * ``trace`` — a lock-guarded, injectable-clock ``Tracer`` hands each
    ``/render`` a trace id and records its span tree (queue wait, batch
    assembly, dispatch, bake, upload/render/readback), kept in a bounded
    ring served at ``/debug/traces``. Disabled tracing routes every call
    through the ``NULL_TRACE``/``NULL_TRACER`` no-op singletons.
  * ``hist`` — sparse exponential-bucket histograms behind the serving
    latency metrics and the SLO windows.
  * ``events`` — the bounded structured lifecycle event log (breaker
    transitions, watchdog trips, scene swaps, SLO alert edges) served at
    ``/debug/events``, with an optional rotating JSONL file sink.
  * ``slo`` — sliding-window objectives with multi-window burn-rate
    alerting, the signal that drives the brownout ladder.
  * ``profile`` — on-demand ``torch.profiler`` captures of live traffic
    (``/debug/profile``).
"""

from mpi_vision_tpu_torch.obs.events import NULL_EVENTS, EventLog, file_sink
from mpi_vision_tpu_torch.obs.profile import DeviceProfiler, ProfileBusyError
from mpi_vision_tpu_torch.obs.slo import SloConfig, SloTracker
from mpi_vision_tpu_torch.obs.trace import NULL_TRACE, NULL_TRACER, Tracer
