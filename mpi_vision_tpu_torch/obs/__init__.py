"""Observability for the serving stack.

  * ``trace`` — a lock-guarded, injectable-clock ``Tracer`` hands each
    ``/render`` a trace id and records its span tree (queue wait, batch
    assembly, dispatch, bake, upload/render/readback), kept in a bounded
    ring served at ``/debug/traces``. Disabled tracing routes every call
    through the ``NULL_TRACE``/``NULL_TRACER`` no-op singletons.
  * ``hist`` — sparse exponential-bucket histograms with trace-id
    exemplars behind the serving latency metrics, the SLO windows and the
    ``mpi_serve_*_nativehist`` exposition families.
  * ``prom`` — the Prometheus text exposition of ``/metrics``: a small
    registry rendering the ``/stats`` snapshot under the JAX package's
    ``mpi_*`` family names, a TTL cache, and the parser tests read it
    back with.
  * ``events`` — the bounded structured lifecycle event log (breaker
    transitions, watchdog trips, scene swaps, SLO alert edges) served at
    ``/debug/events``, with an optional rotating JSONL file sink.
  * ``slo`` — sliding-window objectives with multi-window burn-rate
    alerting, the signal that drives the brownout ladder.
  * ``profile`` — on-demand ``torch.profiler`` captures of live traffic
    (``/debug/profile``).
  * ``tsdb`` — the on-box time-series ring: every ``/metrics`` family
    sampled on a cadence into bounded per-series rings (``/debug/tsdb``).
  * ``attrib`` — the resource-attribution ledger: device seconds, queue
    wait and bytes per (scene, class, brownout level) cell
    (``/debug/attrib``).
  * ``incident`` — SLO-triggered incident bundles (``/debug/incidents``).
  * ``ship`` — off-host shipping of event segments, alert edges, tsdb
    snapshots and incident bundles, with retry and a disk spool (imported
    as ``mpi_vision_tpu_torch.obs.ship``; it layers on
    ``serve.resilience``).
"""

from mpi_vision_tpu_torch.obs.events import NULL_EVENTS, EventLog, file_sink
from mpi_vision_tpu_torch.obs.hist import NativeHistogram
from mpi_vision_tpu_torch.obs.profile import DeviceProfiler, ProfileBusyError
from mpi_vision_tpu_torch.obs.prom import (
    ExpositionCache,
    Metric,
    Registry,
    aggregate_metrics_texts,
    parse_metrics_text,
    render_serve_metrics,
    serve_registry,
)
from mpi_vision_tpu_torch.obs.slo import SloConfig, SloTracker
from mpi_vision_tpu_torch.obs.trace import NULL_TRACE, NULL_TRACER, Tracer
from mpi_vision_tpu_torch.obs.tsdb import TsdbConfig, TsdbRecorder
