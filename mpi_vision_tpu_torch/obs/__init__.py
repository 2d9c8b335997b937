"""Observability for the serving stack: request tracing and histograms.

  * ``trace`` — a lock-guarded, injectable-clock ``Tracer`` hands each
    ``/render`` a trace id and records its span tree (queue wait, batch
    assembly, dispatch, bake, upload/render/readback), kept in a bounded
    ring served at ``/debug/traces``. Disabled tracing routes every call
    through the ``NULL_TRACE``/``NULL_TRACER`` no-op singletons.
  * ``hist`` — sparse exponential-bucket histograms behind the serving
    latency metrics.
"""

from mpi_vision_tpu_torch.obs.trace import NULL_TRACE, NULL_TRACER, Tracer
