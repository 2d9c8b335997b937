"""Batched MPI render serving: scene cache, micro-batching, metrics, HTTP.

Bake scenes once into a byte-budgeted LRU cache in the kernel's layout
(``cache``), coalesce concurrent same-scene pose requests into one batched
dispatch (``scheduler`` -> ``engine``, one CUDA stream per card), export latency,
throughput, batch and cache metrics (``metrics``), keep the service up
through device trouble (``resilience``: retry, circuit breaker, watchdog,
and a CPU fallback engine while the breaker refuses the card;
``faultinject`` drills it), serve repeat and nearby views from an edge
frame cache (``edge``), degrade under overload on an SLO-driven ladder
(``brownout``), and front it all with an in-process API plus a stdlib HTTP
server (``server``). Tile-granular services (``tiles``) render only the
frustum-touched crop of a scene. ``python -m mpi_vision_tpu_torch serve``
runs it.
"""

from mpi_vision_tpu_torch.obs import Tracer
from mpi_vision_tpu_torch.serve.brownout import (
    BrownoutConfig,
    BrownoutController,
    BrownoutShedError,
)
from mpi_vision_tpu_torch.serve.cache import BakedScene, SceneCache, bake_scene
from mpi_vision_tpu_torch.serve.edge import EdgeConfig, EdgeFrameCache
from mpi_vision_tpu_torch.serve.engine import InFlightBatch, RenderEngine
from mpi_vision_tpu_torch.serve.faultinject import Fault, FaultyEngine
from mpi_vision_tpu_torch.serve.metrics import ServeMetrics
from mpi_vision_tpu_torch.serve.resilience import (
    CircuitBreaker,
    CircuitOpenError,
    DispatchTimeoutError,
    ResilienceConfig,
    ResilientExecutor,
    TransientDeviceError,
    classify_error,
)
from mpi_vision_tpu_torch.serve.scheduler import MicroBatcher, QueueFullError
from mpi_vision_tpu_torch.serve.server import (
    RenderService,
    make_http_server,
    synthetic_scene,
    synthetic_tiled_scene,
)
