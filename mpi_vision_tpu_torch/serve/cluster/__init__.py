"""Multi-host serving cluster: scene-sharded routing over serve backends.

The PyTorch package's copy of ``mpi_vision_tpu/serve/cluster/``: the
tier above one serve process, all of it host code. ``ring`` places scenes
on backends by consistent hashing with configurable replication;
``router`` fronts the pool with health-aware forwarding, per-backend
circuit breakers, a retry budget, failover, outbound W3C
``traceparent`` propagation, and aggregated ``/stats`` + ``/metrics`` +
``/healthz``; ``pool`` spawns local ``python -m mpi_vision_tpu_torch
serve --device`` children (the card by default; ``python -m
mpi_vision_tpu_torch cluster``); ``supervisor`` is the self-healing
layer over both — health probing, crash/wedge detection, budgeted
restarts with crash-loop quarantine, and rolling restarts under live
traffic; ``gossip`` + ``lease`` replicate the control plane itself — N
peered routers exchange versioned health/quarantine observations over
``/gossip`` and exactly one holds the supervision lease at a time;
``autoscale`` grows the pool on sustained SLO burn / queue pressure /
brownout and shrinks it on sustained idleness, warming every new
backend's ring assignment before it takes traffic. Every backend renders
with the fused CUDA kernel; the router itself never touches the card.
"""

from mpi_vision_tpu_torch.serve.cluster.autoscale import (
    AutoscaleConfig,
    AutoscalePolicy,
    Autoscaler,
)
from mpi_vision_tpu_torch.serve.cluster.gossip import GossipNode, GossipState
from mpi_vision_tpu_torch.serve.cluster.lease import (
    FileLease,
    GossipLease,
    SupervisionLeaseLost,
)
from mpi_vision_tpu_torch.serve.cluster.pool import (
    BackendPool,
    BackendSpawnError,
    RemoteBackendPool,
)
from mpi_vision_tpu_torch.serve.cluster.ring import HashRing
from mpi_vision_tpu_torch.serve.cluster.router import (
    AllReplicasOpenError,
    HttpTransport,
    ReplicasExhaustedError,
    RetryBudgetExhaustedError,
    Router,
    RouterMetrics,
    make_router_http_server,
    make_traceparent,
    new_trace_id_32,
)
from mpi_vision_tpu_torch.serve.cluster.supervisor import FleetSupervisor

__all__ = [
    "AllReplicasOpenError",
    "AutoscaleConfig",
    "AutoscalePolicy",
    "Autoscaler",
    "BackendPool",
    "BackendSpawnError",
    "FileLease",
    "FleetSupervisor",
    "GossipLease",
    "GossipNode",
    "GossipState",
    "HashRing",
    "HttpTransport",
    "RemoteBackendPool",
    "ReplicasExhaustedError",
    "RetryBudgetExhaustedError",
    "Router",
    "RouterMetrics",
    "SupervisionLeaseLost",
    "make_router_http_server",
    "make_traceparent",
    "new_trace_id_32",
]
