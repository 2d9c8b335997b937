"""Multi-host serving cluster (partial port).

Only ``router.HttpTransport`` of ``mpi_vision_tpu/serve/cluster/`` is
ported so far; the ring, the router, the backend pool, the fleet
supervisor, gossip, leases and the autoscaler are not.
"""

from mpi_vision_tpu_torch.serve.cluster.router import HttpTransport

__all__ = ["HttpTransport"]
