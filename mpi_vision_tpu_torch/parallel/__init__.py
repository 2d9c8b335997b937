"""Mesh parallelism: sharded view rendering, plane-sharded composite,
data-parallel placement — one process drives every device of the mesh."""

from mpi_vision_tpu_torch.parallel.mesh import (
    Mesh,
    batch_spec,
    make_mesh,
    over_composite_planes_sharded,
    render_views_planes_sharded,
    render_views_sharded,
    replicate,
    shard_batch,
)
