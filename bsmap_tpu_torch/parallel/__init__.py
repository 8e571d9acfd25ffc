"""Multi-device alignment (the port of ``bsmap_tpu.parallel``).

  * ``make_mesh`` -- a list of torch devices; it may repeat a device.
  * ``ShardedDeviceEngine`` -- stripes of reads per mesh device against a
    replicated genome and index (``--engine sharded``).
  * ``IndexShardedEngine`` -- the seed index split by genome region across
    the mesh, every read through every shard, the shards' candidates
    merged in global discovery order by the K7 kernel
    (``--engine index-sharded``).

  * ``distributed`` -- multi-process runs (``-p``, ``--nprocs``): a
    contiguous read range per process, the aligner state rebuilt at each
    range boundary, the shards merged in order; ``--coordinator`` joins a
    torch.distributed gloo group.

The shards' results of the mesh engines meet on the mesh's first device in
one process, so no collective library is needed.
"""

from . import distributed
from .index_sharded import IndexShardedEngine
from .mesh import make_mesh
from .sharded import ShardedDeviceEngine

__all__ = ["distributed", "make_mesh", "ShardedDeviceEngine",
           "IndexShardedEngine"]
