"""Multi-device alignment (the port of ``bsmap_tpu.parallel``).

  * ``make_mesh`` -- a list of torch devices; it may repeat a device.
  * ``ShardedDeviceEngine`` -- stripes of reads per mesh device against a
    replicated genome and index (``--engine sharded``).
  * ``IndexShardedEngine`` -- the seed index split by genome region across
    the mesh, every read through every shard, the shards' candidates
    merged in global discovery order by the K7 kernel
    (``--engine index-sharded``).

The shards' results meet on the mesh's first device in one process, so no
collective library is needed.  Multi-process runs
(``bsmap_tpu.parallel.distributed``) are not ported.
"""

from .index_sharded import IndexShardedEngine
from .mesh import make_mesh
from .sharded import ShardedDeviceEngine

__all__ = ["make_mesh", "ShardedDeviceEngine", "IndexShardedEngine"]
