"""Scale-out layer of the port: batched same-shape block pipelines, block
data parallelism over a device mesh (one process per card, under
``torch.distributed``), row-sharded operators, the shape-bucketed stream of
heterogeneous blocks, and process groups with ordered gathering."""

from .batch import (adaptive_rsvd_block, batched_adaptive_rsvd,
                    batched_column_id, batched_nystrom, batched_rel_diff_fro,
                    batched_row_id, batched_rsvd,
                    batched_sketched_two_sided_id, batched_two_sided_id,
                    column_id_block, nystrom_block, row_id_block, rsvd_block,
                    sketched_two_sided_id_block, two_sided_id_block)
from .distributed import (gather_factors, global_mesh, initialize,
                          local_block_slice)
from .mesh import (compress_blocks, compress_blocks_adaptive, make_mesh,
                   replicate, shard_blocks)
from .scheduler import (BlockResult, bucket_dim, compress_heterogeneous,
                        compress_heterogeneous_refined, plan_buckets)
from .sharded import RowShardedOperator

__all__ = ["rsvd_block", "nystrom_block", "column_id_block", "row_id_block",
           "two_sided_id_block", "sketched_two_sided_id_block",
           "adaptive_rsvd_block", "batched_adaptive_rsvd",
           "batched_rsvd", "batched_nystrom", "batched_column_id",
           "batched_row_id", "batched_two_sided_id",
           "batched_sketched_two_sided_id", "batched_rel_diff_fro",
           "make_mesh", "shard_blocks", "replicate", "compress_blocks",
           "compress_blocks_adaptive", "RowShardedOperator",
           "BlockResult", "bucket_dim", "plan_buckets",
           "compress_heterogeneous", "compress_heterogeneous_refined",
           "initialize", "global_mesh", "local_block_slice",
           "gather_factors"]
