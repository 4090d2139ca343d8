"""Scale-out layer of the port: batched same-shape block pipelines, their
front door for one card, and the shape-bucketed stream of heterogeneous
blocks."""

from .batch import (adaptive_rsvd_block, batched_adaptive_rsvd,
                    batched_column_id, batched_nystrom, batched_rel_diff_fro,
                    batched_row_id, batched_rsvd,
                    batched_sketched_two_sided_id, batched_two_sided_id,
                    column_id_block, nystrom_block, row_id_block, rsvd_block,
                    sketched_two_sided_id_block, two_sided_id_block)
from .mesh import compress_blocks, compress_blocks_adaptive
from .scheduler import (BlockResult, bucket_dim, compress_heterogeneous,
                        compress_heterogeneous_refined, plan_buckets)

__all__ = ["rsvd_block", "nystrom_block", "column_id_block", "row_id_block",
           "two_sided_id_block", "sketched_two_sided_id_block",
           "adaptive_rsvd_block", "batched_adaptive_rsvd",
           "batched_rsvd", "batched_nystrom", "batched_column_id",
           "batched_row_id", "batched_two_sided_id",
           "batched_sketched_two_sided_id", "batched_rel_diff_fro",
           "compress_blocks", "compress_blocks_adaptive",
           "BlockResult", "bucket_dim", "plan_buckets",
           "compress_heterogeneous", "compress_heterogeneous_refined"]
