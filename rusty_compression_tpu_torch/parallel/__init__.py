"""Scale-out layer of the port: batched same-shape block pipelines and
their front door for one card."""

from .batch import (adaptive_rsvd_block, batched_adaptive_rsvd,
                    batched_column_id, batched_nystrom, batched_rel_diff_fro,
                    batched_row_id, batched_rsvd,
                    batched_sketched_two_sided_id, batched_two_sided_id,
                    column_id_block, nystrom_block, row_id_block, rsvd_block,
                    sketched_two_sided_id_block, two_sided_id_block)
from .mesh import compress_blocks, compress_blocks_adaptive

__all__ = ["rsvd_block", "nystrom_block", "column_id_block", "row_id_block",
           "two_sided_id_block", "sketched_two_sided_id_block",
           "adaptive_rsvd_block", "batched_adaptive_rsvd",
           "batched_rsvd", "batched_nystrom", "batched_column_id",
           "batched_row_id", "batched_two_sided_id",
           "batched_sketched_two_sided_id", "batched_rel_diff_fro",
           "compress_blocks", "compress_blocks_adaptive"]
