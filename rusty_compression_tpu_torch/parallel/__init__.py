"""Scale-out layer of the port: batched same-shape block pipelines."""

from .batch import (batched_column_id, batched_rel_diff_fro, batched_row_id,
                    batched_rsvd, batched_sketched_two_sided_id,
                    batched_two_sided_id, column_id_block, row_id_block,
                    rsvd_block, sketched_two_sided_id_block,
                    two_sided_id_block)

__all__ = ["rsvd_block", "column_id_block", "row_id_block",
           "two_sided_id_block", "sketched_two_sided_id_block",
           "batched_rsvd", "batched_column_id", "batched_row_id",
           "batched_two_sided_id", "batched_sketched_two_sided_id",
           "batched_rel_diff_fro"]
