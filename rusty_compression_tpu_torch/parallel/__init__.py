"""Scale-out layer of the port: batched same-shape block pipelines."""

from .batch import (batched_rel_diff_fro, batched_rsvd,
                    batched_sketched_two_sided_id, rsvd_block,
                    sketched_two_sided_id_block)

__all__ = ["rsvd_block", "sketched_two_sided_id_block", "batched_rsvd",
           "batched_sketched_two_sided_id", "batched_rel_diff_fro"]
