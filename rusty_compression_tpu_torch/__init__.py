"""rusty_compression_tpu_torch — the PyTorch/CUDA port of rusty_compression_tpu.

Low-rank compression of dense blocks on an NVIDIA H100: randomized range
finding, pivoted QR, truncated SVD and one- and two-sided interpolative
decompositions, with the JAX package's module layout and public names.
Plain tensor code is PyTorch; the fused pivoted-QR panel (K1) is a CUDA
kernel written for sm_90a (``ops/kernels/qrcp.py``, ``csrc/qrcp.cu``).

Differences of idiom from the JAX package: explicit ``torch.Generator``
where it takes a ``key``; a leading batch axis where it uses ``vmap``;
frozen dataclasses of tensors where it uses pytrees. This package imports
``torch`` and never ``jax``.
"""

from .linop import (AdjointOperator, DenseOperator, LinearOperator,
                    as_linear_operator)
from .models.compression import Adaptive, CompressionType, Rank
from .models.interp_decomp import ColumnID, RowID, TwoSidedID
from .models.qr import LQ, QR
from .models.svd import SVD
from .ops.orthogonalize import (cholesky_qr, cholesky_qr2, orthonormalize,
                                shifted_cholesky_qr3)
from .ops.pivoted_qr import pivoted_lq, pivoted_qr
from .ops.svd import compute_svd
from .sampling import (range_finder, sample_range_by_rank, sketched_column_id,
                       sketched_row_id, sketched_two_sided_id)
from .utils.errors import (CompressionError, LayoutError, LinalgError,
                           PivotedQRError, RustyCompressionError)
from .utils.metrics import rel_diff_fro, rel_diff_l2
from .utils.permutation import (MatrixPermutationMode,
                                apply_matrix_permutation,
                                invert_permutation_vector)
from .utils.precision import default_precision, matmul_precision
from .utils.random_matrix import (random_approximate_low_rank_matrix,
                                  random_gaussian, random_orthogonal_matrix)

__version__ = "0.1.0"

__all__ = [
    # operators
    "LinearOperator", "DenseOperator", "AdjointOperator",
    "as_linear_operator",
    # containers & conversions
    "QR", "LQ", "SVD", "ColumnID", "RowID", "TwoSidedID",
    "CompressionType", "Rank", "Adaptive",
    # kernels
    "pivoted_qr", "pivoted_lq", "compute_svd",
    "orthonormalize", "cholesky_qr", "cholesky_qr2", "shifted_cholesky_qr3",
    # sampling
    "range_finder", "sample_range_by_rank",
    "sketched_column_id", "sketched_row_id", "sketched_two_sided_id",
    # utils
    "rel_diff_fro", "rel_diff_l2",
    "MatrixPermutationMode", "apply_matrix_permutation",
    "invert_permutation_vector",
    "random_gaussian", "random_orthogonal_matrix",
    "random_approximate_low_rank_matrix",
    "default_precision", "matmul_precision",
    # errors
    "RustyCompressionError", "CompressionError", "LinalgError",
    "LayoutError", "PivotedQRError",
]
