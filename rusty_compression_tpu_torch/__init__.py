"""rusty_compression_tpu_torch — the PyTorch/CUDA port of rusty_compression_tpu.

Low-rank compression of dense blocks and matrix-free operators on an NVIDIA
H100, to a fixed rank or to a tolerance: randomized range finding (fixed,
power-iterated, adaptive), generalized Nyström, pivoted QR, truncated SVD
and one- and two-sided interpolative decompositions behind one
``compress`` front door, with the JAX package's module layout and public
names.
Plain tensor code is PyTorch; the fused pivoted-QR panels (K1 for f32, K2
for c64) are CUDA kernels written for sm_90a (``ops/kernels/qrcp.py``,
``csrc/qrcp.cu``, ``csrc/qrcp_c64.cu``).

Differences of idiom from the JAX package: explicit ``torch.Generator``
where it takes a ``key``; a leading batch axis where it uses ``vmap``;
frozen dataclasses of tensors where it uses pytrees. This package imports
``torch`` and never ``jax``.
"""

from .config import CompressionConfig, compress
from .linop import (AdjointOperator, CompositeOperator, DenseOperator,
                    FactoredOperator, FunctionOperator, LinearOperator,
                    ScaledOperator, SparseOperator, SumOperator,
                    as_linear_operator)
from .models.compression import Adaptive, CompressionType, Rank
from .models.interp_decomp import ColumnID, RowID, TwoSidedID
from .models.qr import LQ, QR
from .models.svd import SVD
from .ops.orthogonalize import (cholesky_qr, cholesky_qr2, orthonormalize,
                                shifted_cholesky_qr3)
from .ops.pivoted_qr import pivoted_lq, pivoted_qr
from .ops.svd import compute_svd
from .planarc import (planar_column_id, planar_range_capture, planar_row_id,
                      planar_rsvd, planar_two_sided_id)
from .sampling import (HMT_TOL_FACTOR, adaptive_range_finder, max_col_norm,
                       nystrom_svd, randomized_adaptive_qr,
                       randomized_adaptive_svd, range_finder,
                       sample_range_adaptive, sample_range_by_rank,
                       sample_range_power_iteration, sketched_column_id,
                       sketched_row_id, sketched_two_sided_id)
from .utils.errors import (CompressionError, LayoutError, LinalgError,
                           PivotedQRError, RustyCompressionError)
from .utils.metrics import rel_diff_fro, rel_diff_l2
from .utils.permutation import (MatrixPermutationMode, VectorPermutationMode,
                                apply_matrix_permutation,
                                apply_vector_permutation,
                                invert_permutation_vector)
from .utils.precision import default_precision, matmul_precision
from .utils.random_matrix import (random_approximate_low_rank_matrix,
                                  random_gaussian, random_orthogonal_matrix)

__version__ = "0.1.0"

__all__ = [
    # operators
    "LinearOperator", "DenseOperator", "FactoredOperator",
    "FunctionOperator", "CompositeOperator", "SumOperator",
    "ScaledOperator", "AdjointOperator", "SparseOperator",
    "as_linear_operator",
    # containers & conversions
    "QR", "LQ", "SVD", "ColumnID", "RowID", "TwoSidedID",
    # compression config
    "CompressionType", "Rank", "Adaptive",
    "CompressionConfig", "compress",
    # kernels
    "pivoted_qr", "pivoted_lq", "compute_svd",
    "orthonormalize", "cholesky_qr", "cholesky_qr2", "shifted_cholesky_qr3",
    # sampling
    "sample_range_by_rank", "sample_range_power_iteration",
    "sample_range_adaptive", "adaptive_range_finder", "range_finder",
    "randomized_adaptive_qr", "randomized_adaptive_svd",
    "nystrom_svd",
    "sketched_column_id", "sketched_row_id", "sketched_two_sided_id",
    "max_col_norm", "HMT_TOL_FACTOR",
    # complex
    "planar_range_capture", "planar_rsvd", "planar_column_id",
    "planar_row_id", "planar_two_sided_id",
    # utils
    "rel_diff_fro", "rel_diff_l2",
    "MatrixPermutationMode", "VectorPermutationMode",
    "apply_matrix_permutation", "apply_vector_permutation",
    "invert_permutation_vector",
    "random_gaussian", "random_orthogonal_matrix",
    "random_approximate_low_rank_matrix",
    "default_precision", "matmul_precision",
    # errors
    "RustyCompressionError", "CompressionError", "LinalgError",
    "LayoutError", "PivotedQRError",
]
