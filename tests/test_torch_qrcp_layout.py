"""The layout rule of the pivoted-QR panel kernels (K1, K2), on the CPU.

``panel_layout(m, n, k, itemsize)`` decides from the shape alone how a
panel lies on the card: the cluster size (or, where Q does not fit a
cluster, the CTAs of one cooperative grid), the columns per CTA, the block
size, whether the residual slice sits in shared memory, and the bytes of
shared memory. Nothing here launches a kernel; the arithmetic is exact,
so there is no tolerance. Also pins that ``interop.from_numpy`` puts its
result on the card unless the caller names a device.
"""

import inspect

import pytest

from torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def k1():
    import torch  # noqa: F401  (the port imports it; kept out of collection)

    from rusty_compression_tpu_torch.ops.kernels import qrcp

    return qrcp


# Every panel shape chip_smoke.py's phase 2 launches, as (m, n, k, itemsize).
PHASE2 = [
    (24, 16384, 16, 4), (16, 16384, 16, 4), (24, 2048, 16, 4),
    (37, 301, 29, 4), (136, 256, 128, 4), (24, 32, 16, 4),
    (24, 16389, 16, 4), (600, 40, 8, 4),
    (53, 8192, 43, 8), (43, 8192, 43, 8), (136, 256, 128, 8),
    (37, 301, 29, 8), (24, 2048, 16, 8), (53, 8191, 43, 8), (600, 40, 8, 8),
    (37, 1024, 27, 8), (27, 1024, 27, 8), (35, 1024, 27, 8),
]
GRID = PHASE2 + [
    (m, n, min(k, m, n), itemsize)
    for m in (5, 24, 136, 400, 3000)
    for n in (5, 33, 1000, 100_000)
    for k in (4, 128)
    for itemsize in (4, 8)
]


def _slice_bytes(m, width, itemsize):
    """Residual slice, its last R row and its norms."""
    return itemsize * (m * width + width) + 4 * width


@pytest.mark.parametrize("m,n,k,itemsize", GRID)
def test_layout_rule(k1, m, n, k, itemsize):
    layout = k1.panel_layout(m, n, k, itemsize)
    assert k1.kernel_fits(m, k, itemsize)
    # A panel whose Q does not replicate in a CTA runs as one cooperative
    # grid (the grid rule's own tests are in test_torch_qrcp_grid.py).
    assert layout.grid == (not k1._q_replicates(m, k, itemsize))
    if layout.grid:
        assert layout.cluster <= k1.MAX_GRID
        assert (layout.cluster - 1) * layout.width < n <= (
            layout.cluster * layout.width)
        assert layout.smem_bytes <= k1.SMEM_LIMIT_BYTES
        return
    assert layout.cluster in (1, 2, 4, 8, 16)
    assert layout.smem_bytes <= k1.SMEM_LIMIT_BYTES
    assert layout.width == -(-n // layout.cluster)
    assert layout.cluster * layout.width >= n
    assert layout.threads % 32 == 0 and 128 <= layout.threads <= 1024
    basis = k1._basis_bytes(m, k, layout.cluster, layout.threads, itemsize)
    fits = basis + _slice_bytes(m, layout.width, itemsize) \
        <= k1.SMEM_LIMIT_BYTES
    assert layout.resid_in_smem == fits
    assert layout.smem_bytes == basis + (
        _slice_bytes(m, layout.width, itemsize) if fits else 0)
    # The rule is a function of the shape: asking twice gives the same.
    assert layout == k1.panel_layout(m, n, k, itemsize)
    # The residual goes to global memory only when no cluster size holds it.
    if not layout.resid_in_smem:
        for c in k1.CLUSTER_SIZES:
            other = k1.layout_at(m, n, k, itemsize, c)
            assert other is None or not other.resid_in_smem


@pytest.mark.parametrize("m,n,k,itemsize,cluster,in_smem", [
    (24, 16384, 16, 4, 16, True),     # the 16384-wide sketch: 16 x 96 KB
    (16, 16384, 16, 4, 16, True),
    (136, 256, 128, 4, 8, True),      # the RRQR shortlist, Q replicated
    (24, 32, 16, 4, 1, True),         # small panels stay one CTA
    (53, 8192, 43, 8, 16, False),     # 217 KB a slice: stays in L2
    (43, 8192, 43, 8, 16, True),
])
def test_layout_of_the_main_path_panels(k1, m, n, k, itemsize, cluster,
                                        in_smem):
    layout = k1.panel_layout(m, n, k, itemsize)
    assert (layout.cluster, layout.resid_in_smem) == (cluster, in_smem)


def test_small_panel_takes_few_threads(k1):
    assert k1.panel_layout(24, 32, 16, 4).threads == 128
    assert k1.panel_layout(24, 2048, 16, 4).threads < 1024


# Since the grid layouts of K1 and K2 every panel fits; the last three
# rows, whose Q does not replicate in a CTA, run as a grid.
@pytest.mark.parametrize("m,k,itemsize,fits", [
    (136, 128, 4, True), (136, 128, 8, True), (400, 136, 4, True),
    (400, 136, 8, True), (4096, 100, 4, True), (2048, 100, 8, True),
])
def test_kernel_fits_is_where_a_layout_exists(k1, m, k, itemsize, fits):
    assert k1.kernel_fits(m, k, itemsize) == fits
    for n in (k, 1000, 50_000):
        assert (k1.panel_layout(m, n, k, itemsize) is not None) == fits


def test_from_numpy_defaults_to_the_card():
    from rusty_compression_tpu_torch import interop

    default = inspect.signature(interop.from_numpy).parameters["device"]
    assert default.default == "cuda"
