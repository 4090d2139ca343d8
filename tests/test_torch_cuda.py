"""K1 and K2 on the card: the CUDA kernels against their plain version, and
the routes that launch them.

These tests need an NVIDIA card (marker ``cuda``) and skip without one.
This file imports neither JAX nor the JAX package, so that on a machine
with a card and no JAX it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances: pivots exactly equal; q and r to 1e-4 absolute (f32 and c64,
another summation order). Two launches on one panel are bitwise equal
(no atomics, fixed reduction orders).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def k1():
    """The kernels' module, on a machine with a card; skips otherwise."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from rusty_compression_tpu_torch.ops.kernels import qrcp

    return qrcp


def _panel(shape, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * np.geomspace(1.0, 0.1, shape[-1])
    return torch.tensor(a, dtype=torch.float32, device="cuda")


@pytest.mark.parametrize("shape,k,masked", [
    ((24, 2048), 16, False),      # the 2048^2 batch's sketch
    ((16, 2048), 16, False),      # the LQ of C at rank 16
    ((37, 301), 29, True),        # ragged, with a used mask
    ((33, 5), 5, False),          # fewer columns than a warp, k = n
    ((5, 40), 5, False),          # k = m: the residual runs out
    ((3, 24, 2048), 16, False),   # a batch: one cluster per panel
])
def test_kernel_matches_plain(k1, shape, k, masked):
    import torch

    a = _panel(shape)
    used = None
    if masked:
        used = torch.zeros(shape[-1], dtype=torch.bool, device="cuda")
        used[::7] = True
    before = k1.qrcp_panel.launch_count
    q, r, piv = k1.qrcp_panel(a, k, used=used)
    torch.cuda.synchronize()
    assert k1.qrcp_panel.launch_count == before + 1
    q0, r0, piv0 = k1.qrcp_panel_plain(a, k, used)
    assert torch.equal(piv.long(), piv0)
    assert float((q - q0).abs().max()) <= 1e-4
    assert float((r - r0).abs().max()) <= 1e-4


def test_rank_deficient_pivots_stay_permutation(k1):
    import torch

    a = torch.zeros((6, 4), dtype=torch.float32, device="cuda")
    a[2, :] = 1.0
    _, _, piv = k1.qrcp_panel(a, 4)
    assert sorted(piv.tolist()) == [0, 1, 2, 3]
    used = torch.tensor([True, False, False, False], device="cuda")
    _, _, piv = k1.qrcp_panel(a, 3, used=used)
    assert 0 not in piv.tolist()


def test_kernel_rejects_what_it_cannot_take(k1):
    import torch

    a = _panel((24, 64))
    with pytest.raises(ValueError, match="f32-only"):
        k1.qrcp_panel(a.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        k1.qrcp_panel(a.mT, 4)
    with pytest.raises(ValueError, match="shared memory"):
        k1.qrcp_panel(_panel((4096, 100)), 100)
    with pytest.raises(ValueError, match="device"):
        k1.qrcp_panel(a, 4, used=torch.zeros(64, dtype=torch.bool))


def test_auto_mode_takes_the_kernel(k1):
    """pivoted_qr / pivoted_lq on an f32 CUDA tensor launch K1 once."""
    import torch

    from rusty_compression_tpu_torch import pivoted_lq, pivoted_qr

    a = _panel((24, 2048))
    before = k1.qrcp_panel.launch_count
    q, r, ind = pivoted_qr(a, max_rank=16)
    l, _, _ = pivoted_lq(a.mT.contiguous(), max_rank=16)
    torch.cuda.synchronize()
    assert k1.qrcp_panel.launch_count == before + 2
    np.testing.assert_allclose((q @ r)[:, :16].cpu().numpy(),
                               a[:, ind[:16]].cpu().numpy(), atol=1e-4)
    assert torch.equal(l, torch.tril(l))


def _complex_panel(shape, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    a = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
         * np.geomspace(1.0, 0.1, shape[-1]))
    return torch.tensor(a, dtype=torch.complex64, device="cuda")


@pytest.mark.parametrize("shape,k,masked", [
    ((53, 2048), 43, False),      # the core of a complex ID at rank 43
    ((43, 2048), 43, False),      # the LQ of C: k = m
    ((37, 301), 29, True),        # ragged, with a used mask
    ((33, 5), 5, False),          # fewer columns than a warp, k = n
    ((3, 24, 2048), 16, False),   # a batch: one cluster per panel
])
def test_complex_kernel_matches_plain(k1, shape, k, masked):
    import torch

    a = _complex_panel(shape)
    used = None
    if masked:
        used = torch.zeros(shape[-1], dtype=torch.bool, device="cuda")
        used[::7] = True
    before = k1.qrcp_panel_complex.launch_count
    q, r, piv = k1.qrcp_panel_complex(a, k, used=used)
    torch.cuda.synchronize()
    assert k1.qrcp_panel_complex.launch_count == before + 1
    q0, r0, piv0 = k1.qrcp_panel_plain(a, k, used)
    assert torch.equal(piv.long(), piv0)
    assert float((q - q0).abs().max()) <= 1e-4
    assert float((r - r0).abs().max()) <= 1e-4


def test_complex_kernel_rank_deficient_and_rejections(k1):
    import torch

    a = torch.zeros((6, 4), dtype=torch.complex64, device="cuda")
    a[2, :] = 1.0 + 1.0j
    _, _, piv = k1.qrcp_panel_complex(a, 4)
    assert sorted(piv.tolist()) == [0, 1, 2, 3]
    b = _complex_panel((24, 64))
    with pytest.raises(ValueError, match="c64-only"):
        k1.qrcp_panel_complex(b.to(torch.complex128), 4)
    with pytest.raises(ValueError, match="contiguous"):
        k1.qrcp_panel_complex(b.mH, 4)
    with pytest.raises(ValueError, match="shared memory"):
        k1.qrcp_panel_complex(_complex_panel((2048, 100)), 100)


def test_blocked_route_launches_the_panel_kernel(k1):
    """Blocked RRQR on the card: one K1 launch per panel on the shortlist
    (f32), one K2 launch per panel (c64); same pivots as the plain rule
    given the same sketch matrix."""
    import torch

    from rusty_compression_tpu_torch import pivoted_qr
    from rusty_compression_tpu_torch.ops.pivoted_qr import (
        _qrcp_blocked_from_gaussian)

    for make, wrapper in ((_panel, k1.qrcp_panel),
                          (_complex_panel, k1.qrcp_panel_complex)):
        a = make((300, 400), seed=3)
        before = wrapper.launch_count
        q, r, ind = pivoted_qr(a, max_rank=96, mode="blocked", block_size=32)
        torch.cuda.synchronize()
        assert wrapper.launch_count == before + 3
        assert float((q.mH @ q - torch.eye(96, device="cuda")).abs().max()
                     ) <= 1e-5
        assert float(((q @ r)[:, :96] - a[:, ind[:96]]).abs().max()) <= 1e-4
        g = torch.randn((40, 300), device="cuda").to(a.dtype)
        piv_k = _qrcp_blocked_from_gaussian(a, g, 96, 32,
                                            pivot_kernel="kernel")[2]
        piv_p = _qrcp_blocked_from_gaussian(a, g, 96, 32,
                                            pivot_kernel="plain")[2]
        assert torch.equal(piv_k, piv_p)


def test_complex_auto_mode_takes_k2(k1):
    """pivoted_qr / pivoted_lq on a c64 CUDA tensor launch K2 once each,
    and the lazy conjugate of pivoted_lq's ``a.mH`` is written out."""
    import torch

    from rusty_compression_tpu_torch import pivoted_lq, pivoted_qr

    a = _complex_panel((53, 2048))
    before = k1.qrcp_panel_complex.launch_count
    q, r, ind = pivoted_qr(a, max_rank=43)
    c = a.mH[:, :20].resolve_conj().contiguous()   # (2048, 20)
    l, ql, row_ind = pivoted_lq(c)
    torch.cuda.synchronize()
    assert k1.qrcp_panel_complex.launch_count == before + 2
    assert float(((q @ r)[:, :43] - a[:, ind[:43]]).abs().max()) <= 1e-4
    assert float(((l @ ql)[:20] - c[row_ind[:20]]).abs().max()) <= 1e-4
    assert torch.equal(l, torch.tril(l))


# The clustered layouts: (maker, wrapper name, itemsize) for K1 and K2.
_KERNELS = {"f32": (_panel, "qrcp_panel", "rc_qrcp_panel_f32", 4),
            "c64": (_complex_panel, "qrcp_panel_complex",
                    "rc_qrcp_panel_c64", 8)}


def _assert_matches_plain(k1, got, a, k, used, steps=None):
    import torch

    q, r, piv = got
    q0, r0, piv0 = k1.qrcp_panel_plain(a, k, used)
    steps = k if steps is None else steps
    assert torch.equal(piv.long()[..., :steps], piv0[..., :steps])
    assert float((q - q0)[..., :steps].abs().max()) <= 1e-4
    assert float((r - r0)[..., :steps, :].abs().max()) <= 1e-4


@pytest.mark.parametrize("kind", ["f32", "c64"])
@pytest.mark.parametrize("shape,k", [
    ((24, 16389), 16),     # n no multiple of 32 C: a ragged last slice
    ((53, 8191), 43),      # the same at the complex core's size
    ((600, 40), 8),        # fewer columns than 32 a CTA
    ((16, 4096), 16),      # k = m over a cluster
    ((8, 24, 2048), 16),   # a batch of clusters
])
def test_clustered_layouts_match_plain_and_repeat(k1, kind, shape, k):
    import torch

    make, name, _, itemsize = _KERNELS[kind]
    wrapper = getattr(k1, name)
    a = make(shape)
    layout = k1.panel_layout(*shape[-2:], k, itemsize)
    assert layout.cluster > 1
    got = wrapper(a, k)
    again = wrapper(a, k)
    torch.cuda.synchronize()
    _assert_matches_plain(k1, got, a, k, None)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["f32", "c64"])
@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
def test_forced_cluster_sizes(k1, kind, cluster):
    """Every cluster size on one small panel, one with fewer columns than
    CTAs (n = 5 at 8 and 16 CTAs: some CTAs own no column)."""
    import torch

    make, name, entry, itemsize = _KERNELS[kind]
    for shape, k in (((37, 301), 29), ((33, 5), 5)):
        a = make(shape)
        layout = k1.layout_at(*shape, k, itemsize, cluster)
        got = k1._panel(getattr(k1, name), entry, a, k, None, layout)
        torch.cuda.synchronize()
        _assert_matches_plain(k1, got, a, k, None)


@pytest.mark.parametrize("kind", ["f32", "c64"])
def test_masks_over_a_slice_and_over_most_columns(k1, kind):
    import torch

    make, name, _, itemsize = _KERNELS[kind]
    wrapper = getattr(k1, name)
    a = make((24, 4096))
    layout = k1.panel_layout(24, 4096, 16, itemsize)
    assert layout.cluster > 1
    # One CTA's whole slice is used: it never wins over a live column.
    used = torch.zeros(4096, dtype=torch.bool, device="cuda")
    used[layout.width:2 * layout.width] = True
    got = wrapper(a, 16, used=used)
    torch.cuda.synchronize()
    _assert_matches_plain(k1, got, a, 16, used)
    assert not used[got[2].long()].any()
    # Ten live columns for sixteen steps: the live ones come first, in the
    # plain version's order; step 11 takes the lowest used column, as
    # torch.argmax does on a table of -1, and what follows is noise.
    used = torch.ones(4096, dtype=torch.bool, device="cuda")
    live = torch.arange(10, device="cuda") * 400 + 3
    used[live] = False
    got = wrapper(a, 16, used=used)
    torch.cuda.synchronize()
    _assert_matches_plain(k1, got, a, 16, used, steps=11)
    assert sorted(got[2][:10].tolist()) == live.tolist()
    assert int(got[2][10]) == 0


@pytest.mark.parametrize("kind", ["f32", "c64"])
def test_rank_deficient_clustered_pivots_stay_permutation(k1, kind):
    import torch

    _, name, _, itemsize = _KERNELS[kind]
    dtype = torch.float32 if kind == "f32" else torch.complex64
    a = torch.zeros((600, 40), dtype=dtype, device="cuda")
    a[2, :] = 1.0
    assert k1.panel_layout(600, 40, 16, itemsize).cluster > 1
    _, _, piv = getattr(k1, name)(a, 16)
    assert sorted(piv.tolist()) == list(range(16))


# ---------------------------------------------------------------------------
# The tolerance-driven slice on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,k", [
    ((72, 128), 64),        # hilbert(1024) at max_rank 64: the shortlist
    ((72, 1024), 64),       # the same with the pivot rule at full width
    ((80, 144), 72),        # the 72-row sketch of the tolerance-mode ID
    ((136, 64), 32),        # the last panel of a rank-288 RRQR
    ((136, 192), 96),       # ... of a rank-224 one
    ((2, 1024, 1024), 16),  # a whole block as the panel: residual in L2
])
def test_new_panel_shapes_with_their_masks(k1, shape, k):
    """The K1 shapes that the adaptive QR, config 2 and the tolerance-mode
    ID launch, masked as the blocked RRQR masks them (but for the whole
    block, which the kernel mode factorizes unmasked)."""
    import torch

    a = _panel(shape, seed=4)
    used = None
    if len(shape) == 2:
        used = torch.zeros(shape[-1], dtype=torch.bool, device="cuda")
        used[::5] = True
    got = k1.qrcp_panel(a, k, used=used)
    again = k1.qrcp_panel(a, k, used=used)
    torch.cuda.synchronize()
    _assert_matches_plain(k1, got, a, k, used)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    panels = shape[0] if len(shape) == 3 else 1
    assert ((panels, *shape[-2:]), k, used is not None) \
        in k1.qrcp_panel.launched_shapes


def _decade_block(size, per_decade, seed, dtype):
    """U diag(10^(-j / per_decade)) V^T on the host, f64, cast to dtype."""
    import torch

    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((size, size)))
    v, _ = np.linalg.qr(rng.standard_normal((size, size)))
    sigma = 10.0 ** (-np.arange(size) / per_decade)
    return torch.tensor((u * sigma) @ v.T, dtype=dtype)


@pytest.mark.parametrize("dtype_name,tol,rtol", [("float64", 2.6e-4, 1e-6),
                                                 ("float32", 2.6e-4, 2e-2)])
def test_adaptive_loop_on_the_card_against_the_cpu(k1, dtype_name, tol, rtol):
    """The same Gaussian matrices on both devices, a stack whose lanes
    fall by a decade every 8, 16 and 32 columns: the same rounds in every
    lane, the history within rtol (f32: the deflated probe sits near 1e-4
    of the operator norm, where another summation order shows), zero
    padding, and one host read a round. The tolerance is chosen so that
    no estimate of this fixture comes within a factor 1.5 of it."""
    import torch

    from rusty_compression_tpu_torch import DenseOperator
    from rusty_compression_tpu_torch.sampling import _adaptive_loop

    dtype = getattr(torch, dtype_name)
    blocks = torch.stack([_decade_block(256, per, 5 + per, dtype)
                          for per in (8, 16, 32)])
    g = torch.Generator().manual_seed(6)
    omegas = [torch.randn((3, 256, 16), generator=g, dtype=dtype)
              for _ in range(13)]
    out = {}
    for dev in ("cpu", "cuda"):
        _adaptive_loop.host_reads = 0
        res = _adaptive_loop(DenseOperator(blocks.to(dev)),
                             iter([o.to(dev) for o in omegas]), tol, 16, 12)
        out[dev] = [x.cpu() for x in res] + [_adaptive_loop.host_reads]
    (qc, bc, nc, ic, hc, rc_), (qg, bg, ng, ig, hg, rg) = out["cpu"], out["cuda"]
    live = hc[hc > 0]
    assert bool(((live > 1.5 * tol) | (live < tol / 1.5)).all()), live
    assert torch.equal(nc, ng) and torch.equal(ic, ig) and rc_ == rg
    assert len(set(ng.tolist())) == 3 and rg == int(ig.max()) + 1
    # an estimate within ~30 eps of the operator norm is roundoff itself
    floor = 30 * torch.finfo(dtype).eps
    np.testing.assert_allclose(hg.numpy(), hc.numpy(), rtol=rtol, atol=floor)
    for i in range(3):
        k = int(ng[i])
        assert not qg[i, :, k:].any() and not bg[i, k:].any()
    np.testing.assert_allclose((qg @ bg).numpy(), (qc @ bc).numpy(),
                               atol=10 * rtol * tol)


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "complex64"])
def test_sparse_operator_products_on_the_card(k1, dtype_name):
    """``A X`` and ``A^H X`` of a sparse operator on the card against the
    dense products (1e-5 f32/c64, 1e-12 f64, of the largest entry), from a
    COO and from a CSR tensor."""
    import torch

    from rusty_compression_tpu_torch import SparseOperator

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(7)
    dense = torch.randn((600, 400), generator=g, device="cuda").to(dtype)
    if dtype.is_complex:
        dense = dense + 1j * torch.randn((600, 400), generator=g,
                                         device="cuda")
    dense = dense * (torch.rand((600, 400), generator=g, device="cuda") < 0.02)
    x = torch.randn((400, 5), generator=g, device="cuda").to(dtype)
    y = torch.randn((600, 5), generator=g, device="cuda").to(dtype)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for a in (dense.to_sparse_coo(), dense.to_sparse_csr()):
        op = SparseOperator(a)
        assert op.device.type == "cuda" and op.dtype == dtype
        for got, want in ((op.matmat(x), dense @ x),
                          (op.conj_matmat(y), dense.mH @ y)):
            assert float((got - want).abs().max()) <= tol * float(
                want.abs().max())
        assert torch.equal(op.to_dense(), dense)


def test_compress_of_a_c64_block_goes_through_k2(k1):
    """A complex target takes the normal paths: the ID methods of
    ``compress`` launch K2 on the card, and C is bitwise columns of the
    block."""
    import torch

    import rusty_compression_tpu_torch as rt

    rng = np.random.default_rng(8)
    u, _ = np.linalg.qr(rng.standard_normal((1024, 64))
                        + 1j * rng.standard_normal((1024, 64)))
    v, _ = np.linalg.qr(rng.standard_normal((768, 64))
                        + 1j * rng.standard_normal((768, 64)))
    a = torch.tensor((u * np.geomspace(1.0, 1e-6, 64)) @ v.conj().T,
                     dtype=torch.complex64, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(9)
    k2 = k1.qrcp_panel_complex
    for method, launches in (("sketched_two_sided_id", 2), ("column_id", 1),
                             ("two_sided_id", 2), ("row_id", 1)):
        before = k2.launch_count
        f = rt.compress(a, g, rt.CompressionConfig.RANK(24, method=method))
        torch.cuda.synchronize()
        assert k2.launch_count - before == launches, method
        assert f.to_mat().dtype == torch.complex64 and f.rank == 24
        # sigma_25 / sigma_1 = 10^(-6 * 24 / 63) = 5.2e-3; an ID may lose
        # a small multiple of it
        assert float(rt.rel_diff_fro(f.to_mat(), a)) < 10 * 5.2e-3
    cid = rt.sketched_column_id(a, g, rank=24)
    assert torch.equal(cid.c, a[:, cid.col_ind[:24]])
    svd, hist = rt.compress(a, g, rt.CompressionConfig.ADAPTIVE(
        1e-3, sample_size=8))
    assert float(rt.rel_diff_fro(svd.to_mat(), a)) < 5e-3
