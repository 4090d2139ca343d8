"""K1-K4 on the card: the CUDA kernels against their plain versions, and
the routes that launch them; the tol <= 1e-8 pipelines in f64/c128; the
block stream, its pinned packing and checkpoints.

These tests need an NVIDIA card (marker ``cuda``) and skip without one.
This file imports neither JAX nor the JAX package, so that on a machine
with a card and no JAX it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances: pivots exactly equal; q and r to 1e-4 absolute (f32 and c64,
another summation order), 1e-9 for K3 and K4 (f64 and c128, the same).
Two launches on one panel are bitwise equal (no atomics, fixed reduction
orders).
"""

import numpy as np
import pytest

from torch_threads import one_thread  # noqa: F401 (autouse)

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
    """The wrong dtype, a transposed view and a mask on another device
    raise; a (4096, 100) panel at k = 100, whose Q does not replicate in a
    CTA (it raised before K1 had a grid), runs as one grid launch."""
    import torch

    a = _panel((24, 64))
    with pytest.raises(ValueError, match="f32-only"):
        k1.qrcp_panel(a.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        k1.qrcp_panel(a.mT, 4)
    tall = _panel((4096, 100))
    before = k1.qrcp_panel.launch_count
    got = k1.qrcp_panel(tall, 100)
    torch.cuda.synchronize()
    assert k1.qrcp_panel.launch_count == before + 1
    _assert_matches_plain(k1, got, tall, 100, None)
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
    """Rank-deficient pivots stay a permutation; the wrong dtype and a
    conjugate view raise; a (2048, 100) panel at k = 100, whose Q does not
    replicate in a CTA (it raised before K2 had a grid), runs as one grid
    launch."""
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
    tall = _complex_panel((2048, 100))
    before = k1.qrcp_panel_complex.launch_count
    got = k1.qrcp_panel_complex(tall, 100)
    torch.cuda.synchronize()
    assert k1.qrcp_panel_complex.launch_count == before + 1
    _assert_matches_plain(k1, got, tall, 100, None)


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

    make, name, _, itemsize = _KERNELS[kind]
    for shape, k in (((37, 301), 29), ((33, 5), 5)):
        a = make(shape)
        layout = k1.layout_at(*shape, k, itemsize, cluster)
        got = k1._panel(getattr(k1, name), a, k, None, layout)
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


# ---------------------------------------------------------------------------
# The tol <= 1e-8 pipelines (highacc, highacc_id) in f64 / c128 on the card
# ---------------------------------------------------------------------------


def _decaying(seed, m, n, decay_rank=60, complex_=False):
    """sigma_i = 10^(-10 i / (decay_rank - 1)), floor 1e-12: crosses 1e-8 at
    i = 0.8 (decay_rank - 1)."""
    rng = np.random.default_rng(seed)
    k = min(m, n)
    sig = np.maximum(10.0 ** (-10 * np.arange(k) / (decay_rank - 1)), 1e-12)

    def basis(rows):
        g = rng.standard_normal((rows, k))
        if complex_:
            g = g + 1j * rng.standard_normal((rows, k))
        return np.linalg.qr(g)[0]

    return (basis(m) * sig) @ basis(n).conj().T


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("mode", ["fixed", "growth"])
def test_refined_rsvd_rank_on_the_card_equals_the_cpu(k1, complex_, mode):
    import torch

    import rusty_compression_tpu_torch as rt

    a = _decaying(70, 384, 320, complex_=complex_)
    kwargs = dict(round_rank=66) if mode == "fixed" else {}
    outs = {dev: rt.refined_rsvd(torch.tensor(a, device=dev),
                                 torch.Generator(device=dev).manual_seed(1),
                                 tol=1e-8, **kwargs)
            for dev in ("cpu", "cuda")}
    torch.cuda.synchronize()
    assert outs["cuda"].u.device.type == "cuda"
    assert outs["cuda"].rank == outs["cpu"].rank
    for out in outs.values():
        assert out.residual_fro(a) <= 5e-8
    np.testing.assert_allclose(outs["cuda"].s.cpu().numpy(),
                               outs["cpu"].s.numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("side", ["col", "row"])
def test_refined_two_sided_id_on_the_card(k1, side):
    """Skeleton bitwise A's entries; the core's pivots up to the rank equal
    LAPACK ``?geqp3``'s (scipy) on the same core copied to the host."""
    import scipy.linalg
    import torch

    import rusty_compression_tpu_torch as rt
    from rusty_compression_tpu_torch.highacc_id import (_core_qrcp,
                                                        _truncation_rank)

    a = torch.tensor(_decaying(71, 512, 448), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    ts = rt.refined_two_sided_id(a, g, tol=1e-8, side=side)
    torch.cuda.synchronize()
    k = ts.rank
    assert torch.equal(ts.x, a[ts.row_ind[:k][:, None], ts.col_ind[:k]])
    rec = ts.c @ ts.x @ ts.r
    assert float(torch.linalg.norm(rec - a) / torch.linalg.norm(a)) <= 1e-7
    _, b, _, captured = rt.refined_capture(a, g, tol=1e-8)
    rb, ind = _core_qrcp(b)
    kf = _truncation_rank(torch.diagonal(rb), 1e-8, None, captured)
    _, _, piv = scipy.linalg.qr(b.cpu().numpy(), mode="economic",
                                pivoting=True)
    np.testing.assert_array_equal(ind.cpu().numpy()[:kf], piv[:kf])


def test_compress_highacc_on_the_card_is_the_direct_call(k1):
    import torch

    import rusty_compression_tpu_torch as rt
    from rusty_compression_tpu_torch.highacc import refined_rsvd_batch

    stack = torch.tensor(np.stack([_decaying(72 + i, 256, 256, 30 + 10 * i)
                                   for i in range(3)]), device="cuda")
    cfg = rt.CompressionConfig.ADAPTIVE(1e-8, highacc=True, round_rank=56)

    def gen():
        return torch.Generator(device="cuda").manual_seed(3)

    got, _ = rt.compress(stack[1], gen(), cfg)
    want = rt.refined_rsvd(stack[1], gen(), round_rank=56, tol=1e-8)
    pairs = [(got, want)] + list(zip(
        rt.compress(stack, gen(), cfg),
        refined_rsvd_batch(list(stack), gen(), round_rank=56, tol=1e-8)))
    for got, want in pairs:
        for name in ("u", "s", "vt"):
            assert torch.equal(getattr(got, name), getattr(want, name))


def test_batched_growth_and_marking_on_the_card(k1):
    import torch

    import rusty_compression_tpu_torch as rt

    blocks = np.stack([_decaying(80 + i, 256, 256, 30 + 10 * i)
                       for i in range(4)])
    stack = torch.tensor(blocks, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    outs = rt.refined_rsvd_fused_batch(stack, g, tol=1e-8)
    for o, b, dk in zip(outs, blocks, (30, 40, 50, 60)):
        assert o.tol_ok and abs(o.rank - round(0.8 * (dk - 1))) <= 3
        assert o.residual_fro(b) <= 5e-8
    stack[0] = torch.randn((256, 256), generator=g, device="cuda",
                           dtype=torch.float64)
    outs = rt.refined_rsvd_fused_batch(stack, g, round_rank=56, tol=1e-8,
                                       on_unreachable="mark")
    assert [o.tol_ok for o in outs] == [False, True, True, True]


# ---------------------------------------------------------------------------
# The block stream, its pinned packing and checkpoints on the card
# ---------------------------------------------------------------------------


_SHAPES = [(300, 150), (140, 600), (256, 256), (45, 700), (520, 130),
           (90, 90)]


def _stream_blocks(dtype, seed=90):
    """Blocks of six shapes over several buckets, exact rank 12 (f32) or
    sigma_i = 10^(-10 i / 39) with floor 1e-12 (f64)."""
    if dtype == np.float64:
        return [_decaying(seed + i, m, n, 40) for i, (m, n) in
                enumerate(_SHAPES)]
    rng = np.random.default_rng(seed)
    out = []
    for m, n in _SHAPES:
        u = np.linalg.qr(rng.standard_normal((m, 12)))[0]
        v = np.linalg.qr(rng.standard_normal((n, 12)))[0]
        out.append(((u * np.geomspace(1.0, 1e-2, 12)) @ v.T).astype(dtype))
    return out


def _laplace_stream(seed=91):
    """f32 Laplace blocks between unit clouds 3-5 apart (the clouds of
    ``tools/_gen_blocks10k.py``), of the same shapes. The adaptive loop
    needs a spectrum without an exact rank: on a block of exact rank in f32
    it runs to the cap in both packages (the probes of the deflated
    residual are roundoff)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (m, n) in enumerate(_SHAPES):
        x = rng.uniform(-0.5, 0.5, (m, 3))
        y = rng.uniform(-0.5, 0.5, (n, 3)) + [3.0 + 0.5 * (i % 5),
                                              0.5 * (i % 3), 0.0]
        d = np.sqrt(((x[:, None, :] - y[None]) ** 2).sum(-1))
        out.append((1.0 / (4.0 * np.pi * d)).astype(np.float32))
    return out


@pytest.mark.parametrize("stream", ["sketched_two_sided_id", "rsvd",
                                    "tolerance", "refined"])
def test_block_stream_on_the_card_against_the_cpu(k1, stream):
    """Host numpy blocks through the stream on both devices: the same
    buckets and ranks, residuals within 1e-5 (f32) / 1e-12 (f64), factors
    on the host; the ID stream launches K1."""
    import torch

    from rusty_compression_tpu_torch.parallel import scheduler

    f64 = stream == "refined"
    blocks = (_laplace_stream() if stream == "tolerance"
              else _stream_blocks(np.float64 if f64 else np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        g = torch.Generator(device=dev).manual_seed(11)
        before = k1.qrcp_panel.launch_count
        if stream == "refined":
            res = scheduler.compress_heterogeneous_refined(
                blocks, g, rel_tol=1e-8, round_rank=32, chunk_bytes=1 << 20)
        elif stream == "tolerance":
            res = scheduler.compress_heterogeneous(
                blocks, g, rel_tol=1e-3, sample_size=16, chunk_bytes=1 << 20)
        else:
            res = scheduler.compress_heterogeneous(
                blocks, g, rank=12, method=stream, chunk_bytes=1 << 20)
        torch.cuda.synchronize()
        launched = k1.qrcp_panel.launch_count - before
        assert (launched > 0) == (dev == "cuda" and stream.endswith("_id"))
        out[dev] = res
    for c, d in zip(out["cpu"], out["cuda"]):
        assert (c.index, c.bucket, c.rank, c.ok) == (d.index, d.bucket,
                                                     d.rank, d.ok)
        assert abs(c.rel_residual - d.rel_residual) <= (1e-12 if f64
                                                        else 1e-5)
        assert all(getattr(d.factors, f).device.type == "cpu"
                   for f in d.factors.__dataclass_fields__)


def test_refined_stream_of_single_block_chunks(k1):
    """``chunk_bytes`` of less than one block: every chunk holds one block
    (a 1536 x 2048 f64 block among the six), so every core SVD is that of
    one matrix. The card gives the CPU's ranks and residuals (1e-12), no
    block takes a fallback, and no SVD warns that it did not converge.
    Prints the stream's time on the card."""
    import logging
    import time
    import warnings

    import torch

    from rusty_compression_tpu_torch.parallel import scheduler

    blocks = _stream_blocks(np.float64) + [_decaying(97, 1536, 2048, 60)]
    counts = []

    class Tally(logging.Handler):
        def emit(self, record):
            if hasattr(record, "fallbacks"):
                counts.append(record.fallbacks)

    lg = logging.getLogger("rusty_compression_tpu_torch.scheduler")
    level, tally = lg.level, Tally()
    lg.setLevel(logging.INFO)
    lg.addHandler(tally)
    out, seconds = {}, {}
    try:
        for dev in ("cpu", "cuda"):
            g = torch.Generator(device=dev).manual_seed(12)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                out[dev] = scheduler.compress_heterogeneous_refined(
                    blocks, g, rel_tol=1e-8, chunk_bytes=1)
                seconds[dev] = time.perf_counter() - t0
            assert not [w for w in caught if "converge" in str(w.message)]
    finally:
        lg.removeHandler(tally)
        lg.setLevel(level)
    assert [c["blocks"] for c in counts] == [0, 0]
    for c, d in zip(out["cpu"], out["cuda"]):
        assert c.ok and d.ok and (c.bucket, c.rank) == (d.bucket, d.rank)
        assert abs(c.rel_residual - d.rel_residual) <= 1e-12
    print(f"\nrefined stream, {len(blocks)} single-block chunks: "
          f"{seconds['cuda']:.3f} s on the card, {seconds['cpu']:.3f} s on "
          f"the CPU ({torch.cuda.get_device_name(0)})")


def test_pinned_packing_round_trip(k1):
    """Host blocks packed into the pinned slots and copied to the card: the
    zero-padded stack, bitwise; a slot is reused once its copy is done."""
    import torch

    from rusty_compression_tpu_torch.parallel.scheduler import _Packer

    blocks = _stream_blocks(np.float32)
    shapes = [b.shape for b in blocks]
    packer = _Packer(torch.device("cuda"), window=2)
    for rep in range(3):
        for idxs, (bm, bn) in (([0, 5], (512, 256)), ([3], (128, 1024))):
            stack = packer.pack(blocks, shapes, idxs, bm, bn, torch.float32)
            assert stack.device.type == "cuda"
            want = torch.zeros((len(idxs), bm, bn))
            for s, i in enumerate(idxs):
                want[s, :shapes[i][0], :shapes[i][1]] = torch.from_numpy(
                    blocks[i])
            assert torch.equal(stack.cpu(), want)
    assert all(buf.is_pinned() for buf in packer.slots)
    assert packer.count == 6


def test_load_factors_onto_the_card(k1, tmp_path):
    import torch

    import rusty_compression_tpu_torch as rt

    a = torch.tensor(_decaying(95, 200, 150), device="cuda")
    cid = rt.QR.compute_from(a, max_rank=20).column_id()
    path = str(tmp_path / "f.npz")
    rt.io.save_factors(path, cid)
    back = rt.io.load_factors(path)   # device="cuda" by default
    assert back.c.device.type == "cuda" and back.col_ind.dtype == torch.int64
    assert torch.equal(back.c, cid.c) and torch.equal(back.z, cid.z)


# ---------------------------------------------------------------------------
# The multi-card layer on one card
# ---------------------------------------------------------------------------


@pytest.fixture
def card_mesh(k1):
    """``make_mesh()`` on the card: a group of one rank under NCCL, made in
    this process and destroyed after the test."""
    import torch.distributed as dist

    from rusty_compression_tpu_torch.parallel import make_mesh

    try:
        yield make_mesh()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _mesh_stack(seed: int = 21, count: int = 4, side: int = 512):
    import torch

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((count, side, 48)) @ (
        np.geomspace(1, 1e-6, 48)[:, None]
        * rng.standard_normal((count, 48, side)))
    return torch.tensor(a, dtype=torch.float32, device="cuda")


@pytest.mark.parametrize("call", ["rsvd", "column_id", "adaptive"])
def test_mesh_of_one_card_is_the_unsharded_call(k1, card_mesh, call):
    """``compress_blocks(mesh=make_mesh())`` at world size 1 under NCCL:
    bitwise the call without a mesh; the column ID launches K1; gathering
    is one NCCL all-gather of each factor."""
    import torch

    from rusty_compression_tpu_torch import parallel as par

    blocks = _mesh_stack()

    def once(mesh):
        g = torch.Generator(device="cuda").manual_seed(3)
        if call == "adaptive":
            return par.compress_blocks_adaptive(blocks, g, 1e-3, 16, 64,
                                                mesh=mesh)
        return par.compress_blocks(blocks, g, 16, method=call, mesh=mesh)

    want = par.gather_factors(once(None))
    before = k1.qrcp_panel.launch_count
    got = par.gather_factors(once(card_mesh), card_mesh)
    torch.cuda.synchronize()
    assert (k1.qrcp_panel.launch_count > before) == (call == "column_id")
    flat = (lambda x: [*x[0].__dict__.values(), *x[1:]]) \
        if call == "adaptive" else (lambda x: list(x.__dict__.values()))
    for g_, w_ in zip(flat(got), flat(want)):
        assert isinstance(g_, np.ndarray) and np.array_equal(g_, w_)


def test_row_sharded_operator_on_one_card(k1, card_mesh):
    """``RowShardedOperator`` over the one-rank "blocks" axis: products
    equal the dense ones (f32, 1e-5 of the largest entry), and the rank-16
    range sampler and SVD through it reach the dense route's error."""
    import torch

    import rusty_compression_tpu_torch as rt
    from rusty_compression_tpu_torch import parallel as par

    a = _mesh_stack(22, 1, 2048)[0]
    op = par.RowShardedOperator(a, card_mesh, "blocks")
    x = torch.randn(2048, 8, device="cuda")
    for got, want in ((op.matmat(x), a @ x), (op.conj_matmat(x), a.T @ x)):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    errs = []
    for target in (op, rt.DenseOperator(a)):
        g = torch.Generator(device="cuda").manual_seed(4)
        q = rt.sample_range_by_rank(target, g, 16, 5)
        svd = rt.SVD.compute_from_range_estimate(q, target)
        errs.append(float(rt.rel_diff_fro(svd.to_mat(), a)))
    assert errs[0] == pytest.approx(errs[1], rel=1e-3)


_TWO_RANKS = """
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
from rusty_compression_tpu_torch import parallel as par
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=2, rank=rank)
mesh = par.make_mesh(device_type="cuda")
blocks = torch.load(out + "/blocks.pt").cuda()
got = {}
for method in ("rsvd", "column_id"):
    g = torch.Generator(device="cuda").manual_seed(3)
    got[method] = par.gather_factors(
        par.compress_blocks(blocks, g, 16, method=method, mesh=mesh), mesh)
if rank == 0:
    np.savez(out + "/got.npz", **{f"{m}/{k}": v for m, f in got.items()
                                  for k, v in f.__dict__.items()})
dist.destroy_process_group()
"""


def test_two_ranks_on_one_card_under_gloo(k1, tmp_path):
    """Two processes on ``cuda:0`` in a Gloo group (NCCL takes one rank per
    card): each compresses its half of the stack on the card; gathered
    (through the host), the factors are those of one rank, bitwise.
    The ranks are killed after 120 s."""
    import subprocess
    import sys
    from pathlib import Path

    import torch

    from rusty_compression_tpu_torch import parallel as par

    blocks = _mesh_stack()
    torch.save(blocks.cpu(), tmp_path / "blocks.pt")
    repo = str(Path(__file__).resolve().parents[1])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_RANKS, str(r), str(tmp_path / "store"),
         str(tmp_path), repo], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    with np.load(tmp_path / "got.npz") as z:
        got = dict(z)
    for method in ("rsvd", "column_id"):
        g = torch.Generator(device="cuda").manual_seed(3)
        want = par.gather_factors(par.compress_blocks(blocks, g, 16,
                                                      method=method))
        for k, v in want.__dict__.items():
            assert np.array_equal(got[f"{method}/{k}"], v), (method, k)


# ---------------------------------------------------------------------------
# The twins of examples/*.py on the card, at small sizes
# ---------------------------------------------------------------------------


def _twin_on(name: str, device: str) -> dict:
    """Twin ``name``'s ``run`` on ``device`` at a small size (the highacc
    twins at ``RC_EXAMPLE_SMALL``'s), with the JAX example's gates."""
    import importlib
    import tempfile

    import torch

    m = importlib.import_module(f"rusty_compression_tpu_torch.examples.{name}")
    g = torch.Generator(device=device).manual_seed(1)
    if name in ("interpolative_decomposition", "adaptive_sampling"):
        return m.run(m.make_input("cpu"), g)
    if name == "high_accuracy":
        return m.run(*m.make_input(512, 60), g, decay_rank=60)
    if name == "high_accuracy_id":
        return m.run(m.make_input(300, 80)[0], g)
    if name == "complex_operators":
        return m.run(m.make_input(256)[0], g)
    if name == "block_workload":
        with tempfile.TemporaryDirectory() as tmp:
            return m.run(m.make_blocks(0), g, f"{tmp}/ckpt")
    points = m.sphere_points(2048)
    return m.run(points, np.random.default_rng(2).standard_normal(2048), g)


@pytest.mark.parametrize("name", [
    "interpolative_decomposition", "adaptive_sampling", "high_accuracy",
    "high_accuracy_id", "complex_operators", "block_workload", "hmatrix"])
def test_example_twin_on_the_card(k1, name):
    """Each twin on the card passes its gates (its ``run`` raises
    otherwise) and agrees with its run on the CPU: the ID's skeleton
    indices equal, the discovered ranks within one sample block; the
    complex twin launches K2."""
    before = k1.qrcp_panel_complex.launch_count
    got = _twin_on(name, "cuda")
    launched = k1.qrcp_panel_complex.launch_count - before
    want = _twin_on(name, "cpu")
    assert (launched > 0) == (name == "complex_operators")
    if name == "interpolative_decomposition":
        assert np.array_equal(got["col_ind"][:20], want["col_ind"][:20])
        assert got["two_sided_rel_err"] == pytest.approx(
            want["two_sided_rel_err"], rel=1e-8)
    elif name in ("adaptive_sampling", "high_accuracy", "high_accuracy_id"):
        assert abs(got["rank"] - want["rank"]) <= 5
    elif name == "complex_operators":
        assert got["skeleton_err"] <= 1e-3
        assert got["refined_residual"] <= 5e-8
    elif name == "block_workload":
        assert got["pending_after_loss"] == [3]
        assert got["pending_after_recovery"] == []
    else:
        assert (got["admissible"], got["dense"]) == (302, 618)
        assert np.abs(np.subtract(got["ranks"], want["ranks"])).max() <= 8
        assert got["matvec_rel_err"] < 50e-6


# K3 and K4: (shape, k, mask, norm rule). (32, 1024) is config 2h's core
# (a cluster), (256, 8192) config 4h's (the cooperative grid, Q split over
# its CTAs), (453, 1500) the high-accuracy ID example's C^H (10 columns of
# Q a CTA in f64), (64, 2048) config 6c's c128 core; (1000, 4000) and
# (1000, 1000) k=600 split grids whose residual lies in L2, (1900, 2000)
# k=400 one whose c128 shares do not fit (Q in global memory, a warp a
# column); a ragged masked grid and a masked stack; a tall panel whose Q
# and CTA vectors lie in global memory.
_WIDE_CASES = [
    ((32, 1024), 32, False, "downdate"), ((32, 1024), 32, False, "recompute"),
    ((256, 8192), 256, False, "downdate"),
    ((256, 8192), 256, False, "recompute"),
    ((453, 1500), 453, False, "recompute"),
    ((64, 2048), 64, False, "recompute"),
    ((1000, 4000), 32, False, "recompute"),
    ((1000, 1000), 600, False, "downdate"),
    ((1900, 2000), 400, False, "recompute"),
    ((169, 8191), 100, True, "recompute"),
    ((2, 40, 600), 30, True, "recompute"),
    ((16384, 58), 40, True, "downdate"),
]


def _wide_panel(shape, dtype_name, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if dtype_name == "complex128":
        a = a + 1j * rng.standard_normal(shape)
    return torch.tensor(a * np.geomspace(1.0, 0.1, shape[-1]),
                        dtype=getattr(torch, dtype_name), device="cuda")


@pytest.mark.parametrize("dtype_name", ["float64", "complex128"])
@pytest.mark.parametrize("shape,k,masked,norms", _WIDE_CASES)
def test_wide_kernels_match_plain_and_repeat(k1, dtype_name, shape, k,
                                             masked, norms):
    """Each norm rule of K3 / K4 against its plain version: pivots equal,
    q and r within 1e-9, one launch counted, two launches bitwise."""
    import torch

    wrapper = (k1.qrcp_panel_c128 if dtype_name == "complex128"
               else k1.qrcp_panel_f64)
    a = _wide_panel(shape, dtype_name)
    used = None
    if masked:
        used = torch.zeros(shape[-1], dtype=torch.bool, device="cuda")
        used[::7] = True
    before = wrapper.launch_count
    got = wrapper(a, k, used=used, norms=norms)
    torch.cuda.synchronize()
    layout = k1.panel_layout(*shape[-2:], k, a.element_size(), True)
    panels = shape[0] if len(shape) == 3 else 1
    assert wrapper.launch_count == before + (panels if layout.grid else 1)
    q0, r0, piv0 = k1.qrcp_panel_plain(a, k, used, norms)
    assert torch.equal(got[2].long(), piv0)
    assert float((got[0] - q0).abs().max()) <= 1e-9
    assert float((got[1] - r0).abs().max()) <= 1e-9
    again = wrapper(a, k, used=used, norms=norms)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("complex_", [False, True])
def test_core_qrcp_on_the_card_against_geqp3(k1, complex_):
    """``_core_qrcp`` of a captured core launches K3 / K4 once (norm rule
    ``recompute``); its pivots up to the rank equal scipy's ``?geqp3`` on
    the host and the plain rule's on the card, its R within 1e-12 of the
    plain rule's largest entry."""
    import scipy.linalg
    import torch

    import rusty_compression_tpu_torch as rt
    from rusty_compression_tpu_torch.highacc_id import (_core_qrcp,
                                                        _truncation_rank)
    from rusty_compression_tpu_torch.ops.pivoted_qr import _full_permutation

    wrapper = k1.qrcp_panel_c128 if complex_ else k1.qrcp_panel_f64
    a = torch.tensor(_decaying(73, 384, 1024, complex_=complex_),
                     device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    _, b, _, captured = rt.refined_capture(a, g, tol=1e-8)
    before = wrapper.launch_count
    rb, ind = _core_qrcp(b)
    torch.cuda.synchronize()
    assert wrapper.launch_count == before + 1
    kf = _truncation_rank(torch.diagonal(rb), 1e-8, None, captured)
    _, _, piv = scipy.linalg.qr(b.cpu().numpy(), mode="economic",
                                pivoting=True)
    np.testing.assert_array_equal(ind.cpu().numpy()[:kf], piv[:kf])
    _, r0, piv0 = k1.qrcp_core_plain(b)
    ind0 = _full_permutation(piv0, b.shape[1])
    assert torch.equal(ind[:kf], ind0[:kf])
    r0 = torch.triu(r0[:, ind0])
    assert float((rb - r0)[:kf, :kf].abs().max()) <= 1e-12 * float(
        r0.abs().max())


@pytest.mark.parametrize("dtype_name", ["float64", "complex128"])
def test_wide_routes_launch_k3_k4(k1, dtype_name):
    """``pivoted_qr`` on an f64 / c128 card tensor: ``gs`` (auto at n <=
    512) launches K3 / K4 once, with the plain loop's pivots, also over
    the JAX package's 12 MiB working set and on a stack of four
    dimensions; the blocked route's pivot rule launches it once a panel on
    the sketch."""
    import torch

    import rusty_compression_tpu_torch as rt
    from rusty_compression_tpu_torch.ops.pivoted_qr import (
        _qrcp_blocked_from_gaussian)

    wrapper = (k1.qrcp_panel_c128 if dtype_name == "complex128"
               else k1.qrcp_panel_f64)
    a = _wide_panel((300, 200), dtype_name, seed=5)
    before = wrapper.launch_count
    q, r, ind = rt.pivoted_qr(a, 40)
    torch.cuda.synchronize()
    assert wrapper.launch_count == before + 1
    _, _, piv0 = k1.qrcp_panel_plain(a, 40)
    assert torch.equal(ind[:40], piv0)
    assert float(((q @ r)[:, :40] - a[:, ind[:40]]).abs().max()) <= 1e-12
    for shape, k in (((4096, 300), 64), ((2, 2, 120, 90), 20)):
        x = _wide_panel(shape, dtype_name, seed=8)
        before = wrapper.launch_count
        _, _, ind = rt.pivoted_qr(x, k, mode="gs")
        torch.cuda.synchronize()
        layout = k1.panel_layout(*shape[-2:], k, x.element_size(), True)
        panels = int(np.prod(shape[:-2]))
        assert wrapper.launch_count == before + (
            panels if layout.grid else 1)
        _, _, piv0 = k1.qrcp_panel_plain(x, k)
        assert torch.equal(ind[..., :k], piv0)
    b = _wide_panel((200, 1000), dtype_name, seed=6)
    sketch = _wide_panel((72, 200), dtype_name, seed=7)
    before = wrapper.launch_count
    _, _, piv_k = _qrcp_blocked_from_gaussian(b, sketch, 64, 64,
                                              candidate_factor=0)
    torch.cuda.synchronize()
    assert wrapper.launch_count == before + 1
    _, _, piv_p = _qrcp_blocked_from_gaussian(b, sketch, 64, 64,
                                              pivot_kernel="plain",
                                              candidate_factor=0)
    assert torch.equal(piv_k, piv_p)


# K1 and K2 where Q does not replicate in a CTA: one cooperative grid a
# panel, (shape, k, mask, forced layout code or None) by kind. Layout 1
# (Q split over the CTAs) at config 2's f32 panel, ragged and masked, and
# a stack of two; 2 (Q in L2, from 2048 rows); 3 (the CTAs' vectors in
# global memory too); 4 (warps over Q in L2), forced: the rule gives it
# to no f32 panel and to c64 only at about 1900 rows and k > 1400.
_GRID_CASES = {
    "f32": [((1024, 1024), 64, False, None), ((1024, 1021), 64, True, None),
            ((2, 640, 192), 96, False, None), ((4096, 100), 100, False, None),
            ((20000, 40), 32, False, None), ((1000, 1000), 200, False, 4)],
    "c64": [((1024, 512), 64, False, None), ((1024, 509), 64, True, None),
            ((2, 1024, 512), 64, False, None), ((2048, 100), 100, False, None),
            ((12000, 40), 32, False, None), ((1000, 1000), 200, False, 4)],
}


@pytest.mark.parametrize("kind,case", [
    (kind, case) for kind, cases in _GRID_CASES.items() for case in cases])
def test_grid_layouts_match_plain_and_repeat(k1, kind, case):
    """K1 / K2 on the grid against the plain version: pivots exactly
    equal, q and r within 1e-4, one launch a panel, two launches
    bitwise."""
    import torch

    shape, k, masked, code = case
    make, name, _, itemsize = _KERNELS[kind]
    wrapper = getattr(k1, name)
    a = make(shape, seed=9)
    m, n = shape[-2:]
    used = None
    if masked:
        used = torch.zeros(n, dtype=torch.bool, device="cuda")
        used[::7] = True
    layout = k1.panel_layout(m, n, k, itemsize)
    if code is not None:
        layout = k1.layout_at(m, n, k, itemsize, k1.grid_counts(n)[-1],
                              False, code)
    assert layout.grid and (code is None or layout.code == code)
    before = wrapper.launch_count
    got = k1._panel(wrapper, a, k, used, layout)
    torch.cuda.synchronize()
    panels = shape[0] if len(shape) == 3 else 1
    assert wrapper.launch_count == before + panels
    _assert_matches_plain(k1, got, a, k, used)
    again = k1._panel(wrapper, a, k, used, layout)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("kind", ["f32", "c64"])
def test_grid_routes_launch_k1_k2_never_the_plain_loop(k1, monkeypatch,
                                                       kind):
    """On the card ``auto`` at small rank within the JAX package's 12 MiB
    (f32 (1024, 1024) k = 64, config 2's panel; c64 (1024, 512)), ``gs``
    beyond the cluster domain ((4096, 100) / (2048, 100) at k = 100) and
    the blocked route's pivot rule at block_size=256 (a (264, 512)
    shortlist) each launch K1 / K2, with the plain loop's pivots, and
    never run the plain loop or the plain pivot rule."""
    import torch

    from rusty_compression_tpu_torch.ops import pivoted_qr as pq

    make, name, _, _ = _KERNELS[kind]
    wrapper = getattr(k1, name)
    auto_shape = (1024, 1024) if kind == "f32" else (1024, 512)
    gs_shape = (4096, 100) if kind == "f32" else (2048, 100)
    calls = []
    for shape, k, mode in ((auto_shape, 64, "auto"), (gs_shape, 100, "gs")):
        a = make(shape, seed=4)
        _, _, piv0 = k1.qrcp_panel_plain(a, k)
        calls.append((a, k, mode, piv0))
    big = make((600, 800), seed=5)

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain loop ran on the card")

    monkeypatch.setattr(pq, "qrcp_panel_plain", no_plain)
    monkeypatch.setattr(pq, "_select_block_pivots", no_plain)
    for a, k, mode, piv0 in calls:
        before = wrapper.launch_count
        q, r, ind = pq.pivoted_qr(a, k, mode=mode)
        torch.cuda.synchronize()
        assert wrapper.launch_count == before + 1
        assert torch.equal(ind[:k], piv0)
        assert float(((q @ r)[:, :k] - a[:, ind[:k]]).abs().max()) <= 1e-4
    before = wrapper.launch_count
    q, r, ind = pq.pivoted_qr(big, 256, mode="blocked", block_size=256)
    torch.cuda.synchronize()
    assert wrapper.launch_count == before + 1
    assert sorted(ind.tolist()) == list(range(800))
    assert float(((q @ r)[:, :256] - big[:, ind[:256]]).abs().max()) <= 1e-3


# K5, the tall-skinny QR kernel (ops/kernels/tsqr.py), against its plain
# version on the card: the main path's shapes (the 64 f32 sketches of the
# 16384^2 stack, the f64 (8192, n) rounds of the tol 1e-8 capture, an
# H-matrix bucket) and small ones over every layout, ragged leaves, zero
# columns. Limits: ||Q^T Q - I|| and ||QR - Y|| / ||Y|| within 10 n u, as
# the CPU tests hold the plain version to Householder; Q and R within
# 1e-4 (f32) and 1e-10 (f64) of the plain version's (the same reflectors,
# summed in another order); two calls bitwise equal; one launch a call.
_TSQR_CASES = [
    ((64, 16384, 21), "float32"), ((1, 8192, 32), "float64"),
    ((1, 8192, 64), "float64"), ((1, 8192, 128), "float64"),
    ((400, 256, 8), "float64"), ((3, 300, 21), "float64"),
    ((2, 517, 33), "float32"), ((1, 128, 128), "float64"),
    ((4, 1000, 7), "float32"), ((2, 1000, 100), "float64"),
]


@pytest.mark.parametrize("shape,dtype_name", _TSQR_CASES)
def test_tsqr_matches_plain_and_repeats(k1, shape, dtype_name):
    import torch

    from rusty_compression_tpu_torch.ops.kernels import tsqr

    rng = np.random.default_rng(11)
    y_np = rng.standard_normal(shape) * np.geomspace(1.0, 0.1, shape[-1])
    if shape == (2, 517, 33):
        y_np[..., [0, 16, 32]] = 0.0      # zero columns: identities
    dtype = getattr(torch, dtype_name)
    y = torch.tensor(y_np, dtype=dtype, device="cuda")
    n = shape[-1]
    u = float(torch.finfo(dtype).eps) / 2
    before = tsqr.tsqr.launch_count
    q, r = tsqr.tsqr(y, want_r=True)
    q2, r2 = tsqr.tsqr(y, want_r=True)
    torch.cuda.synchronize()
    assert tsqr.tsqr.launch_count == before + 2
    assert torch.equal(q, q2) and torch.equal(r, r2)
    eye = torch.eye(n, dtype=dtype, device="cuda")
    assert float((q.mT @ q - eye).abs().max()) <= 10 * n * u
    assert float((q @ r - y).norm() / y.norm()) <= 10 * n * u
    q0, r0 = tsqr.tsqr_plain(y)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((q - q0).abs().max()) <= tol
    assert float((r - r0).abs().max() / r0.abs().max()) <= tol


@pytest.mark.parametrize("dtype_name,shape,kernel", [
    ("float64", (8192, 32), True),        # a round of the 1e-8 capture
    ("float32", (8, 4096, 21), True),     # a stack: one call
    ("float64", (8192, 128), False),      # a single wide panel: cuSOLVER
    ("complex128", (4096, 16), False),
])
def test_thin_q_launches_k5_on_its_route(k1, dtype_name, shape, kernel):
    """``orthonormalize`` on the card takes K5 (one launch, stack or not)
    exactly where ``thin_q``'s route says, and its Q spans y either way."""
    import torch

    from rusty_compression_tpu_torch.ops.kernels import tsqr
    from rusty_compression_tpu_torch.ops.orthogonalize import orthonormalize

    rng = np.random.default_rng(12)
    dtype = getattr(torch, dtype_name)
    y = torch.tensor(rng.standard_normal(shape), device="cuda").to(dtype)
    before = tsqr.tsqr.launch_count
    q = orthonormalize(y)
    torch.cuda.synchronize()
    assert tsqr.tsqr.launch_count == before + int(kernel)
    q0 = torch.linalg.qr(y)[0]
    tol = 1e-4 if dtype in (torch.float32, torch.complex64) else 1e-10
    assert float((q @ q.mH - q0 @ q0.mH).abs().max()) <= tol


# compute_svd's QR-first route (ops/svd.py): a real card stack whose long
# side is at least twice its short one and whose tall orientation K5 takes
# goes through K5's QR and one batched small SVD; every other input keeps
# torch.linalg.svd. Limits as the CPU tests' (tests/test_torch_rsvd.py).
def _separated(shape, dtype, seed):
    """A (..., m, n) card tensor whose singular values fall from 1 to 1e-3."""
    import torch

    *lead, m, n = shape
    k = min(m, n)
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.standard_normal((*lead, m, k)))[0]
    v = np.linalg.qr(rng.standard_normal((*lead, n, k)))[0]
    a = (u * np.geomspace(1.0, 1e-3, k)) @ np.swapaxes(v, -1, -2)
    return torch.tensor(a, device="cuda").to(getattr(torch, dtype))


@pytest.mark.parametrize("shape,dtype_name,rank,routed", [
    ((8, 21, 4096), "float32", 21, True),     # wide cores, a stack
    ((1, 32, 8192), "float64", 32, True),     # one wide core
    ((8, 21, 4096), "float32", 14, True),     # zero rows, as padded
    ((8, 21, 4096), "complex64", 21, False),  # complex: cuSOLVER
])
def test_compute_svd_through_qr_on_its_route(k1, shape, dtype_name, rank,
                                             routed):
    """``compute_svd`` raises ``through_qr_count`` and K5's launch count by
    one exactly where the route says, and agrees with ``torch.linalg.svd``:
    singular values to 1e-5 (f32) / 1e-12 (f64) of the largest, the
    factors back to a, orthonormal, the same subspaces up to the rank (the
    rows past ``rank`` zero, as the adaptive path pads a core)."""
    import torch

    from rusty_compression_tpu_torch.ops import svd as ops_svd
    from rusty_compression_tpu_torch.ops.kernels import tsqr

    a = torch.zeros(shape, dtype=getattr(torch, dtype_name), device="cuda")
    a[..., :rank, :] = _separated((*shape[:-2], rank, shape[-1]),
                                  dtype_name, 13)
    counts = (ops_svd.compute_svd.through_qr_count, tsqr.tsqr.launch_count)
    u, s, vt = ops_svd.compute_svd(a)
    torch.cuda.synchronize()
    assert (ops_svd.compute_svd.through_qr_count,
            tsqr.tsqr.launch_count) == tuple(c + int(routed) for c in counts)
    u0, s0, vt0 = torch.linalg.svd(a, full_matrices=False)
    k = min(shape[-2:])
    single = a.real.dtype == torch.float32
    assert float((s - s0).abs().max()) <= (1e-5 if single else 1e-12)
    tol = 10 * k * float(torch.finfo(a.real.dtype).eps)
    assert float((u * s[..., None, :].to(a.dtype) @ vt - a).norm()
                 / a.norm()) <= tol
    eye = torch.eye(k, dtype=a.dtype, device="cuda")
    assert float((u.mH @ u - eye).abs().max()) <= tol
    assert float((vt @ vt.mH - eye).abs().max()) <= tol
    for r in (rank // 2, rank):
        for got, want in ((u[..., :r], u0[..., :r]),
                          (vt[..., :r, :].mH, vt0[..., :r, :].mH)):
            assert float((got @ got.mH - want @ want.mH).abs().max()) <= (
                1e-4 if single else 1e-9)


def test_compute_svd_through_qr_of_an_empty_stack(k1):
    """An empty stack takes the route (K5's rule reads the panels' shape)
    and gives empty factors of the library's shapes."""
    import torch

    from rusty_compression_tpu_torch.ops.svd import compute_svd

    a = torch.empty((0, 21, 4096), device="cuda")
    got = compute_svd(a)
    want = torch.linalg.svd(a, full_matrices=False)
    assert [x.shape for x in got] == [x.shape for x in want]


def test_rank16_rsvd_of_a_laplace_stack_through_qr(k1):
    """The front door's rank-16 rSVD of eight 4096^2 f32 Laplace blocks (the
    benchmark's stack cell, smaller) takes the route once, and its worst
    block reads resid, orth and proj within that cell's limits (8e-5, 1e-4,
    6e-5), every number formed in float64."""
    import math

    import torch

    import rusty_compression_tpu_torch as rt
    from rusty_compression_tpu_torch.ops import svd as ops_svd

    gen = torch.Generator(device="cuda").manual_seed(2024)
    x = (torch.rand((8, 4096, 3), generator=gen, device="cuda",
                    dtype=torch.float64) - 0.5)
    y = (torch.rand((8, 4096, 3), generator=gen, device="cuda",
                    dtype=torch.float64) - 0.5
         + torch.tensor([3.0, 0.0, 0.0], device="cuda", dtype=torch.float64))
    d = torch.cdist(x, y)
    stack = (1.0 / (4.0 * math.pi * d)).float()
    before = ops_svd.compute_svd.through_qr_count
    out = rt.compress(stack, gen, rt.CompressionConfig.RANK(16))
    torch.cuda.synchronize()
    assert ops_svd.compute_svd.through_qr_count == before + 1
    a = stack.double()
    u, s, vt = out.u.double(), out.s.double(), out.vt.double()
    norm = torch.linalg.matrix_norm(a)
    resid = torch.linalg.matrix_norm(a - u * s[:, None, :] @ vt) / norm
    proj = torch.linalg.matrix_norm(u.mT @ a - s[..., None] * vt) / norm
    eye = torch.eye(16, dtype=torch.float64, device="cuda")
    orth = max(float((u.mT @ u - eye).abs().max()),
               float((vt @ vt.mT - eye).abs().max()))
    assert float(resid.max()) <= 8e-5
    assert orth <= 1e-4
    assert float(proj.max()) <= 6e-5
