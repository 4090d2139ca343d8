"""K3 (f64) and K4 (c128), the pivot rule of the tol <= 1e-8 ID cores and
of f64/c128 ``gs``, held against the JAX package on the CPU.

On the CPU the wrappers ``qrcp_panel_f64`` / ``qrcp_panel_c128`` run their
plain versions: ``"downdate"`` is ``qrcp_panel_plain``, held to the JAX
package's ``_qrcp_gs`` (pivots exactly equal, q and r within 1e-12: the
same f64 arithmetic in another summation order); ``"recompute"`` is
``qrcp_panel_plain(norms="recompute")`` (``qrcp_core_plain``), held to
the JAX package's ``_host_qrcp`` (LAPACK
``?geqp3`` through scipy) on captured cores, pivots equal up to the rank
that ``_truncation_rank`` finds on ``?geqp3``'s R. Also: the ``used`` mask,
rank deficiency, argument errors, the layout rule at 8 and 16 bytes an
element with f64 norms (pure Python: every core the 1e-8 paths pivot gets
a layout), and the routes that pick K3/K4 on a CUDA device. The kernels
themselves are checked on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
from rusty_compression_tpu import highacc_id as jhid
from rusty_compression_tpu.ops.pivoted_qr import _qrcp_gs as jax_qrcp_gs

from test_torch_highacc import A_CPLX, A_REAL, TOL, core_of
from test_torch_parity import low_rank, n, port, t  # noqa: F401 (fixture)
from torch_threads import one_thread  # noqa: F401 (autouse)


def _kernels():
    from rusty_compression_tpu_torch.ops.kernels import qrcp

    return qrcp


def _wrapper(dtype):
    k = _kernels()
    return k.qrcp_panel_c128 if np.dtype(dtype).kind == "c" else \
        k.qrcp_panel_f64


def _assert_same_panel(got, want, atol=1e-12):
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(n(got[1]), np.asarray(want[1]), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# "downdate": the JAX package's _qrcp_gs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,shape,k", [
    (np.float64, (40, 60), 15), (np.complex128, (40, 60), 15),
    (np.float64, (60, 40), 40),          # k = n: every column chosen
    (np.complex128, (30, 30), 30),
])
def test_downdate_matches_jax_gs(port, dtype, shape, k):
    # sigma_min 1e-3: the last q of a full factorization carries
    # eps / sigma_min of rounding in either package
    a = low_rank(1, shape, 1e-3, dtype)
    q, r, piv, _ = jax.jit(jax_qrcp_gs, static_argnums=1)(jnp.asarray(a), k)
    got = _wrapper(dtype)(t(a), k)
    assert got[2].dtype == port.torch.int32
    _assert_same_panel(got, (q, r, piv))


def test_downdate_batch_is_one_panel_per_block(port):
    a = np.stack([low_rank(s, (30, 40), 1e-3, np.float64) for s in range(3)])
    q, r, piv, _ = jax.jit(jax.vmap(lambda x: jax_qrcp_gs(x, 12)))(
        jnp.asarray(a))
    _assert_same_panel(_kernels().qrcp_panel_f64(t(a), 12), (q, r, piv))


# ---------------------------------------------------------------------------
# "recompute": LAPACK ?geqp3 on captured cores
# ---------------------------------------------------------------------------


def _hilbert_core():
    """The (32, 1024) core of ``hilbert(1024)`` on an exact basis: config
    2h's core."""
    return core_of(scipy.linalg.hilbert(1024), 32)[1]


CORES = {"real-56": lambda: core_of(A_REAL, 56)[1],
         "real-70": lambda: core_of(A_REAL, 70)[1],
         "complex-56": lambda: core_of(A_CPLX, 56)[1],
         "complex-70": lambda: core_of(A_CPLX, 70)[1],
         "hilbert-32": _hilbert_core}


@pytest.mark.parametrize("core", sorted(CORES))
def test_recompute_matches_geqp3_on_captured_cores(port, core):
    b = CORES[core]()
    _, r, piv = jhid._host_qrcp(b)
    kf = jhid._truncation_rank(np.diagonal(r), TOL, None, False)
    _, rb, got = _wrapper(b.dtype)(t(b), min(b.shape), norms="recompute")
    np.testing.assert_array_equal(n(got)[:kf], piv[:kf])
    # the diagonal of R on the pivots, as ?geqp3's, to 1e-12 of |r_00|
    d = np.abs(n(rb)[np.arange(kf), n(got)[:kf]])
    np.testing.assert_allclose(d, np.abs(np.diagonal(r))[:kf], rtol=0,
                               atol=1e-12 * abs(r[0, 0]))


@pytest.mark.parametrize("complex_", [False, True])
def test_core_qrcp_is_the_recompute_rule(port, complex_):
    """``highacc_id._core_qrcp`` is the wrapper's ``recompute`` rule,
    permuted and triangular, bit for bit."""
    from rusty_compression_tpu_torch.highacc_id import _core_qrcp
    from rusty_compression_tpu_torch.ops.pivoted_qr import _full_permutation

    b = t(core_of(A_CPLX if complex_ else A_REAL, 56)[1])
    rb, ind = _core_qrcp(b)
    _, r, piv = _kernels().qrcp_core_plain(b)
    want = _full_permutation(piv, b.shape[1])
    assert port.torch.equal(ind, want)
    assert port.torch.equal(rb, port.torch.triu(r[:, want]))


def test_the_downdated_rule_parts_from_geqp3_and_recompute_does_not(port):
    """Why the 1e-8 cores take ``recompute``: on this core ``downdate``
    leaves ``?geqp3``'s pivots before the rank."""
    b = core_of(A_REAL, 70)[1]
    _, r, piv = jhid._host_qrcp(b)
    kf = jhid._truncation_rank(np.diagonal(r), TOL, None, False)
    k3 = _kernels().qrcp_panel_f64
    down = n(k3(t(b), 70)[2])
    fresh = n(k3(t(b), 70, norms="recompute")[2])
    assert np.array_equal(fresh[:kf], piv[:kf])
    assert not np.array_equal(down[:kf], piv[:kf])


# ---------------------------------------------------------------------------
# Masks, rank deficiency, errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_used_columns_are_never_chosen(port, dtype):
    """Under both norm rules a masked column is never a pivot, and the
    pivots are those of the same panel with the masked columns zeroed (a
    zero column never wins while a positive norm is left); R over the
    unmasked columns agrees."""
    a = low_rank(3, (48, 32), 1e-4, dtype)
    used = np.zeros(32, dtype=bool)
    used[[0, 5, 17]] = True
    zeroed = a.copy()
    zeroed[:, used] = 0
    wrapper = _wrapper(dtype)
    for norms in ("downdate", "recompute"):
        got = wrapper(t(a), 12, used=t(used), norms=norms)
        want = wrapper(t(zeroed), 12, norms=norms)
        assert not set(n(got[2]).tolist()) & {0, 5, 17}
        np.testing.assert_array_equal(n(got[2]), n(want[2]))
        np.testing.assert_allclose(n(got[1])[:, ~used],
                                   n(want[1])[:, ~used], rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_rank_deficient_pivots_stay_a_permutation(port, dtype):
    """Identical columns of a rank-one panel are each picked once: the -1
    sentinel of chosen columns survives both norm rules."""
    a = np.zeros((6, 4), dtype)
    a[2, :] = 1.0
    for norms in ("downdate", "recompute"):
        _, _, piv = _wrapper(dtype)(t(a), 4, norms=norms)
        assert sorted(n(piv).tolist()) == [0, 1, 2, 3]


@pytest.mark.parametrize("call", ["f32_to_k3", "c64_to_k4", "rule", "k",
                                  "mask"])
def test_wrappers_reject_bad_arguments(port, call):
    torch = port.torch
    k = _kernels()
    a = torch.zeros((8, 6), dtype=torch.float64)
    bad = {
        "f32_to_k3": lambda: k.qrcp_panel_f64(a.float(), 3),
        "c64_to_k4": lambda: k.qrcp_panel_c128(a.to(torch.complex64), 3),
        "rule": lambda: k.qrcp_panel_f64(a, 3, norms="exact"),
        "k": lambda: k.qrcp_panel_c128(a.to(torch.complex128), 7),
        "mask": lambda: k.qrcp_panel_f64(a, 3, used=torch.zeros(5)),
    }[call]
    with pytest.raises(ValueError):
        bad()


# ---------------------------------------------------------------------------
# The layout rule (pure Python) and the routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n_,k,itemsize,grid,vectors", [
    (32, 1024, 32, 8, False, True),     # config 2h's core
    (72, 1024, 64, 8, False, True),     # config 2's f64 sketch
    (256, 8192, 256, 8, True, True),    # config 4h's core: Q is 512 KiB
    (169, 8192, 169, 8, True, True),    # 4h: C^H
    (500, 500, 480, 8, True, True),     # the high-accuracy ID example's core
    (453, 1500, 453, 8, True, True),    # and its C^H
    (96, 2048, 96, 16, True, True),     # a c128 core of config 6c's size
    (4096, 512, 64, 8, True, True),     # a tall f64 panel: residual in L2
    (16384, 58, 50, 8, True, False),    # a range sketch: vectors in L2
    (100000, 100, 100, 16, True, False),  # nothing of m fits a CTA
])
def test_every_core_gets_a_layout(port, m, n_, k, itemsize, grid, vectors):
    k1 = _kernels()
    assert k1.kernel_fits(m, k, itemsize, True)
    layout = k1.panel_layout(m, n_, k, itemsize, True)
    assert layout is not None and layout.grid == grid
    assert layout.vectors_in_smem == vectors
    assert layout.smem_bytes <= k1.SMEM_LIMIT_BYTES
    assert layout.threads % 32 == 0 and layout.threads <= k1.MAX_THREADS
    assert layout.cluster * layout.width >= n_
    assert (layout.cluster - 1) * layout.width < n_   # no CTA past the edge
    basis = k1._basis_bytes(m, k, layout.cluster, layout.threads, itemsize,
                            8, layout.code)
    slice_bytes = itemsize * (m * layout.width + layout.width) \
        + 8 * layout.width
    assert layout.smem_bytes == basis + (
        slice_bytes if layout.resid_in_smem else 0)
    # Q is split over the grid's CTAs below ROW_SPLIT_ROWS rows
    assert bool(layout.q_share) == (grid and m < k1.ROW_SPLIT_ROWS)
    if grid:
        assert layout.cluster <= k1.MAX_GRID
        # Q does not fit beside the slice in any cluster
        assert all(x is None or not x.resid_in_smem
                   for x in (k1.layout_at(m, n_, k, itemsize, c, True)
                             for c in k1.CLUSTER_SIZES))
    else:
        assert layout.cluster in k1.CLUSTER_SIZES and layout.resid_in_smem


@pytest.mark.parametrize("m,n_,k,itemsize,ctas,share,code", [
    (256, 8192, 256, 8, 128, 2, 1),    # config 4h's core: 64 columns a CTA
    (169, 8192, 169, 8, 128, 2, 1),    # 4h: C^H
    (500, 500, 480, 8, 30, 16, 1),     # the high-accuracy ID example's core
    (453, 1500, 453, 8, 47, 10, 1),    # and its C^H
    (64, 2048, 64, 16, 64, 1, 1),      # config 6c's c128 core
    (1000, 1000, 1000, 16, 125, 8, 1),  # shares fit beside no slice
    (1900, 2000, 400, 16, 125, 0, 4),  # no share fits: Q in global memory
    (4096, 512, 64, 8, 128, 0, 2),     # from ROW_SPLIT_ROWS on: Q in L2
])
def test_grid_splits_q_over_its_ctas(port, m, n_, k, itemsize, ctas, share,
                                     code):
    """The grid rule below ``ROW_SPLIT_ROWS`` rows, Q split over the CTAs:
    each CTA's share of Q (the columns t = rank mod G), vectors and, where
    they fit too, residual slice lie in its shared memory, and the shares
    cover every column of Q once; of the counts (at most ``MAX_GRID``)
    where the slices fit as well, the fewest whose slices are at most a
    warp wide and whose shares at most ``_GRID_SHARE`` columns, else the
    most; where no slice fits beside the shares, the most CTAs. Where no
    share fits, or from ``ROW_SPLIT_ROWS`` rows on, Q stays in global
    memory."""
    k1 = _kernels()
    layout = k1.panel_layout(m, n_, k, itemsize, True)
    assert layout.grid and layout.code == code
    assert (layout.cluster, layout.q_share) == (ctas, share)
    assert layout.cluster <= k1.MAX_GRID
    counts = [g for g in range(1, min(k1.MAX_GRID, n_) + 1)
              if (g - 1) * -(-n_ // g) < n_]    # no CTA past the edge
    splits = [x for g in counts
              if (x := k1.layout_at(m, n_, k, itemsize, g, True, 1))]
    if code != 1:
        assert not splits or m >= k1.ROW_SPLIT_ROWS
        return
    width, threads = layout.width, layout.threads
    slice_bytes = itemsize * (m * width + width) + 8 * width
    need = (itemsize * share * m                            # Q's share
            + itemsize * (3 * m + share + threads) + 8 * threads)
    assert layout.smem_bytes == need + (
        slice_bytes if layout.resid_in_smem else 0) <= k1.SMEM_LIMIT_BYTES
    columns = [t for rank in range(ctas) for t in range(rank, k, ctas)]
    assert sorted(columns) == list(range(k))
    assert max(len(range(rank, k, ctas)) for rank in range(ctas)) == share
    held = [x for x in splits if x.resid_in_smem]
    assert layout.resid_in_smem == bool(held)
    narrow = [x.cluster for x in held
              if x.width <= 32 and x.q_share <= k1._GRID_SHARE]
    assert ctas == (narrow[0] if narrow else (held or splits)[-1].cluster)


@pytest.mark.parametrize("dtype,wrapper", [("float64", "qrcp_panel_f64"),
                                           ("complex128", "qrcp_panel_c128")])
def test_routes_pick_k3_k4_on_the_card(port, dtype, wrapper):
    """On a CUDA device every f64/c128 ``gs`` call (auto at small rank, n
    <= 512; any shape, any stack) and the blocked route's pivot rule take
    K3/K4 where K1/K2 would take f32/c64, with no plain fallback;
    ``mode="kernel"`` stays K1/K2's (the JAX package's ``"pallas"``)."""
    from rusty_compression_tpu_torch.ops import pivoted_qr as pq

    torch = port.torch
    dt, cuda = getattr(torch, dtype), torch.device("cuda")
    assert pq._panel_kernel(dt) is getattr(_kernels(), wrapper)
    assert pq._resolve_mode("auto", 300, 200, 40, dt, cuda) == "gs"
    # over the JAX package's 12 MiB working set: gs all the same, and so
    # the kernel; a stack of four dimensions reaches the kernel flattened
    # to three, in one call (here the plain version stands in for it)
    assert pq._resolve_mode("auto", 8192, 105, 100, dt, cuda) == "gs"
    seen = []

    def kernel(x, k):
        seen.append(tuple(x.shape))
        return _kernels().qrcp_panel_plain(x, k)

    a = t(np.stack([low_rank(s, (30, 20), 1e-3, np.dtype(dtype))
                    for s in range(6)]).reshape(2, 3, 30, 20))
    got = pq._over_stack(kernel, a, 6)
    assert seen == [(6, 30, 20)]
    for x, y in zip(got, _kernels().qrcp_panel_plain(a, 6)):
        assert torch.equal(x, y)
    # config 2 in f64 / c128: blocked, K3 / K4 on the (72, 1024) sketch
    assert pq._resolve_mode("auto", 1024, 1024, 64, dt, cuda) == "blocked"
    assert pq._pivot_rule("auto", dt, cuda) == "kernel"
    assert pq._pivot_rule("auto", dt, torch.device("cpu")) == "plain"
