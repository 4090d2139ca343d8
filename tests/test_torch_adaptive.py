"""The adaptive range finder of the port held against the JAX package's.

Both sides get the same Gaussian matrices: the port's ``_adaptive_loop``
takes an iterator of them, built here from the JAX loop's own key splits.
The stop is data dependent, so the fixtures keep the estimate away from
the tolerance: f64, a spectrum that falls by ten every ``sample_size``
columns (``decade_block``), and a tolerance between two decades; each
parity test first checks on the JAX history that no entry lies within a
factor 1.5 of the tolerance. Then both packages must stop at the same
round.

Compared: ``ncols``, ``n_iters``, ``hist`` (rtol 1e-6: f64 arithmetic in
another summation order, amplified by the deflation; atol 1e-12 where a
lane's last estimate is roundoff itself), the projector
``Q Q^H`` and ``Q B`` (atol 1e-9), and the padding, which must be exactly
zero. With ``ortho="cholqr2"`` on both sides Q has no sign freedom and is
compared entrywise (atol 1e-9). The JAX side (its results and draws) comes
from ``tests/torch_refs/test_torch_adaptive.npz`` (``make_refs.py``), but
for ``sample_range_adaptive``, which runs live.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rusty_compression_tpu as rc
from rusty_compression_tpu.parallel.batch import (
    adaptive_rsvd_block as jax_adaptive_rsvd_block,
    batched_adaptive_rsvd as jax_batched_adaptive_rsvd)
from test_torch_parity import (decade_block, jax_adaptive_omegas,  # noqa: F401
                               jax_adaptive_omegas_stack, low_rank, n, port,
                               projector, t)
from torch_refs import Refs
from torch_threads import one_thread  # noqa: F401 (autouse)

BLK = 8
SHAPE = (96, 64)
TOL = 3e-4
MAX_ITERS = SHAPE[1] // BLK
refs = Refs(__file__)


def assert_far_from_tol(hist, tol=TOL):
    """The fixture's promise: no estimate within a factor 1.5 of ``tol``."""
    hist = np.asarray(hist)
    live = hist[hist > 0]
    assert np.all((live > 1.5 * tol) | (live < tol / 1.5)), live


def port_loop(port, a, omegas, tol=TOL, ortho="auto", max_iters=MAX_ITERS):
    from rusty_compression_tpu_torch.sampling import _adaptive_loop

    return _adaptive_loop(port.rt.DenseOperator(t(a)),
                          iter([t(o) for o in omegas]), tol, BLK, max_iters,
                          ortho)


@pytest.mark.parametrize("dtype,ortho", [(np.float64, "auto"),
                                         (np.float64, "cholqr2"),
                                         (np.complex128, "auto")])
def test_adaptive_loop_stops_where_jax_stops(port, dtype, ortho):
    a = decade_block(80, SHAPE, BLK, dtype)

    def jax_side():
        key = jax.random.key(81)
        out = rc.adaptive_range_finder(jnp.asarray(a), key, TOL, BLK,
                                       ortho=ortho)
        return {**dict(zip(("q", "b", "ncols", "iters", "hist"), out)),
                "omegas": jax_adaptive_omegas(key, SHAPE[1], BLK,
                                              MAX_ITERS + 1, dtype)}

    want = refs(f"loop {np.dtype(dtype).name} {ortho}", a, jax_side)
    wq, wb, wncols, witers, whist = (want[k] for k in ("q", "b", "ncols",
                                                       "iters", "hist"))
    assert_far_from_tol(whist)
    q, b, ncols, iters, hist = port_loop(port, a, want["omegas"],
                                         ortho=ortho)
    assert int(iters) == int(witers) and int(ncols) == int(wncols)
    assert 2 <= int(iters) < MAX_ITERS  # a data-dependent stop, not the cap
    np.testing.assert_allclose(n(hist), whist, rtol=1e-6)
    assert q.shape == wq.shape and b.shape == wb.shape
    k = int(ncols)
    assert not q[:, k:].any() and not b[k:].any() and not hist[k // BLK:].any()
    np.testing.assert_allclose(projector(n(q)), projector(wq), atol=1e-9)
    np.testing.assert_allclose(n(q @ b), wq @ wb, atol=1e-9)
    if ortho == "cholqr2":
        np.testing.assert_allclose(n(q), wq, atol=1e-9)
        np.testing.assert_allclose(n(b), wb, atol=1e-9)


def test_adaptive_loop_on_a_stack_whose_lanes_stop_at_different_rounds(port):
    """Three lanes, decades of 4, 8 and 16 columns: every lane stops at
    its own round and is frozen from then on, as ``vmap`` of the JAX
    ``while_loop`` does."""
    blocks = np.stack([decade_block(82 + i, SHAPE, per, np.float64)
                       for i, per in enumerate((4, 8, 16))])
    def jax_side():
        key = jax.random.key(83)
        _, ranks, hist = jax_batched_adaptive_rsvd(jnp.asarray(blocks), key,
                                                   TOL, BLK)
        return {"ranks": ranks, "hist": hist,
                "omegas": jax_adaptive_omegas_stack(
                    key, 3, SHAPE[1], BLK, MAX_ITERS + 1, np.float64)}

    want = refs("stack lanes", blocks, jax_side)
    wranks, whist, omegas = want["ranks"], want["hist"], want["omegas"]
    assert_far_from_tol(whist)
    q, b, ncols, iters, hist = port_loop(port, blocks, omegas)
    np.testing.assert_array_equal(n(ncols), np.asarray(wranks))
    assert len(set(n(ncols).tolist())) == 3
    np.testing.assert_allclose(n(hist), whist, rtol=1e-6, atol=1e-12)
    for i in range(3):
        k = int(ncols[i])
        assert not q[i, :, k:].any() and not b[i, k:].any()
        # each lane equals the loop run on that block alone
        q1, b1, k1, _, h1 = port_loop(port, blocks[i],
                                      [o[i] for o in omegas])
        assert int(k1) == k
        np.testing.assert_allclose(n(q[i] @ b[i]), n(q1 @ b1), atol=1e-12)
        np.testing.assert_allclose(n(hist[i]), n(h1), rtol=1e-9)


@pytest.mark.parametrize("small_svd", ["direct", "gram"])
def test_adaptive_rsvd_block_given_the_jax_omegas(port, small_svd):
    """The padded small SVD: the zero rows of ``b_mat`` come out as exact
    zero triplets in the port (the JAX package leaves roundoff there), and
    the live ones equal the JAX package's (rtol 1e-8 on s above 1e-6 of the
    largest for gram, which squares the condition number)."""
    from rusty_compression_tpu_torch.parallel.batch import (
        _adaptive_rsvd_block_from_omegas)

    a = decade_block(84, SHAPE, BLK, np.float64)

    def jax_side():
        key = jax.random.key(89)  # a draw that keeps clear of TOL
        wsvd, wrank, whist = jax_adaptive_rsvd_block(
            jnp.asarray(a), key, TOL, BLK, small_svd=small_svd)
        return {"s": wsvd.s, "to_mat": wsvd.to_mat(), "rank": wrank,
                "hist": whist, "omegas": jax_adaptive_omegas(
                    key, SHAPE[1], BLK, MAX_ITERS + 1, np.float64)}

    want = refs(f"rsvd block {small_svd}", a, jax_side)
    assert_far_from_tol(want["hist"])
    svd, rank, hist = _adaptive_rsvd_block_from_omegas(
        t(a), iter([t(o) for o in want["omegas"]]), TOL, BLK,
        small_svd=small_svd)
    k = int(rank)
    assert k == int(want["rank"])
    assert svd.u.shape == (SHAPE[0], SHAPE[1]) and svd.s.shape == (SHAPE[1],)
    assert not svd.u[:, k:].any() and not svd.s[k:].any() \
        and not svd.vt[k:].any()
    ws = want["s"]
    assert np.all(ws[k:] <= 1e-12 * ws[0])  # JAX: zero up to roundoff
    live = ws[:k] > (1e-6 if small_svd == "gram" else 0.0) * ws[0]
    np.testing.assert_allclose(n(svd.s)[:k][live], ws[:k][live], rtol=1e-8)
    np.testing.assert_allclose(n(svd.to_mat()), want["to_mat"], atol=1e-9)
    np.testing.assert_allclose(n(hist), want["hist"], rtol=1e-6)
    assert float(port.rt.rel_diff_fro(svd.to_mat(), t(a))) < 5 * TOL


def batched_blocks_and_jax():
    """Two blocks whose ranks differ, and the JAX package's
    ``batched_adaptive_rsvd`` of them with its draws (stored)."""
    blocks = np.stack([decade_block(86 + i, SHAPE, per, np.float64)
                       for i, per in enumerate((4, 16))])

    def jax_side():
        key = jax.random.key(89)  # a draw that keeps clear of TOL
        wsvd, wranks, whist = jax_batched_adaptive_rsvd(
            jnp.asarray(blocks), key, TOL, BLK, max_rank=48)
        return {"u_shape": np.asarray(wsvd.u.shape), "ranks": wranks,
                "hist": whist, "to_mat": jax.vmap(lambda s: s.to_mat())(wsvd),
                "omegas": jax_adaptive_omegas_stack(key, 2, SHAPE[1], BLK, 7,
                                                    np.float64)}

    return blocks, refs("batched", blocks, jax_side)


def test_batched_adaptive_rsvd_matches_jax(port, monkeypatch):
    """The public stack entry on the JAX package's draws: ranks equal,
    reconstructions to 1e-9, padding exactly zero."""
    from rusty_compression_tpu_torch.parallel import batched_adaptive_rsvd
    from test_torch_parity import feed_gaussians

    blocks, want = batched_blocks_and_jax()
    assert_far_from_tol(want["hist"])
    left = feed_gaussians(monkeypatch, want["omegas"])
    svd, ranks, hist = batched_adaptive_rsvd(
        t(blocks), port.torch.Generator(), TOL, BLK, max_rank=48)
    assert svd.u.shape == (2, SHAPE[0], 48) == tuple(want["u_shape"])
    np.testing.assert_array_equal(n(ranks), want["ranks"])
    rounds = int(ranks.max()) // BLK
    assert len(left) == 7 - (rounds + 1)  # one draw a round and the first
    np.testing.assert_allclose(n(hist), want["hist"], rtol=1e-6)
    np.testing.assert_allclose(n(svd.to_mat()), want["to_mat"], atol=1e-9)
    for i in range(2):
        assert not svd.s[i, int(ranks[i]):].any()
        assert not svd.u[i, :, int(ranks[i]):].any()


def test_sliced_adaptive_rsvd_of_a_stack_matches_jax(port, monkeypatch):
    """The block stream's form of the stack entry, on the same draws as
    ``test_batched_adaptive_rsvd_matches_jax``: the small SVD taken at the
    stack's largest rank, the triplets beyond each block's own rank exactly
    zero, the reconstructions equal to the JAX package's padded ones."""
    from rusty_compression_tpu_torch.parallel.batch import (
        _adaptive_rsvd_sliced)
    from test_torch_parity import feed_gaussians

    blocks, want = batched_blocks_and_jax()
    feed_gaussians(monkeypatch, want["omegas"])
    svd, ranks, hist = _adaptive_rsvd_sliced(
        t(blocks), port.torch.Generator(), TOL, BLK, max_rank=48)
    np.testing.assert_array_equal(n(ranks), want["ranks"])
    kmax = int(ranks.max())
    assert int(ranks.min()) < kmax and svd.u.shape == (2, SHAPE[0], kmax)
    assert svd.vt.shape == (2, kmax, SHAPE[1])
    np.testing.assert_allclose(n(hist), want["hist"], rtol=1e-6)
    np.testing.assert_allclose(n(svd.to_mat()), want["to_mat"], atol=1e-9)
    for i in range(2):
        k = int(ranks[i])
        assert not svd.s[i, k:].any() and not svd.u[i, :, k:].any()
        assert not svd.vt[i, k:].any()


def test_sample_range_adaptive_matches_jax(port):
    from rusty_compression_tpu_torch.sampling import (
        _sample_range_adaptive_from_omegas)

    a = decade_block(88, SHAPE, BLK, np.float64)
    key = jax.random.key(89)
    wq, wres = rc.sample_range_adaptive(jnp.asarray(a), key, TOL, BLK)
    assert_far_from_tol([v for _, v in wres])
    omegas = jax_adaptive_omegas(key, SHAPE[1], BLK, MAX_ITERS + 1,
                                 np.float64)
    q, res = _sample_range_adaptive_from_omegas(
        port.rt.DenseOperator(t(a)), iter([t(o) for o in omegas]), TOL, BLK)
    assert [r for r, _ in res] == [r for r, _ in wres]
    np.testing.assert_allclose([v for _, v in res], [v for _, v in wres],
                               rtol=1e-6)
    assert q.shape == np.asarray(wq).shape == (SHAPE[0], res[-1][0])
    np.testing.assert_allclose(projector(n(q)), projector(np.asarray(wq)),
                               atol=1e-9)


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
def test_reaches_tolerance_from_a_generator(port, dtype):
    """``tests/test_sampling.py::TestAdaptiveSampling`` on the port."""
    torch, rt = port.torch, port.rt
    tdt = getattr(torch, dtype)
    single = tdt in (torch.float32, torch.complex64)
    rel_tol = 1e-3 if single else 1e-5
    g = torch.Generator().manual_seed(13)
    a = rt.random_approximate_low_rank_matrix(
        g, (200, 100), 1.0, 1e-5 if single else 1e-10, dtype=tdt)
    q, residuals = rt.sample_range_adaptive(a, g, rel_tol, sample_size=10)
    assert q.shape == (200, residuals[-1][0])
    ranks = [r for r, _ in residuals]
    assert ranks == [10 * (i + 1) for i in range(len(ranks))]
    assert residuals[-1][1] < rel_tol
    resid = torch.linalg.norm(a - q @ (q.mH @ a)) / torch.linalg.norm(a)
    assert float(resid) < 10 * rel_tol
    np.testing.assert_allclose(n(q.mH @ q), np.eye(q.shape[1]),
                               atol=1e-4 if single else 1e-12)


@pytest.mark.parametrize("wrapper", ["qr", "svd"])
def test_adaptive_wrappers(port, wrapper):
    """``TestAdaptiveWrappers`` on the port: rank = rounds * block, rel err
    below 5 tol."""
    torch, rt = port.torch, port.rt
    g = torch.Generator().manual_seed(1)
    a = rt.random_approximate_low_rank_matrix(g, (150, 100), 1.0, 1e-10)
    fn = getattr(rt, f"randomized_adaptive_{wrapper}")
    f, hist = fn(a, g, 1e-5, 10)
    assert f.rank == len(hist) * 10
    assert float(rt.rel_diff_fro(f.to_mat(), a)) < 5e-5
    if wrapper == "svd":
        assert bool((f.s[1:] <= f.s[:-1]).all())


def test_below_the_dtype_floor_stops_cleanly(port):
    """A tolerance under the f32 floor: the stall guard ends the loop and
    the basis stays orthonormal
    (``test_adaptive_below_dtype_floor_stops_cleanly``)."""
    torch, rt = port.torch, port.rt
    g = torch.Generator().manual_seed(0)
    a = rt.random_approximate_low_rank_matrix(g, (128, 128), 1.0, 1e-10,
                                              dtype=torch.float32)
    q, hist = rt.sample_range_adaptive(a, g, rel_tol=1e-9, sample_size=8)
    assert q.shape[1] <= 128
    assert float(torch.linalg.norm(q.mT @ q - torch.eye(q.shape[1]))) < 1e-4
    resid = torch.linalg.norm(a - q @ (q.mT @ a)) / torch.linalg.norm(a)
    assert float(resid) < 1e-5


def test_slow_decay_still_converges(port):
    """The stall guard must not fire far above the floor
    (``test_adaptive_slow_decay_still_converges``)."""
    torch, rt = port.torch, port.rt
    g = torch.Generator().manual_seed(2)
    a = rt.random_approximate_low_rank_matrix(g, (160, 160), 1.0, 1e-5)
    q, _ = rt.sample_range_adaptive(a, g, 1e-4, 10)
    resid = torch.linalg.norm(a - q @ (q.mT @ a)) / torch.linalg.norm(a)
    assert float(resid) <= 5e-4


def test_one_host_read_a_round(port):
    """The loop reads one device flag a round, plus the one that ends it;
    a loop that the cap ends needs no last read."""
    from rusty_compression_tpu_torch.sampling import _adaptive_loop

    torch, rt = port.torch, port.rt
    g = torch.Generator().manual_seed(3)
    a = t(decade_block(90, SHAPE, BLK, np.float64))
    _adaptive_loop.host_reads = 0
    _, _, _, iters, _ = rt.adaptive_range_finder(a, g, TOL, BLK)
    assert _adaptive_loop.host_reads == int(iters) + 1
    _adaptive_loop.host_reads = 0
    q, _, ncols, iters, _ = rt.adaptive_range_finder(a, g, 1e-12, BLK,
                                                     max_rank=20)
    assert q.shape == (SHAPE[0], 24) and int(ncols) == 24  # ceil(20/8)*8
    assert _adaptive_loop.host_reads == int(iters) == 3


def test_zero_block_and_stack_refusal(port):
    torch, rt = port.torch, port.rt
    g = torch.Generator().manual_seed(4)
    a = t(decade_block(91, SHAPE, BLK, np.float64))
    stack = torch.stack([a, torch.zeros_like(a)])
    q, b, ncols, iters, hist = rt.adaptive_range_finder(stack, g, TOL, BLK)
    assert int(ncols[1]) == 0 and not q[1].any() and not hist[1].any()
    assert int(ncols[0]) > 0
    with pytest.raises(ValueError, match="not a stack"):
        rt.sample_range_adaptive(stack, g, TOL, BLK)


def test_matrix_free_operator_end_to_end(port):
    """``test_matrix_free_end_to_end``: an operator that never forms its
    matrix goes through the adaptive sampler and the range-estimate SVD."""
    torch, rt = port.torch, port.rt
    size = 64
    diag = torch.logspace(0, -9, size, dtype=torch.float64)

    class DiagOp(rt.LinearOperator):
        shape = (size, size)
        dtype = torch.float64
        device = torch.device("cpu")

        def matmat(self, x):
            return diag[:, None] * x

        conj_matmat = matmat

    op = DiagOp()
    g = torch.Generator().manual_seed(29)
    q, residuals = rt.sample_range_adaptive(op, g, 1e-6, sample_size=4)
    assert residuals[-1][1] < 1e-6
    svd = rt.SVD.compute_from_range_estimate(q, op)
    np.testing.assert_allclose(n(svd.s[:10]), n(diag[:10]), rtol=1e-6)
