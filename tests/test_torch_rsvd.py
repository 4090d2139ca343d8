"""The rSVD half of the port held against the JAX package: orthonormalize,
compute_svd, range_finder, SVD containers, rsvd_block / batched_rsvd.

The port's inner ``_..._from_omega`` functions get the Gaussian matrix the
JAX function drew from its key. Range bases are compared by projector
(Householder and eigenvector signs may differ between the two LAPACK
paths). Tolerances: singular values rtol 1e-5 (f32) / 1e-10 (f64);
reconstruction errors within 1e-6 of the JAX package's. The JAX side (its
results and draws) comes from ``tests/torch_refs/test_torch_rsvd.npz``
(``make_refs.py``), but for ``orthonormalize`` and ``max_col_norm``,
which run live.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rusty_compression_tpu as rc
from test_torch_parity import (jax_gaussian, low_rank, n, port,  # noqa: F401
                               projector, t)
from test_torch_tsqr import _Card
from torch_refs import Refs
from torch_threads import one_thread  # noqa: F401 (autouse)

RTOL = {np.float32: 1e-5, np.float64: 1e-10}
SHAPE = (60, 40)
refs = Refs(__file__)


@pytest.mark.parametrize("dtype,power_iters", [(np.float32, 2)])
def test_range_finder_given_the_jax_omega(port, dtype, power_iters):
    from rusty_compression_tpu_torch.sampling import _range_finder_from_omega

    a = low_rank(20, SHAPE, 1e-4, dtype)

    def jax_side():
        key = jax.random.key(21)
        q = jax.jit(lambda x, k: rc.range_finder(x, k, 12, power_iters))(
            jnp.asarray(a), key)
        return {"q": q, "omega": jax_gaussian(key, (SHAPE[1], 12), dtype)}

    want = refs(f"range finder {np.dtype(dtype).name} {power_iters}", a,
                jax_side)
    got = _range_finder_from_omega(port.rt.DenseOperator(t(a)),
                                   t(want["omega"]), power_iters)
    np.testing.assert_allclose(projector(n(got)), projector(want["q"]),
                               atol=10 * RTOL[dtype])


@pytest.mark.parametrize("method", ["scholqr3", "svqb", "qr"])
def test_orthonormalize_matches_jax(port, method):
    y = low_rank(22, SHAPE, 1e-2, np.float64)[:, :12]
    want = np.asarray(jax.jit(lambda x: rc.orthonormalize(x, method))(
        jnp.asarray(y)))
    got = n(port.rt.orthonormalize(t(y), method))
    np.testing.assert_allclose(got.T @ got, np.eye(12), atol=1e-12)
    np.testing.assert_allclose(projector(got), projector(want), atol=1e-12)
    if method == "scholqr3":  # no sign freedom: the same Q
        np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("method,dtype", [("direct", np.float32),
                                          ("gram", np.float64)])
def test_compute_svd_matches_jax(port, method, dtype):
    """f64 for gram: it squares the condition number, so f32 singular
    values near 1e-2 carry ~1e-3 relative eigensolver noise."""
    a = low_rank(23, (12, 40), 1e-2, dtype)
    js = refs(f"compute_svd {method}", a, lambda: {
        "s": rc.compute_svd(jnp.asarray(a), method=method)[1]})["s"]
    u, s, vt = port.rt.compute_svd(t(a), method=method)
    np.testing.assert_allclose(n(s), js, rtol=RTOL[dtype])
    np.testing.assert_allclose(n(u * s[None, :] @ vt), a,
                               atol=100 * RTOL[dtype])


@pytest.mark.parametrize("small_svd", ["direct", "gram"])
def test_rsvd_block_given_the_jax_omega(port, small_svd):
    from rusty_compression_tpu_torch.parallel.batch import (
        _rsvd_block_from_omega)

    from rusty_compression_tpu.parallel.batch import rsvd_block

    a = low_rank(24, SHAPE, 1e-4, np.float32)

    def jax_side():
        key = jax.random.key(25)
        out = jax.jit(lambda x, k: rsvd_block(x, k, 10, oversample=4,
                                              power_iters=1,
                                              small_svd=small_svd))(
            jnp.asarray(a), key)
        return {"s": out.s,
                "err": rc.rel_diff_fro(out.to_mat(), jnp.asarray(a)),
                "omega": jax_gaussian(key, (SHAPE[1], 14), np.float32)}

    want = refs(f"rsvd block {small_svd}", a, jax_side)
    got = _rsvd_block_from_omega(t(a), t(want["omega"]), 10, power_iters=1,
                                 small_svd=small_svd)
    np.testing.assert_allclose(n(got.s), want["s"], rtol=RTOL[np.float32])
    err = float(port.rt.rel_diff_fro(got.to_mat(), t(a)))
    assert abs(err - float(want["err"])) <= 1e-6


def test_svd_tolerance_matches_jax(port):
    a = low_rank(26, SHAPE, 1e-8, np.float64)
    want = refs("svd tolerance", a, lambda: {"s": rc.SVD.compute_from(
        jnp.asarray(a)).compress_svd_tolerance(1e-4).s})
    got = port.rt.SVD.compute_from(t(a)).compress_svd_tolerance(1e-4)
    assert got.rank == want["s"].shape[0]
    np.testing.assert_allclose(n(got.s), want["s"], rtol=1e-10)
    with pytest.raises(port.rt.CompressionError):
        got.compress_svd_tolerance(1e-9)


def test_batched_rsvd_from_a_generator(port):
    """Independent per-block sketches from one generator: every block of
    the stack reaches the HMT error class of its spectrum."""
    torch, rt = port.torch, port.rt
    from rusty_compression_tpu_torch.parallel import (batched_rel_diff_fro,
                                                      batched_rsvd)

    blocks = t(np.stack([low_rank(s, SHAPE, 1e-4) for s in range(3)]))
    g = torch.Generator().manual_seed(0)
    svd = batched_rsvd(blocks, g, 10, oversample=5, power_iters=1)
    assert svd.u.shape == (3, 60, 10) and svd.s.shape == (3, 10)
    sigma_next = 1e-4 ** (10 / 39)  # sigma_11 / sigma_1 of the fixture
    assert torch.all(batched_rel_diff_fro(svd, blocks) < 3 * sigma_next)
    with pytest.raises(ValueError, match="block stack"):
        batched_rsvd(blocks[0], g, 10)


# ---------------------------------------------------------------------------
# The rest of the small samplers: nsqb, the range finder's knobs, power
# iteration, max_col_norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,shape", [(np.float32, SHAPE),
                                         (np.complex64, SHAPE),
                                         (np.float64, (3, *SHAPE))])
def test_nsqb_matches_jax(port, dtype, shape):
    """The Newton–Schulz orthonormalization keeps the column order and has
    no sign freedom: the same Q, to 1e-4 (f32/c64: 22 iterations of three
    GEMMs) / 1e-9 (f64). On a stack every matrix gets its own scaling, as
    ``vmap`` of the JAX function does. Orthogonality is that of the
    method: the shift 1e-5 over the weakest Gram eigenvalue, 1e-2 of the
    largest here, leaves a bias near 1e-3."""
    from rusty_compression_tpu.ops.orthogonalize import nsqb as jax_nsqb

    from rusty_compression_tpu_torch.ops.orthogonalize import nsqb

    rng = np.random.default_rng(30)
    y = rng.standard_normal((*shape[:-1], 12))
    if np.issubdtype(dtype, np.complexfloating):
        y = y + 1j * rng.standard_normal(y.shape)
    y = (y * np.geomspace(1.0, 1e-1, 12) * 37.0).astype(dtype)
    fn = jax.vmap(jax_nsqb) if y.ndim == 3 else jax_nsqb
    want = refs(f"nsqb {np.dtype(dtype).name} {shape}", y, lambda: {
        "q": fn(jnp.asarray(y))})["q"]
    got = n(nsqb(t(y)))
    tol = 1e-9 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(got, want, atol=tol)
    gram = np.swapaxes(got.conj(), -1, -2) @ got
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(12), gram.shape),
                               atol=1e-2)
    np.testing.assert_allclose(n(port.rt.orthonormalize(t(y), "nsqb")), got,
                               atol=0)


@pytest.mark.parametrize("knobs", [dict(mid_ortho="nsqb"),
                                   dict(ortho="svqb", final_passes=2),
                                   dict(sketch_precision="high"),
                                   dict(ortho="svqb", mid_ortho="cholqr2",
                                        sketch_precision="highest")])
def test_range_finder_knobs_match_jax(port, knobs):
    """``sketch_precision`` / ``mid_ortho`` / ``final_passes`` reach the
    same places as in the JAX package: the same basis by projector, 1e-9
    (f64). On the CPU a precision below "highest" changes no product."""
    from rusty_compression_tpu_torch.sampling import _range_finder_from_omega

    a = low_rank(31, SHAPE, 1e-4, np.float64)

    def jax_side():
        key = jax.random.key(32)
        return {"q": rc.range_finder(jnp.asarray(a), key, 12, 2, **knobs),
                "omega": jax_gaussian(key, (SHAPE[1], 12), np.float64)}

    want = refs(f"knobs {sorted(knobs.items())}", a, jax_side)
    got = _range_finder_from_omega(port.rt.DenseOperator(t(a)),
                                   t(want["omega"]), 2, **knobs)
    np.testing.assert_allclose(projector(n(got)), projector(want["q"]),
                               atol=1e-9)


def test_sketch_precision_lowers_the_operator_products_only(port):
    torch, rt = port.torch, port.rt
    seen = []

    class Watching(rt.DenseOperator):
        def matmat(self, x):
            seen.append(("op", torch.get_float32_matmul_precision()))
            return super().matmat(x)

        def conj_matmat(self, x):
            seen.append(("op", torch.get_float32_matmul_precision()))
            return super().conj_matmat(x)

    from rusty_compression_tpu_torch.ops import orthogonalize
    from rusty_compression_tpu_torch.parallel import rsvd_block

    a = t(low_rank(33, SHAPE, 1e-3, np.float32))
    g = torch.Generator().manual_seed(1)
    real_qr = torch.linalg.qr

    def watching_qr(*args, **kwargs):
        seen.append(("ortho", torch.get_float32_matmul_precision()))
        return real_qr(*args, **kwargs)

    torch.linalg.qr = watching_qr
    try:
        svd = rsvd_block(Watching(a), g, 10, power_iters=1,
                         sketch_precision="high")
    finally:
        torch.linalg.qr = real_qr
    assert orthogonalize.torch.linalg.qr is real_qr
    # three sketch products lowered; the projection B = Q^H A is not one
    assert [p for kind, p in seen if kind == "op"] == ["high"] * 3 + [
        "highest"]
    assert {p for kind, p in seen if kind == "ortho"} == {"highest"}
    assert float(rt.rel_diff_fro(svd.to_mat(), a)) < 5 * 1e-3 ** (10 / 39)


@pytest.mark.parametrize("it_count", [0, 2])
def test_power_iteration_given_the_jax_omega(port, it_count):
    """The documented semantics (each iteration refines the last iterate),
    on the JAX draw: the same pivoted basis, by projector to 1e-9 and
    entrywise up to the sign of each column."""
    from rusty_compression_tpu_torch.sampling import (
        _sample_range_power_iteration_from_omega)

    a = low_rank(34, SHAPE, 1e-3, np.float64)

    def jax_side():
        key = jax.random.key(35)
        out = {"q": rc.sample_range_power_iteration(
            jnp.asarray(a), key, k=8, p=5, it_count=it_count),
            "omega": jax_gaussian(key, (SHAPE[1], 13), np.float64)}
        if it_count == 0:
            out["by_rank"] = rc.sample_range_by_rank(jnp.asarray(a), key,
                                                     k=8, p=5)
        return out

    stored = refs(f"power iteration {it_count}", a, jax_side)
    want = stored["q"]
    got = n(_sample_range_power_iteration_from_omega(
        port.rt.DenseOperator(t(a)), t(stored["omega"]), 8, it_count))
    assert got.shape == want.shape == (SHAPE[0], 8)
    np.testing.assert_allclose(projector(got), projector(want), atol=1e-9)
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=1e-9)
    if it_count == 0:  # reduces to sample_range_by_rank
        np.testing.assert_allclose(got, stored["by_rank"], atol=1e-12)


def test_power_iteration_improves_a_slow_spectrum(port):
    """``TestPowerIteration.test_improves_slow_spectrum`` on the port."""
    torch, rt = port.torch, port.rt
    m = n_ = 150
    g = torch.Generator().manual_seed(11)
    u = rt.random_orthogonal_matrix(g, (m, n_))
    vt = rt.random_orthogonal_matrix(g, (n_, n_))
    s = 1.0 / torch.arange(1, n_ + 1, dtype=torch.float64)
    a = (u * s) @ vt
    errs = []
    for it in (0, 2, 4):
        q = rt.sample_range_power_iteration(
            a, torch.Generator().manual_seed(12), k=10, p=5, it_count=it)
        errs.append(float(torch.linalg.norm(a - q @ (q.mT @ a))
                          / torch.linalg.norm(a)))
    assert errs[1] < errs[0] and errs[2] <= errs[1] * 1.05
    opt = float(torch.sqrt((s[10:] ** 2).sum()) / torch.linalg.norm(s))
    assert errs[2] < 1.6 * opt


def test_max_col_norm_and_the_hmt_factor(port):
    rt = port.rt
    a = np.array([[3.0, 0.0], [4.0, 1.0]])
    assert float(rt.max_col_norm(t(a))) == pytest.approx(5.0)
    assert float(rt.max_col_norm(t(a))) == float(rc.max_col_norm(a))
    rng = np.random.default_rng(36)
    stack = rng.standard_normal((3, 7, 5)) + 1j * rng.standard_normal((3, 7, 5))
    np.testing.assert_allclose(n(rt.max_col_norm(t(stack))),
                               np.asarray(rc.max_col_norm(stack)), rtol=1e-14)
    assert rt.HMT_TOL_FACTOR == rc.HMT_TOL_FACTOR


def test_hilbert_defaults_to_the_card():
    import inspect

    from rusty_compression_tpu_torch.utils import kernel_matrices as km

    assert inspect.signature(km.hilbert).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# compute_svd's QR-first route (``ops/svd._svd_through_qr``): on the card K5
# takes the QR of the long side; on the CPU the helper runs K5's plain
# version, held here against torch.linalg.svd
# ---------------------------------------------------------------------------


def _core(shape, dtype, kind):
    """A (..., m, n) core: a spectrum falling from 1 to 1e-3 (well separated
    singular values), as the adaptive path pads it (the last third of the
    short side's rows or columns zero), or all zero; and its rank."""
    *lead, m, n = shape
    k = min(m, n)
    a = np.zeros(shape, dtype)
    rank = {"zero": 0, "padded": k - k // 3}.get(kind, k)
    if rank:
        rows, cols = (rank, n) if m < n else (m, rank)
        a[..., :rows, :cols] = np.stack([
            low_rank(40 + i, (rows, cols), 1e-3, dtype)
            for i in range(int(np.prod(lead)))]).reshape(*lead, rows, cols)
    return a, rank


@pytest.mark.parametrize("shape,dtype,kind", [
    ((12, 1024), np.float32, "full"),          # wide, one core
    ((3, 12, 1024), np.float32, "full"),       # wide, a stack
    ((12, 1024), np.float64, "full"),
    ((3, 12, 1024), np.float64, "full"),
    ((1024, 12), np.float32, "full"),          # tall
    ((3, 1024, 12), np.float32, "full"),
    ((1024, 12), np.float64, "full"),
    ((3, 1024, 12), np.float64, "full"),
    ((3, 12, 1024), np.float32, "padded"),     # zero rows, as padded
    ((3, 12, 1024), np.float64, "padded"),
    ((3, 1024, 12), np.float64, "padded"),     # zero columns
    ((12, 1024), np.float64, "zero"),          # an all-zero core
])
def test_svd_through_qr_matches_the_library(port, shape, dtype, kind):
    """``_svd_through_qr`` against ``torch.linalg.svd``: the singular values
    to rtol 1e-12 (f64) / 1e-5 (f32) of the largest, ``u diag(s) vt`` back
    to ``a``, ``u`` and ``vt`` orthonormal (past the rank, rows of the QR's
    orthonormal Q turned by the small SVD's), and the leading half and the whole of the rank's left and right singular
    subspaces the library's (by projector)."""
    torch = port.torch
    from rusty_compression_tpu_torch.ops.svd import _svd_through_qr

    a_np, rank = _core(shape, dtype, kind)
    a = t(a_np)
    u, s, vt = _svd_through_qr(a)
    u0, s0, vt0 = torch.linalg.svd(a, full_matrices=False)
    k = min(shape[-2:])
    assert u.shape == u0.shape and s.shape == s0.shape
    assert vt.shape == vt0.shape
    rtol = 1e-12 if dtype == np.float64 else 1e-5
    scale = float(s0.max()) if rank else 0.0
    assert float((s - s0).abs().max()) <= rtol * scale
    tol = 10 * k * float(torch.finfo(a.dtype).eps)
    assert float((u * s[..., None, :] @ vt - a).norm()) <= tol * float(
        a.norm())
    eye = torch.eye(k, dtype=a.dtype)
    assert float((u.mT @ u - eye).abs().max()) <= tol
    assert float((vt @ vt.mT - eye).abs().max()) <= tol
    for r in {rank // 2, rank} - {0}:
        for got, want in ((u[..., :r], u0[..., :r]),
                          (vt[..., :r, :].mT, vt0[..., :r, :].mT)):
            assert float((got @ got.mT - want @ want.mT).abs().max()) <= (
                10 * RTOL[dtype])


@pytest.mark.parametrize("device,dtype,shape,takes", [
    ("cuda", "float32", (64, 21, 16384), True),  # cell 4's cores
    ("cuda", "float32", (3, 12, 1024), True),    # a wide stack
    ("cuda", "float64", (3, 1024, 12), True),    # a tall stack
    ("cuda", "float64", (1, 32, 8192), True),    # one core, 256 a column
    ("cuda", "float64", (32, 8192), True),
    ("cpu", "float32", (3, 12, 1024), False),    # a CPU tensor
    ("cuda", "complex64", (3, 12, 1024), False),  # complex
    ("cuda", "float64", (2, 130, 1024), False),  # k > 128
    ("cuda", "float32", (3, 20, 20), False),     # a square stack
    ("cuda", "float32", (3, 20, 39), False),     # long side < 2 k
    ("cuda", "float64", (64, 1024), False),      # K5 refuses: one core,
])                                               # 16 rows a column
def test_svd_through_qr_route(port, device, dtype, shape, takes):
    """``compute_svd(method="direct")`` takes the QR-first route exactly for
    a real f32 / f64 card tensor whose tall orientation K5 takes and whose
    long side is at least twice its short one (a stand-in tensor); every
    input on the CPU, and every other input, gets ``torch.linalg.svd``'s
    factors bit for bit and leaves the counter as it was."""
    torch = port.torch
    from rusty_compression_tpu_torch.ops import svd as ops_svd

    assert ops_svd._through_qr_takes(_Card(
        device=torch.device(device), dtype=getattr(torch, dtype),
        shape=shape)) == takes
    small = shape if np.prod(shape) <= 2 ** 18 else (2, *shape[-2:-1], 64)
    rng = np.random.default_rng(41)
    a = torch.tensor(rng.standard_normal(small)).to(getattr(torch, dtype))
    before = ops_svd.compute_svd.through_qr_count
    got = port.rt.compute_svd(a)
    want = torch.linalg.svd(a, full_matrices=False)
    assert ops_svd.compute_svd.through_qr_count == before
    assert all(torch.equal(x, y) for x, y in zip(got, want))
