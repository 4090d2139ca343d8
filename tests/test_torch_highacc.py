"""The port's tol <= 1e-8 rSVD (``highacc.py``, native f64/c128) held
against the JAX package's compensated-precision one.

The two capture the range from different random matrices (an f64 range
finder here, f32 rounds with double-float residuals there), so end to end
they are compared by their contracts on the same numpy inputs: both
residuals <= 5 tol, both ranks at the spectrum's crossing and within 2 of
each other, the singular values within 1e-9 of sigma_1. The deterministic
tail (``_finish_core``: the SVD of a given core, the tolerance cut,
``opt_resid``) is fed the same f64 core on both sides and agrees to 1e-12.

The JAX results come from ``tests/torch_refs/test_torch_highacc.npz``
(``make_refs.py`` writes it from these inputs); one case of the
deterministic tail runs the JAX package live. The c128 path is held against
the JAX package in ``test_torch_highacc_id.py``.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest

from rusty_compression_tpu import highacc as jha
from rusty_compression_tpu.utils.doublefloat import (DF, df_from_f64,
                                                     df_to_f64)
from rusty_compression_tpu.utils.errors import CompressionError as JaxError
from test_torch_parity import n, port, t  # noqa: F401
from torch_refs import Refs
from torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 1e-8
refs = Refs(__file__)


def pack(r, prefix: str = "") -> dict:
    """A JAX ``RefinedSVD`` as arrays (for the store)."""
    return {f"{prefix}u_hi": r.u.hi, f"{prefix}u_lo": r.u.lo,
            f"{prefix}s": r.s, f"{prefix}vt": r.vt,
            f"{prefix}history": list(r.history),
            f"{prefix}tol_ok": r.tol_ok, f"{prefix}opt_resid": r.opt_resid}


def unpack(d: dict, prefix: str = ""):
    """The JAX ``RefinedSVD`` of stored arrays (host numpy leaves)."""
    opt = d.get(f"{prefix}opt_resid")
    return jha.RefinedSVD(
        DF(d[f"{prefix}u_hi"], d[f"{prefix}u_lo"]), d[f"{prefix}s"],
        d[f"{prefix}vt"], tuple(float(h) for h in d[f"{prefix}history"]),
        bool(d[f"{prefix}tol_ok"]), None if opt is None else float(opt))


def decaying(seed, m, n_, decay_rank=60, floor=1e-12, complex_=False,
             with_u=False):
    """``sigma_i = max(10^(-10 i / (decay_rank - 1)), floor)``: crosses 1e-8
    at i = 0.8 (decay_rank - 1). With ``with_u``, ``(a, u)``: also the
    left singular vectors ``a`` was made from."""
    rng = np.random.default_rng(seed)
    k = min(m, n_)
    sig = np.maximum(10.0 ** (-10 * np.arange(k) / (decay_rank - 1)), floor)

    def basis(rows):
        g = rng.standard_normal((rows, k))
        if complex_:
            g = g + 1j * rng.standard_normal((rows, k))
        return np.linalg.qr(g)[0]

    u = basis(m)
    a = (u * sig) @ basis(n_).conj().T
    return (a, u) if with_u else a


def crossing(decay_rank):
    return int(np.ceil(0.8 * (decay_rank - 1)))


def flat(seed, size):
    """A spectrum that never crosses any small tolerance."""
    q, _ = np.linalg.qr(np.random.default_rng(seed)
                        .standard_normal((size, size)))
    return q @ np.diag(np.linspace(1.0, 0.5, size)) @ q.T


A_REAL, U_REAL = decaying(1, 192, 160, with_u=True)
A_CPLX, U_CPLX = decaying(2, 160, 128, complex_=True, with_u=True)
MARK_STACK = np.stack([decaying(44, 96, 96, decay_rank=30), flat(43, 96)])


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's results on the module's inputs (stored)."""
    fixed = refs("fixed", A_REAL, lambda: pack(jha.refined_rsvd(
        A_REAL, jax.random.key(1), round_rank=66, tol=TOL)))

    def mark():
        outs = jha.refined_rsvd_fused_batch(MARK_STACK, jax.random.key(1),
                                            tol=TOL, on_unreachable="mark")
        return {**pack(outs[0], "0."), **pack(outs[1], "1.")}

    marked = refs("mark", MARK_STACK, mark)
    return {"fixed": unpack(fixed),
            "mark": [unpack(marked, "0."), unpack(marked, "1.")]}


def gen(port, seed=0):
    return port.torch.Generator().manual_seed(seed)


def assert_same_class(got, want, a, rank_at):
    """Both residuals <= 5 tol, ranks at the crossing and within 2 of each
    other, singular values within 1e-9 of sigma_1."""
    assert want.residual_fro(a) <= 5 * TOL
    assert got.residual_fro(a) <= 5 * TOL
    assert abs(got.rank - want.rank) <= 2
    assert abs(got.rank - rank_at) <= 2
    k = min(got.rank, want.rank)
    np.testing.assert_allclose(n(got.s)[:k], np.asarray(want.s)[:k],
                               rtol=0, atol=1e-9 * float(want.s[0]))


# ---------------------------------------------------------------------------
# End to end against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["refined_rsvd", "refined_rsvd_fused",
                                   "verified"])
def test_fixed_rounds_match_jax(port, jax_results, entry):
    ha = port.rt.highacc
    kwargs = dict(round_rank=66, tol=TOL)
    if entry == "verified":
        out = ha.refined_rsvd_fused(t(A_REAL), gen(port), verify=True,
                                    **kwargs)
        assert len(out.history) == 1 and out.history[0] <= 2.5 * TOL
    else:
        out = getattr(ha, entry)(t(A_REAL), gen(port), **kwargs)
        assert out.history == ()
    assert_same_class(out, jax_results["fixed"], A_REAL, crossing(60))
    u = n(out.u)
    assert u.dtype == np.float64 and out.s.dtype == port.torch.float64
    assert np.abs(u.T @ u - np.eye(out.rank)).max() < 1e-12
    assert out.opt_resid == pytest.approx(
        float(np.sqrt((np.linalg.svd(A_REAL, compute_uv=False)[out.rank:]
                       ** 2).sum()) / np.linalg.norm(A_REAL)), rel=1e-6)


@pytest.mark.parametrize("entry", ["refined_rsvd", "refined_rsvd_fused"])
def test_growth_matches_jax(port, jax_results, entry):
    """The port's growth against the JAX package's result on the same
    input (its fixed-round one: the JAX growth costs one more compile and
    is held to the same contracts in tests/test_highacc.py)."""
    out = getattr(port.rt.highacc, entry)(t(A_REAL), gen(port), tol=TOL)
    assert_same_class(out, jax_results["fixed"], A_REAL, crossing(60))
    hist = out.history
    assert len(hist) >= 2 and all(x > y for x, y in zip(hist, hist[1:]))
    assert hist[-1] <= 0.5 * TOL < hist[-2]


@pytest.mark.parametrize("entry", ["refined_rsvd", "refined_rsvd_planar",
                                   "growth"])
def test_complex_meets_the_contract(port, entry):
    """c128 against the input's exact spectrum (the JAX package's c128
    results are held against the port in test_torch_highacc_id.py)."""
    ha = port.rt.highacc
    if entry == "growth":
        out = ha.refined_rsvd(t(A_CPLX), gen(port), tol=TOL)
    else:
        out = getattr(ha, entry)(A_CPLX, gen(port), round_rank=54, tol=TOL)
    assert out.u.dtype == port.torch.complex128
    assert out.residual_fro(A_CPLX) <= 5 * TOL
    assert abs(out.rank - crossing(60)) <= 2
    sig = 10.0 ** (-10 * np.arange(out.rank) / 59)
    np.testing.assert_allclose(n(out.s), sig, rtol=0, atol=1e-9)
    u = n(out.u)
    assert np.abs(u.conj().T @ u - np.eye(out.rank)).max() < 1e-12


def test_marked_stack_matches_jax(port, jax_results):
    outs = port.rt.refined_rsvd_fused_batch(t(MARK_STACK), gen(port),
                                            tol=TOL, on_unreachable="mark")
    want = jax_results["mark"]
    assert [o.tol_ok for o in outs] == [w.tol_ok for w in want] \
        == [True, False]
    assert_same_class(outs[0], want[0], MARK_STACK[0], crossing(30))
    assert outs[1].rank == 96  # the full capture of the flat block
    with pytest.raises(port.rt.CompressionError, match="block 1"):
        port.rt.refined_rsvd_fused_batch(t(MARK_STACK), gen(port), tol=TOL)


def test_from_numpy_carries_the_jax_result(port, jax_results):
    want = jax_results["fixed"]
    from rusty_compression_tpu_torch.interop import from_numpy

    got = from_numpy(want, device="cpu")
    assert isinstance(got, port.rt.highacc.RefinedSVD)
    np.testing.assert_array_equal(n(got.u), df_to_f64(want.u))
    assert got.residual_fro(A_REAL) == pytest.approx(
        want.residual_fro(A_REAL), rel=1e-9)
    assert got.rank == want.rank and got.opt_resid == want.opt_resid


# ---------------------------------------------------------------------------
# The deterministic tail: the same core through both packages
# ---------------------------------------------------------------------------


def core_of(a, width, seed=5):
    """The orthonormal basis of a sketch of ``a`` under one power iteration,
    as a capture makes it, and its core. Past the spectrum's 1e-5 (cubed to
    the rounding level) its columns are noise, which moves at O(1) with the
    BLAS's thread count; the core ``b`` moves only in its last bits."""
    g = np.random.default_rng(seed).standard_normal((a.shape[1], width))
    q = np.linalg.qr(a @ (a.conj().T @ (a @ g)))[0]
    return q, q.conj().T @ a


def exact_core(a, u, width, seed=5):
    """An orthonormal basis of ``a``'s dominant range, its first ``width``
    left singular vectors ``u`` turned by a random rotation, and its core:
    unlike ``core_of``'s, the basis too moves only in its last bits with
    the BLAS's thread count."""
    g = np.random.default_rng(seed).standard_normal((width, width))
    q = u[:, :width] @ np.linalg.qr(g)[0]
    return q, q.conj().T @ a


@pytest.mark.parametrize("case", [
    dict(tol=TOL), dict(tol=TOL, rank=20), dict(rank=30), dict(tol=1e-5),
    dict(tol=1e-30, captured=True), dict(tol=1e-30)])
@pytest.mark.parametrize("complex_", [False, True])
def test_finish_core_matches_jax(port, case, complex_):
    """One case runs the JAX package live, the others read its stored
    results."""
    a, u = (A_CPLX, U_CPLX) if complex_ else (A_REAL, U_REAL)
    q, b = exact_core(a, u, 70)
    tol, rank = case.get("tol"), case.get("rank")
    captured = case.get("captured", False)
    call = dict(tol=tol, rank=rank, history=(), captured=captured)

    def jax_side():
        try:
            out = jha._finish_core(df_from_f64(q), b, complex_, 7, **call)
        except JaxError:
            return {"raised": True}
        return {"raised": False, **pack(out)}

    live = not complex_ and case == dict(tol=1e-30, captured=True)
    want = jax_side() if live else refs(
        f"finish_core {complex_} {sorted(case.items())}", (q, b), jax_side)
    if tol == 1e-30 and not captured:
        assert want["raised"]
        with pytest.raises(port.rt.CompressionError):
            port.rt.highacc._finish_core(t(q), t(b), **call)
        return
    assert not want["raised"]
    want = unpack(want)
    got = port.rt.highacc._finish_core(t(q), t(b), **call)
    assert got.rank == want.rank
    np.testing.assert_allclose(n(got.s), want.s, rtol=0,
                               atol=1e-12 * want.s[0])
    assert got.opt_resid == pytest.approx(want.opt_resid, rel=1e-12)
    rec = n(got.u) @ (n(got.s)[:, None] * n(got.vt))
    want_rec = df_to_f64(want.u) @ (want.s[:, None] * want.vt)
    assert np.abs(rec - want_rec).max() <= 1e-9


# ---------------------------------------------------------------------------
# Contracts of tests/test_highacc.py, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fixed", "growth"])
def test_refined_capture_contract(port, mode):
    kwargs = dict(round_rank=66) if mode == "fixed" else dict(tol=TOL)
    q, b, hist, captured = port.rt.refined_capture(t(A_REAL), gen(port),
                                                   **kwargs)
    q, b = n(q), n(b)
    assert np.abs(q.T @ q - np.eye(q.shape[1])).max() < 1e-12
    np.testing.assert_allclose(b, q.T @ A_REAL, atol=1e-13)
    err = np.linalg.norm(A_REAL - q @ b) / np.linalg.norm(A_REAL)
    if mode == "fixed":
        assert captured and hist == () and q.shape[1] == min(2 * 76, 160)
        assert err < 1e-11  # the spectrum's floor is 1e-12
    else:
        assert captured and err <= hist[-1] * (1 + 1e-6) <= 0.5 * TOL


@pytest.mark.parametrize("shape", [(120, 90), (90, 120), (100, 100),
                                   (300, 80)])
def test_saturated_shapes(port, shape):
    a = decaying(0, *shape, decay_rank=40)
    out = port.rt.refined_rsvd(t(a), gen(port), round_rank=46, tol=TOL)
    assert out.residual_fro(a) < 5 * TOL
    assert abs(out.rank - crossing(40)) <= 2


@pytest.mark.parametrize("mode", ["fixed", "growth"])
def test_padded_block_matches_the_unpadded(port, mode):
    """The JAX package certifies merged directions so that a zero-padded
    block's filler columns cannot spoil its double-float merge; the port
    keeps them (its f64 QR spans every column) and gets the same result."""
    a = decaying(20, 129, 159, decay_rank=58)
    pad = np.zeros((256, 256))
    pad[:129, :159] = a
    kwargs = dict(round_rank=128) if mode == "fixed" else {}
    outs = [port.rt.refined_rsvd(t(x), gen(port), tol=TOL, **kwargs)
            for x in (a, pad)]
    assert outs[0].rank == outs[1].rank == pytest.approx(crossing(58), abs=2)
    assert outs[1].residual_fro(pad) < 5 * TOL
    np.testing.assert_allclose(n(outs[1].s), n(outs[0].s), rtol=0,
                               atol=1e-10)


def test_tall_growth_and_direct_route(port):
    ha = port.rt.highacc
    a = decaying(15, 640, 256, decay_rank=60)
    q, b, _, captured = ha.growth_capture_fused(t(a), gen(port), tol=TOL)
    q = n(q)
    assert captured and np.abs(q.T @ q - np.eye(q.shape[1])).max() < 1e-12
    assert np.linalg.norm(q @ n(b) - a) / np.linalg.norm(a) < 5 * TOL
    # tol below a tall block's floor: the growth reaches the direct route
    rng = np.random.default_rng(12)
    u, _ = np.linalg.qr(rng.standard_normal((220, 90)))
    v, _ = np.linalg.qr(rng.standard_normal((90, 90)))
    low = (u * 10.0 ** (-6 * np.arange(90) / 89)) @ v.T
    q, b, _, captured = ha.refined_capture(t(low), gen(port), tol=1e-9)
    assert captured and q.shape == (220, 90)
    assert port.rt.refined_rsvd(t(low), gen(port), tol=1e-4) \
        .residual_fro(low) < 5e-4


@pytest.mark.parametrize("entry", ["refined_rsvd", "refined_rsvd_fused"])
def test_unreachable_tolerance_raises(port, entry):
    with pytest.raises(port.rt.CompressionError):
        getattr(port.rt, entry)(t(A_REAL), gen(port), round_rank=40,
                                tol=1e-30)
    with pytest.raises(port.rt.CompressionError):  # growth fills the space
        getattr(port.rt, entry)(t(flat(13, 96)), gen(port), tol=1e-10)


def test_full_capture_is_not_an_error(port):
    rng = np.random.default_rng(14)
    u, _ = np.linalg.qr(rng.standard_normal((256, 40)))
    v, _ = np.linalg.qr(rng.standard_normal((192, 40)))
    a = (u * np.geomspace(1.0, 1e-2, 40)) @ v.T
    out = port.rt.refined_rsvd(t(a), gen(port), tol=1e-6)
    assert out.rank == 40 and out.residual_fro(a) < 5e-6


def test_verify_repairs_an_under_capacity_capture(port):
    a = decaying(21, 256, 256, decay_rank=100)
    with pytest.raises(port.rt.CompressionError):
        port.rt.refined_rsvd_fused(t(a), gen(port), round_rank=24, tol=TOL)
    out = port.rt.refined_rsvd_fused(t(a), gen(port), round_rank=24, tol=TOL,
                                     verify=True)
    assert abs(out.rank - crossing(100)) <= 2
    assert out.residual_fro(a) < 5 * TOL
    assert out.history[0] > 2.5 * TOL and len(out.history) >= 2


def test_batch_growth_finds_each_rank(port):
    dks = (30, 60, 40)
    blocks = np.stack([decaying(40 + i, 128, 128, decay_rank=dk)
                       for i, dk in enumerate(dks)])
    outs = port.rt.refined_rsvd_fused_batch(t(blocks), gen(port), tol=TOL)
    for o, b, dk in zip(outs, blocks, dks):
        assert o.tol_ok and abs(o.rank - crossing(dk)) <= 2
        assert o.residual_fro(b) < 5 * TOL


def test_fixed_round_stack_marks_a_gaussian_block(port):
    """Chip phase 17's second half at a small size."""
    blocks = np.stack([decaying(50 + i, 128, 128, decay_rank=40)
                       for i in range(3)])
    blocks[0] = np.random.default_rng(9).standard_normal((128, 128))
    outs = port.rt.refined_rsvd_fused_batch(
        t(blocks), gen(port), round_rank=40, tol=TOL, on_unreachable="mark")
    assert not outs[0].tol_ok
    for o, b in zip(outs[1:], blocks[1:]):
        assert o.tol_ok and abs(o.rank - crossing(40)) <= 2
        assert o.residual_fro(b) < 5 * TOL


def test_tall_saturated_stack(port):
    blocks = np.stack([decaying(47, 320, 96, decay_rank=30),
                       decaying(48, 320, 96, decay_rank=50)])
    h = port.rt.highacc.refined_fused_batch_begin(
        t(blocks), gen(port), tol=TOL, round_rank=64, on_unreachable="mark")
    assert h["mode"] == "direct"
    outs = port.rt.highacc.refined_fused_batch_finish(h)
    for o, b, dk in zip(outs, blocks, (30, 50)):
        assert abs(o.rank - crossing(dk)) <= 2 and o.residual_fro(b) < 5 * TOL


def test_identical_blocks_get_their_own_sketches(port):
    """Against the JAX package's re-run of bad lanes, which seeds every
    sub-batch from one fixed key (``highacc.py:1841-1848``): here each
    block of a stack draws its own Gaussian matrices, so two equal blocks
    get different round-1 bases."""
    a = decaying(60, 96, 96, decay_rank=90)
    h = port.rt.highacc.refined_fused_batch_begin(
        t(np.stack([a, a])), gen(port), round_rank=10, refine_rounds=0)
    q = n(h["q"])
    p0, p1 = q[0] @ q[0].T, q[1] @ q[1].T
    assert np.abs(p0 - p1).max() > 1e-3


@pytest.mark.parametrize("block,width", [(8, 8), (16, 16), (64, 48)])
def test_growth_block_sets_the_round_width(port, block, width):
    """``growth_block`` reaches the batched growth, which the JAX package's
    re-run dropped: rounds of ``cap // max(cap // block, 2)`` columns."""
    ha = port.rt.highacc
    assert ha._growth_rounds(96, block)[0] == width
    a = decaying(61, 96, 96, decay_rank=30)
    h = ha.refined_fused_batch_begin(t(a[None]), gen(port), tol=TOL,
                                     growth_block=block)
    assert h["q"].shape[-1] % width == 0
    assert h["q"].shape[-1] == width * len(h["histories"][0])


def test_same_generator_state_same_factors(port):
    outs = [port.rt.refined_rsvd(t(A_REAL), gen(port, 3), tol=TOL)
            for _ in range(2)]
    for name in ("u", "s", "vt"):
        assert port.torch.equal(getattr(outs[0], name),
                                getattr(outs[1], name))


def test_batch_list_and_operator(port):
    torch = port.torch
    blocks = [decaying(10 + s, 128, 128, decay_rank=40) for s in (0, 1)]
    outs = port.rt.highacc.refined_rsvd_batch([t(b) for b in blocks],
                                               gen(port), round_rank=46)
    for o, b in zip(outs, blocks):
        assert o.residual_fro(b) < 5 * TOL
    a = t(A_REAL)
    op = port.rt.FunctionOperator(lambda x: a @ x, a.shape, a.dtype,
                                  device="cpu")
    out = port.rt.refined_rsvd(op, gen(port), tol=TOL)
    assert abs(out.rank - crossing(60)) <= 2
    assert out.residual_fro(A_REAL) < 5 * TOL
    assert out.u.device == torch.device("cpu")


def test_containers_and_argument_checks(port):
    ha = port.rt.highacc
    out = ha.refined_rsvd(A_REAL, gen(port), rank=30)   # numpy in
    svd = out.to_svd()
    assert svd.u.dtype == port.torch.float32 and svd.rank == 30
    assert out.to_f64()[0] is out.u
    assert out._replace(tol_ok=False).tol_ok is False
    with pytest.raises(ValueError):
        ha.refined_rsvd(A_REAL, gen(port))
    with pytest.raises(ValueError):
        ha.refined_rsvd_fused_batch(t(MARK_STACK), gen(port), tol=TOL,
                                    on_unreachable="skip")
    from test_torch_parity import one_rank_mesh

    with one_rank_mesh() as mesh:  # a mesh, once refused, shards the stack
        got = ha.refined_rsvd_fused_batch(t(MARK_STACK), gen(port), tol=TOL,
                                          mesh=mesh, on_unreachable="mark")
    want = ha.refined_rsvd_fused_batch(t(MARK_STACK), gen(port), tol=TOL,
                                       on_unreachable="mark")
    assert [(x.rank, x.tol_ok) for x in got] == [(y.rank, y.tol_ok)
                                                 for y in want]
    assert all(port.torch.equal(x.u, y.u) for x, y in zip(got, want))


def test_modules_import_neither_jax_nor_the_jax_package():
    pkg = Path(__file__).resolve().parents[1] / "rusty_compression_tpu_torch"
    pattern = re.compile(r"^\s*(import|from)\s+(jax|rusty_compression_tpu)\b",
                         re.M)
    files = [*sorted(pkg.rglob("*.py")), pkg.parent / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        assert not pattern.search(path.read_text()), path.name
