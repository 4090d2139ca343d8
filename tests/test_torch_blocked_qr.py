"""The port's blocked randomized RRQR (``pivoted_qr(mode="blocked")``) held
against the JAX package.

``_qrcp_blocked_from_gaussian`` is fed the very sketch matrix ``g`` that
JAX ``pivoted_qr(mode="blocked", key=...)`` draws, so on distinct-norm
inputs both pick the same pivots. Then the invariants and quality bounds of
``tests/test_pivoted_qr.py`` (TestPivotedQRBlocked, TestTournamentPivoting)
for f32/f64/c64/c128, with the sketch drawn from a ``torch.Generator``.

Tolerances: pivots exactly equal; factors to 2e-4 (f32/c64) or 1e-10
(f64/c128) of the largest entry (Householder panels on both sides, another
GEMM summation order). Invariants as in the JAX suite: 2e-4 (5e-4 with
scholqr3 panels) single, 1e-11 (1e-10) double.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rusty_compression_tpu as rc
from test_torch_parity import (jax_gaussian, low_rank, n,  # noqa: F401
                               port, t)

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


def _single(dtype) -> bool:
    return np.dtype(dtype).itemsize <= 8


def _blocked():
    from rusty_compression_tpu_torch.ops import pivoted_qr

    return pivoted_qr


def _gen(port, seed=0):
    return port.torch.Generator().manual_seed(seed)


def check_invariants(a, q, r, ind, atol):
    """``tests/test_pivoted_qr.py::check_invariants`` on tensors."""
    a, q, r, ind = n(a), n(q), n(r), n(ind)
    m, n_ = a.shape
    k = q.shape[1]
    np.testing.assert_allclose(q.conj().T @ q, np.eye(k), atol=atol)
    assert sorted(ind.tolist()) == list(range(n_))
    np.testing.assert_array_equal(r, np.triu(r))
    ncheck = n_ if k == m else k
    np.testing.assert_allclose((q @ r)[:, :ncheck], a[:, ind[:ncheck]],
                               atol=atol * np.abs(a).max() * 10)


def rel_err(a, q, r, ind):
    a, approx = n(a), n(q) @ n(r)
    inv = np.argsort(n(ind))
    return np.linalg.norm(approx[:, inv] - a) / np.linalg.norm(a)


def optimal(a, k):
    s = np.linalg.svd(n(a), compute_uv=False)
    return np.sqrt(np.sum(s[k:] ** 2)) / np.linalg.norm(n(a))


@pytest.mark.parametrize("candidates", [2, 0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_from_gaussian_matches_jax(port, dtype, candidates):
    """Same ``g``, same pivots (three panels, the last one short), with the
    tournament shortlist on and off."""
    a = low_rank(20, (120, 90), 1e-3, dtype)
    key, k, block, p = jax.random.key(5), 40, 16, 8
    jq, jr, jind = rc.pivoted_qr(
        jnp.asarray(a), max_rank=k, mode="blocked", block_size=block,
        sketch_oversample=p, pivot_kernel="xla",
        pivot_candidates=candidates, key=key)
    g = jax_gaussian(key, (block + p, 120), dtype)
    q, r_orig, piv = _blocked()._qrcp_blocked_from_gaussian(
        t(a), t(g), k, block, pivot_kernel="plain",
        candidate_factor=candidates)
    np.testing.assert_array_equal(n(piv), np.asarray(jind)[:k])
    atol = 2e-4 if _single(dtype) else 1e-10
    np.testing.assert_allclose(n(q), np.asarray(jq), atol=atol)
    r = np.triu(n(r_orig)[:, np.asarray(jind)])
    np.testing.assert_allclose(r, np.asarray(jr),
                               atol=atol * np.abs(np.asarray(jr)).max())


@pytest.mark.parametrize("dtype", DTYPES)
class TestBlockedInvariants:
    def test_invariants_large(self, port, dtype):
        a = t(np.random.default_rng(21).standard_normal((300, 200))
              .astype(dtype))
        q, r, ind = port.rt.pivoted_qr(a, mode="blocked", block_size=48,
                                       generator=_gen(port))
        check_invariants(a, q, r, ind, 2e-4 if _single(dtype) else 1e-11)

    def test_invariants_scholqr3_panel(self, port, dtype):
        a = t(low_rank(22, (300, 200), 1e-4 if _single(dtype) else 1e-8,
                       dtype))
        q, r, ind = port.rt.pivoted_qr(a, mode="blocked", block_size=48,
                                       panel_qr="scholqr3",
                                       generator=_gen(port))
        check_invariants(a, q, r, ind, 5e-4 if _single(dtype) else 1e-10)

    def test_panel_kernel_does_not_change_the_pivots(self, port, dtype):
        """Pivot choice is sketch-driven: same generator seed, Householder
        or scholqr3 panels, at least 30 of 32 pivots in common."""
        a = t(low_rank(23, (160, 120), 1e-4, dtype))
        inds = [port.rt.pivoted_qr(a, max_rank=32, mode="blocked",
                                   block_size=16, panel_qr=method,
                                   generator=_gen(port, 5))[2]
                for method in ("house", "scholqr3")]
        common = len(set(n(inds[0])[:32]) & set(n(inds[1])[:32]))
        assert common >= 30, common

    def test_rank_revealing_quality(self, port, dtype):
        sigma_min, k = (1e-4, 30) if _single(dtype) else (1e-10, 40)
        a = t(low_rank(24, (256, 192), sigma_min, dtype))
        q, r, ind = port.rt.pivoted_qr(a, max_rank=k, mode="blocked",
                                       block_size=16, generator=_gen(port))
        err, opt = rel_err(a, q, r, ind), optimal(a, k)
        assert err < 10 * opt + 1e-12, (err, opt)

    def test_truncated_spans_the_dominant_range(self, port, dtype):
        a = t(low_rank(25, (120, 80), 1e-6, dtype))
        q, r, ind = port.rt.pivoted_qr(a, max_rank=25, mode="blocked",
                                       block_size=8, generator=_gen(port))
        assert tuple(q.shape) == (120, 25) and tuple(r.shape) == (25, 80)
        an, qn = n(a), n(q)
        resid = an - qn @ (qn.conj().T @ an)
        assert (np.linalg.norm(resid) / np.linalg.norm(an)
                < 20 * optimal(a, 25))


def test_shortlist_matches_full_width_quality(port):
    a = t(low_rank(26, (256, 192), 1e-5))
    k = 48
    e2, e0 = (rel_err(a, *port.rt.pivoted_qr(
        a, max_rank=k, mode="blocked", block_size=16, pivot_candidates=c,
        generator=_gen(port, 7))) for c in (2, 0))
    opt = optimal(a, k)
    assert e0 < 10 * opt + 1e-12, (e0, opt)
    assert e2 < 10 * opt + 1e-12, (e2, opt)
    assert e2 < 4 * max(e0, opt), (e2, e0, opt)


def test_shortlist_on_a_stair_step_spectrum(port):
    """Stair-step spectra maximize near-ties; the shortlist must not
    truncate a step early."""
    rng = np.random.default_rng(27)
    m, n_, k = 200, 160, 40
    u, _ = np.linalg.qr(rng.standard_normal((m, n_)))
    v, _ = np.linalg.qr(rng.standard_normal((n_, n_)))
    s = np.repeat(10.0 ** -np.arange(8), 20)[:n_]
    a = t(((u * s) @ v).astype(np.float32))
    q, r, ind = port.rt.pivoted_qr(a, max_rank=k, mode="blocked",
                                   block_size=16, generator=_gen(port))
    opt = np.sqrt(np.sum(s[k:] ** 2)) / np.linalg.norm(n(a).astype(float))
    assert rel_err(a, q, r, ind) < 10 * opt


def test_exhaustion_on_a_full_factorization(port):
    """k == n: the last panels' shortlists hold used columns, and the mask
    keeps the permutation valid."""
    a = t(np.random.default_rng(28).standard_normal((96, 64))
          .astype(np.float32))
    q, r, ind = port.rt.pivoted_qr(a, mode="blocked", block_size=16,
                                   pivot_candidates=2, generator=_gen(port))
    check_invariants(a, q, r, ind, 2e-4)


def test_scholqr3_panel_redoes_an_unhealthy_panel(port):
    """A panel of condition 1e9 breaks shifted CholeskyQR3 in f32; the
    self-check hands it, and only it, to Householder."""
    torch = port.torch
    from rusty_compression_tpu_torch.ops.orthogonalize import (
        shifted_cholesky_qr3)

    bad = t(low_rank(29, (200, 16), 1e-9))
    good = t(low_rank(30, (200, 16), 1e-2))
    eye = torch.eye(16)
    assert float((shifted_cholesky_qr3(bad)[0].mT
                  @ shifted_cholesky_qr3(bad)[0] - eye).abs().max()) > 1e-3
    q = _blocked()._panel_qr(torch.stack([bad, good]), "scholqr3")
    assert float((q.mT @ q - eye).abs().max()) < 1e-5
    np.testing.assert_array_equal(n(q[0]), n(torch.linalg.qr(bad)[0]))
    np.testing.assert_array_equal(n(q[1]), n(shifted_cholesky_qr3(good)[0]))


def test_smooth_kernel_block_with_scholqr3_panels(port):
    """The small-k wide route on a Laplace block, whose 16-pivot panel is
    ill-conditioned (tests/test_pivoted_qr.py, the config-4b regression)."""
    from rusty_compression_tpu_torch.utils.kernel_matrices import (
        laplace_kernel_block)

    rng = np.random.default_rng(40)
    x = rng.uniform(-0.5, 0.5, (768, 3))
    y = rng.uniform(-0.5, 0.5, (768, 3)) + np.array([3.0, 0.0, 0.0])
    a = laplace_kernel_block(t(x), t(y)).float()
    q, r, ind = port.rt.pivoted_qr(a, 16, mode="blocked", block_size=16,
                                   panel_qr="scholqr3", generator=_gen(port))
    q64 = n(q).astype(np.float64)
    assert np.abs(q64.T @ q64 - np.eye(16)).max() < 1e-4
    an = n(a).astype(np.float64)
    err = (np.linalg.norm(q64 @ n(r).astype(np.float64) - an[:, n(ind)])
           / np.linalg.norm(an))
    assert err < 1e-4, err


@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
def test_stack_equals_its_blocks_one_by_one(port, dtype):
    """A (B, m, n) stack with a (B, l, m) sketch stack gives each block's
    own factorization."""
    torch = port.torch
    rng = np.random.default_rng(31)
    a = t(np.stack([low_rank(32 + s, (60, 80), 1e-3, dtype)
                    for s in range(3)]))
    g = t(rng.standard_normal((3, 24, 60)).astype(dtype))
    fn = _blocked()._qrcp_blocked_from_gaussian
    q, r, piv = fn(a, g, 32, 16)
    for b in range(3):
        qb, rb, pivb = fn(a[b], g[b], 32, 16)
        assert torch.equal(piv[b], pivb)
        atol = 1e-5 if _single(dtype) else 1e-12
        np.testing.assert_allclose(n(q[b]), n(qb), atol=atol)
        np.testing.assert_allclose(n(r[b]), n(rb), atol=atol)
    q, r, ind = port.rt.pivoted_qr(a, 32, mode="blocked", block_size=16)
    assert tuple(ind.shape) == (3, 80)
    for b in range(3):
        check_invariants(a[b], q[b], r[b], ind[b],
                         2e-4 if _single(dtype) else 1e-11)


def test_pivot_kernel_names(port):
    """The port's names are "kernel" and "plain"; on a CPU tensor the
    kernel wrapper runs its plain version and picks the plain rule's
    pivots on a distinct-norm input. The JAX names are refused."""
    a = t(low_rank(33, (80, 100), 1e-3))
    inds = [port.rt.pivoted_qr(a, 32, mode="blocked", block_size=16,
                               pivot_kernel=rule, generator=_gen(port))[2]
            for rule in ("plain", "kernel", "auto")]
    np.testing.assert_array_equal(n(inds[0]), n(inds[1]))
    np.testing.assert_array_equal(n(inds[0]), n(inds[2]))
    for name in ("pallas", "xla"):
        with pytest.raises(ValueError, match="'kernel', 'plain'"):
            port.rt.pivoted_qr(a, 32, mode="blocked", pivot_kernel=name)
    with pytest.raises(ValueError, match="panel_qr"):
        port.rt.pivoted_qr(a, 32, mode="blocked", panel_qr="svqb")


def test_default_generator_is_a_fixed_seed(port):
    """No generator: a seed-0 generator on the input's device, as the JAX
    package's ``key(0)``; two calls agree bit for bit. At small rank
    auto's blocked mode runs the pivot rule over the whole sketch."""
    a = t(low_rank(34, (64, 600), 1e-3))
    first = port.rt.pivoted_qr(a, max_rank=8)   # n > 512: auto is blocked
    second = port.rt.pivoted_qr(a, max_rank=8, mode="blocked",
                                pivot_candidates=0)
    for x, y in zip(first, second):
        np.testing.assert_array_equal(n(x), n(y))


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_two_sided_id_of_a_block_wider_than_512(port, dtype):
    """The LQ of a (1024, 43) ``C`` is a QRCP of a (43, 1024) matrix, which
    auto mode sends to "blocked" on the CPU; it used to raise. Gates of the
    8192^2 complex configuration: rel err <= 10 sigma_43, skeleton within
    1e-3 (one-read ID: 5e-3)."""
    a = t(low_rank(68, (1024, 1024), 1e-9, dtype, rank=96))
    sigma_k = np.geomspace(1.0, 1e-9, 96)[43]
    ts = port.rt.sketched_two_sided_id(a, _gen(port, 1), rank=43,
                                       oversample=10)
    assert float(port.rt.rel_diff_fro(ts.to_mat(), a)) <= 5e-3
    skel = n(a)[np.ix_(n(ts.row_ind[:43]), n(ts.col_ind[:43]))]
    assert np.abs(n(ts.x) - skel).max() / np.abs(skel).max() <= 1e-3
    from rusty_compression_tpu_torch.parallel import batched_two_sided_id

    two_read = batched_two_sided_id(a[None], _gen(port, 2), rank=43)
    assert tuple(two_read.x.shape) == (1, 43, 43)
    err = float(port.rt.rel_diff_fro(two_read.to_mat(), a[None]))
    assert err <= 10 * sigma_k, err
