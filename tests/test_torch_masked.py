"""The masked tolerance compressions, ``SVD.to_qr`` and the vector
permutation of the port, held against the JAX package.

The JAX factors go into the port through ``interop.from_numpy`` (the same
numbers on both sides), so ranks and flags must be equal and the masked
factors equal to 1e-14 (f64; one multiplication by 0 or 1). ``to_qr``
pivots a fresh QR on each side: compared through ``to_mat``, 1e-4 (f32) /
1e-11 (f64) as ``tests/test_containers.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rusty_compression_tpu as rc
from rusty_compression_tpu.models.qr import _tolerance_rank_device as jax_rank
from test_torch_parity import low_rank, n, port, t  # noqa: F401
from torch_threads import one_thread  # noqa: F401 (autouse)


def from_jax(obj):
    from rusty_compression_tpu_torch import interop

    return interop.from_numpy(obj, device="cpu")


DIAGS = {
    "transient_dip": [1.0, 0.5, 1e-9, 0.3, 0.1, 1e-9, 1e-10],
    "monotone": [1.0, 0.5, 0.1, 1e-7, 1e-8],
    "unreachable": [1.0, 0.9, 0.8, 0.7],
    "negative_entries": [-2.0, 1.0, -1e-8, 1e-9],
    "first_below": [1.0, 1e-9, 1e-9],
}


@pytest.mark.parametrize("name", sorted(DIAGS))
def test_tolerance_rank_device(port, name):
    from rusty_compression_tpu_torch.models.qr import _tolerance_rank_device

    d = np.asarray(DIAGS[name])
    want_rank, want_ok = jax_rank(jnp.asarray(d), 1e-6)
    rank, ok = _tolerance_rank_device(t(d), 1e-6)
    assert int(rank) == int(want_rank) and bool(ok) == bool(want_ok)


def test_tolerance_rank_device_on_a_batch(port):
    from rusty_compression_tpu_torch.models.qr import _tolerance_rank_device

    d = np.stack([np.pad(np.asarray(v), (0, 7 - len(v)), constant_values=1e-12)
                  for v in DIAGS.values()])
    want_rank, want_ok = jax.vmap(lambda x: jax_rank(x, 1e-6))(jnp.asarray(d))
    rank, ok = _tolerance_rank_device(t(d), 1e-6)
    np.testing.assert_array_equal(n(rank), np.asarray(want_rank))
    np.testing.assert_array_equal(n(ok), np.asarray(want_ok))
    assert rank.dtype == port.torch.int64


@pytest.mark.parametrize("tol,reachable", [(1e-3, True), (1e-30, False)])
def test_qr_masked_matches_jax(port, tol, reachable):
    a = low_rank(70, (80, 60), 1e-5, np.float64)
    jqr = rc.QR.compute_from(jnp.asarray(a))
    want_rank, want, want_ok = jqr.compress_qr_tolerance_masked(tol)
    rank, got, ok = from_jax(jqr).compress_qr_tolerance_masked(tol)
    assert bool(ok) == bool(want_ok) == reachable
    assert int(rank) == int(want_rank)
    if not reachable:
        assert int(rank) == got.rank
    for name in ("q", "r"):
        np.testing.assert_allclose(n(getattr(got, name)),
                                   np.asarray(getattr(want, name)), atol=1e-14)
    assert got.q.shape == (80, 60)  # the padded shape stays
    if reachable:  # zero beyond the rank, and equal to the slicing host API
        assert not got.q[:, int(rank):].any() and not got.r[int(rank):].any()
        host = from_jax(jqr).compress_qr_tolerance(tol)
        assert host.rank == int(rank)
        np.testing.assert_allclose(n(got.to_mat()), n(host.to_mat()),
                                   atol=1e-12)


def test_lq_masked_matches_jax(port):
    a = low_rank(71, (30, 50), 1e-5, np.float64)
    jlq = rc.LQ.compute_from(jnp.asarray(a))
    want_rank, want, want_ok = jlq.compress_lq_tolerance_masked(1e-3)
    rank, got, ok = from_jax(jlq).compress_lq_tolerance_masked(1e-3)
    assert bool(ok) and bool(want_ok) and int(rank) == int(want_rank)
    for name in ("l", "q"):
        np.testing.assert_allclose(n(getattr(got, name)),
                                   np.asarray(getattr(want, name)), atol=1e-14)
    np.testing.assert_allclose(
        n(got.to_mat()), n(from_jax(jlq).compress_lq_tolerance(1e-3).to_mat()),
        atol=1e-12)


def test_svd_masked_on_a_stack_matches_jax(port):
    """A stack whose blocks reach the tolerance at different ranks, one
    call, no host slicing: what ``vmap`` of the JAX method returns."""
    blocks = np.stack([low_rank(72 + i, (48, 40), 10.0 ** -(4 + 2 * i),
                                np.float64) for i in range(4)])
    u, s, vt = np.linalg.svd(blocks, full_matrices=False)
    run = jax.vmap(lambda x: rc.SVD(*x).compress_svd_tolerance_masked(1e-4))
    want_rank, want, want_ok = run((jnp.asarray(u), jnp.asarray(s),
                                    jnp.asarray(vt)))
    rank, got, ok = port.rt.SVD(t(u), t(s), t(vt)) \
        .compress_svd_tolerance_masked(1e-4)
    np.testing.assert_array_equal(n(rank), np.asarray(want_rank))
    assert len(set(n(rank).tolist())) > 1  # the ranks really differ
    assert bool(ok.all()) and bool(np.all(np.asarray(want_ok)))
    for name in ("u", "s", "vt"):
        np.testing.assert_allclose(n(getattr(got, name)),
                                   np.asarray(getattr(want, name)), atol=1e-14)
    for i in range(4):
        host = port.rt.SVD(t(u[i]), t(s[i]), t(vt[i])) \
            .compress_svd_tolerance(1e-4)
        assert host.rank == int(rank[i])
        np.testing.assert_allclose(n(got.to_mat()[i]), n(host.to_mat()),
                                   atol=1e-12)


def test_qr_masked_on_a_stack(port):
    """The masked QR of a stack equals the masked QR of each block."""
    blocks = t(np.stack([low_rank(76 + i, (40, 30), 10.0 ** -(4 + 3 * i),
                                  np.float64) for i in range(3)]))
    qr = port.rt.QR.compute_from(blocks)
    rank, got, ok = qr.compress_qr_tolerance_masked(1e-3)
    assert rank.shape == (3,) and bool(ok.all())
    for i in range(3):
        one = port.rt.QR(qr.q[i], qr.r[i], qr.ind[i])
        r_i, got_i, _ = one.compress_qr_tolerance_masked(1e-3)
        assert int(r_i) == int(rank[i])
        np.testing.assert_array_equal(n(got.q[i]), n(got_i.q))
        np.testing.assert_array_equal(n(got.r[i]), n(got_i.r))


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4),
                                       (np.float64, 1e-11),
                                       (np.complex128, 1e-11)])
def test_svd_to_qr_roundtrip(port, dtype, tol):
    a = low_rank(79, (50, 40), 1e-3, dtype)
    want = rc.SVD.compute_from(jnp.asarray(a)).to_qr()
    got = port.rt.SVD.compute_from(t(a)).to_qr()
    assert float(port.rt.rel_diff_fro(got.to_mat(), t(a))) < tol
    assert float(rc.rel_diff_fro(want.to_mat(), jnp.asarray(a))) < tol
    np.testing.assert_array_equal(n(got.ind), np.asarray(want.ind))
    np.testing.assert_allclose(np.abs(n(got.r).diagonal()),
                               np.abs(np.asarray(want.r).diagonal()),
                               rtol=1e-3 if dtype == np.float32 else 1e-9)


@pytest.mark.parametrize("mode", ["INV", "NOINV"])
def test_apply_vector_permutation(port, mode):
    rng = np.random.default_rng(5)
    vec = rng.standard_normal(9)
    perm = rng.permutation(9).astype(np.int32)
    want = rc.apply_vector_permutation(
        jnp.asarray(vec), perm, getattr(rc.VectorPermutationMode, mode))
    got = port.rt.apply_vector_permutation(
        t(vec), t(perm), getattr(port.rt.VectorPermutationMode, mode))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    # a stack of vectors, one permutation each
    vecs = rng.standard_normal((3, 9))
    perms = np.stack([rng.permutation(9) for _ in range(3)])
    got = port.rt.apply_vector_permutation(
        t(vecs), t(perms), getattr(port.rt.VectorPermutationMode, mode))
    for i in range(3):
        np.testing.assert_array_equal(n(got[i]), np.asarray(
            rc.apply_vector_permutation(
                jnp.asarray(vecs[i]), perms[i],
                getattr(rc.VectorPermutationMode, mode))))
