"""The twins of ``examples/*.py`` (``rusty_compression_tpu_torch/examples/``)
held against the JAX package's calls, as the JAX examples make them, on the
same numpy-seeded inputs, on the CPU (the kernels' plain versions).

The interpolative decomposition is compared live (f64 ``gs`` is
deterministic: equal index vectors, errors within 1e-10 relative); the
H-matrix partition is compared live with ``examples/hmatrix.py``'s own
``build_tree`` / ``partition``. The other JAX sides (the H-matrix stream and
matvec at 2048 points, the tol-1e-8 pipelines at ``RC_EXAMPLE_SMALL``
sizes, the complex classes at 256^2, the block workload's stream) come from
``tests/torch_refs/test_torch_examples.npz`` (``make_refs.py``), which also
records the sha256 of the ``examples/*.py`` files they mirror
(``tests/test_torch_refs.py`` checks them).
"""

import importlib
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

import rusty_compression_tpu as rc
from test_torch_parity import port  # noqa: F401
from torch_refs import Refs
from torch_threads import one_thread  # noqa: F401 (autouse)

refs = Refs(__file__)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TWINS = ("interpolative_decomposition", "adaptive_sampling", "high_accuracy",
         "high_accuracy_id", "complex_operators", "block_workload",
         "hmatrix")


def twin(name: str):
    return importlib.import_module(f"rusty_compression_tpu_torch.examples."
                                   f"{name}")


def jax_example(name: str):
    """``examples/<name>.py`` as a module (it imports JAX at its top)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gen(port, seed: int):
    return port.torch.Generator().manual_seed(seed)


def geomspace_matrix(seed: int, m: int, n: int) -> np.ndarray:
    """``U diag(geomspace(1, 1e-10, n)) V^T``, the JAX examples' fixture
    drawn with numpy."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u * np.geomspace(1.0, 1e-10, n)) @ v.T


@pytest.mark.parametrize("name", TWINS)
def test_main_runs_on_the_card_or_raises(port, monkeypatch, name):
    """No device named means the card; without one, ``main`` raises before
    it computes anything (no quiet fallback to the CPU)."""
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin(name).main()


def test_interpolative_decomposition_is_the_jax_packages(port):
    """Live: the JAX example's calls on the same f64 500x100 matrix; f64
    ``gs`` is deterministic, so the skeleton's indices are equal (the
    columns' up to the rank: past sigma ~ 1e-5 the downdated norms of the
    full factorization's trailing steps cancel, and the two packages order
    those columns apart) and each stage's error within 1e-10 relative."""
    import jax.numpy as jnp

    a = geomspace_matrix(42, 500, 100)
    got = twin("interpolative_decomposition").run(a, gen(port, 0))
    mat = jnp.asarray(a)
    qr = rc.QR.compute_from(mat).compress(rc.CompressionType.RANK(20))
    col_id = qr.column_id()
    ts = col_id.two_sided_id()
    np.testing.assert_array_equal(got["col_ind"][:20],
                                  np.asarray(ts.col_ind)[:20])
    np.testing.assert_array_equal(got["row_ind"], np.asarray(ts.row_ind))
    for key, fac in (("qr_rel_err", qr), ("column_id_rel_err", col_id),
                     ("two_sided_rel_err", ts)):
        want = float(rc.rel_diff_fro(fac.to_mat(), mat))
        assert abs(got[key] - want) <= 1e-10 * want, key
    skel = mat[ts.row_ind[:20], :][:, ts.col_ind[:20]]
    assert float(jnp.max(jnp.abs(ts.x - skel))) <= 1e-14
    assert got["skeleton_err"] <= 1e-14


def test_adaptive_sampling_against_the_jax_sampler(port):
    """The same 500x200 matrix, f64 at tol 1e-5 in blocks of 5: both
    samplers stop within one block of each other, each history's last
    estimate below tol and the exact residual of the QR within 5 tol."""
    a = geomspace_matrix(7, 500, 200)

    def jax_side():
        import jax.numpy as jnp

        q, res = rc.sample_range_adaptive(jnp.asarray(a), jax.random.key(1),
                                          1e-5, 5)
        qr = rc.QR.compute_from_range_estimate(q, jnp.asarray(a))
        return {"rank": int(q.shape[1]), "estimated": [e for _, e in res],
                "qr_rel_err": float(rc.rel_diff_fro(qr.to_mat(),
                                                    jnp.asarray(a)))}

    want = refs("adaptive_sampling", a, jax_side)
    got = twin("adaptive_sampling").run(a, gen(port, 1))
    assert abs(got["rank"] - int(want["rank"])) <= 5
    assert got["estimated"][-1] < 1e-5 and want["estimated"][-1] < 1e-5
    assert got["qr_rel_err"] <= 5e-5 and float(want["qr_rel_err"]) <= 5e-5
    assert got["ranks"] == [5 * (i + 1) for i in range(got["blocks"])]
    assert got["exact"][-1] == pytest.approx(got["qr_rel_err"], rel=1e-6)


def test_hmatrix_partition_is_the_jax_examples(port):
    """Live: the twin's tree and partition of 2048 sphere points give the
    admissible and dense index lists of ``examples/hmatrix.py``'s own."""
    ex = jax_example("hmatrix")
    hm = twin("hmatrix")
    points = hm.sphere_points(2048)
    adm, inadm = ex.partition(ex.build_tree(points), ex.build_tree(points))
    tree = hm.build_tree(points)
    got_adm, got_inadm = hm.partition(tree, tree)
    assert (len(adm), len(inadm)) == (302, 618)
    for got, want in ((got_adm, adm), (got_inadm, inadm)):
        assert len(got) == len(want)
        for (s, t), (ws, wt) in zip(got, want):
            np.testing.assert_array_equal(s.indices, ws.indices)
            np.testing.assert_array_equal(t.indices, wt.indices)


def jax_hmatrix(points: np.ndarray, x: np.ndarray, tol: float) -> dict:
    """``examples/hmatrix.py:98-173`` on ``points`` and ``x``, in f64."""
    import jax.numpy as jnp

    from rusty_compression_tpu import parallel as par
    from rusty_compression_tpu.utils.kernel_matrices import (
        laplace_kernel_block)

    ex = jax_example("hmatrix")
    tree = ex.build_tree(points)
    adm, inadm = ex.partition(tree, tree)
    pts = jnp.asarray(points)
    far = [np.asarray(laplace_kernel_block(
        pts[jnp.asarray(s.indices)], pts[jnp.asarray(t.indices)],
        dtype=jnp.float64)) for s, t in adm]
    results = par.compress_heterogeneous(far, jax.random.key(1), rel_tol=tol,
                                         sample_size=8)
    n = len(points)
    y_h = np.zeros(n)
    for (s, t), r in zip(adm, results):
        y_h[s.indices] += np.asarray(r.factors.apply(
            jnp.asarray(x[t.indices][:, None])))[:, 0]
    d_all = np.linalg.norm(points[:, None, :] - points[None, :, :], axis=-1)
    dense = 1.0 / (4.0 * np.pi * np.maximum(d_all, 1e-2))
    for s, t in inadm:
        y_h[s.indices] += dense[np.ix_(s.indices, t.indices)] @ x[t.indices]
    for (s, t), blk in zip(adm, far):
        dense[np.ix_(s.indices, t.indices)] = blk
    y_d = dense @ x
    return {"ranks": [r.rank for r in results], "y_h": y_h, "y_d": y_d,
            "matvec_rel_err": float(np.linalg.norm(y_h - y_d)
                                    / np.linalg.norm(y_d))}


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_hmatrix_stream_and_matvec_against_the_jax_example(port):
    """2048 points (302 admissible, 618 dense blocks), f64, tol 1e-6: every
    block's rank within one sample block (8) of the JAX stream's; the
    twin's dense operator applied to ``x`` equals the JAX example's dense
    matrix times ``x`` to 1e-12 relative (the cut-off and the exact far
    field built apart from the twin's); the twin's H-matrix matvec within
    50 tol of that JAX product, as is the JAX example's own."""
    hm = twin("hmatrix")
    points = hm.sphere_points(2048)
    x = np.random.default_rng(2).standard_normal(2048)
    want = refs("hmatrix 2048", (points, x),
                lambda: jax_hmatrix(points, x, 1e-6))
    got = hm.run(points, x, gen(port, 1))
    assert (got["admissible"], got["dense"]) == (302, 618)
    assert len(want["ranks"]) == len(got["ranks"]) == 302
    assert np.abs(np.asarray(got["ranks"]) - want["ranks"]).max() <= 8
    assert rel(got["y_d"], want["y_d"]) <= 1e-12
    assert rel(got["y_h"], want["y_d"]) < 50e-6
    assert got["matvec_rel_err"] < 50e-6
    assert float(want["matvec_rel_err"]) < 50e-6
    assert rel(want["y_h"], want["y_d"]) == pytest.approx(
        float(want["matvec_rel_err"]), rel=1e-12)
    assert got["h_bytes"] < got["dense_bytes"] == 2048 ** 2 * 8


def test_high_accuracy_against_the_jax_pipeline(port):
    """``RC_EXAMPLE_SMALL``'s 512^2, decay 60, tol 1e-8: the rank within 2
    of the spectrum's crossing in both packages, the residual <= 5 tol."""
    from rusty_compression_tpu.highacc import refined_rsvd_fused

    ha = twin("high_accuracy")
    a, sig = ha.make_input(512, 60)

    def jax_side():
        out = refined_rsvd_fused(a, jax.random.key(0), round_rank=66,
                                 tol=1e-8)
        return {"rank": out.rank, "residual": out.residual_fro(a)}

    want = refs("high_accuracy small", a, jax_side)
    got = ha.run(a, sig, gen(port, 0), decay_rank=60)
    crossing = got["crossing"]
    assert crossing == int(np.searchsorted(-sig / sig[0], -1e-8))
    assert abs(got["rank"] - crossing) <= 2
    assert abs(int(want["rank"]) - crossing) <= 2
    assert got["residual"] <= 5e-8 and float(want["residual"]) <= 5e-8
    assert got["orthogonality"] <= 1e-12


def test_high_accuracy_id_against_the_jax_pipeline(port):
    """``RC_EXAMPLE_SMALL``'s 300x80, tol 1e-8: the skeleton bitwise
    ``A[row_ind, col_ind]`` in both packages and the error <= 10 tol. The
    rank is where the core's pivoted-R diagonal crosses tol; in both
    packages that sits above the spectrum's crossing (64), and the two
    ranks are within 2 of each other."""
    from rusty_compression_tpu.highacc_id import refined_two_sided_id

    hid = twin("high_accuracy_id")
    a, crossing = hid.make_input(300, 80)

    def jax_side():
        ts = refined_two_sided_id(a, jax.random.key(0), tol=1e-8)
        ri = np.asarray(ts.row_ind)[:ts.rank]
        ci = np.asarray(ts.col_ind)[:ts.rank]
        err = np.linalg.norm(ts.c @ (ts.x @ ts.r) - a) / np.linalg.norm(a)
        return {"rank": ts.rank, "rel_err": float(err),
                "skeleton_bitwise": bool(np.array_equal(
                    np.asarray(ts.x), a[ri[:, None], ci]))}

    want = refs("high_accuracy_id small", a, jax_side)
    got = hid.run(a, gen(port, 0))
    assert crossing == 64
    assert got["skeleton_bitwise"] and bool(want["skeleton_bitwise"])
    assert got["rel_err"] <= 1e-7 and float(want["rel_err"]) <= 1e-7
    assert abs(got["rank"] - int(want["rank"])) <= 2
    assert min(got["rank"], int(want["rank"])) >= crossing


def test_complex_operators_at_256(port):
    """256^2 c64 (96 singular values, decay to 1e-10 over 60 ranks), rank
    27, through K2's plain version: the example's gate (the c128 residual
    <= 5e-8) and those of the complex ID on the card (rel err <= 10
    sigma_27, the skeleton within 1e-3); the c128 rank within 2 of the JAX
    package's."""
    co = twin("complex_operators")
    a, sig = co.make_input(256)

    def jax_side():
        out = rc.refined_rsvd_planar(a.astype(np.complex128),
                                     jax.random.key(3), round_rank=66,
                                     tol=1e-8)
        return {"rank": out.rank,
                "residual": out.residual_fro(a.astype(np.complex128))}

    want = refs("complex_operators 256", a, jax_side)
    got = co.run(a, gen(port, 1))
    bound = 10 * sig[27] / sig[0]
    assert got["rsvd_rel_err"] <= 3 * sig[27] / sig[0]
    for key in ("two_sided_rel_err", "column_id_rel_err",
                "compress_two_sided_rel_err"):
        assert got[key] <= bound, key
    assert got["two_sided_rank"] == got["compress_two_sided_rank"] == 27
    assert got["skeleton_err"] <= 1e-3
    assert got["refined_residual"] <= 5e-8
    assert float(want["residual"]) <= 5e-8
    assert abs(got["refined_rank"] - int(want["rank"])) <= 2


def test_block_workload_checkpoint_reads_in_the_jax_package(port, tmp_path):
    """The twin's checkpoint of the eight blocks loads in the JAX package's
    ``io.load_block_results`` (one row a block, the factors of each); the
    pending lists are [3], then []; every rank within one sample block of
    the JAX stream's on the same blocks."""
    from rusty_compression_tpu import parallel as par

    bw = twin("block_workload")
    blocks = bw.make_blocks(0)

    def jax_side():
        res = par.compress_heterogeneous(blocks, jax.random.key(1),
                                         rel_tol=1e-6, sample_size=8)
        return {"ranks": [r.rank for r in res]}

    want = refs("block_workload", blocks, jax_side)
    got = bw.run(blocks, gen(port, 1), str(tmp_path / "ckpt"))
    assert got["pending_after_loss"] == [3]
    assert got["pending_after_recovery"] == []
    assert np.abs(np.asarray(got["ranks"]) - want["ranks"]).max() <= 8
    rows = rc.io.load_block_results(str(tmp_path / "ckpt"))
    assert sorted(r["block"] for r in rows) == list(range(8))
    for r in rows:
        m, n_ = blocks[r["block"]].shape
        assert r["factors"].u.shape[0] == m
        assert r["factors"].vt.shape[1] == n_
    assert rc.io.pending_blocks(str(tmp_path / "ckpt"), 8) == []
