"""The ``compress`` front door of the port held against the JAX package's.

``feed_gaussians`` makes the port draw the very Gaussian matrices that the
JAX ``compress`` draws from its key, so each route computes on the same
numbers: pivots must be equal, singular values agree to rtol 1e-9 and
reconstructions to atol 1e-9 (f64; sigma_1 = 1). The blocks are 80 x 60,
so every pivoted QR takes the plain Gram–Schmidt route on both sides and
needs no random sketch of its own. The JAX side (its results and its
draws) comes from ``tests/torch_refs/test_torch_config.npz``
(``make_refs.py``), but for the stack's rSVD route, which runs live.
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rusty_compression_tpu as rc
from test_torch_parity import (block_keys, feed_gaussians,  # noqa: F401
                               jax_adaptive_omegas, jax_adaptive_omegas_stack,
                               jax_gaussian, jax_nystrom_omegas, jax_sketch,
                               low_rank, n, port, t)
from torch_refs import Refs
from torch_threads import one_thread  # noqa: F401 (autouse)

SHAPE = (80, 60)
M, N = SHAPE
CLASS = {"rsvd": "SVD", "nystrom": "SVD", "column_id": "ColumnID",
         "row_id": "RowID", "two_sided_id": "TwoSidedID",
         "sketched_two_sided_id": "TwoSidedID"}
refs = Refs(__file__)


def jax_draws(method, key, cfg, dtype=np.float64):
    """What JAX ``compress`` of one (M, N) matrix draws, in order."""
    if method == "rsvd":
        return [jax_gaussian(key, (N, cfg.rank + cfg.oversample), dtype)]
    if method == "nystrom":
        return list(jax_nystrom_omegas(key, M, N, cfg.rank, cfg.oversample,
                                       dtype))
    if method == "sketched_two_sided_id":
        return [jax_sketch(key, M, cfg.rank + 8, dtype)]
    return []  # the QR routes draw nothing at this size


def stacked(draws_per_block):
    return [np.stack(mats) for mats in zip(*draws_per_block)]


def factors_of(want, recon) -> dict:
    """What the tests compare of a JAX container: its class, rank, pivots,
    singular values and reconstruction."""
    out = {"type": type(want).__name__, "rank": want.rank,
           "to_mat": np.asarray(recon)}
    for name in ("ind", "col_ind", "row_ind", "s"):
        if hasattr(want, name):
            out[name] = np.asarray(getattr(want, name))
    return out


def assert_same_factors(got, want: dict):
    for name in ("ind", "col_ind", "row_ind"):
        if name in want:
            np.testing.assert_array_equal(n(getattr(got, name)), want[name])
    if "s" in want:
        np.testing.assert_allclose(n(got.s), want["s"], rtol=1e-9)


@pytest.mark.parametrize("method", sorted(CLASS))
def test_single_matrix_routes_match_jax(port, monkeypatch, method):
    a = low_rank(120, SHAPE, 1e-10, np.float64)
    iters = 0 if method == "nystrom" else 1
    kwargs = dict(method=method, power_iters=iters)
    cfg = port.rt.CompressionConfig.RANK(12, **kwargs)

    def jax_side():
        key = jax.random.key(1)
        out = rc.compress(jnp.asarray(a), key,
                          rc.CompressionConfig.RANK(12, **kwargs))
        return {**factors_of(out, out.to_mat()),
                "draws": jax_draws(method, key, cfg)}

    want = refs(f"single {method}", a, jax_side)
    left = feed_gaussians(monkeypatch, want["draws"])
    got = port.rt.compress(t(a), port.torch.Generator(), cfg)
    assert not left
    assert type(got).__name__ == str(want["type"]) == CLASS[method]
    assert got.rank == int(want["rank"]) == 12
    assert_same_factors(got, want)
    np.testing.assert_allclose(n(got.to_mat()), want["to_mat"], atol=1e-9)
    assert float(port.rt.rel_diff_fro(got.to_mat(), t(a))) < 1e-1


@pytest.mark.parametrize("method", sorted(CLASS))
def test_stack_routes_match_jax(port, monkeypatch, method):
    """The rSVD route runs the JAX package live, the others read its
    stored results."""
    blocks = np.stack([low_rank(121 + i, SHAPE, 1e-10, np.float64)
                       for i in range(3)])
    cfg = port.rt.CompressionConfig.RANK(8, method=method)

    def jax_side():
        key = jax.random.key(3)
        out = rc.compress(jnp.asarray(blocks), key,
                          rc.CompressionConfig.RANK(8, method=method))
        draws = stacked([jax_draws(method, k, cfg)
                         for k in block_keys(key, 3)])
        return {**factors_of(out, jax.vmap(type(out).to_mat)(out)),
                "draws": draws}

    want = jax_side() if method == "rsvd" else refs(f"stack {method}",
                                                    blocks, jax_side)
    left = feed_gaussians(monkeypatch, want["draws"])
    got = port.rt.compress(t(blocks), port.torch.Generator(), cfg)
    assert not left and type(got).__name__ == CLASS[method]
    assert_same_factors(got, want)
    assert got.to_mat().shape == (3, M, N)
    np.testing.assert_allclose(n(got.to_mat()), want["to_mat"], atol=1e-9)


def test_adaptive_single_matches_jax(port, monkeypatch):
    a = low_rank(124, SHAPE, 1e-10, np.float64)

    def jax_side():
        key = jax.random.key(2)
        wsvd, whist = rc.compress(jnp.asarray(a), key,
                                  rc.CompressionConfig.ADAPTIVE(1e-5))
        return {"rank": wsvd.rank, "s": wsvd.s, "hist": whist,
                "omegas": jax_adaptive_omegas(key, N, 10, 7, np.float64)}

    want = refs("adaptive single", a, jax_side)
    feed_gaussians(monkeypatch, want["omegas"])
    svd, hist = port.rt.compress(t(a), port.torch.Generator(),
                                 port.rt.CompressionConfig.ADAPTIVE(1e-5))
    whist = want["hist"]
    live = whist[whist > 0]
    assert np.all((live > 1.5e-5) | (live < 1e-5 / 1.5))  # a clear stop
    assert svd.rank == int(want["rank"]) and svd.rank % 10 == 0
    np.testing.assert_allclose(n(hist), whist, rtol=1e-6)
    np.testing.assert_allclose(n(svd.s), want["s"], rtol=1e-8)
    assert float(port.rt.rel_diff_fro(svd.to_mat(), t(a))) < 5e-5


def test_adaptive_knobs_reach_the_stack_pipeline(port, monkeypatch):
    """``test_adaptive_knobs_reach_pipelines``: max_rank, sample_size,
    ortho and small_svd flow through the stack path; the padded rank is
    ceil(24 / 8) * 8, not min(m, n)."""
    a = low_rank(125, (100, 80), 1e-10, np.float64)
    blocks = np.stack([a, a])
    kwargs = dict(max_rank=24, sample_size=8, ortho="cholqr2",
                  small_svd="gram")

    def jax_side():
        key = jax.random.key(1)
        wsvd, wranks, whist = rc.compress(
            jnp.asarray(blocks), key,
            rc.CompressionConfig.ADAPTIVE(1e-3, **kwargs))
        return {"width": np.asarray(wsvd.u).shape[-1], "ranks": wranks,
                "hist": whist, "omegas": jax_adaptive_omegas_stack(
                    key, 2, 80, 8, 4, np.float64)}

    want = refs("adaptive knobs", blocks, jax_side)
    feed_gaussians(monkeypatch, want["omegas"])
    svd, ranks, hist = port.rt.compress(
        t(blocks), port.torch.Generator(),
        port.rt.CompressionConfig.ADAPTIVE(1e-3, **kwargs))
    assert svd.u.shape[-1] == int(want["width"]) == 24
    np.testing.assert_array_equal(n(ranks), want["ranks"])
    np.testing.assert_allclose(n(hist), want["hist"], rtol=1e-6)


@pytest.mark.parametrize("kwargs,match", [
    (dict(), "exactly one"),
    (dict(rank=3, rel_tol=0.1), "exactly one"),
    (dict(rank=3, method="nope"), "unknown method"),
    (dict(rel_tol=0.1, method="column_id"), "produces an SVD"),
    (dict(rank=5, method="nystrom", power_iters=2), "single-pass"),
    (dict(rank=8, highacc=True), "tolerance pipeline"),
    (dict(rel_tol=1e-8, highacc=True), "round_rank"),
])
def test_config_validation_matches_jax(port, kwargs, match):
    for cls in (rc.CompressionConfig, port.rt.CompressionConfig):
        with pytest.raises(ValueError, match=match):
            cls(**kwargs)


def test_config_fields_and_defaults_match_jax(port):
    import dataclasses

    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert fields(port.rt.CompressionConfig) == fields(rc.CompressionConfig)
    cfg = port.rt.CompressionConfig.RANK(4)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.rank = 5
    assert port.rt.CompressionConfig.ADAPTIVE(1e-3).rel_tol == 1e-3


def test_pallas_is_refused_by_name(port):
    with pytest.raises(ValueError, match="'kernel'"):
        port.rt.CompressionConfig.RANK(4, method="column_id",
                                       qr_mode="pallas")


@pytest.mark.parametrize("what", ["list", "highacc_list", "mesh_rank",
                                  "mesh_adaptive"])
def test_later_slices_are_refused_by_name(port, what):
    """A list of blocks takes the block stream (rank and highacc); a stack
    on a mesh (once refused) takes the sharded call: on a group of one
    rank, bitwise the call without a mesh."""
    torch, rt = port.torch, port.rt
    a = t(low_rank(126, SHAPE, 1e-6, np.float64))
    g = torch.Generator()
    rank, adaptive = rt.CompressionConfig.RANK(4), \
        rt.CompressionConfig.ADAPTIVE(1e-3)
    if what in ("list", "highacc_list"):
        blocks = [a, a[:40, :30]]
        if what == "highacc_list":  # spectra that cross 1e-8
            blocks = [t(low_rank(126, SHAPE, 1e-12, np.float64)),
                      t(low_rank(127, (40, 30), 1e-12, np.float64, rank=20))]
        cfg = rank if what == "list" else rt.CompressionConfig.ADAPTIVE(
            1e-8, highacc=True, round_rank=16)
        out = rt.compress(blocks, g.manual_seed(0), cfg)
        assert [r.index for r in out] == [0, 1]
        assert [r.shape for r in out] == [SHAPE, (40, 30)]
        assert all(r.ok and r.bucket == (128, 128) for r in out)
        for r, b in zip(out, blocks):
            err = float(rt.rel_diff_fro(r.factors.to_mat(), b))
            assert r.rel_residual == pytest.approx(err, rel=1e-9)
            s = np.linalg.svd(n(b), compute_uv=False)
            k = r.rank
            opt = np.sqrt((s[k:] ** 2).sum() / (s ** 2).sum())
            assert err <= (2 * opt if what == "list" else 5e-8)
        return
    from rusty_compression_tpu_torch.parallel import gather_factors
    from test_torch_parity import one_rank_mesh

    cfg = rank if what == "mesh_rank" else adaptive
    stack = torch.stack([a, a])
    with one_rank_mesh() as mesh:
        got = gather_factors(rt.compress(stack, g.manual_seed(1), cfg,
                                         mesh=mesh), mesh)
    want = gather_factors(rt.compress(stack, g.manual_seed(1), cfg))
    if what == "mesh_adaptive":
        (got, *got_rest), (want, *want_rest) = got, want
        for x, y in zip(got_rest, want_rest):
            np.testing.assert_array_equal(x, y)
    for name in ("u", "s", "vt"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_compress_blocks_checks(port):
    from rusty_compression_tpu_torch.parallel import (
        compress_blocks, compress_blocks_adaptive)
    from rusty_compression_tpu.parallel import compress_blocks as jax_blocks

    torch = port.torch
    blocks = torch.zeros(2, 8, 6)
    with pytest.raises(ValueError, match="unknown method 'nope'"):
        compress_blocks(blocks, torch.Generator(), 2, method="nope")
    with pytest.raises(ValueError, match="unknown method 'nope'"):
        jax_blocks(jnp.zeros((2, 8, 6)), jax.random.key(0), 2, method="nope")
    with pytest.raises(ValueError, match="block stack"):
        compress_blocks(blocks[0], torch.Generator(), 2)
    with pytest.raises(ValueError, match="block stack"):
        compress_blocks_adaptive(blocks[0], torch.Generator(), 1e-3, 2)


@pytest.mark.parametrize("dtype,warns", [("float32", True),
                                         ("complex64", True),
                                         ("float64", False)])
def test_f32_floor_warning_keys_on_the_dtype(port, dtype, warns):
    torch, rt = port.torch, port.rt
    g = torch.Generator().manual_seed(0)
    a = rt.random_approximate_low_rank_matrix(
        g, (48, 40), 1.0, 1e-6, dtype=getattr(torch, dtype))
    cfg = rt.CompressionConfig.ADAPTIVE(1e-8, sample_size=8, max_rank=16)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rt.compress(a, g, cfg)
    hits = [w for w in caught if "accuracy floor" in str(w.message)]
    assert bool(hits) == warns
    if warns:
        assert "float64" in str(hits[0].message)


def test_operator_sparse_and_numpy_targets(port):
    """An operator, a scipy.sparse matrix (wrapped by
    ``as_linear_operator`` or as it is) and a numpy array all go through
    ``compress(RANK)``."""
    import scipy.sparse as sp

    torch, rt = port.torch, port.rt
    a = low_rank(127, SHAPE, 1e-10, np.float64)
    g = torch.Generator().manual_seed(1)
    cfg = rt.CompressionConfig.RANK(12, power_iters=1)
    for target in (rt.DenseOperator(t(a)), a,
                   rt.as_linear_operator(sp.csr_matrix(a), device="cpu"),
                   sp.csr_matrix(a)):
        svd = rt.compress(target, g, cfg)
        assert svd.rank == 12
        assert float(rt.rel_diff_fro(svd.to_mat(), t(a))) < 1e-1
    svd, hist = rt.compress(rt.DenseOperator(t(a)), g,
                            rt.CompressionConfig.ADAPTIVE(1e-5))
    assert float(rt.rel_diff_fro(svd.to_mat(), t(a))) < 5e-5


@pytest.mark.parametrize("method", ["rsvd", "column_id", "two_sided_id",
                                    "sketched_two_sided_id"])
def test_complex_target_takes_the_normal_paths(port, method):
    """No planar detour: a c128 block goes down the same route as a real
    one and comes back in its own dtype."""
    torch, rt = port.torch, port.rt
    a = t(low_rank(128, SHAPE, 1e-10, np.complex128))
    f = rt.compress(a, torch.Generator().manual_seed(2),
                    rt.CompressionConfig.RANK(12, method=method,
                                              power_iters=1))
    assert f.to_mat().dtype == torch.complex128 and f.rank == 12
    assert float(rt.rel_diff_fro(f.to_mat(), a)) < 1e-1


def test_precision_knob_reaches_the_products(port):
    torch, rt = port.torch, port.rt
    seen = []

    class Watching(rt.DenseOperator):
        def matmat(self, x):
            seen.append(torch.get_float32_matmul_precision())
            return super().matmat(x)

    a = t(low_rank(129, SHAPE, 1e-4, np.float32))
    g = torch.Generator().manual_seed(3)
    rt.compress(Watching(a), g, rt.CompressionConfig.RANK(8))
    rt.compress(Watching(a), g, rt.CompressionConfig.RANK(8,
                                                          precision="high"))
    rt.compress(Watching(a), g, rt.CompressionConfig.ADAPTIVE(
        1e-2, precision="high", max_rank=20))
    assert seen[0] == "highest" and set(seen[1:]) == {"high"}


def test_compress_equals_the_direct_calls(port):
    """The front door adds nothing: with generators in the same state the
    result is bitwise that of the pipeline it routes to."""
    from rusty_compression_tpu_torch.parallel import (
        batched_adaptive_rsvd, batched_nystrom, batched_rsvd,
        batched_two_sided_id)

    torch, rt = port.torch, port.rt
    blocks = t(np.stack([low_rank(130 + i, SHAPE, 1e-6, np.float64)
                         for i in range(2)]))

    def gen():
        return torch.Generator().manual_seed(9)

    pairs = [
        (rt.compress(blocks, gen(), rt.CompressionConfig.RANK(
            8, power_iters=1, small_svd="gram")),
         batched_rsvd(blocks, gen(), 8, oversample=5, power_iters=1,
                      ortho="auto", small_svd="gram")),
        (rt.compress(blocks, gen(), rt.CompressionConfig.RANK(
            8, method="nystrom", oversample=6)),
         batched_nystrom(blocks, gen(), 8, oversample=6)),
        (rt.compress(blocks, gen(), rt.CompressionConfig.RANK(
            8, method="two_sided_id")),
         batched_two_sided_id(blocks, gen(), 8)),
        (rt.compress(blocks, gen(), rt.CompressionConfig.ADAPTIVE(
            1e-3, sample_size=8, max_rank=32))[0],
         batched_adaptive_rsvd(blocks, gen(), 1e-3, 8, 32)[0]),
    ]
    for got, want in pairs:
        assert type(got) is type(want)
        for name in vars(want):
            assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_exported_names_against_the_jax_package(port):
    """Every public name of the JAX package is exported by the port, the
    multi-card layer's and ``utils.mfu``'s too; no gap is left."""
    from rusty_compression_tpu import parallel as jpar
    from rusty_compression_tpu.utils import mfu as jmfu

    from rusty_compression_tpu_torch import parallel
    from rusty_compression_tpu_torch.utils import mfu

    still_to_port: set = set()
    assert set(rc.__all__) - set(port.rt.__all__) == still_to_port
    assert set(port.rt.__all__) <= set(rc.__all__)
    for name in port.rt.__all__:
        assert hasattr(port.rt, name), name
    parallel_gaps: set = set()
    assert set(jpar.__all__) - set(parallel.__all__) == parallel_gaps
    assert set(jpar.__all__) == set(parallel.__all__)
    assert set(jmfu.__all__) == set(mfu.__all__)
    for name in mfu.__all__:
        assert hasattr(mfu, name), name


def test_the_peak_table_holds_the_h100_alone(port):
    """``utils.mfu`` keyed on the name the card reports: the H100 SXM's
    data-sheet peaks by matmul precision; any other name (a TPU's, the
    CPU's) gives None, not a figure."""
    from rusty_compression_tpu_torch.utils import mfu

    name = "NVIDIA H100 80GB HBM3"
    assert [mfu.effective_peak_flops(name, p) for p in
            ("highest", "high", "default")] == [67e12, 494.7e12, 989.4e12]
    assert mfu.hbm_peak_bytes(name) == 3.35e12
    assert mfu.mfu_pct(67e12, 2.0, name, "highest") == 50.0
    assert mfu.hbm_util_pct(3.35e12, 1.0, name) == 100.0
    for other in ("TPU v5 lite", "cpu", "NVIDIA H100 PCIe"):
        assert mfu.effective_peak_flops(other, "highest") is None
        assert mfu.mfu_pct(1.0, 1.0, other, "highest") is None
        assert mfu.hbm_util_pct(1.0, 1.0, other) is None
    with pytest.raises(ValueError):
        mfu.effective_peak_flops(name, "medium")


@pytest.mark.parametrize("candidates,within",
                         [(2, False), (0, True), (None, True)])
def test_hilbert_column_id_and_the_pivot_shortlist(port, candidates, within):
    """Config 2 of the benchmark suite on the CPU, f64, tol 1e-8: in blocked
    mode a tournament shortlist of factor 2 takes every pivot from the 128
    columns of largest sketch norm (the leading ones of a Hilbert matrix)
    and misses the gate ``10 x optimal + 100 eps`` by two orders of
    magnitude; the pivot rule at full sketch width meets it. Both packages
    behave alike (the sketch matrices differ, the verdict does not). The
    port's default (``None``) is the full width at this small rank, where
    the JAX package on its accelerator runs the exact rule in its kernel;
    the JAX package's own default off the accelerator is the shortlist."""
    from rusty_compression_tpu.utils.kernel_matrices import hilbert as jhilbert

    from rusty_compression_tpu_torch.utils.kernel_matrices import hilbert

    h = hilbert(1024, device="cpu")
    s = np.linalg.svd(n(h), compute_uv=False)

    def verdict(cid, err):
        e_opt = np.sqrt((s[cid.rank:] ** 2).sum() / (s ** 2).sum())
        return err <= 10 * e_opt + 100 * np.finfo(np.float64).eps

    kwargs = {} if candidates is None else {"pivot_candidates": candidates}
    got = port.rt.QR.compute_from(
        h, max_rank=64, generator=port.torch.Generator().manual_seed(0),
        **kwargs) \
        .compress(port.rt.CompressionType.ADAPTIVE(1e-8)).column_id()

    def jax_side():
        jh = jhilbert(1024, dtype=jnp.float64)
        cid = rc.QR.compute_from(jh, max_rank=64,
                                 pivot_candidates=candidates or 0) \
            .compress(rc.CompressionType.ADAPTIVE(1e-8)).column_id()
        return {"rank": cid.rank, "err": rc.rel_diff_fro(cid.to_mat(), jh)}

    want = refs(f"hilbert {candidates}", 1024, jax_side)
    assert verdict(got, float(port.rt.rel_diff_fro(got.to_mat(), h))) \
        == within
    assert verdict(types.SimpleNamespace(rank=int(want["rank"])),
                   float(want["err"])) == within
    cols = h[:, got.col_ind[:got.rank]]
    assert float((got.c - cols).abs().max()) <= 1e-12  # columns stay exact


def highacc_fixture(seed, shape=(96, 80), decay_rank=40):
    """sigma_i = 10^(-10 i / (decay_rank - 1)): crosses 1e-8 at i = 32."""
    rng = np.random.default_rng(seed)
    k = min(shape)
    u, _ = np.linalg.qr(rng.standard_normal((shape[0], k)))
    v, _ = np.linalg.qr(rng.standard_normal((shape[1], k)))
    return (u * 10.0 ** (-10 * np.arange(k) / (decay_rank - 1))) @ v.T


@pytest.mark.parametrize("target", ["matrix", "numpy", "stack"])
def test_compress_highacc_equals_the_direct_call(port, target):
    """``compress(highacc=True)`` is bitwise the direct ``refined_rsvd``
    (``refined_rsvd_batch`` for a stack) with a generator in the same
    state; ``c.oversample`` is not forwarded, as in the JAX package."""
    torch, rt = port.torch, port.rt
    from rusty_compression_tpu_torch.highacc import refined_rsvd_batch

    if target == "stack":
        a = t(np.stack([highacc_fixture(140 + i) for i in range(2)]))
    else:
        a = highacc_fixture(140)
        a = a if target == "numpy" else t(a)
    cfg = rt.CompressionConfig.ADAPTIVE(1e-8, highacc=True, round_rank=42,
                                        oversample=3)

    def gen():
        return torch.Generator().manual_seed(11)

    got = rt.compress(a, gen(), cfg)
    if target == "stack":
        want = refined_rsvd_batch(list(a), gen(), round_rank=42, tol=1e-8)
        assert isinstance(got, list) and len(got) == 2
    else:
        got, history = got
        assert history == got.history
        want = [rt.refined_rsvd(a, gen(), round_rank=42, tol=1e-8)]
        got = [got]
    for g_, w in zip(got, want):
        assert type(g_).__name__ == "RefinedSVD" and g_.tol_ok
        for name in ("u", "s", "vt"):
            assert torch.equal(getattr(g_, name), getattr(w, name)), name
        assert abs(g_.rank - 32) <= 2
    ref = np.asarray(a)[0] if target == "stack" else np.asarray(a)
    assert got[0].residual_fro(ref) < 5e-8


def test_compress_highacc_refuses_an_operator(port):
    rt = port.rt
    a = t(highacc_fixture(141))
    cfg = rt.CompressionConfig.ADAPTIVE(1e-8, highacc=True, round_rank=42)
    with pytest.raises(ValueError, match="dense matrix entries"):
        rt.compress(rt.DenseOperator(a), port.torch.Generator(), cfg)
