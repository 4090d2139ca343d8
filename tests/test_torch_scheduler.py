"""The port's block stream (``parallel/scheduler.py``) held against the JAX
package's.

The planning is pure Python on both sides and is compared live. The streams
are compared by their contracts on the same numpy blocks: results in
submission order, buckets the next power of two, factors of the un-padded
frame; rank mode bitwise equal to ``compress_blocks`` of each chunk's
zero-padded stack with that chunk's generator; tolerance mode with ranks
within one sample block of the JAX stream's; the refined (tol 1e-8) stream
with ranks within 2 of the JAX stream's and every block at 5 tol. The JAX
streams' ranks and residuals come from
``tests/torch_refs/test_torch_scheduler.npz`` (``make_refs.py``).
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest

from rusty_compression_tpu.parallel import scheduler as jsc
from test_torch_highacc import decaying
from test_torch_parity import low_rank, n, port, t  # noqa: F401
from torch_refs import Refs
from torch_threads import one_thread  # noqa: F401 (autouse)

refs = Refs(__file__)
METHODS = ["rsvd", "nystrom", "column_id", "row_id", "two_sided_id",
           "sketched_two_sided_id"]
SHAPES = [(30, 150), (140, 60), (100, 100), (45, 37), (150, 130), (60, 140)]
REFINED_SHAPES = [(40, 130), (120, 90), (64, 64), (130, 100), (90, 50)]


def stream_blocks(dtype=np.float64):
    return [low_rank(200 + i, s, 1e-7, dtype) for i, s in enumerate(SHAPES)]


def refined_blocks():
    return [decaying(210 + i, m, n_, decay_rank=30 + 5 * i)
            for i, (m, n_) in enumerate(REFINED_SHAPES)]


def gen(port, seed=0):
    return port.torch.Generator().manual_seed(seed)


def sc(port):
    from rusty_compression_tpu_torch.parallel import scheduler

    return scheduler


def fallbacks(caplog) -> dict:
    """The fallback counts that the one refined stream logged."""
    [record] = [r for r in caplog.records if hasattr(r, "fallbacks")]
    return record.fallbacks


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,floor", [(0, 128), (1, 64), (2, 32)])
def test_bucket_dim_and_plan_match_jax(port, seed, floor):
    rng = np.random.default_rng(seed)
    shapes = [tuple(int(d) for d in s)
              for s in rng.integers(1, 3000, (200, 2))]
    s = sc(port)
    for m, n_ in shapes:
        assert s.bucket_dim(m, floor) == jsc.bucket_dim(m, floor)
        assert s.bucket_dim(n_, floor) == jsc.bucket_dim(n_, floor)
    assert s.plan_buckets(shapes, floor) == jsc.plan_buckets(shapes, floor)
    assert s._batch_bucket(13, 4) == jsc._batch_bucket(13, 4) == 16


@pytest.mark.parametrize("native", [True, False])
def test_chunk_batch_is_the_budget_alone(port, monkeypatch, native):
    """The largest multiple of the granule under the budget, clamped to
    [granule, padded count]; no lane cap (a 256^2 f32 chunk of 300 blocks
    under 1 GiB is one chunk, where the JAX package caps it at 32)."""
    from rusty_compression_tpu_torch import native as nat

    s = sc(port)
    if not native:
        monkeypatch.setattr(nat, "chunk_batch", lambda *a: None)
    for count in (1, 5, 300):
        for granule in (1, 4):
            for bm, bn, elem in ((256, 256, 4), (1024, 512, 8)):
                for budget in (0, 1 << 20, 1 << 30):
                    padded = -(-count // granule) * granule
                    fit = max(budget // (bm * bn * elem * granule), 1) \
                        * granule
                    want = padded if budget <= 0 else min(padded, fit)
                    assert s._chunk_batch(count, granule, bm, bn, elem,
                                          budget) == want
    assert s._chunk_batch(300, 1, 256, 256, 4, 1 << 30) == 300


# ---------------------------------------------------------------------------
# The stream by rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
def test_rank_stream_is_compress_blocks_of_each_chunk(port, method):
    """Order, buckets, un-padded shapes; each block's factors bitwise those
    of ``compress_blocks`` of its chunk's zero-padded stack, drawn from
    that chunk's generator."""
    from rusty_compression_tpu_torch.parallel import compress_blocks

    torch, s = port.torch, sc(port)
    blocks = stream_blocks()
    budget = 128 * 256 * 8  # one (128, 256) block a chunk
    seen = []
    res = s.compress_heterogeneous(blocks, gen(port), rank=10, method=method,
                                   chunk_bytes=budget, on_result=seen.append)
    assert [r.index for r in res] == list(range(len(SHAPES)))
    assert [r.shape for r in res] == SHAPES
    assert [r.bucket for r in res] == [
        (jsc.bucket_dim(m), jsc.bucket_dim(n_)) for m, n_ in SHAPES]
    shapes = [b.shape for b in blocks]
    chunks = s._chunks(blocks, shapes, s.plan_buckets(shapes), 1, budget,
                       False)
    assert len(chunks) > len(s.plan_buckets(shapes))  # a bucket split
    seeds = s._seeds(gen(port), len(chunks))
    order = [i for _, _, idxs, _ in chunks for i in idxs]
    assert [r.index for r in seen] == order
    for (bm, bn, idxs, dtype), seed in zip(chunks, seeds):
        stack = torch.zeros((len(idxs), bm, bn), dtype=dtype)
        for slot, i in enumerate(idxs):
            stack[slot, :shapes[i][0], :shapes[i][1]] = t(blocks[i])
        want = compress_blocks(stack, torch.Generator().manual_seed(seed),
                               10, method=method)
        for slot, i in enumerate(idxs):
            got = res[i].factors
            ref = s._unpad_factors(want, slot, *shapes[i], method)
            assert type(got) is type(ref)
            for f in dataclasses.fields(ref):
                assert torch.equal(getattr(got, f.name),
                                   getattr(ref, f.name)), (i, f.name)
            assert got.to_mat().shape == shapes[i]
            err = float(port.rt.rel_diff_fro(got.to_mat(), t(blocks[i])))
            assert res[i].rel_residual == pytest.approx(err, rel=1e-9)
            assert res[i].rank == 10 and res[i].ok


def test_tolerance_stream_ranks_match_jax(port):
    """rel_tol mode: ranks within one sample block of the JAX stream's on
    the same blocks, both at most 5 tol."""
    blocks = stream_blocks()

    def jax_side():
        out = jsc.compress_heterogeneous(blocks, jax.random.key(4),
                                         rel_tol=1e-3, sample_size=8)
        return {"ranks": [r.rank for r in out],
                "errs": [r.rel_residual for r in out]}

    want = refs("tolerance stream", blocks, jax_side)
    res = sc(port).compress_heterogeneous(blocks, gen(port), rel_tol=1e-3,
                                          sample_size=8)
    assert np.all(want["errs"] <= 5e-3)
    for r, k in zip(res, want["ranks"]):
        assert abs(r.rank - int(k)) <= 8 and r.rank % 8 == 0
        assert r.rel_residual <= 5e-3
        assert r.factors.rank == r.rank
        assert r.factors.to_mat().shape == r.shape


# ---------------------------------------------------------------------------
# The refined stream (tol 1e-8)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("round_rank", [32, None])
def test_refined_stream_matches_jax(port, round_rank, caplog):
    """Fixed rounds and growth: ranks within 2 of the JAX stream's (stored),
    every block at 5 tol with no error, f64 host factors of the un-padded
    frame."""
    torch = port.torch
    blocks = refined_blocks()

    def jax_side():
        out = jsc.compress_heterogeneous_refined(
            blocks, jax.random.key(7), rel_tol=1e-8, round_rank=round_rank)
        return {"ranks": [r.rank for r in out],
                "errs": [r.rel_residual for r in out],
                "ok": [r.ok for r in out]}

    want = refs(f"refined {round_rank}", blocks, jax_side)
    caplog.set_level(logging.INFO, "rusty_compression_tpu_torch.scheduler")
    res = sc(port).compress_heterogeneous_refined(
        blocks, gen(port), rel_tol=1e-8, round_rank=round_rank)
    assert all(bool(ok) for ok in want["ok"])
    assert np.all(want["errs"] <= 1.5e-7)  # the JAX gate: max(5 tol, 1.5 opt)
    for r, b, k in zip(res, blocks, want["ranks"]):
        assert r.ok and abs(r.rank - int(k)) <= 2
        assert r.rel_residual <= 5e-8
        f = r.factors
        assert f.u.dtype == torch.float64 and f.u.device.type == "cpu"
        assert f.u.shape == (b.shape[0], r.rank)
        assert f.vt.shape == (r.rank, b.shape[1])
        rec = n(f.u) @ (n(f.s)[:, None] * n(f.vt))
        err = np.linalg.norm(rec - b) / np.linalg.norm(b)
        assert err == pytest.approx(r.rel_residual, rel=1e-6)
    assert fallbacks(caplog)["blocks"] == 0


def test_unreachable_tolerance_is_contained(port, caplog):
    """A wide Gaussian block in the stream (a tall one is captured whole by
    the direct route): recorded with ``error`` set and the full-rank
    capture of its un-padded frame; the other blocks pass."""
    blocks = refined_blocks()[:3]
    blocks[1] = np.random.default_rng(9).standard_normal((50, 70))
    caplog.set_level(logging.INFO, "rusty_compression_tpu_torch.scheduler")
    res = sc(port).compress_heterogeneous_refined(blocks, gen(port),
                                                  rel_tol=1e-8, round_rank=16)
    assert [r.ok for r in res] == [True, False, True]
    assert "unreachable" in res[1].error
    f = res[1].factors
    assert f.u.shape[0] == 50 and f.vt.shape[1] == 70
    assert res[1].rank == 50  # two rounds of 26 columns fill the 50
    assert res[1].record()["error"] == res[1].error
    fb = fallbacks(caplog)
    assert fb["growth"] == fb["blocks"] == 1


@pytest.mark.parametrize("stream", ["rank", "refined"])
def test_window_does_not_change_the_results(port, stream):
    torch, s = port.torch, sc(port)
    if stream == "rank":
        blocks = stream_blocks(np.float32)
        run = lambda w: s.compress_heterogeneous(  # noqa: E731
            blocks, gen(port), rank=8, method="sketched_two_sided_id",
            window=w, chunk_bytes=2 * 256 * 256 * 4)
    else:
        blocks = refined_blocks()
        run = lambda w: s.compress_heterogeneous_refined(  # noqa: E731
            blocks, gen(port), round_rank=24, window=w,
            chunk_bytes=2 * 256 * 256 * 8)
    one, three = run(1), run(3)
    for a, b in zip(one, three):
        assert a.rank == b.rank and a.rel_residual == b.rel_residual
        for f in dataclasses.fields(a.factors):
            assert torch.equal(getattr(a.factors, f.name),
                               getattr(b.factors, f.name))


def test_on_result_once_per_block_in_collection_order(port):
    s = sc(port)
    blocks = stream_blocks()
    seen = []
    res = s.compress_heterogeneous(blocks, gen(port), rank=6,
                                   on_result=seen.append, window=2)
    assert sorted(r.index for r in seen) == list(range(len(blocks)))
    assert [r.index for r in seen] == sorted(
        range(len(blocks)), key=lambda i: (res[i].bucket, i))
    assert all(a is res[a.index] for a in seen)


# ---------------------------------------------------------------------------
# The front door, inputs, checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["column_id", "sketched_two_sided_id"])
def test_complex_list_takes_the_stream(port, method):
    """A c64 list through ``compress`` with an ID method: the normal stream
    (K2 on the card), bitwise the direct stream call."""
    torch, rt = port.torch, port.rt
    blocks = [low_rank(220 + i, s, 1e-6, np.complex64)
              for i, s in enumerate([(50, 70), (90, 40), (64, 64)])]
    cfg = rt.CompressionConfig.RANK(8, method=method)
    got = rt.compress(blocks, gen(port, 5), cfg)
    want = sc(port).compress_heterogeneous(
        blocks, gen(port, 5), rank=8, method=method, mode=cfg.qr_mode,
        block_size=cfg.block_size)
    for g_, w, b in zip(got, want, blocks):
        assert g_.factors.c.dtype == torch.complex64
        for f in dataclasses.fields(w.factors):
            assert torch.equal(getattr(g_.factors, f.name),
                               getattr(w.factors, f.name))
        s = np.linalg.svd(b, compute_uv=False)
        assert g_.rel_residual <= 20 * s[8] / np.linalg.norm(s)


def test_inputs_may_be_memmaps_and_tensors(port, tmp_path):
    """Read-only memory maps and CPU tensors give the numpy arrays'
    results bitwise."""
    torch, s = port.torch, sc(port)
    blocks = stream_blocks()[:4]
    maps = []
    for i, b in enumerate(blocks):
        np.save(tmp_path / f"{i}.npy", b)
        maps.append(np.load(tmp_path / f"{i}.npy", mmap_mode="r"))
    runs = [s.compress_heterogeneous(x, gen(port), rank=6)
            for x in (blocks, maps, [t(b) for b in blocks])]
    for a, b, c in zip(*runs):
        assert torch.equal(a.factors.u, b.factors.u)
        assert torch.equal(a.factors.u, c.factors.u)


@pytest.mark.parametrize("call,match", [
    (lambda s, b, g: s.compress_heterogeneous(b, g), "exactly one"),
    (lambda s, b, g: s.compress_heterogeneous(b, g, rank=4, rel_tol=0.1),
     "exactly one"),
    (lambda s, b, g: s.compress_heterogeneous(b, g, rank=38), "exceeds"),
    (lambda s, b, g: s.compress_heterogeneous([b[0][0]], g, rank=2),
     "matrices"),
])
def test_stream_argument_checks(port, call, match):
    blocks = stream_blocks()
    s = sc(port)
    with pytest.raises(ValueError, match=match):
        call(s, blocks, gen(port))
    with pytest.raises(ValueError, match=match):  # the JAX package agrees
        call(jsc, blocks, jax.random.key(0))


def test_mesh_is_refused_by_name(port):
    """A mesh, once refused by name, shards both streams: on a group of one
    rank the results are the unsharded stream's, bitwise."""
    from test_torch_parity import one_rank_mesh

    s = sc(port)
    runs = (lambda **kw: s.compress_heterogeneous(
        stream_blocks(), gen(port), rank=4, **kw),
        lambda **kw: s.compress_heterogeneous_refined(
            refined_blocks(), gen(port), **kw))
    for call in runs:
        with one_rank_mesh() as mesh:
            got = call(mesh=mesh)
        want = call()
        assert [(r.index, r.rank, r.rel_residual) for r in got] == [
            (r.index, r.rank, r.rel_residual) for r in want]
        assert all(port.torch.equal(x.factors.u, y.factors.u)
                   for x, y in zip(got, want))


def test_block_result_matches_the_jax_record(port):
    s = sc(port)
    assert [f.name for f in dataclasses.fields(s.BlockResult)] == [
        f.name for f in dataclasses.fields(jsc.BlockResult)]
    kw = dict(index=3, shape=(5, 4), bucket=(128, 128), rank=2,
              rel_residual=0.5, wall_time_s=1.0, factors=None,
              device_time_s=0.5)
    ours, theirs = s.BlockResult(**kw), jsc.BlockResult(**kw)
    assert ours.record() == theirs.record() and ours.ok
    assert not s.BlockResult(**kw, error="x").ok
    assert s.OPT_SLACK == jsc.OPT_SLACK


def test_chunks_stay_under_the_budget(port):
    s = sc(port)
    blocks = stream_blocks()
    shapes = [b.shape for b in blocks]
    budget = 3 * 256 * 256 * 8
    chunks = s._chunks(blocks, shapes, s.plan_buckets(shapes), 1, budget,
                       False)
    for bm, bn, idxs, dtype in chunks:
        assert len(idxs) * bm * bn * dtype.itemsize <= budget
    assert sorted(i for c in chunks for i in c[2]) == list(range(6))
