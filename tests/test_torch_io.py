"""The port's checkpoints (``io.py``) and its metrics and profiling helpers.

A checkpoint written by either package loads in the other with equal
arrays (the JAX package's ``save_factors`` / ``load_factors`` on numpy
leaves compile nothing). The port's ``load_block_results`` keeps the last
manifest row of a block, the row that ``pending_blocks`` and a resumed run
rely on; the JAX package's loader returns every row.
"""

import dataclasses
import io as stdio
import json

import numpy as np
import pytest

import rusty_compression_tpu as rc
from rusty_compression_tpu import io as jio
from test_torch_parity import low_rank, n, port, t  # noqa: F401
from torch_threads import one_thread  # noqa: F401 (autouse)

KINDS = ["QR", "LQ", "SVD", "ColumnID", "RowID", "TwoSidedID"]


def containers(port):
    """One port container of each kind, from one 30 x 20 block."""
    rt = port.rt
    a = t(low_rank(230, (30, 20), 1e-6, np.float64))
    qr = rt.QR.compute_from(a, max_rank=8)
    return {"QR": qr, "LQ": rt.LQ.compute_from(a, max_rank=8),
            "SVD": rt.SVD.compute_from(a).compress_svd_rank(8),
            "ColumnID": qr.column_id(), "RowID": rt.LQ.compute_from(
                a, max_rank=8).row_id(),
            "TwoSidedID": qr.column_id().two_sided_id()}


def fields(obj) -> dict:
    return {f.name: n(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip(port, tmp_path, kind):
    f = containers(port)[kind]
    path = str(tmp_path / "f.npz")
    port.rt.io.save_factors(path, f)
    back = port.rt.io.load_factors(path, device="cpu")
    assert type(back) is type(f)
    for name, arr in fields(f).items():
        got = n(getattr(back, name))
        np.testing.assert_array_equal(got, arr)
        assert got.dtype == (np.int64 if arr.dtype.kind == "i" else arr.dtype)


@pytest.mark.parametrize("kind", ["SVD", "TwoSidedID"])
def test_checkpoints_cross_between_the_packages(port, tmp_path, kind):
    f = containers(port)[kind]
    ours = str(tmp_path / "port.npz")
    port.rt.io.save_factors(ours, f)
    jax_f = jio.load_factors(ours)  # the port's file in the JAX package
    assert type(jax_f).__name__ == kind
    for name, arr in fields(f).items():
        np.testing.assert_array_equal(np.asarray(getattr(jax_f, name)), arr)
    theirs = str(tmp_path / "jax.npz")
    leaves = {name: (arr.astype(np.int32) if arr.dtype.kind == "i" else arr)
              for name, arr in fields(f).items()}
    jio.save_factors(theirs, getattr(rc, kind)(**leaves))
    back = port.rt.io.load_factors(theirs, device="cpu")
    assert type(back) is type(f)
    for name, arr in fields(f).items():
        np.testing.assert_array_equal(n(getattr(back, name)), arr)
    with pytest.raises(ValueError, match="container tag"):
        np.savez(str(tmp_path / "bare.npz"), a=np.ones(2))
        port.rt.io.load_factors(str(tmp_path / "bare.npz"), device="cpu")


def results(port, indices, rank):
    from rusty_compression_tpu_torch.parallel import BlockResult

    rt = port.rt
    out = []
    for i in indices:
        a = t(low_rank(240 + i, (20, 16), 1e-6, np.float64))
        svd = rt.SVD.compute_from(a).compress_svd_rank(rank)
        out.append(BlockResult(i, (20, 16), (128, 128), rank, 0.1 * rank,
                               1.0, svd, 0.5))
    return out


def test_manifest_keeps_the_last_row_of_a_block(port, tmp_path):
    """A resumed run appends rows for blocks already there: the port's
    loader keeps each block's last row (the JAX package's keeps both)."""
    rio = port.rt.io
    ckpt = str(tmp_path / "ckpt")
    rio.save_block_results(ckpt, results(port, range(4), 3))
    rio.save_block_results(ckpt, results(port, [2, 1], 5), append=True)
    loaded = rio.load_block_results(ckpt, device="cpu")
    assert [r["block"] for r in loaded] == [0, 1, 2, 3]
    assert [r["rank"] for r in loaded] == [3, 5, 5, 3]
    assert all(r["factors"].rank == r["rank"] for r in loaded)
    assert len(jio.load_block_results(ckpt)) == 6  # the reference's fault
    assert rio.pending_blocks(ckpt, 6) == jio.pending_blocks(ckpt, 6) \
        == [4, 5]


def test_pending_blocks_reads_environment_rows(port, tmp_path):
    """An ``environment:`` error (a contained transient failure of the JAX
    stream) leaves its block pending; any other error does not."""
    rio = port.rt.io
    ckpt = str(tmp_path / "ckpt")
    rows = results(port, range(3), 2)
    rows[0] = dataclasses.replace(rows[0], error="environment: lost device")
    rows[1] = dataclasses.replace(rows[1], error="tolerance unreachable")
    jio.save_block_results(ckpt, [
        dataclasses.replace(r, factors=rc.SVD(*[n(x) for x in (
            r.factors.u, r.factors.s, r.factors.vt)])) for r in rows])
    assert rio.pending_blocks(ckpt, 4) == jio.pending_blocks(ckpt, 4) \
        == [0, 3]
    assert rio.pending_blocks(str(tmp_path / "none"), 2) == [0, 1]
    loaded = rio.load_block_results(ckpt, device="cpu")
    assert loaded[1]["error"] == "tolerance unreachable"
    assert type(loaded[2]["factors"]).__name__ == "SVD"


def test_metrics_logger(port):
    buf = stdio.StringIO()
    log = port.rt.MetricsLogger(buf)
    log.write({"block": 1, "rank": 4})
    log.write({"block": 2})
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert [x["block"] for x in lines] == [1, 2]
    assert lines[0]["process"] == 0 and lines[0]["rank"] == 4
    assert lines[0]["n_devices"] == port.torch.cuda.device_count()
    assert set(lines[1]) == {"ts", "process", "n_devices", "block"}


def test_sync_timeit_slope_and_trace(port, tmp_path):
    torch, rt = port.torch, port.rt
    svd = containers(port)["SVD"]
    rt.sync([svd, {"x": torch.ones(3)}, (torch.zeros(2),)])  # CPU: no wait
    rt.sync(None)
    a = torch.randn(64, 64, dtype=torch.float64)
    per = rt.timeit_slope(lambda x: x @ x, a, n1=1, n2=3, trials=2)
    assert 0 < per < 1.0
    with rt.trace(str(tmp_path / "trace")):
        a @ a
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "traceEvents" in text
