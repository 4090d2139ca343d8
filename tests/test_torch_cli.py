"""The port's command-line runner (``cli.py``), on the CPU.

``main(argv)`` with ``--device cpu`` on a directory of ``.npy`` blocks and
on an ``.npz`` bundle: the arguments and the printed summary are the JAX
package's; each run writes the checkpoint that ``io`` reads back.
"""

import contextlib
import io as stdio
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rusty_compression_tpu import cli as jcli
from test_torch_highacc import decaying
from test_torch_parity import port  # noqa: F401
from torch_threads import one_thread  # noqa: F401 (autouse)

SHAPES = [(40, 70), (90, 30), (64, 64), (100, 80)]


@pytest.fixture
def blocks(tmp_path):
    """A directory of ``.npy`` blocks (f64, spectra crossing 1e-8) and an
    ``.npz`` bundle of the same blocks."""
    arrays = [decaying(250 + i, m, n_, decay_rank=30)
              for i, (m, n_) in enumerate(SHAPES)]
    src = tmp_path / "blocks"
    src.mkdir()
    for i, a in enumerate(arrays):
        np.save(src / f"b{i:02d}.npy", a)
    np.savez(tmp_path / "bundle.npz",
             **{f"b{i:02d}": a for i, a in enumerate(arrays)})
    return tmp_path, arrays


def run(port, *argv):
    from rusty_compression_tpu_torch import cli

    out = stdio.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([*map(str, argv), "--device", "cpu"])
    return rc, out.getvalue()


def manifest(ckpt):
    return [json.loads(line) for line in (ckpt / "manifest.jsonl")
            .read_text().splitlines()]


@pytest.mark.parametrize("mode", [
    ["--rank", "6"], ["--rank", "6", "--method", "column_id"],
    ["--tol", "1e-3", "--sample-size", "8"],
    ["--tol", "1e-8", "--highacc", "--round-rank", "32"]])
def test_main_writes_a_checkpoint(port, blocks, mode):
    tmp, arrays = blocks
    ckpt = tmp / "ckpt"
    rc, out = run(port, tmp / "blocks", "-o", ckpt, *mode)
    assert rc == 0
    lines = out.splitlines()
    assert lines[0] == f"compressed {len(SHAPES)} blocks -> {ckpt}"
    assert lines[1].startswith("ranks: min ")
    assert "rel residual: max" in lines[1]
    rows = manifest(ckpt)
    assert sorted(r["block"] for r in rows) == list(range(len(SHAPES)))
    loaded = port.rt.io.load_block_results(str(ckpt), device="cpu")
    gate = {"--rank": 1.0, "--tol": 5e-3}[mode[0]] if "--highacc" not in mode \
        else 5e-8
    for rec, a in zip(loaded, arrays):
        f = rec["factors"]
        assert (rec["m"], rec["n"]) == a.shape and rec["error"] is None
        err = float(port.rt.rel_diff_fro(f.to_mat(),
                                         port.torch.from_numpy(a)))
        assert err == pytest.approx(rec["rel_residual"], rel=1e-6)
        assert err <= gate
    expected = {"--rank": "ColumnID" if "column_id" in mode else "SVD",
                "--tol": "SVD"}[mode[0]]
    assert {r["container"] for r in rows} == {expected}


def test_resume_runs_only_the_missing_blocks(port, blocks):
    tmp, _ = blocks
    ckpt = tmp / "ckpt"
    args = [tmp / "blocks", "-o", ckpt, "--tol", "1e-8", "--highacc"]
    run(port, *args)
    rows = manifest(ckpt)
    (ckpt / "manifest.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows[:-2]))
    dropped = sorted(r["block"] for r in rows[-2:])
    rc, out = run(port, *args, "--resume")
    assert rc == 0 and out.splitlines()[0] == \
        f"resuming: 2/{len(SHAPES)} blocks pending"
    after = manifest(ckpt)
    assert len(after) == len(SHAPES)
    assert sorted(r["block"] for r in after[-2:]) == dropped
    rc, out = run(port, *args, "--resume")
    assert out.strip() == f"all {len(SHAPES)} blocks already done in {ckpt}"


def test_metrics_and_the_npz_bundle(port, blocks):
    tmp, _ = blocks
    metrics = tmp / "metrics.jsonl"
    rc, _ = run(port, tmp / "bundle.npz", "-o", tmp / "ckpt", "--rank", "5",
                "--metrics", metrics)
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert rc == 0 and [r["block"] for r in rows] == list(range(len(SHAPES)))
    assert {"process", "n_devices", "ts", "rank", "rel_residual",
            "bucket_m", "wall_time_s", "device_time_s"} <= set(rows[0])
    assert all(r["rank"] == 5 for r in rows)


def test_blocks_are_memory_maps(port, blocks):
    from rusty_compression_tpu_torch import cli

    tmp, arrays = blocks
    loaded = cli._load_blocks(str(tmp / "blocks"))
    assert all(isinstance(b, np.memmap) for b in loaded)
    for got, want in zip(loaded, arrays):
        np.testing.assert_array_equal(got, want)
    assert len(cli._load_blocks(str(tmp / "bundle.npz"))) == len(SHAPES)
    with pytest.raises(SystemExit):
        cli._load_blocks(str(tmp / "nothing.txt"))


def test_arguments_match_the_jax_cli(port):
    from rusty_compression_tpu_torch import cli

    ours = {a.dest: a.default for a in cli.build_parser()._actions}
    theirs = {a.dest: a.default for a in jcli.build_parser()._actions}
    assert ours.pop("device") == "cuda"
    assert ours == theirs


def test_mesh_and_highacc_without_tol_are_refused(port, blocks):
    """``--mesh`` is no longer refused: with no launcher it runs on a group
    of one rank (made and destroyed by ``main``) and writes the checkpoint
    of the run without it. ``--highacc`` without ``--tol`` is refused."""
    import torch.distributed as dist

    tmp, _ = blocks
    for ckpt, extra in (("c", ["--mesh"]), ("plain", [])):
        rc, printed = run(port, tmp / "blocks", "-o", tmp / ckpt, "--rank",
                          "4", *extra)
        assert rc == 0
        assert ("mesh: 1 ranks over 'blocks'" in printed) == bool(extra)
    assert not dist.is_initialized()
    drop = ("wall_time_s", "device_time_s")
    assert [{k: v for k, v in r.items() if k not in drop}
            for r in manifest(tmp / "c")] == [
        {k: v for k, v in r.items() if k not in drop}
        for r in manifest(tmp / "plain")]
    with pytest.raises(SystemExit):
        run(port, tmp / "blocks", "-o", tmp / "c", "--rank", "4",
            "--highacc")


def test_help_needs_no_jax(tmp_path):
    """``python -m rusty_compression_tpu_torch --help`` with JAX made
    unimportable."""
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.argv = ['rusty_compression_tpu_torch', '--help']; "
            "runpy.run_module('rusty_compression_tpu_torch', "
            "run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    assert "--highacc" in proc.stdout and "--device" in proc.stdout
