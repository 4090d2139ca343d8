"""Drive the PyTorch port's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each ends with ``torch.cuda.synchronize()``; any failed check
raises, and the script exits non-zero without its result line):

0. Card: name and power limit from ``nvidia-smi``; TF32 turned off.
1. Build: compiles the K1 kernel (``csrc/qrcp.cu``) from this checkout.
2. K1 against its plain version on the card at the main path's panel
   shapes: pivots exactly equal, q and r within 1e-4; median times of 10
   launches each (CUDA events). Then the whole ID path and the rSVD at a
   small size on the card against the same path on the CPU.
3. rSVD (config 3): ``batched_rsvd`` of one 8192^2 f32 block
   G1 diag(geomspace(1, 1e-6, 400)) G2, rank 100, oversample 5, two power
   iterations, Gram small SVD; rel err <= 3 sigma_101 / sigma_1.
4. One-read two-sided ID (config 4b1): ``batched_sketched_two_sided_id``
   of one 16384^2 f32 Laplace block between two unit clouds 3 apart,
   rank 16, oversample 8; rel err <= 5e-3, the column gather bitwise,
   the skeleton within 1e-3, two K1 launches per call.
5. Batch: the same on eight 2048^2 Laplace blocks (one K1 launch covers
   the batch).

The launch counts are zeroed just before phase 3 and read after phase 5.
The line before the last is a JSON object with the kernel's launches,
error and times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Throughput is block bytes (B m n 4) over the wall time of one call.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

KERNEL_SOURCE = "rusty_compression_tpu_torch/csrc/qrcp.cu"
KERNEL_REPLACES = "rusty_compression_tpu/ops/pallas/qrcp.py:41"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def wall_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn`` (after one warm-up call), each call
    ending in ``torch.cuda.synchronize()``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def event_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card(torch) -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("0-card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return card


def phase_build(k1) -> None:
    t0 = time.perf_counter()
    path, report = k1.build()
    seconds = time.perf_counter() - t0
    k1._library()
    say("1-build", seconds=seconds, library=path.name,
        ptxas=[line.strip() for line in report.splitlines()
               if "registers" in line or "spill" in line])


def distinct_norm_panel(torch, gen, shape):
    """Gaussian columns scaled by geomspace(1, 0.1): distinct norms."""
    n = shape[-1]
    scale = torch.logspace(0.0, -1.0, n, device="cuda")
    return torch.randn(shape, generator=gen, device="cuda") * scale


def phase_kernel(torch, k1, gen) -> dict:
    cases = [((24, 16384), 16, False), ((16, 16384), 16, False),
             ((24, 2048), 16, False), ((37, 301), 29, True),
             ((8, 24, 2048), 16, False)]
    worst, main = 0.0, None
    for shape, k, masked in cases:
        a = distinct_norm_panel(torch, gen, shape)
        used = None
        if masked:
            used = torch.zeros(shape[-1], dtype=torch.bool, device="cuda")
            used[::7] = True
        q, r, piv = k1.qrcp_panel(a, k, used=used)
        q0, r0, piv0 = k1.qrcp_panel_plain(a, k, used)
        torch.cuda.synchronize()
        check(torch.equal(piv.long(), piv0), f"K1 pivots at {shape} k={k}")
        err = max(float((q - q0).abs().max()), float((r - r0).abs().max()))
        check(err <= 1e-4, f"K1 |q|, |r| error {err} at {shape} k={k}")
        ms = event_ms(lambda: k1.qrcp_panel(a, k, used=used))
        plain_ms = event_ms(lambda: k1.qrcp_panel_plain(a, k, used))
        worst = max(worst, err)
        say("2-kernel", shape=list(shape), k=k, used_mask=masked,
            pivots_equal=True, max_abs_err=err, ms=ms, plain_ms=plain_ms)
        if main is None:  # the sketch of the 16384^2 block
            main = {"ms": ms, "plain_ms": plain_ms}
    torch.cuda.synchronize()
    return {"max_abs_err": worst, **main}


def phase_reference(torch, rt) -> None:
    """The ID path and the rSVD at a small size: card (K1) against CPU
    (plain version), on the same blocks and Gaussian matrices."""
    from rusty_compression_tpu_torch.parallel.batch import (
        _rsvd_block_from_omega)
    from rusty_compression_tpu_torch.sampling import (
        _sketched_column_id_from_sketch)

    g = torch.Generator().manual_seed(1)
    u = torch.linalg.qr(torch.randn((3, 120, 90), generator=g))[0]
    v = torch.linalg.qr(torch.randn((3, 90, 90), generator=g))[0]
    blocks = (u * torch.logspace(0, -4, 90)) @ v.mT
    g_h = torch.randn((3, 120, 32), generator=g)
    omega = torch.randn((3, 90, 32), generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        op = rt.DenseOperator(blocks.to(dev))
        ts = _sketched_column_id_from_sketch(op, g_h.to(dev),
                                             24).two_sided_id()
        svd = _rsvd_block_from_omega(blocks.to(dev), omega.to(dev), 24,
                                     power_iters=1)
        out[dev] = (ts, svd)
    torch.cuda.synchronize()
    (ts_c, svd_c), (ts_g, svd_g) = out["cpu"], out["cuda"]
    check(torch.equal(ts_c.col_ind, ts_g.col_ind.cpu())
          and torch.equal(ts_c.row_ind, ts_g.row_ind.cpu()),
          "ID pivots on the card equal the CPU's")
    id_err = max(float((getattr(ts_c, f) - getattr(ts_g, f).cpu()).abs().max()
                       / getattr(ts_c, f).abs().max()) for f in "cxr")
    check(id_err <= 1e-4, f"ID factors card vs CPU {id_err}")
    s_err = float((svd_c.s - svd_g.s.cpu()).abs().max() / svd_c.s.max())
    check(s_err <= 1e-5, f"rSVD singular values card vs CPU {s_err}")
    say("2-reference", blocks=[3, 120, 90], rank=24, pivots_equal=True,
        id_factor_rel_err=id_err, rsvd_s_rel_err=s_err)


def phase_rsvd(torch, rt, gen) -> None:
    from rusty_compression_tpu_torch.parallel import (batched_rel_diff_fro,
                                                      batched_rsvd)

    m = n = 8192
    rank, r = 100, 400
    g1 = rt.random_gaussian(gen, (m, r), dtype=torch.float32)
    g2 = rt.random_gaussian(gen, (r, n), dtype=torch.float32)
    sigma = torch.logspace(0.0, -6.0, r, device="cuda")
    blocks = ((g1 * sigma) @ g2)[None]
    run = lambda: batched_rsvd(blocks, gen, rank, oversample=5,  # noqa: E731
                               power_iters=2, small_svd="gram")
    svd = run()
    err = float(batched_rel_diff_fro(svd, blocks)[0])
    gate = 3.0 * float(sigma[rank] / sigma[0])
    check(math.isfinite(err) and err <= gate,
          f"rSVD rel err {err} > {gate}")
    check(tuple(svd.u.shape) == (1, m, rank), "rSVD shapes")
    ms = wall_ms(run, reps=10)
    torch.cuda.synchronize()
    say("3-rsvd-8192", rel_err=err, gate=gate,
        sigma_101_over_sigma_1=float(sigma[rank] / sigma[0]), ms=ms,
        gbps=m * n * 4 / (ms * 1e-3) / 1e9)


def laplace_blocks(torch, gen, count: int, size: int):
    from rusty_compression_tpu_torch.utils.kernel_matrices import (
        laplace_kernel_block, random_cloud)

    x = torch.stack([random_cloud(gen, size, (0.0, 0.0, 0.0),
                                  dtype=torch.float32)
                     for _ in range(count)])
    y = torch.stack([random_cloud(gen, size, (3.0, 0.0, 0.0),
                                  dtype=torch.float32)
                     for _ in range(count)])
    return laplace_kernel_block(x, y)


def phase_two_sided(torch, rt, k1, gen, name: str, count: int,
                    size: int) -> None:
    from rusty_compression_tpu_torch.parallel import (
        batched_rel_diff_fro, batched_sketched_two_sided_id)

    rank = 16
    blocks = laplace_blocks(torch, gen, count, size)
    before = k1.qrcp_panel.launch_count
    ts = batched_sketched_two_sided_id(blocks, gen, rank, oversample=8)
    torch.cuda.synchronize()
    launches = k1.qrcp_panel.launch_count - before
    check(launches == 2, f"{launches} K1 launches in one batched call, not 2")
    errs = batched_rel_diff_fro(ts, blocks)
    err = float(errs.max())
    check(bool(torch.isfinite(errs).all()) and err <= 5e-3,
          f"two-sided ID rel err {err} > 5e-3")
    cols = torch.take_along_dim(blocks, ts.col_ind[:, None, :rank], dim=-1)
    skel = torch.take_along_dim(cols, ts.row_ind[:, :rank, None], dim=-2)
    skel_err = float((ts.x - skel).abs().max() / skel.abs().max())
    check(skel_err <= 1e-3, f"skeleton rel err {skel_err} > 1e-3")
    cid = rt.sketched_column_id(blocks, gen, rank=rank, oversample=8)
    check(torch.equal(cid.c, torch.take_along_dim(
        blocks, cid.col_ind[:, None, :rank], dim=-1)),
        "column gather C is not bitwise A[:, col_ind[:k]]")
    ms = wall_ms(lambda: batched_sketched_two_sided_id(
        blocks, gen, rank, oversample=8), reps=10)
    torch.cuda.synchronize()
    say(name, blocks=[count, size, size], rank=rank, rel_err=err,
        skeleton_rel_err=skel_err, column_gather_bitwise=True,
        k1_launches_per_call=launches, ms=ms,
        blocks_per_s=count / (ms * 1e-3),
        gbps=count * size * size * 4 / (ms * 1e-3) / 1e9)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    import rusty_compression_tpu_torch as rt
    from rusty_compression_tpu_torch.ops.kernels import qrcp as k1

    card = phase_card(torch)
    phase_build(k1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernel = phase_kernel(torch, k1, gen)
    phase_reference(torch, rt)

    k1.qrcp_panel.launch_count = 0   # the main path starts here
    phase_rsvd(torch, rt, gen)
    phase_two_sided(torch, rt, k1, gen, "4-two-sided-id-16384", 1, 16384)
    phase_two_sided(torch, rt, k1, gen, "5-two-sided-id-batch-2048", 8, 2048)
    launches = k1.qrcp_panel.launch_count
    check(launches > 0, "the main path launched no K1 kernel")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "qrcp_panel", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
