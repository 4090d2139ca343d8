"""Drive the PyTorch port's main paths once on one NVIDIA card and check them.

    python3 chip_smoke.py [--profile]

Phases (each ends with ``torch.cuda.synchronize()``; any failed check
raises, and the script exits non-zero without its result line):

0. Card: name and power limit from ``nvidia-smi``; TF32 turned off.
1. Build: compiles K1 (``csrc/qrcp.cu``, f32) and K2 (``csrc/qrcp_c64.cu``,
   c64) from this checkout, one ``nvcc`` each, started together; prints
   both ``ptxas`` reports.
2. K1 and K2 against their plain version on the card at the main paths'
   panel shapes and at ragged and masked ones (a width that is no
   multiple of the cluster's warps, fewer columns than 32 a CTA, a mask
   over one CTA's whole slice): pivots exactly equal, q and r within
   1e-4, two launches on one panel bitwise equal; the layout the wrapper
   chose (cluster size, residual in shared memory or not, bytes of
   shared memory); median times of 10 launches each (CUDA events around
   the wrapper's call: ``ms``, ``plain_ms``) and the kernel alone, queued
   behind a busy card (``device_ms``), beside the roofline bound of the
   shape. Then, at a small size, the one-read ID, the rSVD, the blocked
   RRQR (f32 and c64) and the complex two-sided ID on the card against
   the same call on the CPU with the same Gaussian matrices.
3. rSVD (config 3): ``batched_rsvd`` of one 8192^2 f32 block
   G1 diag(geomspace(1, 1e-6, 400)) G2, rank 100, oversample 5, two power
   iterations, Gram small SVD; rel err <= 3 sigma_101 / sigma_1.
4. One-read two-sided ID (config 4b1): ``batched_sketched_two_sided_id``
   of one 16384^2 f32 Laplace block between two unit clouds 3 apart,
   rank 16, oversample 8; rel err <= 5e-3, the column gather bitwise,
   the skeleton within 1e-3, two K1 launches per call.
5. Batch: the same on eight 2048^2 Laplace blocks (one K1 launch covers
   the batch).
6. Blocked RRQR (the kernel-benchmark row): ``pivoted_qr`` of a 4096^2 f32
   Gaussian matrix, k = 512, four 128-wide Householder panels, K1 on the
   (136, 256) shortlist of each; Q orthonormal to 1e-5 (in f64), R upper
   triangular, ind a permutation, (QR)[:, :k] = A[:, ind[:k]]; exactly four
   K1 launches per call.
7. Two-read two-sided ID (config 4b): ``batched_two_sided_id`` of one
   16384^2 f32 Laplace block, rank 16 (blocked RRQR with one 16-wide
   panel, then the LQ of C through K1); rel err <= 5e-3, skeleton within
   1e-3, two K1 launches per call.
8. Complex two-sided ID (config 6s8k): ``planar_two_sided_id`` of an 8192^2
   c64 block with 96 singular values geomspace(1, 1e-9) (numpy, seed 68),
   rank 43; rel err <= 10 sigma_43, skeleton within 1e-3, C bitwise
   columns, two K2 launches per call. Then the one-read
   ``batched_sketched_two_sided_id`` of the same block: rel err <= 5e-3,
   two K2 launches.

Both launch counts are set to 0 just before each of phases 3-8 and read
just after it; a kernel that a phase's path must run and that it launched
no time fails the run. The line before the last is a JSON object with each
kernel's launches, error, times and bound; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Throughput is block bytes over the wall time of one call. A kernel's bound
is the larger of its bytes (each input read once, each output written
once) over 3.35 TB/s and its operations over 67 TFLOP/s (f32 outside the
tensor cores), the H100's published peaks. No single PyTorch call computes
a column-pivoted QR (``torch.linalg.qr`` does not pivot), so
``library_ms`` is null for both kernels.

``--profile`` also runs ``torch.profiler`` over six warm calls of each of
phases 3-8 and prints, per phase, the wall time per call with the tracing
on, the device-busy time, the idle share and the device time by kernel
name.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

KERNELS = {
    "qrcp_panel": {
        "source": "rusty_compression_tpu_torch/csrc/qrcp.cu",
        "replaces": "rusty_compression_tpu/ops/pallas/qrcp.py:41",
        "entry": "rc_qrcp_panel_f32"},
    "qrcp_panel_complex": {
        "source": "rusty_compression_tpu_torch/csrc/qrcp_c64.cu",
        "replaces": "rusty_compression_tpu/ops/pallas/qrcp.py:150",
        "entry": "rc_qrcp_panel_c64"},
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
F32_FLOP_PER_S = 67e12      # f32 outside the tensor cores, published


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


def panel_bound(shape, k: int, itemsize: int, masked: bool) -> dict:
    """Least time the card could take for one panel call: bytes (the panel
    and the mask read once, q, r and piv written once) over the memory
    rate, against operations (R row and rank-1 downdate over the panel,
    the reorthogonalization against Q; four real operations per element
    and step in f32, sixteen in c64) over the f32 rate. Every one of the k
    steps runs whatever the data."""
    *batch, m, n = shape
    count = math.prod(batch)
    nbytes = count * (itemsize * (m * n + m * k + k * n) + 4 * k
                      + (4 * n if masked else 0))
    ops = count * (4 if itemsize == 4 else 16) * (m * n * k + m * k * k)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


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
    built = k1.build()
    seconds = time.perf_counter() - t0
    for name, meta in KERNELS.items():
        path, report = built[meta["entry"]]
        k1._entry(meta["entry"])
        say("1-build", kernel=name, seconds_all=seconds, library=path.name,
            ptxas=[line.strip() for line in report.splitlines()
                   if "registers" in line or "spill" in line])


def distinct_norm_panel(torch, gen, shape, dtype=None):
    """Gaussian columns scaled by geomspace(1, 0.1): distinct norms."""
    n = shape[-1]
    scale = torch.logspace(0.0, -1.0, n, device="cuda")
    a = torch.randn(shape, generator=gen, device="cuda")
    if dtype == torch.complex64:
        a = torch.complex(a, torch.randn(shape, generator=gen,
                                         device="cuda"))
    return a * scale


def phase_kernel(torch, k1, gen) -> dict:
    """Each kernel against the plain version; the first case of each is
    the shape whose times go into the ``kernels`` line."""
    from rusty_compression_tpu_torch.ops.kernels.sweep import device_ms

    # (shape, k, mask): mask False, True (every seventh column used) or
    # "slice" (the first CTA's whole slice used).
    cases = {
        "qrcp_panel": [
            ((24, 16384), 16, False),     # sketch of the 16384^2 block
            ((16, 16384), 16, False), ((24, 2048), 16, False),
            ((37, 301), 29, True), ((8, 24, 2048), 16, False),
            ((136, 256), 128, True),      # the 4096^2 RRQR's shortlist
            ((24, 32), 16, False),        # config 4b's shortlist
            ((24, 16389), 16, True),      # ragged last CTA
            ((24, 16384), 16, "slice"), ((8, 24, 2048), 16, "slice"),
            ((600, 40), 8, False)],       # fewer columns than 32 a CTA
        "qrcp_panel_complex": [
            ((53, 8192), 43, False),      # core of the 8192^2 complex ID
            ((43, 8192), 43, False), ((136, 256), 128, True),
            ((37, 301), 29, True), ((8, 24, 2048), 16, False),
            ((53, 8191), 43, True),       # ragged, residual in L2
            ((43, 8192), 43, "slice"), ((600, 40), 8, False)],
    }
    out = {}
    for name, shapes in cases.items():
        fn = getattr(k1, name)
        dtype = torch.complex64 if name.endswith("complex") else None
        worst, main = 0.0, None
        for shape, k, masked in shapes:
            a = distinct_norm_panel(torch, gen, shape, dtype)
            layout = k1.panel_layout(*shape[-2:], k, a.element_size())
            used = None
            if masked:
                used = torch.zeros(shape[-1], dtype=torch.bool, device="cuda")
                if masked == "slice":
                    check(layout.cluster > 1, f"{shape} is not clustered")
                    used[:layout.width] = True
                else:
                    used[::7] = True
            q, r, piv = fn(a, k, used=used)
            q0, r0, piv0 = k1.qrcp_panel_plain(a, k, used)
            torch.cuda.synchronize()
            check(torch.equal(piv.long(), piv0),
                  f"{name} pivots at {shape} k={k}")
            err = max(float((q - q0).abs().max()),
                      float((r - r0).abs().max()))
            check(err <= 1e-4, f"{name} |q|, |r| error {err} at {shape} k={k}")
            again = fn(a, k, used=used)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip((q, r, piv), again)),
                  f"{name} at {shape} k={k}: two launches differ")
            times = {"ms": event_ms(lambda: fn(a, k, used=used)),
                     "device_ms": device_ms(
                         torch, lambda: fn(a, k, used=used)),
                     "plain_ms": event_ms(
                         lambda: k1.qrcp_panel_plain(a, k, used)),
                     **panel_bound(shape, k, a.element_size(), masked)}
            worst = max(worst, err)
            say("2-kernel", kernel=name, shape=list(shape), k=k,
                used_mask=masked, cluster=layout.cluster,
                resid_in_smem=layout.resid_in_smem,
                smem_bytes=layout.smem_bytes, threads=layout.threads,
                pivots_equal=True, repeat_bitwise=True, max_abs_err=err,
                **times)
            main = main or times
        out[name] = {"max_abs_err": worst, **main}
    torch.cuda.synchronize()
    return out


def rel_max(got, want) -> float:
    return float((got.cpu() - want).abs().max() / want.abs().max())


def phase_reference(torch, rt) -> None:
    """Small sizes: card (K1, K2) against CPU (plain version) on the same
    blocks and Gaussian matrices."""
    from rusty_compression_tpu_torch.ops.pivoted_qr import (
        _qrcp_blocked_from_gaussian)
    from rusty_compression_tpu_torch.parallel.batch import (
        _rsvd_block_from_omega)
    from rusty_compression_tpu_torch.planarc import _column_id_from_omega
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
    id_err = max(rel_max(getattr(ts_g, f), getattr(ts_c, f)) for f in "cxr")
    check(id_err <= 1e-4, f"ID factors card vs CPU {id_err}")
    s_err = float((svd_c.s - svd_g.s.cpu()).abs().max() / svd_c.s.max())
    check(s_err <= 1e-5, f"rSVD singular values card vs CPU {s_err}")
    say("2-reference", blocks=[3, 120, 90], rank=24, pivots_equal=True,
        id_factor_rel_err=id_err, rsvd_s_rel_err=s_err)

    # Blocked RRQR, three 16-wide panels: K1 / K2 on the (24, 32) shortlist
    # on the card, the plain rule on the CPU, the same sketch matrix. Q and
    # R are compared through Q R and |R| (a panel's Householder signs may
    # differ between the two LAPACKs).
    for dtype in (torch.float32, torch.complex64):
        a = blocks[:2].to(dtype)
        sketch = torch.randn((2, 24, 120), generator=g).to(dtype)
        q_c, r_c, piv_c = _qrcp_blocked_from_gaussian(a, sketch, 48, 16)
        q_g, r_g, piv_g = _qrcp_blocked_from_gaussian(
            a.cuda(), sketch.cuda(), 48, 16)
        torch.cuda.synchronize()
        check(torch.equal(piv_c, piv_g.cpu()),
              f"blocked RRQR pivots card vs CPU ({dtype})")
        err = max(rel_max(q_g @ r_g, q_c @ r_c),
                  rel_max(r_g.abs(), r_c.abs()))
        check(err <= 1e-4, f"blocked RRQR factors card vs CPU {err}")
        say("2-reference-blocked", dtype=str(dtype), blocks=[2, 120, 90],
            k=48, block=16, pivots_equal=True, factor_rel_err=err)

    # Complex two-sided ID: K2 for the core and for the LQ of C on the
    # card, the plain loop on the CPU (both widths <= 512).
    a = torch.complex(blocks[0], blocks[1])
    omega = torch.complex(torch.randn((90, 34), generator=g),
                          torch.randn((90, 34), generator=g))
    ids = [_column_id_from_omega(rt.DenseOperator(a.to(dev)), omega.to(dev),
                                 24, 1).two_sided_id()
           for dev in ("cpu", "cuda")]
    torch.cuda.synchronize()
    check(torch.equal(ids[0].col_ind, ids[1].col_ind.cpu())
          and torch.equal(ids[0].row_ind, ids[1].row_ind.cpu()),
          "complex ID pivots on the card equal the CPU's")
    err = max(rel_max(getattr(ids[1], f), getattr(ids[0], f)) for f in "cxr")
    check(err <= 1e-4, f"complex ID factors card vs CPU {err}")
    say("2-reference-complex", block=[120, 90], rank=24, pivots_equal=True,
        factor_rel_err=err)


def phase_rsvd(torch, rt, gen):
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
    return run


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


def skeleton_rel_err(torch, ts, blocks, rank: int) -> float:
    """``X`` against the skeleton submatrix ``A[row_ind[:k], col_ind[:k]]``,
    entrywise, relative to the submatrix's largest entry."""
    cols = torch.take_along_dim(blocks, ts.col_ind[..., None, :rank], dim=-1)
    skel = torch.take_along_dim(cols, ts.row_ind[..., :rank, None], dim=-2)
    return float((ts.x - skel).abs().max() / skel.abs().max())


def phase_two_sided(torch, rt, k1, gen, name: str, count: int, size: int):
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
    skel_err = skeleton_rel_err(torch, ts, blocks, rank)
    check(skel_err <= 1e-3, f"skeleton rel err {skel_err} > 1e-3")
    cid = rt.sketched_column_id(blocks, gen, rank=rank, oversample=8)
    check(torch.equal(cid.c, torch.take_along_dim(
        blocks, cid.col_ind[:, None, :rank], dim=-1)),
        "column gather C is not bitwise A[:, col_ind[:k]]")
    run = lambda: batched_sketched_two_sided_id(  # noqa: E731
        blocks, gen, rank, oversample=8)
    ms = wall_ms(run, reps=10)
    torch.cuda.synchronize()
    say(name, blocks=[count, size, size], rank=rank, rel_err=err,
        skeleton_rel_err=skel_err, column_gather_bitwise=True,
        k1_launches_per_call=launches, ms=ms,
        blocks_per_s=count / (ms * 1e-3),
        gbps=count * size * size * 4 / (ms * 1e-3) / 1e9)
    return run


def phase_rrqr(torch, rt, k1, gen):
    import numpy as np

    m = n = 4096
    k = 512
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((m, n))
                         .astype(np.float32)).cuda()
    run = lambda: rt.pivoted_qr(  # noqa: E731
        a, k, block_size=128, panel_qr="house", pivot_candidates=2,
        generator=gen)
    before = k1.qrcp_panel.launch_count
    q, r, ind = run()
    torch.cuda.synchronize()
    launches = k1.qrcp_panel.launch_count - before
    check(launches == 4, f"{launches} K1 launches in the 4096^2 RRQR, not 4")
    q64 = q.double()
    ortho = float((q64.mT @ q64 - torch.eye(k, dtype=torch.float64,
                                            device="cuda")).abs().max())
    check(ortho <= 1e-5, f"RRQR max|Q^T Q - I| {ortho} > 1e-5")
    check(torch.equal(torch.sort(ind).values,
                      torch.arange(n, device="cuda")),
          "RRQR ind is not a permutation")
    check(torch.equal(r, torch.triu(r)), "RRQR R is not upper triangular")
    col_err = float(((q @ r)[:, :k] - a[:, ind[:k]]).abs().max())
    col_gate = 2e-4 * float(a.abs().max()) * 10
    check(col_err <= col_gate, f"RRQR (QR)[:, :k] off by {col_err}")
    ms = wall_ms(run, reps=5)
    torch.cuda.synchronize()
    say("6-rrqr-4096", k=k, block=128, ortho_err=ortho, column_err=col_err,
        column_gate=col_gate, k1_launches_per_call=launches, ms=ms,
        tflops_2mnk=2 * m * n * k / (ms * 1e-3) / 1e12)
    return run


def phase_two_read(torch, k1, gen):
    from rusty_compression_tpu_torch.parallel import (batched_rel_diff_fro,
                                                      batched_two_sided_id)

    size, rank = 16384, 16
    blocks = laplace_blocks(torch, gen, 1, size)
    run = lambda: batched_two_sided_id(blocks, gen, rank)  # noqa: E731
    before = k1.qrcp_panel.launch_count
    ts = run()
    torch.cuda.synchronize()
    launches = k1.qrcp_panel.launch_count - before
    check(launches == 2, f"{launches} K1 launches in one two-read ID, not 2")
    err = float(batched_rel_diff_fro(ts, blocks).max())
    check(math.isfinite(err) and err <= 5e-3,
          f"two-read two-sided ID rel err {err} > 5e-3")
    skel_err = skeleton_rel_err(torch, ts, blocks, rank)
    check(skel_err <= 1e-3, f"skeleton rel err {skel_err} > 1e-3")
    ms = wall_ms(run, reps=10)
    # The pivots come from a random sketch: the error of five more draws,
    # reported beside the gated first one.
    draws = [float(batched_rel_diff_fro(run(), blocks).max())
             for _ in range(5)]
    torch.cuda.synchronize()
    say("7-two-read-id-16384", blocks=[1, size, size], rank=rank,
        rel_err=err, rel_err_more_draws=draws, skeleton_rel_err=skel_err,
        k1_launches_per_call=launches, ms=ms, blocks_per_s=1 / (ms * 1e-3),
        gbps_two_reads=2 * size * size * 4 / (ms * 1e-3) / 1e9)
    return run


def complex_fixture(torch, size: int, rank_in: int, seed: int):
    """U diag(geomspace(1, 1e-9)) V^H, c64: thin factors from host QRs of
    numpy Gaussians (seed 68 in the configuration), multiplied in c128 on
    the card and rounded to c64."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((size, rank_in))
                        + 1j * rng.standard_normal((size, rank_in)))
    v, _ = np.linalg.qr(rng.standard_normal((size, rank_in))
                        + 1j * rng.standard_normal((size, rank_in)))
    sig = np.geomspace(1.0, 1e-9, rank_in)
    a = (torch.from_numpy(u * sig).cuda()
         @ torch.from_numpy(v).cuda().mH).to(torch.complex64)
    return a, sig


def phase_complex(torch, rt, k1, gen):
    from rusty_compression_tpu_torch.parallel import (
        batched_sketched_two_sided_id)

    size, rank = 8192, int(0.45 * 96)
    a, sig = complex_fixture(torch, size, 96, 68)
    k2 = k1.qrcp_panel_complex
    run = lambda: rt.planar_two_sided_id(a, gen, rank=rank)  # noqa: E731
    before = k2.launch_count
    ts = run()
    torch.cuda.synchronize()
    launches = k2.launch_count - before
    check(launches == 2, f"{launches} K2 launches in one complex ID, not 2")
    check(ts.rank == rank, f"complex ID rank {ts.rank}, not {rank}")
    err = float(rt.rel_diff_fro(ts.to_mat(), a))
    gate = 10 * float(sig[rank])
    check(math.isfinite(err) and err <= gate,
          f"complex two-sided ID rel err {err} > {gate}")
    skel_err = skeleton_rel_err(torch, ts, a, rank)
    check(skel_err <= 1e-3, f"complex skeleton rel err {skel_err} > 1e-3")
    cid = rt.planar_column_id(a, gen, rank=rank)
    check(torch.equal(cid.c, a[:, cid.col_ind[:rank]]),
          "complex C is not bitwise A[:, col_ind[:k]]")
    ms = wall_ms(run, reps=10)

    one_read = lambda: batched_sketched_two_sided_id(  # noqa: E731
        a[None], gen, rank, oversample=10)
    before = k2.launch_count
    ts1 = one_read()
    torch.cuda.synchronize()
    launches1 = k2.launch_count - before
    check(launches1 == 2, f"{launches1} K2 launches in the one-read complex "
          f"ID, not 2")
    err1 = float(rt.rel_diff_fro(ts1.to_mat(), a[None]))
    check(math.isfinite(err1) and err1 <= 5e-3,
          f"one-read complex ID rel err {err1} > 5e-3")
    ms1 = wall_ms(one_read, reps=10)
    torch.cuda.synchronize()
    nbytes = size * size * 8
    say("8-complex-id-8192", block=[size, size], rank=rank, rel_err=err,
        gate=gate, skeleton_rel_err=skel_err, column_gather_bitwise=True,
        k2_launches_per_call=launches, ms=ms,
        gbps=nbytes / (ms * 1e-3) / 1e9, one_read_rel_err=err1,
        one_read_k2_launches_per_call=launches1, one_read_ms=ms1,
        one_read_gbps=nbytes / (ms1 * 1e-3) / 1e9)
    return run


def profile(torch, name: str, run, calls: int = 5) -> None:
    """Device-busy time, idle share and device time by kernel name over
    ``calls`` warm calls of ``run`` (torch.profiler). The wall time is taken
    inside the profiled region, so it carries the tracing's cost per
    launch but not the profiler's start and stop."""
    from torch.profiler import ProfilerActivity, profile as profiler

    run()
    torch.cuda.synchronize()
    with profiler(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        run()   # the first traced call pays for the tracer's start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    traced = calls + 1
    rows = [(e.key, e.self_device_time_total / 1e3 / traced, e.count / traced)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    check(bool(rows), f"profile of {name}: no device time recorded")
    rows.sort(key=lambda row: -row[1])
    busy = sum(row[1] for row in rows)
    say("profile", cell=name, wall_ms_per_call=wall, device_busy_ms=busy,
        idle_share=1 - busy / wall,
        kernels_per_call=sum(row[2] for row in rows),
        top=[{"kernel": key[:60], "ms": ms, "per_call": cnt}
             for key, ms, cnt in rows[:6]])


def main(argv) -> int:
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
    kernels = phase_kernel(torch, k1, gen)
    phase_reference(torch, rt)

    # The main paths: each phase with both counts at 0 just before it and
    # read just after; `must` names the kernel its path has to launch.
    # Phases 6-8 draw from generators of their own, so that what they
    # compute does not depend on how much the phases before them drew.
    gen6, gen7, gen8 = (torch.Generator(device="cuda").manual_seed(seed)
                        for seed in (6, 7, 8))
    paths = [
        ("3-rsvd-8192", None, lambda: phase_rsvd(torch, rt, gen)),
        ("4-two-sided-id-16384", "qrcp_panel", lambda: phase_two_sided(
            torch, rt, k1, gen, "4-two-sided-id-16384", 1, 16384)),
        ("5-two-sided-id-batch-2048", "qrcp_panel", lambda: phase_two_sided(
            torch, rt, k1, gen, "5-two-sided-id-batch-2048", 8, 2048)),
        ("6-rrqr-4096", "qrcp_panel",
         lambda: phase_rrqr(torch, rt, k1, gen6)),
        ("7-two-read-id-16384", "qrcp_panel",
         lambda: phase_two_read(torch, k1, gen7)),
        ("8-complex-id-8192", "qrcp_panel_complex",
         lambda: phase_complex(torch, rt, k1, gen8)),
    ]
    launches = {name: 0 for name in KERNELS}
    for phase, must, drive in paths:
        for name in KERNELS:
            getattr(k1, name).launch_count = 0
        run = drive()
        torch.cuda.synchronize()
        counts = {name: getattr(k1, name).launch_count for name in KERNELS}
        check(must is None or counts[must] > 0,
              f"phase {phase} launched no {must} kernel")
        say("launches", path=phase, **counts)
        for name in KERNELS:
            launches[name] += counts[name]
        if "--profile" in argv:
            profile(torch, phase, run)
        del run
        torch.cuda.empty_cache()

    print(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": meta["source"],
        "replaces": meta["replaces"], "launches": launches[name],
        "max_abs_err": kernels[name]["max_abs_err"],
        "ms": kernels[name]["ms"], "device_ms": kernels[name]["device_ms"],
        "plain_ms": kernels[name]["plain_ms"],
        "bound_ms": kernels[name]["bound_ms"],
        "bound_by": kernels[name]["bound_by"], "library_ms": None}
        for name, meta in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
