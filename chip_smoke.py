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
   panel, its pivots by K1 over the whole (24, 16384) sketch, then the LQ
   of C through K1); rel err <= 5e-3, skeleton within
   1e-3, two K1 launches per call.
8. Complex two-sided ID (config 6s8k): ``planar_two_sided_id`` of an 8192^2
   c64 block with 96 singular values geomspace(1, 1e-9) (numpy, seed 68),
   rank 43; rel err <= 10 sigma_43, skeleton within 1e-3, C bitwise
   columns, two K2 launches per call. Then the one-read
   ``batched_sketched_two_sided_id`` of the same block: rel err <= 5e-3,
   two K2 launches.
9. Adaptive rSVD (config 1 at width): ``compress(a, gen,
   CompressionConfig.ADAPTIVE(1e-3, sample_size=32, max_rank=512))`` of
   phase 3's 8192^2 block; true rel err <= 5 tol, rank a multiple of 32
   below the cap, last history entry below tol; rounds and host reads
   printed. Then config 1 as written: 500^2,
   ``random_approximate_low_rank_matrix(1, 1e-10)``,
   ``sample_range_adaptive`` with sample 10, f32 at 1e-4 and f64 at 1e-5;
   projection residual <= 5 tol.
10. Adaptive QR of the same 8192^2 block: ``randomized_adaptive_qr`` ->
    ``column_id()``; ``to_mat`` rel err <= 5 tol, ``ind`` a permutation, C
    within 1e-3 of the block's columns; the blocked RRQR of B launches K1
    on its shortlists, the last of them as wide as the rank found.
11. Config 2: ``hilbert(1024)``, ``QR.compute_from(h, max_rank=64)`` ->
    ``compress(Adaptive(tol))`` -> ``column_id()`` at its defaults; f32 at
    1e-5 (blocked, K1 picks the pivots over the whole (72, 1024) sketch)
    and f64 at 1e-8 (plain pivot rule, no launch); C's columns exact to
    1e-5 / 1e-12; rel err <= 10 x the optimal rank-k error + 100 eps.
12. Config 4b1t: ``sketched_two_sided_id(blk, gen, tol=1e-3, max_rank=64)``
    of phase 4's 16384^2 Laplace block; rel err <= 5e-3, rank <= 64, the
    column gather bitwise; K1 on the (80, 144) shortlist of the 72-row
    sketch and on the LQ of C.
13. Nyström: ``nystrom_block(a, gen, 43)`` of an 8192^2 f32 block with 96
    singular values geomspace(1, 1e-9); rel err <= 10 sigma_44 / sigma_1,
    rank 43, U orthonormal to 1e-4; two passes over the block.
14. The front door over a stack: eight 2048^2 Laplace blocks through
    ``compress`` with ``RANK(16, method=...)`` for all six methods, and a
    stack of four of them and four blocks of slower decay with
    ``ADAPTIVE(1e-3, sample_size=8, max_rank=64)``; each result bitwise
    the direct ``batched_*`` call's with a generator in the same state;
    the lanes of the adaptive stack stop at different rounds, below the
    cap, each within 5 tol and exactly zero beyond its rank. Then a ``FunctionOperator`` (matvec of a 2048^2
    block) and a 16384^2 ``SparseOperator`` (1 % density) plus a low-rank
    part as a ``SumOperator`` through ``compress(RANK(16))``, each against
    the dense matrix of the same operator.

Both launch counts are set to 0 just before each of phases 3-14 and read
just after it; a kernel that a phase's path must run and that it launched
no time fails the run. Every panel shape that a phase launched has to be
one that phase 2 held against the plain version; a shape whose size
depends on the data (the rank a tolerance found) is held right after its
phase, outside the count. The line before the last is a JSON object with each
kernel's launches, error, times and bound; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Throughput is block bytes over the wall time of one call. A kernel's bound
is the larger of its bytes (each input read once, each output written
once) over 3.35 TB/s and its operations over 67 TFLOP/s (f32 outside the
tensor cores), the H100's published peaks. No single PyTorch call computes
a column-pivoted QR (``torch.linalg.qr`` does not pivot), so
``library_ms`` is null for both kernels.

``--profile`` also runs ``torch.profiler`` over six warm calls of each of
phases 3-14 and prints, per phase, the wall time per call with the tracing
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


#: Phase 2's cases, (shape, k, mask): mask False, True (every seventh
#: column used) or "slice" (the first CTA's whole slice used). The first
#: case of each kernel is the shape whose times go into the ``kernels``
#: line.
KERNEL_CASES = {
    "qrcp_panel": [
        ((24, 16384), 16, False),     # sketch of the 16384^2 block
        ((16, 16384), 16, False), ((24, 2048), 16, False),
        ((37, 301), 29, True), ((8, 24, 2048), 16, False),
        ((8, 16, 2048), 16, False),   # LQ of C over the batch
        ((136, 256), 128, True),      # the RRQR's full panels
        ((24, 32), 16, False),
        ((24, 32), 16, True),         # a 16-wide panel's shortlist
        ((24, 16389), 16, True),      # ragged last CTA
        ((24, 16384), 16, "slice"), ((8, 24, 2048), 16, "slice"),
        ((600, 40), 8, False),        # fewer columns than 32 a CTA
        ((72, 1024), 64, True),       # config 2: hilbert(1024), k = 64
        ((72, 128), 64, True),        # the same through a shortlist
        ((80, 144), 72, True),        # config 4b1t: the 72-row sketch
        ((8, 2048, 2048), 16, False)],  # column/row ID of the stack
    "qrcp_panel_complex": [
        ((53, 8192), 43, False),      # core of the 8192^2 complex ID
        ((43, 8192), 43, False), ((136, 256), 128, True),
        ((37, 301), 29, True), ((8, 24, 2048), 16, False),
        ((53, 8191), 43, True),       # ragged, residual in L2
        ((43, 8192), 43, "slice"), ((600, 40), 8, False)],
}


class KernelChecks:
    """Phase 2: each kernel against its plain version, shape by shape.
    ``held`` keeps, per kernel, the ``((panels, m, n), k, masked)`` that
    passed, in the form the wrappers record what they launched."""

    def __init__(self, torch, k1, gen):
        self.torch, self.k1, self.gen = torch, k1, gen
        self.held = {name: set() for name in KERNELS}
        self.worst = {name: 0.0 for name in KERNELS}
        self.main = {}

    def hold(self, name: str, shape, k: int, masked, reps: int = 10) -> None:
        from rusty_compression_tpu_torch.ops.kernels.sweep import device_ms

        torch, k1 = self.torch, self.k1
        fn = getattr(k1, name)
        dtype = torch.complex64 if name.endswith("complex") else None
        a = distinct_norm_panel(torch, self.gen, shape, dtype)
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
        err = max(float((q - q0).abs().max()), float((r - r0).abs().max()))
        check(err <= 1e-4, f"{name} |q|, |r| error {err} at {shape} k={k}")
        again = fn(a, k, used=used)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip((q, r, piv), again)),
              f"{name} at {shape} k={k}: two launches differ")
        times = {"ms": event_ms(lambda: fn(a, k, used=used), reps),
                 "device_ms": device_ms(torch, lambda: fn(a, k, used=used)),
                 "plain_ms": event_ms(
                     lambda: k1.qrcp_panel_plain(a, k, used), reps),
                 **panel_bound(shape, k, a.element_size(), masked)}
        say("2-kernel", kernel=name, shape=list(shape), k=k,
            used_mask=masked, cluster=layout.cluster,
            resid_in_smem=layout.resid_in_smem,
            smem_bytes=layout.smem_bytes, threads=layout.threads,
            pivots_equal=True, repeat_bitwise=True, max_abs_err=err, **times)
        self.worst[name] = max(self.worst[name], err)
        self.main.setdefault(name, times)
        panels = shape[0] if len(shape) == 3 else 1
        self.held[name].add(((panels, *shape[-2:]), k, bool(masked)))

    def hold_launched(self, name: str, allowed) -> None:
        """Hold the shapes ``name`` launched and phase 2 has not seen, if
        ``allowed(shape, k, masked)`` says their size depends on the data;
        any other unseen shape fails the run."""
        launched = getattr(self.k1, name).launched_shapes
        for shape, k, masked in sorted(launched - self.held[name]):
            check(allowed(shape, k, masked),
                  f"{name} was launched at {shape} k={k} masked={masked}, "
                  f"a shape that phase 2 did not hold")
            self.hold(name, shape if shape[0] > 1 else shape[1:], k, masked,
                      reps=5)

    def summary(self) -> dict:
        return {name: {"max_abs_err": self.worst[name], **self.main[name]}
                for name in KERNELS}


def phase_kernel(torch, k1, gen) -> KernelChecks:
    checks = KernelChecks(torch, k1, gen)
    for name, cases in KERNEL_CASES.items():
        for shape, k, masked in cases:
            checks.hold(name, shape, k, masked)
    torch.cuda.synchronize()
    return checks


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
    # held to the same gate.
    draws = [float(batched_rel_diff_fro(run(), blocks).max())
             for _ in range(5)]
    check(max(draws) <= 5e-3, f"two-read ID rel err over draws {draws}")
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


def decaying_block(torch, rt, gen, size: int = 8192, inner: int = 400):
    """Phase 3's block: G1 diag(geomspace(1, 1e-6, inner)) G2, f32."""
    g1 = rt.random_gaussian(gen, (size, inner), dtype=torch.float32)
    g2 = rt.random_gaussian(gen, (inner, size), dtype=torch.float32)
    sigma = torch.logspace(0.0, -6.0, inner, device=gen.device)
    return (g1 * sigma) @ g2


def phase_adaptive_rsvd(torch, rt, gen, size: int = 8192):
    from rusty_compression_tpu_torch.sampling import _adaptive_loop

    tol, blk, cap = 1e-3, 32, 512
    a = decaying_block(torch, rt, gen, size)
    cfg = rt.CompressionConfig.ADAPTIVE(tol, sample_size=blk, max_rank=cap)
    run = lambda: rt.compress(a, gen, cfg)  # noqa: E731
    _adaptive_loop.host_reads = 0
    svd, hist = run()
    reads = _adaptive_loop.host_reads
    err = float(rt.rel_diff_fro(svd.to_mat(), a))
    rounds = int((hist > 0).sum())
    check(math.isfinite(err) and err <= 5 * tol,
          f"adaptive rSVD rel err {err} > {5 * tol}")
    check(svd.rank == rounds * blk and 0 < svd.rank < min(cap, size),
          f"adaptive rSVD rank {svd.rank} after {rounds} rounds of {blk}")
    check(float(hist[rounds - 1]) < tol,
          f"last residual estimate {float(hist[rounds - 1])} >= {tol}")
    check(reads == rounds + 1, f"{reads} host reads in {rounds} rounds")
    ms = wall_ms(run, reps=3)
    passes = 2 * rounds + 1   # the first probe; A^H Q and a probe a round
    say("9-adaptive-rsvd-8192", block=[size, size], tol=tol, sample_size=blk,
        max_rank=cap, rank=svd.rank, rounds=rounds, rel_err=err,
        last_estimate=float(hist[rounds - 1]),
        loop_host_reads=reads, operator_passes=passes,
        ms=ms, gbps=passes * size * size * 4 / (ms * 1e-3) / 1e9)

    # Config 1 as the benchmark suite writes it.
    for dtype, tol1 in ((torch.float32, 1e-4), (torch.float64, 1e-5)):
        b = rt.random_approximate_low_rank_matrix(
            gen, (min(500, size), min(500, size)), 1.0, 1e-10, dtype=dtype)
        run1 = lambda: rt.sample_range_adaptive(b, gen, tol1, 10)  # noqa: E731
        q, residuals = run1()
        resid = float(torch.linalg.norm(b - q @ (q.mT @ b))
                      / torch.linalg.norm(b))
        check(math.isfinite(resid) and resid <= 5 * tol1,
              f"config 1 ({dtype}) residual {resid} > {5 * tol1}")
        check(q.shape[1] == residuals[-1][0] and residuals[-1][1] < tol1,
              f"config 1 ({dtype}) history {residuals[-1]}")
        say("9-config-1-500", dtype=str(dtype), tol=tol1, rank=q.shape[1],
            rounds=len(residuals), rel_residual=resid,
            ms=wall_ms(run1, reps=3))
    return run


def phase_adaptive_qr(torch, rt, k1, gen, size: int = 8192):
    tol, blk = 1e-3, 32
    a = decaying_block(torch, rt, gen, size)
    run = lambda: rt.randomized_adaptive_qr(  # noqa: E731
        a, gen, tol, blk, max_rank=512)[0].column_id()
    before = k1.qrcp_panel.launch_count
    qr, hist = rt.randomized_adaptive_qr(a, gen, tol, blk, max_rank=512)
    cid = qr.column_id()
    torch.cuda.synchronize()
    launches = k1.qrcp_panel.launch_count - before
    check(launches >= 1, "the adaptive QR launched no K1")
    check(qr.rank == len(hist) * blk, f"rank {qr.rank} after {len(hist)} rounds")
    err = float(rt.rel_diff_fro(qr.to_mat(), a))
    check(math.isfinite(err) and err <= 5 * tol,
          f"adaptive QR rel err {err} > {5 * tol}")
    check(torch.equal(torch.sort(qr.ind).values,
                      torch.arange(size, device=a.device)),
          "adaptive QR ind is not a permutation")
    cols = a[:, cid.col_ind[:cid.rank]]
    col_err = float((cid.c - cols).abs().max() / cols.abs().max())
    check(col_err <= 1e-3, f"C is off the block's columns by {col_err}")
    id_err = float(rt.rel_diff_fro(cid.to_mat(), a))
    ms = wall_ms(run, reps=3)
    say("10-adaptive-qr-8192", block=[size, size], tol=tol, rank=qr.rank,
        rounds=len(hist), rel_err=err, column_rel_err=col_err,
        column_id_rel_err=id_err, k1_launches_per_call=launches, ms=ms)
    return run


def phase_hilbert(torch, rt, k1, gen, size: int = 1024):
    """Config 2, through the call the benchmark makes, at its defaults. Q
    of a (1024, 64) panel does not fit K1, so ``auto`` goes blocked with
    one 64-wide panel, and at small rank that runs the pivot rule over the
    whole width of the (72, 1024) sketch: K1 in f32, the plain rule in
    f64."""
    from rusty_compression_tpu_torch.utils.kernel_matrices import hilbert

    runs = []
    for dtype, tol, col_gate, must in ((torch.float32, 1e-5, 1e-5, True),
                                       (torch.float64, 1e-8, 1e-12, False)):
        h = hilbert(size, dtype=dtype, device=gen.device)
        s = torch.linalg.svdvals(h.double())

        def run(h=h, tol=tol):
            qr = rt.QR.compute_from(h, max_rank=64, generator=gen)
            return qr.compress(rt.CompressionType.ADAPTIVE(tol)).column_id()

        before = k1.qrcp_panel.launch_count
        cid = run()
        torch.cuda.synchronize()
        launches = k1.qrcp_panel.launch_count - before
        check((launches > 0) == must,
              f"config 2 ({dtype}): {launches} K1 launches")
        err = float(rt.rel_diff_fro(cid.to_mat(), h))
        e_opt = float(torch.sqrt((s[cid.rank:] ** 2).sum() / (s ** 2).sum()))
        gate = 10 * e_opt + 100 * float(torch.finfo(dtype).eps)
        check(math.isfinite(err) and err <= gate,
              f"config 2 ({dtype}) rel err {err} > {gate}")
        col_err = float((cid.c - h[:, cid.col_ind[:cid.rank]]).abs().max())
        check(col_err <= col_gate,
              f"config 2 ({dtype}) columns off by {col_err}")
        ms = wall_ms(run, reps=5)
        say("11-config-2-hilbert", size=size, dtype=str(dtype), tol=tol,
            rank=cid.rank, rel_err=err, e_opt=e_opt, gate=gate,
            column_abs_err=col_err, k1_launches_per_call=launches, ms=ms,
            gbps=size * size * h.element_size() / (ms * 1e-3) / 1e9)
        runs.append(run)
    return lambda: [run() for run in runs]


def phase_tolerance_id(torch, rt, k1, gen, size: int = 16384):
    tol, cap = 1e-3, 64
    blk = laplace_blocks(torch, gen, 1, size)[0]
    run = lambda: rt.sketched_two_sided_id(  # noqa: E731
        blk, gen, tol=tol, max_rank=cap)
    before = k1.qrcp_panel.launch_count
    ts = run()
    torch.cuda.synchronize()
    launches = k1.qrcp_panel.launch_count - before
    check(launches == 2, f"{launches} K1 launches in the tolerance-mode ID")
    check(0 < ts.rank <= cap, f"tolerance-mode ID rank {ts.rank}")
    err = float(rt.rel_diff_fro(ts.to_mat(), blk))
    check(math.isfinite(err) and err <= 5 * tol,
          f"tolerance-mode ID rel err {err} > {5 * tol}")
    cid = rt.sketched_column_id(blk, gen, tol=tol, max_rank=cap)
    check(torch.equal(cid.c, blk[:, cid.col_ind[:cid.rank]]),
          "tolerance-mode C is not bitwise A[:, col_ind[:k]]")
    ms = wall_ms(run, reps=10)
    say("12-config-4b1t-16384", block=[size, size], tol=tol, max_rank=cap,
        sketch_rows=min(cap + 8, size), rank=ts.rank, rel_err=err,
        column_gather_bitwise=True, k1_launches_per_call=launches, ms=ms, blocks_per_s=1 / (ms * 1e-3),
        gbps=size * size * 4 / (ms * 1e-3) / 1e9)
    return run


def real_fixture(torch, size: int, rank_in: int, seed: int, device):
    """U diag(geomspace(1, 1e-9)) V^T, f32: config 6s8k's construction in
    real arithmetic (host QRs of numpy Gaussians, the product in f64 on
    the card)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((size, rank_in)))
    v, _ = np.linalg.qr(rng.standard_normal((size, rank_in)))
    sig = np.geomspace(1.0, 1e-9, rank_in)
    a = (torch.from_numpy(u * sig).to(device)
         @ torch.from_numpy(v).to(device).mT).to(torch.float32)
    return a, sig


def phase_nystrom(torch, rt, gen, size: int = 8192):
    from rusty_compression_tpu_torch.parallel import nystrom_block

    rank = 43
    a, sig = real_fixture(torch, size, 96, 68, gen.device)
    run = lambda: nystrom_block(a, gen, rank)  # noqa: E731
    svd = run()
    err = float(rt.rel_diff_fro(svd.to_mat(), a))
    gate = 10 * float(sig[rank])
    check(math.isfinite(err) and err <= gate,
          f"Nystrom rel err {err} > {gate}")
    check(svd.rank == rank, f"Nystrom rank {svd.rank}")
    ortho = float(torch.linalg.matrix_norm(
        svd.u.mT @ svd.u - torch.eye(rank, device=a.device)))
    check(ortho < 1e-4, f"Nystrom ||U^T U - I|| {ortho}")
    ms = wall_ms(run, reps=10)
    say("13-nystrom-8192", block=[size, size], rank=rank, rel_err=err,
        gate=gate, ortho_err=ortho, operator_passes=2, ms=ms,
        gbps=2 * size * size * 4 / (ms * 1e-3) / 1e9)
    return run


def same_state(gen):
    """A second generator in ``gen``'s state."""
    import torch

    twin = torch.Generator(device=gen.device)
    twin.set_state(gen.get_state())
    return twin


def phase_front_door(torch, rt, k1, gen, count: int = 8, size: int = 2048,
                     sparse_size: int = 16384):
    import dataclasses

    from rusty_compression_tpu_torch import parallel
    from rusty_compression_tpu_torch.sampling import _adaptive_loop

    rank, tol = 16, 1e-3
    blocks = laplace_blocks(torch, gen, count, size)
    direct = {
        "rsvd": lambda g: parallel.batched_rsvd(
            blocks, g, rank, oversample=5, power_iters=0, ortho="auto",
            small_svd="direct"),
        "nystrom": lambda g: parallel.batched_nystrom(
            blocks, g, rank, oversample=5, small_svd="direct"),
        "column_id": lambda g: parallel.batched_column_id(
            blocks, g, rank, mode="auto", block_size=128),
        "row_id": lambda g: parallel.batched_row_id(
            blocks, g, rank, mode="auto", block_size=128),
        "two_sided_id": lambda g: parallel.batched_two_sided_id(
            blocks, g, rank, mode="auto", block_size=128),
        "sketched_two_sided_id":
            lambda g: parallel.batched_sketched_two_sided_id(
                blocks, g, rank, mode="auto", block_size=128),
    }
    runs = []
    for method, call in direct.items():
        cfg = rt.CompressionConfig.RANK(rank, method=method)
        before = k1.qrcp_panel.launch_count
        got = rt.compress(blocks, same_state(gen), cfg)
        torch.cuda.synchronize()
        launches = k1.qrcp_panel.launch_count - before
        want = call(same_state(gen))
        check(type(got) is type(want) and all(
            torch.equal(getattr(got, f.name), getattr(want, f.name))
            for f in dataclasses.fields(want)),
            f"compress(RANK, {method}) is not the direct batched call")
        check((launches > 0) == (method not in ("rsvd", "nystrom")),
              f"compress(RANK, {method}): {launches} K1 launches")
        errs = parallel.batched_rel_diff_fro(got, blocks)
        check(bool(torch.isfinite(errs).all()) and float(errs.max()) <= 5e-2,
              f"compress(RANK, {method}) rel err {float(errs.max())}")
        run = lambda cfg=cfg: rt.compress(blocks, gen, cfg)  # noqa: E731
        say("14-front-door-rank", blocks=[count, size, size], method=method,
            rank=rank, max_rel_err=float(errs.max()), equals_direct=True,
            k1_launches_per_call=launches, ms=wall_ms(run, reps=5))
        runs.append(run)

    # The adaptive stack: the Laplace blocks stop after one round, so half
    # of the lanes get blocks of slower decay (six decades over 24 to 60
    # singular values) and the loop goes on with the early lanes frozen.
    stack = blocks.clone()
    for lane, inner in zip(range(count // 2, count), (24, 36, 48, 60)):
        stack[lane] = decaying_block(torch, rt, gen, size, inner)
    cfg = rt.CompressionConfig.ADAPTIVE(tol, sample_size=8, max_rank=64)
    _adaptive_loop.host_reads = 0
    svd, ranks, hist = rt.compress(stack, same_state(gen), cfg)
    reads = _adaptive_loop.host_reads
    want = parallel.batched_adaptive_rsvd(stack, same_state(gen), tol, 8, 64,
                                          ortho="auto", small_svd="direct")
    check(all(torch.equal(getattr(svd, f), getattr(want[0], f))
              for f in ("u", "s", "vt")) and torch.equal(ranks, want[1]),
          "compress(ADAPTIVE) is not the direct batched call")
    errs = parallel.batched_rel_diff_fro(svd, stack)
    check(bool(torch.isfinite(errs).all()) and float(errs.max()) <= 5 * tol,
          f"adaptive stack rel err {float(errs.max())} > {5 * tol}")
    check(len(set(ranks.tolist())) > 1 and int(ranks.max()) < 64,
          f"adaptive stack ranks {ranks.tolist()}: no lane was frozen "
          f"while another went on, or one ran into the cap")
    check(reads == int(ranks.max()) // 8 + 1,
          f"{reads} host reads for ranks {ranks.tolist()}")
    beyond = torch.arange(svd.s.shape[-1], device=ranks.device) >= ranks[:, None]
    check(not bool((svd.s * beyond).any())
          and not bool((svd.u * beyond[:, None, :]).any())
          and not bool((svd.vt * beyond[:, :, None]).any()),
          "adaptive stack: factors beyond a lane's rank are not zero")
    run = lambda: rt.compress(stack, gen, cfg)  # noqa: E731
    say("14-front-door-adaptive", blocks=[count, size, size], tol=tol,
        ranks=ranks.tolist(), rounds=int(ranks.max()) // 8,
        max_rel_err=float(errs.max()), padding_exactly_zero=True,
        loop_host_reads=reads, equals_direct=True, ms=wall_ms(run, reps=5))
    runs.append(run)

    # A matvec closure and a sparse + low-rank sum through compress(RANK).
    a = blocks[0]
    fop = rt.FunctionOperator(lambda v: a @ v, a.shape, a.dtype,
                              conj_matvec=lambda v: a.mT @ v,
                              device=a.device)
    cfg = rt.CompressionConfig.RANK(rank, power_iters=1)
    svd = rt.compress(fop, gen, cfg)
    err = float(rt.rel_diff_fro(svd.to_mat(), a))
    check(math.isfinite(err) and err <= 5e-3,
          f"FunctionOperator rSVD rel err {err}")
    run_f = lambda: rt.compress(fop, gen, cfg)  # noqa: E731
    say("14-front-door-function-operator", shape=list(a.shape), rank=rank,
        rel_err=err, ms=wall_ms(run_f, reps=5))
    runs.append(run_f)

    n, nnz = sparse_size, sparse_size * sparse_size // 100
    idx = torch.randint(0, n, (2, nnz), generator=gen, device=gen.device)
    vals = 1e-6 * torch.randn(nnz, generator=gen, device=gen.device)
    near = rt.SparseOperator(torch.sparse_coo_tensor(
        idx, vals, (n, n), check_invariants=True))
    far = rt.SVD(torch.linalg.qr(rt.random_gaussian(
                     gen, (n, 24), dtype=torch.float32))[0],
                 torch.logspace(0.0, -6.0, 24, device=gen.device),
                 torch.linalg.qr(rt.random_gaussian(
                     gen, (n, 24), dtype=torch.float32))[0].mT.contiguous())
    op = near + rt.as_linear_operator(far)
    check(type(op).__name__ == "SumOperator", "sparse + factored is no sum")
    svd = rt.compress(op, gen, cfg)
    dense = near.to_dense() + far.to_mat()
    err = float(rt.rel_diff_fro(svd.to_mat(), dense))
    # the rank-16 truncation drops sigma_17.. of the far field and the
    # whole near field: both measured on the dense matrix of the operator
    opt = float(torch.sqrt((far.s[rank:] ** 2).sum()
                           + (near.a.values() ** 2).sum())
                / torch.linalg.norm(dense))
    check(math.isfinite(err) and err <= 3 * opt,
          f"sparse + low-rank rSVD rel err {err} > 3 x {opt}")
    run_s = lambda: rt.compress(op, gen, cfg)  # noqa: E731
    say("14-front-door-sparse-operator", shape=[n, n], nnz=near.a._nnz(),
        far_rank=24, rank=rank, rel_err=err, dropped_part=opt,
        ms=wall_ms(run_s, reps=5))
    runs.append(run_s)
    return lambda: [run() for run in runs]


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
    checks = phase_kernel(torch, k1, gen)
    phase_reference(torch, rt)

    # The main paths: each phase with both counts at 0 just before it and
    # read just after; `must` names the kernel its path has to launch.
    # Phases from 6 on draw from generators of their own, so that what they
    # compute does not depend on how much the phases before them drew.
    # `late` says which of a phase's K1 shapes have a size that its data
    # decides; phase 2 holds those right after the phase, outside the count.
    gens = {seed: torch.Generator(device="cuda").manual_seed(seed)
            for seed in range(6, 15)}
    no_late = lambda shape, k, masked: False  # noqa: E731
    paths = [
        ("3-rsvd-8192", None, no_late, lambda: phase_rsvd(torch, rt, gen)),
        ("4-two-sided-id-16384", "qrcp_panel", no_late,
         lambda: phase_two_sided(torch, rt, k1, gen, "4-two-sided-id-16384",
                                 1, 16384)),
        ("5-two-sided-id-batch-2048", "qrcp_panel", no_late,
         lambda: phase_two_sided(torch, rt, k1, gen,
                                 "5-two-sided-id-batch-2048", 8, 2048)),
        ("6-rrqr-4096", "qrcp_panel", no_late,
         lambda: phase_rrqr(torch, rt, k1, gens[6])),
        ("7-two-read-id-16384", "qrcp_panel", no_late,
         lambda: phase_two_read(torch, k1, gens[7])),
        ("8-complex-id-8192", "qrcp_panel_complex", no_late,
         lambda: phase_complex(torch, rt, k1, gens[8])),
        ("9-adaptive-rsvd-8192", None, no_late,
         lambda: phase_adaptive_rsvd(torch, rt, gens[9])),
        # the RRQR's last panel is as wide as the rank found, modulo 128
        ("10-adaptive-qr-8192", "qrcp_panel",
         lambda shape, k, masked: (masked and shape[:2] == (1, 136)
                                   and shape[2] == 2 * k and k % 32 == 0),
         lambda: phase_adaptive_qr(torch, rt, k1, gens[10])),
        ("11-config-2-hilbert", "qrcp_panel", no_late,
         lambda: phase_hilbert(torch, rt, k1, gens[11])),
        # the LQ of C: a (rank, 16384) panel at the rank the tolerance found
        ("12-config-4b1t-16384", "qrcp_panel",
         lambda shape, k, masked: (not masked and shape == (1, k, 16384)
                                   and k <= 64),
         lambda: phase_tolerance_id(torch, rt, k1, gens[12])),
        ("13-nystrom-8192", None, no_late,
         lambda: phase_nystrom(torch, rt, gens[13])),
        ("14-front-door", "qrcp_panel", no_late,
         lambda: phase_front_door(torch, rt, k1, gens[14])),
    ]
    launches = {name: 0 for name in KERNELS}
    for phase, must, late, drive in paths:
        for name in KERNELS:
            getattr(k1, name).launch_count = 0
            getattr(k1, name).launched_shapes.clear()
        run = drive()
        torch.cuda.synchronize()
        counts = {name: getattr(k1, name).launch_count for name in KERNELS}
        check(must is None or counts[must] > 0,
              f"phase {phase} launched no {must} kernel")
        say("launches", path=phase, **counts, shapes={
            name: sorted([list(shape), k, masked] for shape, k, masked
                         in getattr(k1, name).launched_shapes)
            for name in KERNELS})
        for name in KERNELS:
            launches[name] += counts[name]
            checks.hold_launched(name, late)
        if "--profile" in argv:
            profile(torch, phase, run)
        del run
        torch.cuda.empty_cache()
    kernels = checks.summary()

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
