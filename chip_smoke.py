"""Drive the PyTorch port's main paths once on one NVIDIA card and check them.

    python3 chip_smoke.py [--profile] [--volume N]

Phases (each ends with ``torch.cuda.synchronize()``; any failed check
raises, and the script exits non-zero without its result line):

0. Card: name and power limit from ``nvidia-smi``; TF32 turned off.
1. Build: compiles every source of ``ops.kernels.library.ENTRY_POINTS``
   from this checkout, K1 (``csrc/qrcp.cu``, f32), K2
   (``csrc/qrcp_c64.cu``, c64), K3 (``csrc/qrcp_f64.cu``, f64), K4
   (``csrc/qrcp_c128.cu``, c128) and K5 (``csrc/tsqr.cu``, f32 and f64),
   one ``nvcc`` each, started together; loads every entry point and
   prints the five ``ptxas`` reports.
2. K1 and K2 against their plain version on the card at the main paths'
   panel shapes and at ragged and masked ones (a width that is no
   multiple of the cluster's warps, fewer columns than 32 a CTA, a mask
   over one CTA's whole slice), and where Q does not replicate in a CTA
   as one cooperative grid in each layout code 1-4 (config 2's (1024,
   1024) panel at k = 64 among them; code 4, which the rule gives no f32
   panel, forced): pivots exactly equal, q and r within
   1e-4, two launches on one panel bitwise equal; the layout the wrapper
   chose (cluster size, residual in shared memory or not, bytes of
   shared memory); median times of 10 launches each (CUDA events around
   the wrapper's call: ``ms``, ``plain_ms``) and the kernel alone, queued
   behind a busy card (``device_ms``), beside the roofline bound of the
   shape. K3 and K4 the same with each norm rule (``downdate``, K1's;
   ``recompute``, the 1e-8 ID cores') at the shapes of configs 2h's and
   4h's cores, config 2's f64 sketch, the high-accuracy ID example's
   cores, a c128 core and ragged, masked and batched panels: pivots
   exactly equal, q and r within 1e-9 (f64 sums in another order), two
   launches bitwise, the layout (a cluster, or the cooperative grid where
   Q does not fit one). Then, at a small size, the one-read ID, the rSVD,
   the blocked RRQR (f32 and c64) and the complex two-sided ID on the card
   against the same call on the CPU with the same Gaussian matrices. Then
   the two routes of phase 14's eight 2048^2 f32 blocks at k = 16: K1
   forced (``mode="kernel"``) and ``auto`` (the JAX package's blocked
   RRQR, as the working set is over its 12 MiB bound), CUDA-event times
   of ``pivoted_qr`` and ``batched_column_id`` each, both at cell 14's
   gates. Then ``pivoted_qr(mode="gs")`` in each dtype: one kernel launch
   a panel, the plain loop's result, both times.
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
    1e-5 (one K1 launch over the whole (1024, 1024) panel, a cooperative
    grid, as the JAX package runs its Pallas kernel there; rank and error
    printed beside the TPU's) and f64 at 1e-8 (blocked, K3 picks the
    pivots over the whole (72, 1024) sketch); C's columns exact to 1e-5 /
    1e-12; rel err <= 10 x the optimal rank-k error + 100 eps.
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
15-21. The tol <= 1e-8 pipelines in f64 / c128, at the sizes of
    ``bench_suite.py`` (K3 / K4 pivot the ID cores; each line gives ms
    per call, GB/s at 8 bytes an element (16 for c128), rank, rel err
    against its gate and the host reads of one call, ``highacc._read``):
    15 config 6, ``refined_rsvd`` and ``refined_rsvd_fused`` of a 4096^2
    block with sigma_i = 10^(-10 i / 119) over 160 terms, round_rank 132:
    resid <= 5e-8, rank within 10 of the crossing; the card's SVD of the
    core (through its QR) against numpy's (<= 1e-9 sigma_1), and the
    SVD of the whole core with each cuSOLVER driver.
    16 config 1h, growth of a 512^2 block (decay 120). 17 config 1hb, the
    batched growth of eight 256^2 blocks, then fixed rounds with block 0
    Gaussian (``on_unreachable="mark"``): it alone is marked. 18 config
    2h, ``refined_column_id`` of f64 ``hilbert(1024)``: rel err <= 5e-8,
    columns bitwise, one K3 launch a call, the core's pivots (K3,
    ``recompute``) up to the rank equal to scipy's ``?geqp3`` and to the
    plain rule's on the same core, whose times are printed side by side.
    19 config 4h, ``refined_two_sided_id`` of an 8192^2 f64 Laplace block
    (clouds of ``rng(44)`` 3 apart): rel err <= 1e-7, skeleton bitwise,
    two K3 launches a call, pivots as in 18. 20 config 6c, 2048^2 c128
    (decay 60, 96 terms), ``refined_rsvd`` and ``refined_rsvd_planar``;
    then ``refined_two_sided_id(tol=1e-8)`` of the same block: rel err <=
    10 tol (the JAX package's complex test), skeleton bitwise, two K4
    launches a call, pivots as in 18.
    21 ``compress(ADAPTIVE(1e-8, highacc=True, round_rank=k))`` of phase
    15's block and phase 17's stack, bitwise the direct calls.
22. The block stream (BASELINE config 5's shapes on one card): 64 f32
    Laplace blocks (the clouds of ``tools/_gen_blocks10k.py``), sides from
    ``default_rng(22).integers(1024, 8193)``, made on the card and handed
    over as host numpy arrays, through ``compress_heterogeneous`` at rank
    16 (``sketched_two_sided_id``, then ``rsvd``) and at rel_tol 1e-3:
    every block in submission order, ``on_result`` in collection order,
    the bucket the next power of two >= 128, rel err <= 5e-3 (tolerance
    mode: ranks a multiple of 16), the ID's pivots inside each block and
    its skeleton within 1e-3 of A[row_ind[:16], col_ind[:16]], the
    C++ plan equal to ``plan_buckets``', ``compress(list)`` bitwise the
    direct stream; blocks/s, GB/s, chunks, peak device memory, K1 launches.
23. The 1,024-block volume (``BASELINE.md:201``; ``--volume N`` for N): f64
    Laplace blocks with sides from ``default_rng(5).integers(64, 513)``,
    written as ``.npy`` files, through ``cli.main([dir, "-o", ckpt, "--tol",
    "1e-8", "--highacc", "--metrics", ...])``: every block without an
    error (at max(5e-8, 1.5 opt)), three blocks' stored factors giving
    their recorded residual, at most 2 % of the blocks on a fallback; then
    the manifest's last 100 rows deleted and ``--resume``: exactly those
    100 blocks re-run, ``load_block_results`` one row per block.
24. The multi-card layer (the twin of ``__graft_entry__.dryrun_multichip``):
    ``make_mesh()`` over every card (NCCL; world size 1 on one card):
    ``compress_blocks(mesh=)`` with ``rsvd`` and ``column_id`` on eight
    2048^2 Laplace blocks at rank 16 (and ``column_id`` on four 1024^2 c64
    blocks: K2), ``compress_blocks_adaptive(mesh=)``
    on four 2048^2 blocks of phase 14's decays, ``refined_rsvd_fused_batch
    (mesh=)`` on phase 17's stack (fixed rounds and growth), phase 22's 64
    blocks through ``compress_heterogeneous(mesh=)`` (blocks/s beside the
    unsharded stream's), each bitwise the unsharded call; phase 23's
    volume through ``cli.main([..., "--mesh"])`` with ``--resume``; a
    16384^2 f32 block as a ``RowShardedOperator`` through
    ``sample_range_by_rank`` and ``SVD.compute_from_range_estimate``, its
    error the dense route's to 1e-3. Then two NCCL ranks on ``cuda:0``
    (NCCL refuses a card twice) and two Gloo ranks on ``cuda:0``
    (``--split-rank``, killed after 240 s) on a smaller stack and stream,
    held against one rank's results by the rule written in
    ``phase_mesh``; the K1 shapes the two ranks launched are held against
    the plain version after the phase.
25. The twins of ``examples/*.py`` (``rusty_compression_tpu_torch.examples``)
    through their ``run`` on the card at their default sizes, each with
    the JAX example's gates (and, where it prints without a gate, the
    ones ``phase_examples`` names): the interpolative decomposition, the
    adaptive sampler, ``high_accuracy`` (2048^2, tol 1e-8),
    ``high_accuracy_id`` (1500x500), ``complex_operators`` (1024^2 c64,
    rank 27: K2), ``block_workload`` (eight blocks, checkpoint, block 3
    lost and recovered) and ``hmatrix`` at 3000 points (the f64 twins'
    K3 launches counted and held after the phase); then ``hmatrix`` at
    32,768 points: 12,894 far-field blocks (8.3 GB f64,
    sides up to 2048) in one tolerance stream on the card, 8,906 dense
    blocks, the matvec within 50 tol of the dense operator.

The four launch counts are set to 0 just before each of phases 3-25 and
read just after it; a kernel that a phase's path must run and that it
launched no time fails the run. Every K1/K2 panel shape that a phase
launched has to be one that phase 2 held against the plain version; a
shape whose size depends on the data (the rank a tolerance found) is held
right after its phase, outside the count, as is every K3/K4 shape phase 2
did not hold (the 1e-8 cores are as wide as the capture found). The line
before the last is a JSON object with each kernel's launches, error, times
and bound; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Throughput is block bytes over the wall time of one call. A kernel's bound
is the larger of its bytes (each input read once, each output written
once) over 3.35 TB/s and its operations over 67 TFLOP/s, the H100 SXM's
published peak for the type: f32 outside the tensor cores for K1 and K2
(TF32 is a lower precision), f64 on the tensor cores for K3 and K4 (FP64
DMMA is IEEE f64). No single PyTorch call computes a
column-pivoted QR (``torch.linalg.qr`` does not pivot), so ``library_ms``
is null for all four kernels.

``--profile`` also runs ``torch.profiler`` over six warm calls of each of
phases 3-21 (three of the ID stream of 22, of a 128-block refined stream
of 23 and of the ID stream on the mesh of 24, two of the H-matrix of 25
at each of its sizes) and prints, per phase, the wall time per call with
the tracing on, the device-busy time, the idle share, the kernels per
call (per chunk of a stream, per block of the H-matrix) and the device
time by kernel name.
"""

from __future__ import annotations

import json
import logging
import math
import statistics
import subprocess
import sys
import time

#: What each kernel replaces, by wrapper name; entry point, dtype and
#: tolerance come from ``ops.kernels.qrcp.KERNELS``.
KERNELS = {
    "qrcp_panel": "rusty_compression_tpu/ops/pallas/qrcp.py:41",
    "qrcp_panel_complex": "rusty_compression_tpu/ops/pallas/qrcp.py:150",
    # no Pallas kernel: the JAX package's host ?geqp3 and its jnp loop
    "qrcp_panel_f64": "rusty_compression_tpu/highacc_id.py:64, "
                      "rusty_compression_tpu/ops/pivoted_qr.py:62",
    "qrcp_panel_c128": "rusty_compression_tpu/highacc_id.py:64, "
                       "rusty_compression_tpu/ops/pivoted_qr.py:62",
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
F32_FLOP_PER_S = 67e12      # f32 outside the tensor cores, published
F64_FLOP_PER_S = 67e12      # f64 on the tensor cores (IEEE f64), published


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


def panel_bound(shape, k: int, dtype, masked: bool) -> dict:
    """Least time the card could take for one panel call: bytes (the panel
    and the mask read once, q, r and piv written once) over the memory
    rate, against operations over the card's peak rate for the type (f32
    outside the tensor cores for K1 and K2, as TF32 is a lower precision;
    f64 on the tensor cores for K3 and K4). Operations: the R row and the
    rank-1 downdate over the panel (4 m n a step), and the
    reorthogonalization of step i against Q (4 m i, 2 m k^2 in all); real
    operations in a real type, four times as many in a complex one. Every
    one of the k steps runs whatever the data."""
    from rusty_compression_tpu_torch.ops.kernels.qrcp import WIDE_DTYPES

    *batch, m, n = shape
    count = math.prod(batch)
    itemsize = dtype.itemsize
    nbytes = count * (itemsize * (m * n + m * k + k * n) + 4 * k
                      + (4 * n if masked else 0))
    ops = count * (4 if dtype.is_complex else 1) * (
        4 * m * n * k + 2 * m * k * k)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / (F64_FLOP_PER_S if dtype in WIDE_DTYPES
                    else F32_FLOP_PER_S) * 1e3
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


def phase_build() -> None:
    from rusty_compression_tpu_torch.ops.kernels import library

    t0 = time.perf_counter()
    built = library.build()
    seconds = time.perf_counter() - t0
    by_source: dict[str, list[str]] = {}
    for entry, (source, _) in library.ENTRY_POINTS.items():
        by_source.setdefault(source, []).append(entry)
        library.entry(entry)
    for source, entries in by_source.items():
        path, report = built[entries[0]]
        say("1-build", source=source, entries=entries, seconds_all=seconds,
            library=path.name,
            ptxas=[line.strip() for line in report.splitlines()
                   if "registers" in line or "spill" in line])


def distinct_norm_panel(torch, gen, shape, dtype):
    """Gaussian columns scaled by geomspace(1, 0.1): distinct norms."""
    n = shape[-1]
    real = dtype.to_real() if dtype.is_complex else dtype
    scale = torch.logspace(0.0, -1.0, n, device="cuda", dtype=real)
    a = torch.randn(shape, generator=gen, device="cuda", dtype=real)
    if dtype.is_complex:
        a = torch.complex(a, torch.randn(shape, generator=gen,
                                         device="cuda", dtype=real))
    return a * scale


#: Phase 2's cases, (shape, k, mask): mask False, True (every seventh
#: column used) or "slice" (the first CTA's whole slice used); for K1 and
#: K2 an optional fourth element forces a grid layout code over the most
#: CTAs the grid takes. The first case of each kernel is the shape whose
#: times go into the ``kernels`` line.
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
        # a whole block of the stack, K1 forced: auto goes blocked there
        # (its working set is over the JAX package's 12 MiB bound), and
        # the route line times both
        ((8, 2048, 2048), 16, False),
        # Q does not replicate in a CTA: one cooperative grid a panel.
        # Config 2 in f32 (layout 1, Q split over 32 CTAs), ragged and
        # masked, a stack of two, 16 columns of Q a CTA, the blocked pivot
        # rule's shortlist at block_size=256; gs at (4096, 100) and a
        # 2048-row panel (2, Q in L2); 20000 rows (3, the CTAs' vectors in
        # global memory); layout 4 (warps over Q in L2), which the rule
        # gives no f32 panel, forced (the fourth element: its code)
        ((1024, 1024), 64, False), ((1024, 1021), 64, True),
        ((2, 1024, 1024), 64, False), ((640, 192), 96, False),
        ((264, 512), 256, True), ((4096, 100), 100, False),
        ((2048, 256), 64, False), ((20000, 40), 32, False),
        ((1000, 1000), 200, False, 4)],
    "qrcp_panel_complex": [
        ((53, 8192), 43, False),      # core of the 8192^2 complex ID
        ((43, 8192), 43, False), ((136, 256), 128, True),
        ((37, 301), 29, True), ((8, 24, 2048), 16, False),
        ((53, 8191), 43, True),       # ragged, residual in L2
        ((43, 8192), 43, "slice"), ((600, 40), 8, False),
        # the complex example at 1024^2, rank 27: the core of the planar
        # two-sided ID, the LQ of C, the full-width pivot rule of
        # compress(RANK(27, "two_sided_id"))'s 35-row sketch
        ((37, 1024), 27, False), ((27, 1024), 27, False),
        ((35, 1024), 27, True),
        # K2 on the grid: layout 1, ragged and masked, a stack of two; gs
        # at (2048, 100) (2); 12000 rows (3); layout 4 forced
        ((1024, 512), 64, False), ((1024, 509), 64, True),
        ((2, 1024, 512), 64, False), ((2048, 100), 100, False),
        ((12000, 40), 32, False), ((1000, 1000), 200, False, 4)],
    # K3 and K4: (shape, k, mask, norm rule)
    "qrcp_panel_f64": [
        ((256, 8192), 256, False, "recompute"),   # config 4h's core
        ((169, 8192), 169, False, "recompute"),   # 4h: the LQ of C
        ((32, 1024), 32, False, "recompute"),     # config 2h's core
        ((72, 1024), 64, True, "downdate"),       # config 2's f64 sketch
        ((453, 1500), 453, False, "recompute"),   # the example's LQ of C
        ((500, 500), 480, False, "recompute"),    # the example's core
        ((256, 8192), 256, False, "downdate"),    # the other rule, grid
        ((32, 1024), 32, False, "downdate"),      # the other rule, cluster
        ((72, 1024), 64, True, "recompute"),
        ((37, 301), 29, True, "downdate"),        # ragged, masked
        ((169, 8191), 100, True, "recompute"),    # ragged grid, masked
        ((24, 16389), 16, "slice", "downdate"),   # one CTA's slice masked
        ((8, 24, 2048), 16, False, "downdate"),   # a stack's sketch
        ((2, 169, 8192), 64, False, "recompute"),  # a stack on the grid
        ((600, 40), 8, False, "recompute"),       # few columns a CTA
        # f64 gs over the JAX package's 12 MiB working set: a tall panel
        # (residual in L2), and a 16384-row range sketch whose CTA vectors
        # lie in global memory
        ((4096, 512), 64, False, "downdate"),
        ((16384, 58), 50, False, "downdate")],
    "qrcp_panel_c128": [
        ((96, 2048), 96, False, "recompute"),     # a c128 core (grid)
        ((64, 2048), 64, False, "recompute"),     # config 6c's core (grid)
        ((70, 2048), 70, True, "recompute"),
        ((96, 2048), 96, False, "downdate"),
        ((37, 301), 29, True, "downdate"),
        ((24, 1024), 24, False, "recompute"),     # a core on a cluster
        ((8, 24, 2048), 16, False, "downdate"),
        ((600, 40), 8, False, "recompute"),
        ((8192, 40), 32, False, "downdate")],     # vectors in global memory
}


class KernelChecks:
    """Phase 2: each kernel against its plain version, shape by shape.
    ``held`` keeps, per kernel, the ``((panels, m, n), k, masked)`` that
    passed (and the norm rule for K3, K4), in the form the wrappers record
    what they launched."""

    def __init__(self, torch, k1, gen):
        self.torch, self.k1, self.gen = torch, k1, gen
        self.held = {name: set() for name in KERNELS}
        self.worst = {name: 0.0 for name in KERNELS}
        self.main = {}

    def hold(self, name: str, shape, k: int, masked, norms=None,
             reps: int = 10, code=None) -> None:
        from rusty_compression_tpu_torch.ops.kernels.sweep import device_ms

        torch, k1 = self.torch, self.k1
        wrapper, spec = getattr(k1, name), k1.KERNELS[name]
        wide, tol = spec.wide, spec.tol
        rule = {"norms": norms} if wide else {}
        a = distinct_norm_panel(torch, self.gen, shape, spec.dtype)
        m, n = shape[-2:]
        if code is None:
            layout = k1.panel_layout(m, n, k, a.element_size(), wide)
            fn = lambda a, k, used: wrapper(  # noqa: E731
                a, k, used=used, **rule)
        else:
            layout = k1.layout_at(m, n, k, a.element_size(),
                                  k1.grid_counts(n)[-1], wide, code)
            fn = lambda a, k, used: k1._panel(  # noqa: E731
                wrapper, a, k, used, layout, norms)
        used = None
        if masked:
            used = torch.zeros(shape[-1], dtype=torch.bool, device="cuda")
            if masked == "slice":
                check(layout.cluster > 1, f"{shape} is not clustered")
                used[:layout.width] = True
            else:
                used[::7] = True
        q, r, piv = fn(a, k, used)
        plain = lambda: k1.qrcp_panel_plain(  # noqa: E731
            a, k, used, norms or "downdate")
        q0, r0, piv0 = plain()
        torch.cuda.synchronize()
        check(torch.equal(piv.long(), piv0),
              f"{name} pivots at {shape} k={k} {norms}")
        err = max(float((q - q0).abs().max()), float((r - r0).abs().max()))
        check(err <= tol, f"{name} |q|, |r| error {err} at {shape} k={k}")
        again = fn(a, k, used)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip((q, r, piv), again)),
              f"{name} at {shape} k={k}: two launches differ")
        times = {"ms": event_ms(lambda: fn(a, k, used), reps),
                 "device_ms": device_ms(torch, lambda: fn(a, k, used)),
                 "plain_ms": event_ms(plain, reps),
                 **panel_bound(shape, k, a.dtype, masked)}
        say("2-kernel", kernel=name, shape=list(shape), k=k,
            used_mask=masked, **rule, cluster=layout.cluster,
            layout=layout.code, forced=code is not None,
            resid_in_smem=layout.resid_in_smem,
            q_share=layout.q_share,
            smem_bytes=layout.smem_bytes, threads=layout.threads,
            pivots_equal=True, repeat_bitwise=True, max_abs_err=err, **times)
        self.worst[name] = max(self.worst[name], err)
        self.main.setdefault(name, times)
        panels = shape[0] if len(shape) == 3 else 1
        key = ((panels, *shape[-2:]), k, bool(masked))
        self.held[name].add((*key, norms) if wide else key)

    def hold_launched(self, name: str, allowed) -> None:
        """Hold the shapes ``name`` launched and phase 2 has not seen, if
        ``allowed(shape, k, masked)`` says their size depends on the data
        (every K3/K4 shape: the 1e-8 cores are as wide as the capture
        found); any other unseen shape fails the run."""
        launched = getattr(self.k1, name).launched_shapes
        for shape, k, masked, *norms in sorted(launched - self.held[name]):
            check(self.k1.KERNELS[name].wide or allowed(shape, k, masked),
                  f"{name} was launched at {shape} k={k} masked={masked}, "
                  f"a shape that phase 2 did not hold")
            self.hold(name, shape if shape[0] > 1 else shape[1:], k, masked,
                      *norms, reps=5)

    def summary(self) -> dict:
        return {name: {"max_abs_err": self.worst[name], **self.main[name]}
                for name in KERNELS}


def phase_kernel(torch, k1, gen) -> KernelChecks:
    checks = KernelChecks(torch, k1, gen)
    for name, cases in KERNEL_CASES.items():
        wide = k1.KERNELS[name].wide
        for shape, k, masked, *extra in cases:
            if wide:   # the norm rule
                checks.hold(name, shape, k, masked, *extra)
            else:      # a forced grid layout code
                checks.hold(name, shape, k, masked, code=(extra or [None])[0])
    torch.cuda.synchronize()
    return checks


#: K5's phase-2 shapes (batch, m, n) and types: cell 4's 64 sketches of
#: the 16384^2 f32 stack, the f64 (8192, n) rounds of the tol 1e-8
#: capture (the 128-wide one stays on cuSOLVER in the route, timed here
#: beside it), one H-matrix bucket of the adaptive range finder.
TSQR_CASES = [((64, 16384, 21), "float32"), ((1, 8192, 32), "float64"),
              ((1, 8192, 64), "float64"), ((1, 8192, 128), "float64"),
              ((400, 256, 8), "float64")]


def phase_tsqr(torch, gen) -> dict:
    """Phase 2 for K5: each case against the plain version (Q within 1e-4
    in f32, 1e-10 in f64; ||Q^T Q - I|| and ||QR - Y|| / ||Y|| within
    10 n u), two calls bitwise equal, one launch a call, and the times:
    the wrapper's, the kernel's on a busy card, the plain version's, the
    bound, and ``torch.linalg.qr``'s as ``library_ms``. Returns the first
    case's row."""
    from rusty_compression_tpu_torch.ops.kernels import tsqr
    from rusty_compression_tpu_torch.ops.kernels.sweep import device_ms

    rows = []
    for shape, name in TSQR_CASES:
        dtype = getattr(torch, name)
        y = distinct_norm_panel(torch, gen, shape, dtype)
        n = shape[-1]
        u = float(torch.finfo(dtype).eps) / 2
        before = tsqr.tsqr.launch_count
        q, r = tsqr.tsqr(y, want_r=True)
        q2, r2 = tsqr.tsqr(y, want_r=True)
        torch.cuda.synchronize()
        check(tsqr.tsqr.launch_count == before + 2,
              f"tsqr launched other than once a call at {shape}")
        check(torch.equal(q, q2) and torch.equal(r, r2),
              f"tsqr at {shape}: two calls differ")
        eye = torch.eye(n, dtype=dtype, device="cuda")
        orth = float((q.mT @ q - eye).abs().max())
        resid = float((q @ r - y).norm() / y.norm())
        check(orth <= 10 * n * u and resid <= 10 * n * u,
              f"tsqr at {shape}: orth {orth}, resid {resid}")
        q0, _ = tsqr.tsqr_plain(y)
        err = float((q - q0).abs().max())
        check(err <= (1e-4 if name == "float32" else 1e-10),
              f"tsqr at {shape}: |Q - Q_plain| {err}")
        plan = tsqr.tsqr_plan(*shape, y.element_size())
        row = {"ms": event_ms(lambda: tsqr.tsqr(y)),
               "device_ms": device_ms(torch, lambda: tsqr.tsqr(y)),
               "plain_ms": event_ms(lambda: tsqr.tsqr_plain(y), 3),
               **tsqr.bound_ms(*shape, y.element_size()),
               "library_ms": device_ms(torch, lambda: torch.linalg.qr(y))}
        say("2-kernel", kernel="tsqr", shape=list(shape), dtype=name,
            groups=plan.groups, rows=plan.rows, leaves=plan.leaves,
            height=plan.height, orth=orth, resid=resid, max_abs_err=err,
            repeat_bitwise=True,
            route=tsqr.kernel_takes(y.device, dtype, *shape), **row)
        rows.append({"max_abs_err": err, **row})
    return rows[0]


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


def phase_route(torch, gen, count: int = 8, size: int = 2048,
                rank: int = 16) -> None:
    """The two routes of a whole 2048^2 f32 block at k = 16 (phase 14's
    stack): K1 forced (``mode="kernel"``, the residual in L2) and ``auto``,
    which takes the JAX package's blocked RRQR there (the working set is
    over its 12 MiB bound). CUDA-event medians of 10 calls, in the order
    kernel, auto, auto, kernel; both held to cell 14's gates (rel err <=
    5e-2, the ID's columns those of the block)."""
    from rusty_compression_tpu_torch import parallel, pivoted_qr
    from rusty_compression_tpu_torch.ops.pivoted_qr import _resolve_mode

    blocks = laplace_blocks(torch, gen, count, size)
    check(_resolve_mode("auto", size, size, rank, blocks.dtype,
                        blocks.device) == "blocked",
          "auto does not take the blocked route at a whole 2048^2 block")
    times = {"kernel": [], "auto": []}
    for mode in ("kernel", "auto", "auto", "kernel"):
        def qr(mode=mode):
            return pivoted_qr(blocks, rank, mode=mode,
                              generator=same_state(gen))

        def cid(mode=mode):
            return parallel.batched_column_id(blocks, same_state(gen), rank,
                                              mode=mode, block_size=128)

        got = cid()
        err = float(parallel.batched_rel_diff_fro(got, blocks).max())
        cols = torch.take_along_dim(blocks, got.col_ind[:, None, :rank],
                                    dim=-1)
        col_err = float((got.c - cols).abs().max() / cols.abs().max())
        check(math.isfinite(err) and err <= 5e-2 and col_err <= 1e-4,
              f"column ID ({mode}) rel err {err}, columns {col_err}")
        times[mode].append({"pivoted_qr_ms": event_ms(qr),
                            "column_id_ms": event_ms(cid),
                            "max_rel_err": err, "column_err": col_err})
    say("2-route-2048", blocks=[count, size, size], rank=rank,
        auto_resolves_to=_resolve_mode("auto", size, size, rank,
                                       blocks.dtype, blocks.device),
        kernel=times["kernel"], auto=times["auto"])


def phase_route_gs(torch, k1) -> None:
    """``pivoted_qr(mode="gs")`` on the card: the dtype's kernel (K1-K4) at
    every shape, one launch a call (a panel a launch on the grid), with no
    plain fallback (an f64 panel over the JAX package's 12 MiB working
    set, a stack of four dimensions, a tall c128 panel whose CTA vectors
    lie in global memory, f32 and c64 panels whose Q does not replicate in
    a CTA), ``(q, r, ind)`` as the plain loop's on the same tensor (pivots
    equal, q and r within the kernel's tolerance). CUDA-event medians of
    the call and of the plain loop."""
    from rusty_compression_tpu_torch import pivoted_qr
    from rusty_compression_tpu_torch.ops.pivoted_qr import _full_permutation

    gen = torch.Generator(device="cuda").manual_seed(26)
    for shape, k, dtype in (((4096, 512), 64, torch.float64),
                            ((2, 2, 300, 200), 40, torch.float64),
                            ((8192, 40), 32, torch.complex128),
                            ((4096, 100), 100, torch.float32),
                            ((2048, 100), 100, torch.complex64)):
        spec = k1.KERNELS[k1.PANEL_KERNELS[dtype].__name__]
        wrapper = k1.PANEL_KERNELS[dtype]
        a = distinct_norm_panel(torch, gen, shape, dtype)
        panels = math.prod(shape[:-2])
        layout = k1.panel_layout(*shape[-2:], k, a.element_size(), spec.wide)
        want = panels if layout.grid else 1   # the grid: a launch a panel
        before = wrapper.launch_count
        q, r, ind = pivoted_qr(a, k, mode="gs")
        torch.cuda.synchronize()
        check(wrapper.launch_count - before == want,
              f"gs at {shape} {dtype}: {wrapper.launch_count - before} "
              f"{spec.entry} launches, not {want}")
        q0, r0, piv0 = k1.qrcp_panel_plain(a, k)
        ind0 = _full_permutation(piv0, shape[-1])
        r0 = torch.triu(torch.take_along_dim(r0, ind0.unsqueeze(-2), dim=-1))
        err = max(float((q - q0).abs().max()), float((r - r0).abs().max()))
        check(torch.equal(ind, ind0) and err <= spec.tol,
              f"gs at {shape} {dtype}: pivots or factors ({err}) differ "
              f"from the plain loop's")
        say("2-route-gs", shape=list(shape), k=k, dtype=str(dtype),
            kernel=spec.entry, launches=want, layout=layout.code,
            vectors_in_smem=layout.vectors_in_smem,
            pivots_equal=True, max_abs_err=err,
            gs_ms=event_ms(lambda: pivoted_qr(a, k, mode="gs")),
            plain_ms=event_ms(lambda: k1.qrcp_panel_plain(a, k), reps=3))


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


#: Config 2 in f32 on the TPU, where ``auto`` took the Pallas kernel over
#: the whole panel (``BENCH_SUITE.jsonl``, ``2-column-id``): printed beside
#: the card's rank and error, not a gate.
TPU_CONFIG_2 = {"rank": 10, "rel_err": 1.930e-4}


def phase_hilbert(torch, rt, k1, gen, size: int = 1024):
    """Config 2, through the call the benchmark makes, at its defaults. In
    f32 ``auto`` takes K1 over the whole (1024, 1024) panel at k = 64, as
    the JAX package takes its Pallas kernel there (a working set of 8.9 MB,
    under its 12 MiB bound): one launch, a cooperative grid, since Q does
    not replicate in a CTA. In f64 it goes blocked with one 64-wide panel,
    and at small rank runs the pivot rule over the whole width of the (72,
    1024) sketch: K3."""
    from rusty_compression_tpu_torch.utils.kernel_matrices import hilbert

    runs = []
    for dtype, tol, col_gate, kernel, shape in (
            (torch.float32, 1e-5, 1e-5, k1.qrcp_panel,
             ((1, size, size), 64, False)),
            (torch.float64, 1e-8, 1e-12, k1.qrcp_panel_f64,
             ((1, 72, size), 64, True, "downdate"))):
        h = hilbert(size, dtype=dtype, device=gen.device)
        s = torch.linalg.svdvals(h.double())

        def run(h=h, tol=tol):
            qr = rt.QR.compute_from(h, max_rank=64, generator=gen)
            return qr.compress(rt.CompressionType.ADAPTIVE(tol)).column_id()

        before = kernel.launch_count
        kernel.launched_shapes.clear()
        cid = run()
        torch.cuda.synchronize()
        launches = kernel.launch_count - before
        check(launches == 1 and kernel.launched_shapes == {shape},
              f"config 2 ({dtype}): {launches} {kernel.__name__} launches "
              f"at {kernel.launched_shapes}")
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
            column_abs_err=col_err, kernel=kernel.__name__,
            launched=[list(shape[0]), *shape[1:]],
            launches_per_call=launches, ms=ms,
            tpu=TPU_CONFIG_2 if dtype == torch.float32 else None,
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


# ---------------------------------------------------------------------------
# Phases 15-21: the tol <= 1e-8 pipelines in f64 / c128 (no kernel)
# ---------------------------------------------------------------------------


def decay_block(torch, rng, size: int, inner: int, decay_rank: int,
                complex_: bool = False, floor: float = 0.0):
    """``U diag(max(10^(-10 i / (decay_rank - 1)), floor)) V^H`` with U, V the
    Q factors of host numpy Gaussians (size, inner), the product in f64 /
    c128 on the card; and the index of the spectrum's 1e-8 crossing."""
    import numpy as np

    sig = np.maximum(10.0 ** (-10.0 * np.arange(inner) / (decay_rank - 1)),
                     floor)

    def basis():
        g = rng.standard_normal((size, inner))
        if complex_:
            g = g + 1j * rng.standard_normal((size, inner))
        return torch.from_numpy(np.linalg.qr(g)[0]).cuda()

    u, v = basis(), basis()
    cross = int(np.argmax(sig / sig[0] < 1e-8))
    return (u * torch.from_numpy(sig).cuda().to(u.dtype)) @ v.mH, cross


def rel_fro(torch, got, a) -> float:
    return float(torch.linalg.norm(got - a) / torch.linalg.norm(a))


def svd_rel(torch, out, a) -> float:
    """``||A - U S V^H|| / ||A||`` on the card in the block's dtype."""
    return rel_fro(torch, out.u @ (out.s.to(out.u.dtype)[:, None] * out.vt),
                   a)


def reads_of(ha, fn):
    """``(result, host reads)`` of one call of ``fn``."""
    before = ha._read.count
    out = fn()
    return out, ha._read.count - before


def refined_line(phase, torch, ha, run, a, gate, cross=None, reps=5,
                 **fields):
    """Drive ``run`` once (gates: residual, rank at the crossing +- 10), then
    time it; print one line. Returns the first result."""
    out, reads = reads_of(ha, run)
    torch.cuda.synchronize()
    err = svd_rel(torch, out, a)
    check(math.isfinite(err) and err <= gate,
          f"{phase} rel err {err} > {gate}")
    if cross is not None:
        check(abs(out.rank - cross) <= 10,
              f"{phase} rank {out.rank}, crossing {cross}")
    ms = wall_ms(run, reps=reps)
    say(phase, block=list(a.shape), dtype=str(a.dtype), rank=out.rank,
        crossing=cross, rel_err=err, gate=gate, host_reads=reads, ms=ms,
        gbps=a.numel() * a.element_size() / (ms * 1e-3) / 1e9,
        opt_resid=out.opt_resid, history=list(out.history)[:8], **fields)
    return out


def config_6_block(torch):
    import numpy as np

    return decay_block(torch, np.random.default_rng(6), 4096, 160, 120)


def phase_refined_rsvd(torch, rt, gen):
    """Config 6: 4096^2 f64, sigma_i = 10^(-10 i / 119) over 160 terms,
    round_rank 132, one refinement round; and the card's small SVD of the
    core against numpy's on the same core."""
    import numpy as np

    from rusty_compression_tpu_torch import highacc as ha

    a, cross = config_6_block(torch)
    runs = []
    for entry in ("refined_rsvd", "refined_rsvd_fused"):
        run = lambda f=getattr(rt, entry): f(  # noqa: E731
            a, gen, round_rank=132, tol=1e-8, refine_rounds=1)
        refined_line("15-refined-rsvd-4096", torch, ha, run, a, 5e-8, cross,
                     entry=entry)
        runs.append(run)
    _, b, _, _ = rt.refined_capture(a, gen, round_rank=132)
    want = np.linalg.svd(b.cpu().numpy(), compute_uv=False)
    # the pipeline's route (QR of the core, SVD of its R factor), then
    # cuSOLVER's SVD of the whole core with each driver, for the record
    routes = [("qr+svd", lambda: ha._core_svd(b))] + [
        (driver or "default", lambda d=driver: torch.linalg.svd(
            b, full_matrices=False, driver=d))
        for driver in (None, "gesvd", "gesvdj")]
    for route, fn in routes:
        err = float(np.abs(fn()[1].cpu().numpy() - want).max() / want[0])
        if route == "qr+svd":
            check(err <= 1e-9, f"core singular values off numpy's by {err}")
        say("15-core-svd", core=list(b.shape), route=route,
            max_abs_err_over_s0=err, ms=event_ms(fn, reps=5))
    return lambda: [run() for run in runs]


def phase_growth(torch, rt, gen):
    """Config 1h: 512^2 f64, rng(18), decay 120, tol alone."""
    import numpy as np

    from rusty_compression_tpu_torch import highacc as ha

    a, cross = decay_block(torch, np.random.default_rng(18), 512, 512, 120,
                           floor=1e-12)
    run = lambda: rt.refined_rsvd_fused(a, gen, tol=1e-8)  # noqa: E731
    refined_line("16-growth-512", torch, ha, run, a, 5e-8, cross)
    return run


def config_1hb_stack(torch):
    import numpy as np

    dks = [30 + 10 * (i % 4) for i in range(8)]
    blocks = []
    for i, dk in enumerate(dks):
        sig = np.maximum(10.0 ** (-10.0 * np.arange(256) / (dk - 1)), 1e-12)
        u = np.linalg.qr(np.random.default_rng(50 + i)
                         .standard_normal((256, 256)))[0]
        v = np.linalg.qr(np.random.default_rng(80 + i)
                         .standard_normal((256, 256)))[0]
        blocks.append((u * sig) @ v.T)
    crossings = [int(np.argmax(10.0 ** (-10.0 * np.arange(256) / (dk - 1))
                               < 1e-8)) for dk in dks]
    return torch.from_numpy(np.stack(blocks)).cuda(), crossings


def check_stack(torch, phase, outs, stack, crossings, lanes):
    errs = []
    for i in lanes:
        o = outs[i]
        err = svd_rel(torch, o, stack[i])
        check(o.tol_ok and math.isfinite(err) and err <= 5e-8
              and abs(o.rank - crossings[i]) <= 10,
              f"{phase} block {i}: tol_ok {o.tol_ok}, rank {o.rank} "
              f"(crossing {crossings[i]}), rel err {err}")
        errs.append(err)
    return errs


def phase_batched_growth(torch, rt, gen):
    """Config 1hb: eight 256^2 blocks, decays 30/40/50/60 twice; the batched
    growth, then fixed rounds (round_rank 56, ``on_unreachable="mark"``)
    with block 0 a Gaussian block."""
    from rusty_compression_tpu_torch import highacc as ha

    stack, crossings = config_1hb_stack(torch)
    run = lambda: rt.refined_rsvd_fused_batch(stack, gen, tol=1e-8)  # noqa: E731
    outs, reads = reads_of(ha, run)
    errs = check_stack(torch, "17-batched-growth", outs, stack, crossings,
                       range(8))
    ms = wall_ms(run, reps=5)
    say("17-batched-growth", blocks=list(stack.shape), ranks=[
        o.rank for o in outs], crossings=crossings, max_rel_err=max(errs),
        host_reads=reads, ms=ms, blocks_per_s=8 / (ms * 1e-3),
        gbps=stack.numel() * 8 / (ms * 1e-3) / 1e9)

    marked = stack.clone()
    marked[0] = torch.randn((256, 256), generator=gen, device="cuda",
                            dtype=torch.float64)
    run_m = lambda: rt.refined_rsvd_fused_batch(  # noqa: E731
        marked, gen, round_rank=56, tol=1e-8, on_unreachable="mark")
    outs, reads = reads_of(ha, run_m)
    check(not outs[0].tol_ok, "the Gaussian block was not marked")
    errs = check_stack(torch, "17-fixed-round-mark", outs, marked, crossings,
                       range(1, 8))
    ms = wall_ms(run_m, reps=5)
    say("17-fixed-round-mark", blocks=list(marked.shape),
        ranks=[o.rank for o in outs], tol_ok=[o.tol_ok for o in outs],
        max_rel_err_unmarked=max(errs), host_reads=reads, ms=ms,
        gbps=marked.numel() * 8 / (ms * 1e-3) / 1e9)
    return lambda: (run(), run_m())


def core_pivots_as_geqp3(torch, rt, a, gen, rank: int):
    """The core that the ID's capture builds (a generator in ``gen``'s
    state), pivoted on the card by K3/K4 (``_core_qrcp``, norm rule
    ``recompute``), by the plain rule on the card (``qrcp_core_plain``)
    and by scipy's ``?geqp3`` on the host: ``ind[:rank]`` must be equal
    in all three. Returns the first index where the kernel's part from
    ``?geqp3``'s and from the plain rule's, and the ms of the kernel's and
    the plain rule's pivot rule on that core (host clock, synchronised)."""
    import numpy as np
    import scipy.linalg

    from rusty_compression_tpu_torch.highacc_id import _core_qrcp
    from rusty_compression_tpu_torch.ops.kernels.qrcp import qrcp_core_plain
    from rusty_compression_tpu_torch.ops.pivoted_qr import _full_permutation

    _, b, _, _ = rt.refined_capture(a, same_state(gen), tol=1e-8)
    _, ind = _core_qrcp(b)
    plain = lambda: qrcp_core_plain(b)  # noqa: E731
    plain_ind = _full_permutation(plain()[2], b.shape[1]).cpu().numpy()
    _, _, piv = scipy.linalg.qr(b.cpu().numpy(), mode="economic",
                                pivoting=True)
    ind = ind.cpu().numpy()
    check(np.array_equal(ind[:rank], piv[:rank]),
          f"core pivots differ from ?geqp3's before the rank {rank}")
    check(np.array_equal(ind[:rank], plain_ind[:rank]),
          f"core pivots differ from the plain rule's before the rank {rank}")

    def first_difference(other):
        differ = np.nonzero(ind[:len(other)] != other[:len(ind)])[0]
        return int(differ[0]) if differ.size else min(len(other), len(ind))

    return (first_difference(piv),
            {"core": list(b.shape), "dtype": str(b.dtype),
             "pivots_as_plain_to": first_difference(plain_ind),
             "pivot_rule_ms": wall_ms(lambda: _core_qrcp(b), reps=3),
             "plain_pivot_rule_ms": wall_ms(plain, reps=3)})


def launches_of(kernel, fn):
    """``(result, launches of kernel)`` of one call of ``fn``."""
    before = kernel.launch_count
    out = fn()
    return out, kernel.launch_count - before


def phase_hilbert_id(torch, rt, gen):
    """Config 2h: f64 ``hilbert(1024)``, ``refined_column_id(tol=1e-8)``."""
    from rusty_compression_tpu_torch import highacc as ha
    from rusty_compression_tpu_torch.utils.kernel_matrices import hilbert

    from rusty_compression_tpu_torch.ops.kernels import qrcp as k1

    h = hilbert(1024, dtype=torch.float64, device="cuda")
    twin = same_state(gen)
    run = lambda: rt.refined_column_id(h, gen, tol=1e-8)  # noqa: E731
    (cid, reads), k3 = launches_of(k1.qrcp_panel_f64,
                                   lambda: reads_of(ha, run))
    check(k3 == 1, f"config 2h: {k3} K3 launches a call, not 1")
    agree, pivot_rule = core_pivots_as_geqp3(torch, rt, h, twin, cid.rank)
    check(torch.equal(rt.refined_column_id(h, same_state(twin),
                                           tol=1e-8).col_ind, cid.col_ind),
          "same generator state, other pivots")
    err = rel_fro(torch, cid.c @ cid.z, h)
    check(math.isfinite(err) and err <= 5e-8, f"config 2h rel err {err}")
    check(torch.equal(cid.c, h[:, cid.col_ind[:cid.rank]]),
          "config 2h columns are not bitwise")
    ms = wall_ms(run, reps=5)
    say("18-hilbert-column-id", size=1024, rank=cid.rank, rel_err=err,
        gate=5e-8, columns_bitwise=True, k3_launches_per_call=k3,
        pivots_as_geqp3_to=agree,
        **pivot_rule, host_reads=reads, ms=ms, gbps=h.numel() * 8 / (ms * 1e-3) / 1e9)
    return run


def phase_two_sided_refined(torch, rt, gen, size: int = 8192):
    """Config 4h: 8192^2 f64 Laplace block between two clouds of
    ``rng(44)`` 3 apart, ``refined_two_sided_id(tol=1e-8)``."""
    import numpy as np

    from rusty_compression_tpu_torch import highacc as ha
    from rusty_compression_tpu_torch.ops.kernels import qrcp as k1
    from rusty_compression_tpu_torch.utils.kernel_matrices import (
        laplace_kernel_block)

    rng = np.random.default_rng(44)
    x = rng.uniform(-1.0, 1.0, (size, 3))
    y = rng.uniform(-1.0, 1.0, (size, 3))
    y[:, 0] += 3.0
    a = laplace_kernel_block(torch.from_numpy(x).cuda(),
                             torch.from_numpy(y).cuda())
    twin = same_state(gen)
    run = lambda: rt.refined_two_sided_id(a, gen, tol=1e-8)  # noqa: E731
    (ts, reads), k3 = launches_of(k1.qrcp_panel_f64,
                                  lambda: reads_of(ha, run))
    check(k3 == 2, f"config 4h: {k3} K3 launches a call, not 2")
    agree, pivot_rule = core_pivots_as_geqp3(torch, rt, a, twin, ts.rank)
    k = ts.rank
    err = rel_fro(torch, ts.c @ (ts.x @ ts.r), a)
    check(math.isfinite(err) and err <= 1e-7, f"config 4h rel err {err}")
    check(torch.equal(ts.x, a[ts.row_ind[:k][:, None], ts.col_ind[:k]]),
          "config 4h skeleton is not bitwise")
    ms = wall_ms(run, reps=3)
    say("19-two-sided-id-8192", block=[size, size], rank=k, rel_err=err,
        gate=1e-7, skeleton_bitwise=True, k3_launches_per_call=k3,
        pivots_as_geqp3_to=agree,
        **pivot_rule, host_reads=reads, ms=ms, blocks_per_s=1 / (ms * 1e-3),
        gbps=a.numel() * 8 / (ms * 1e-3) / 1e9)
    return run


def phase_refined_complex(torch, rt, gen):
    """Config 6c: 2048^2 c128, rng(66), decay 60 over 96 terms,
    round_rank 66; then its two-sided ID at tol 1e-8, whose two cores K4
    pivots (the gate of the JAX package's complex refined-ID tests: rel
    err <= 10 tol, skeleton bitwise)."""
    import numpy as np

    from rusty_compression_tpu_torch import highacc as ha
    from rusty_compression_tpu_torch.ops.kernels import qrcp as k1

    a, cross = decay_block(torch, np.random.default_rng(66), 2048, 96, 60,
                           complex_=True)
    runs = []
    for entry in ("refined_rsvd", "refined_rsvd_planar"):
        run = lambda f=getattr(rt, entry): f(  # noqa: E731
            a, gen, round_rank=66, tol=1e-8, refine_rounds=1)
        refined_line("20-refined-c128-2048", torch, ha, run, a, 5e-8, cross,
                     entry=entry)
        runs.append(run)

    twin = same_state(gen)
    run = lambda: rt.refined_two_sided_id(a, gen, tol=1e-8)  # noqa: E731
    (ts, reads), k4 = launches_of(k1.qrcp_panel_c128,
                                  lambda: reads_of(ha, run))
    check(k4 == 2, f"config 6c two-sided ID: {k4} K4 launches, not 2")
    agree, pivot_rule = core_pivots_as_geqp3(torch, rt, a, twin, ts.rank)
    k = ts.rank
    err = rel_fro(torch, ts.c @ (ts.x @ ts.r), a)
    check(math.isfinite(err) and err <= 1e-7,
          f"config 6c two-sided ID rel err {err}")
    check(torch.equal(ts.x, a[ts.row_ind[:k][:, None], ts.col_ind[:k]]),
          "config 6c skeleton is not bitwise")
    say("20-two-sided-id-c128-2048", block=list(a.shape), rank=k,
        crossing=cross, rel_err=err, gate=1e-7, skeleton_bitwise=True,
        k4_launches_per_call=k4, pivots_as_geqp3_to=agree, **pivot_rule,
        host_reads=reads, ms=wall_ms(run, reps=3))
    runs.append(run)
    return lambda: [run() for run in runs]


def phase_refined_front_door(torch, rt, gen):
    """``compress(ADAPTIVE(1e-8, highacc=True, round_rank=k))`` of phase
    15's block and of phase 17's stack: bitwise the direct calls."""
    from rusty_compression_tpu_torch.highacc import refined_rsvd_batch

    a, _ = config_6_block(torch)
    stack, _ = config_1hb_stack(torch)
    runs = []
    for target, k in ((a, 132), (stack, 56)):
        cfg = rt.CompressionConfig.ADAPTIVE(1e-8, highacc=True, round_rank=k)
        got = rt.compress(target, same_state(gen), cfg)
        if target.ndim == 2:
            got = [got[0]]
            want = [rt.refined_rsvd(target, same_state(gen), round_rank=k,
                                    tol=1e-8)]
        else:
            want = refined_rsvd_batch(list(target), same_state(gen),
                                      round_rank=k, tol=1e-8)
        check(len(got) == len(want) and all(
            torch.equal(getattr(x, f), getattr(y, f))
            for x, y in zip(got, want) for f in ("u", "s", "vt")),
            f"compress(highacc=True) of {list(target.shape)} is not the "
            f"direct call")
        run = lambda t=target, c=cfg: rt.compress(t, gen, c)  # noqa: E731
        say("21-front-door-highacc", target=list(target.shape), round_rank=k,
            ranks=[o.rank for o in got], equals_direct=True,
            ms=wall_ms(run, reps=3))
        runs.append(run)
    return lambda: [run() for run in runs]


# ---------------------------------------------------------------------------
# Phases 22-23: the heterogeneous block stream, checkpoints and the CLI
# ---------------------------------------------------------------------------


def stream_blocks(torch, gen, sides, dtype):
    """Admissible Laplace blocks of the given (m, n) sides, made on the card
    and handed over as host numpy arrays; the clouds of
    ``tools/_gen_blocks10k.py``: unit cubes, the sources' centred at
    (3 + 0.5 (i % 5), 0.5 (i % 3), 0)."""
    from rusty_compression_tpu_torch.utils.kernel_matrices import (
        laplace_kernel_block, random_cloud)

    blocks = []
    for i, (m, n) in enumerate(sides):
        x = random_cloud(gen, int(m), (0.0, 0.0, 0.0))
        y = random_cloud(gen, int(n), (3.0 + 0.5 * (i % 5), 0.5 * (i % 3),
                                       0.0))
        blocks.append(laplace_kernel_block(x, y, dtype=dtype).cpu().numpy())
    return blocks


def stream_line(results, blocks, seconds) -> dict:
    nbytes = sum(b.nbytes for b in blocks)
    errs = sorted(r.rel_residual for r in results)
    return {"blocks": len(results), "gbytes": nbytes / 1e9,
            "seconds": seconds, "blocks_per_s": len(results) / seconds,
            "gbps": nbytes / seconds / 1e9, "rel_err_max": errs[-1],
            "ranks": [min(r.rank for r in results),
                      max(r.rank for r in results)]}


def phase_block_stream(torch, rt, k1, gen, count: int = 64):
    """Config 5's shapes on one card: ``count`` f32 Laplace blocks with
    sides from ``default_rng(22).integers(1024, 8193)``, through
    ``compress_heterogeneous`` at rank 16 (one-read ID and rSVD) and at
    rel_tol 1e-3; then ``compress(list)`` against the direct call."""
    import numpy as np

    from rusty_compression_tpu_torch import native
    from rusty_compression_tpu_torch.parallel import (
        bucket_dim, compress_heterogeneous, plan_buckets)
    from rusty_compression_tpu_torch.parallel.scheduler import _chunks

    sides = np.random.default_rng(22).integers(1024, 8193, (count, 2))
    blocks = stream_blocks(torch, gen, sides, torch.float32)
    shapes = [b.shape for b in blocks]
    groups = plan_buckets(shapes)
    nplan = native.plan(shapes)
    check(nplan is None or nplan.groups() == groups,
          "the C++ plan differs from plan_buckets")
    chunks = len(_chunks(blocks, shapes, groups, 1, 1 << 30, False))
    calls = {
        "sketched_two_sided_id": dict(rank=16,
                                      method="sketched_two_sided_id"),
        "rsvd": dict(rank=16, method="rsvd"),
        "adaptive": dict(rel_tol=1e-3, sample_size=16)}
    runs = []
    for name, kwargs in calls.items():
        seen, skel = [], None
        torch.cuda.reset_peak_memory_stats()
        before = k1.qrcp_panel.launch_count
        t0 = time.perf_counter()
        res = compress_heterogeneous(blocks, gen, on_result=seen.append,
                                     **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = k1.qrcp_panel.launch_count - before
        check([r.index for r in res] == list(range(count))
              and [r.index for r in seen] == sorted(
                  range(count), key=lambda i: (res[i].bucket, i)),
              f"{name}: results out of order")
        check(all(r.bucket == (bucket_dim(m), bucket_dim(n))
                  and r.shape == (m, n) for r, (m, n) in zip(res, shapes)),
              f"{name}: wrong buckets")
        worst = max(r.rel_residual for r in res)
        if name == "adaptive":
            check(worst <= 5e-3 and all(r.rank % 16 == 0 for r in res),
                  f"adaptive stream: rel err {worst}, ranks "
                  f"{sorted({r.rank for r in res})}")
        else:
            check(worst <= 5e-3, f"{name} stream rel err {worst} > 5e-3")
        if name == "sketched_two_sided_id":
            check(launches > 0, "the ID stream launched no K1")
            # the padding is never chosen; X is the skeleton of the block
            skel = 0.0
            for r, b in zip(res, blocks):
                rows = r.factors.row_ind[:16].numpy()
                cols = r.factors.col_ind[:16].numpy()
                check(rows.max() < b.shape[0] and cols.max() < b.shape[1],
                      f"block {r.index}: a pivot in the padding")
                sub = b[rows[:, None], cols]
                skel = max(skel, float(np.abs(r.factors.x.numpy() - sub).max()
                                       / np.abs(sub).max()))
            check(skel <= 1e-3, f"skeleton rel err {skel} > 1e-3")
            cfg = rt.CompressionConfig.RANK(16, method=name)
            twin = same_state(gen)
            got = rt.compress(blocks, gen, cfg)
            want = compress_heterogeneous(
                blocks, twin, rank=16, method=name, mode=cfg.qr_mode,
                block_size=cfg.block_size)
            check(all(torch.equal(getattr(x.factors, f), getattr(
                y.factors, f)) for x, y in zip(got, want)
                for f in ("c", "x", "r", "row_ind", "col_ind")),
                "compress(list) is not the direct stream")
        say("22-block-stream-f32", call=name,
            skeleton_rel_err=skel,
            **stream_line(res, blocks, seconds), chunks=chunks,
            buckets=len(groups), plan="native" if nplan else "python",
            k1_launches=launches,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        runs.append(lambda kw=kwargs: compress_heterogeneous(blocks, gen,
                                                             **kw))
    run = lambda: runs[0]()  # noqa: E731
    run.chunks = chunks  # for the profile's kernels per chunk
    return run


def volume_sides(count: int):
    """Sides of the volume stream: ``default_rng(5).integers(64, 513)``,
    m then n for each block, as ``tools/_gen_blocks10k.py`` draws them."""
    import numpy as np

    rng = np.random.default_rng(5)
    return [(int(rng.integers(64, 513)), int(rng.integers(64, 513)))
            for _ in range(count)]


class FallbackTally(logging.Handler):
    """Sums the fallback counts that each refined stream logs (the
    ``fallbacks`` of the scheduler's record), while it is entered."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.counts: dict = {}
        self.streams = 0

    def emit(self, record):
        if hasattr(record, "fallbacks"):
            self.streams += 1
            for key, value in record.fallbacks.items():
                self.counts[key] = self.counts.get(key, 0) + value

    def __enter__(self):
        self.logger = logging.getLogger("rusty_compression_tpu_torch.scheduler")
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def phase_volume(torch, rt, gen, count: int, phase: str = "23-volume-1e-8",
                 extra: tuple = ()):
    """``count`` f64 Laplace blocks (sides 64-512) as ``.npy`` files through
    ``cli.main(--tol 1e-8 --highacc, *extra)``; the last 100 manifest rows
    deleted and the stream resumed."""
    import contextlib
    import io as stdio
    import json as _json
    import os
    import shutil
    import tempfile

    import numpy as np

    from rusty_compression_tpu_torch import cli
    from rusty_compression_tpu_torch import highacc as ha
    from rusty_compression_tpu_torch import io as rcio
    from rusty_compression_tpu_torch.parallel import scheduler

    work = tempfile.mkdtemp(prefix="rc_volume_")
    try:
        need = sum(m * n * 8 for m, n in volume_sides(count)) * 3
        free = shutil.disk_usage(work).free
        check(free > need, f"{free / 1e9:.1f} GB free for {count} blocks, "
              f"{need / 1e9:.1f} GB needed")
        src, ckpt = os.path.join(work, "blocks"), os.path.join(work, "ckpt")
        os.makedirs(src)
        sides = volume_sides(count)
        for lo in range(0, count, 256):
            part = stream_blocks(torch, gen, sides[lo:lo + 256],
                                 torch.float64)
            for i, b in enumerate(part, lo):
                np.save(os.path.join(src, f"block_{i:05d}.npy"), b)
        metrics = os.path.join(work, "metrics.jsonl")

        def run(*args):
            out = stdio.StringIO()
            reads = ha._read.count
            tally = FallbackTally()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), tally:
                rc = cli.main([src, "-o", ckpt, "--tol", "1e-8",
                               "--highacc", "--metrics", metrics, *extra,
                               *args])
            torch.cuda.synchronize()
            check(rc == 0, f"cli.main returned {rc}")
            check(tally.streams == 1, f"{tally.streams} refined streams ran")
            return (time.perf_counter() - t0, out.getvalue(), tally.counts,
                    ha._read.count - reads)

        seconds, printed, fallbacks, reads = run()
        manifest = os.path.join(ckpt, "manifest.jsonl")
        with open(manifest) as f:
            rows = [_json.loads(line) for line in f]
        check(len(rows) == count and sorted(r["block"] for r in rows)
              == list(range(count)), "the manifest does not hold each block")
        failed = [r for r in rows if r["error"]]
        check(not failed, f"{len(failed)} blocks failed: {failed[:2]}")
        check(fallbacks["blocks"] <= 0.02 * count,
              f"{fallbacks['blocks']} of {count} blocks took a fallback")
        errs = np.sort([r["rel_residual"] for r in rows])
        ranks = [r["rank"] for r in rows]
        pick = np.random.default_rng(23).choice(count, 3, replace=False)
        for i in pick:
            a = np.load(os.path.join(src, f"block_{i:05d}.npy"))
            f = rcio.load_factors(os.path.join(ckpt, f"block_{i:08d}.npz"),
                                  device="cuda")
            rec = (f.u @ (f.s[:, None] * f.vt)).cpu().numpy()
            err = float(np.linalg.norm(rec - a) / np.linalg.norm(a))
            want = next(r["rel_residual"] for r in rows if r["block"] == i)
            check(abs(err - want) <= 1e-6 * want + 1e-15,
                  f"block {i}: stored factors give {err}, recorded {want}")

        # resume: the last 100 rows deleted, exactly those blocks re-run
        dropped = sorted(r["block"] for r in rows[-100:])
        with open(manifest, "w") as f:
            f.writelines(_json.dumps(r) + "\n" for r in rows[:-100])
        check(rcio.pending_blocks(ckpt, count) == dropped,
              "pending_blocks is not the deleted rows")
        r_seconds, r_printed, r_fallbacks, r_reads = run("--resume")
        check(f"resuming: 100/{count} blocks pending" in r_printed,
              f"resume printed {r_printed.splitlines()[:1]}")
        with open(manifest) as f:
            after = [_json.loads(line) for line in f]
        check(sorted(r["block"] for r in after[count - 100:]) == dropped
              and len(after) == count, "the resume re-ran other blocks")
        loaded = rcio.load_block_results(ckpt, device="cuda")
        check([r["block"] for r in loaded] == list(range(count)),
              "load_block_results does not give each block once")
        say(phase, blocks=count, cli_extra=list(extra),
            gbytes=sum(m * n * 8 for m, n in sides) / 1e9,
            seconds=seconds, blocks_per_s=count / seconds,
            resumed_blocks=100, resumed_seconds=r_seconds,
            resumed_blocks_per_s=100 / r_seconds,
            rel_err_max=float(errs[-1]),
            rel_err_median=float(np.median(errs)),
            rel_err_p99=float(np.quantile(errs, 0.99)),
            ranks=[min(ranks), max(ranks)], fallbacks=fallbacks,
            resume_fallbacks=r_fallbacks, host_reads=reads,
            resume_host_reads=r_reads, checked_blocks=pick.tolist(),
            summary=printed.strip().splitlines()[-2:])
        head = [np.load(os.path.join(src, f"block_{i:05d}.npy"))
                for i in range(min(count, 128))]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    run = lambda: scheduler.compress_heterogeneous_refined(  # noqa: E731
        head, gen, rel_tol=1e-8)
    shapes = [b.shape for b in head]
    run.chunks = len(scheduler._chunks(head, shapes,
                                       scheduler.plan_buckets(shapes), 1,
                                       256 << 20, True))
    return run


# ---------------------------------------------------------------------------
# Phase 24: the multi-card layer (the port's twin of dryrun_multichip)
# ---------------------------------------------------------------------------

SPLIT_DEADLINE_S = 240


def split_inputs(torch, rt, gen) -> dict:
    """The smaller stack and stream that two ranks split on one card."""
    import numpy as np

    stack, _ = config_1hb_stack(torch)
    return {"blocks": laplace_blocks(torch, gen, 8, 1024).cpu(),
            "adaptive": torch.stack([decaying_block(torch, rt, gen, 1024, r)
                                     for r in (24, 36, 48, 60)]).cpu(),
            "refined": stack.cpu(),
            "stream": stream_blocks(torch, gen, np.random.default_rng(24)
                                    .integers(512, 2049, (16, 2)),
                                    torch.float32),
            "rows": decaying_block(torch, rt, gen, 4096, 48).cpu()}


def split_calls(torch, rt, inputs: dict, mesh) -> dict:
    """Every sharded route on ``inputs``, gathered on every rank as host
    numpy; the same calls give the one-rank results and the two ranks'."""
    import numpy as np

    from rusty_compression_tpu_torch import parallel as par

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    blocks = inputs["blocks"].cuda()
    out = {m: par.gather_factors(par.compress_blocks(
        blocks, gen(1), 16, method=m, mesh=mesh), mesh).__dict__
        for m in ("rsvd", "column_id")}
    svd, ranks, hist = par.gather_factors(par.compress_blocks_adaptive(
        inputs["adaptive"].cuda(), gen(2), 1e-3, 8, 64, mesh=mesh), mesh)
    out["adaptive"] = {**svd.__dict__, "ranks": ranks, "hist": hist}
    for name, kw in (("refined_fixed", dict(round_rank=56, tol=1e-8)),
                     ("refined_growth", dict(tol=1e-8))):
        outs = par.gather_factors(rt.refined_rsvd_fused_batch(
            inputs["refined"].cuda(), gen(3), mesh=mesh, **kw), mesh)
        out[name] = {"ranks": np.array([o.rank for o in outs]),
                     "tol_ok": np.array([o.tol_ok for o in outs]),
                     **{f"{f}{i}": getattr(o, f) for i, o in enumerate(outs)
                        for f in ("u", "s", "vt")}}
    # chunks padded to an even count at one rank too: the same chunks
    res = par.compress_heterogeneous(inputs["stream"], gen(4), rank=16,
                                     method="sketched_two_sided_id",
                                     mesh=mesh, batch_granule=2)
    out["stream"] = {f"{f}{r.index}": getattr(r.factors, f).numpy()
                     for r in res for f in ("c", "x", "r", "row_ind",
                                            "col_ind")}
    out["stream"]["errs"] = np.array([r.rel_residual for r in res])
    a = inputs["rows"].cuda()
    op = par.RowShardedOperator(a, mesh, "blocks")
    q = rt.sample_range_by_rank(op, gen(5), 16, 5)
    svd = rt.SVD.compute_from_range_estimate(q, op)
    out["rows"] = {"s": svd.s.cpu().numpy(), "err": np.array(
        float(rt.rel_diff_fro(svd.to_mat(), a)))}
    return out


def split_worker(argv) -> int:
    """One of the two ranks on ``cuda:0`` (``--split-rank R WORK BACKEND``):
    joins the group through ``WORK/store``, runs ``split_calls`` on
    ``WORK/inputs.pt`` and writes ``WORK/rank<R>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist

    import rusty_compression_tpu_torch as rt
    from rusty_compression_tpu_torch import parallel as par
    from rusty_compression_tpu_torch.ops.kernels import qrcp as k1

    i = argv.index("--split-rank")
    rank, work, backend = int(argv[i + 1]), argv[i + 2], argv[i + 3]
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{work}/store",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = par.make_mesh()
        inputs = torch.load(f"{work}/inputs.pt", weights_only=False)
        out = split_calls(torch, rt, inputs, mesh)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    torch.save({"out": out if rank == 0 else None,
                "launches": k1.qrcp_panel.launch_count,
                "shapes": sorted(k1.qrcp_panel.launched_shapes)},
               f"{work}/rank{rank}.pt")
    return 0


def nccl_probe_worker(argv) -> int:
    """One of two NCCL ranks on ``cuda:0`` (``--nccl-probe R WORK``): one
    ``all_reduce``; NCCL is expected to refuse two ranks on one card."""
    import datetime

    import torch
    import torch.distributed as dist

    i = argv.index("--nccl-probe")
    rank, work = int(argv[i + 1]), argv[i + 2]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{work}/probe",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    try:
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return 0 if float(x[0]) == 2.0 else 1
    finally:
        dist.destroy_process_group()


def spawn_two(flag: str, work: str, *rest, deadline: float) -> list:
    """This script twice as ranks 0 and 1 (``flag R WORK *rest``); killed
    at ``deadline`` seconds. Returns ``(returncode, output)`` per rank
    (returncode None when killed)."""
    procs = [subprocess.Popen(
        [sys.executable, __file__, flag, str(r), work, *rest],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    t0, out = time.perf_counter(), []
    try:
        for p in procs:
            left = max(deadline - (time.perf_counter() - t0), 1.0)
            try:
                log = p.communicate(timeout=left)[0].decode()
                out.append((p.returncode, log))
            except subprocess.TimeoutExpired:
                out.append((None, "killed at the deadline"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def same_arrays(got: dict, want: dict) -> dict:
    """``bitwise``: all arrays bitwise equal; ``max_rel_diff``: the largest
    entrywise difference relative to the largest entry of its array
    (infinite where a shape or an integer differs), at ``worst_key``."""
    bitwise, worst, at = True, 0.0, None
    for key, w in want.items():
        g = got[key]
        diff = math.inf
        if g.shape == w.shape:
            bitwise &= bool((g == w).all())
            if w.dtype.kind in "fc":
                scale = float(abs(w).max()) if w.size else 1.0
                diff = float(abs(g - w).max()) / (scale or 1.0) \
                    if w.size else 0.0
            else:
                diff = 0.0 if (g == w).all() else math.inf
        else:
            bitwise = False
        if at is None or diff > worst:
            worst, at = diff, key
    return {"bitwise": bitwise, "max_rel_diff": worst, "worst_key": at}


def phase_mesh(torch, rt, k1, gen, volume: int):
    """The multi-card layer on the card, as ``dryrun_multichip`` drives it
    on the TPU: ``make_mesh()`` over every card (NCCL), the sharded stack
    (rank and adaptive), the refined batch, both streams (the ID stream
    and the CLI's refined stream with ``--resume``) and the row-sharded
    operator, each against the unsharded route; then two ranks that split
    one card (``split_calls``). The JAX package's stub of a
    complex-rejecting backend has no twin: the card takes complex dtypes
    (``rusty_compression_tpu_torch/utils/__init__.py``)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from rusty_compression_tpu_torch import parallel as par

    mesh = par.make_mesh()
    world = dist.get_world_size()
    check(world == torch.cuda.device_count(),
          f"world size {world} != {torch.cuda.device_count()} cards")
    say("24-mesh-group", world_size=world, backend=dist.get_backend(),
        mesh=list(mesh.mesh.shape), axes=list(mesh.mesh_dim_names))

    # the stack: cell 5's eight 2048^2 Laplace blocks at rank 16
    blocks = laplace_blocks(torch, gen, 8, 2048)
    for method in ("rsvd", "column_id"):
        twin = same_state(gen)
        before = k1.qrcp_panel.launch_count
        t0 = time.perf_counter()
        got = par.compress_blocks(blocks, gen, 16, method=method, mesh=mesh)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = k1.qrcp_panel.launch_count - before
        want = par.compress_blocks(blocks, twin, 16, method=method)
        check(all(torch.equal(getattr(got, f.name), getattr(want, f.name))
                  for f in dataclasses.fields(want)),
              f"compress_blocks({method}, mesh=) is not the unsharded call")
        gathered = par.gather_factors(got, mesh)
        check(all(np.array_equal(getattr(gathered, f.name),
                                 getattr(want, f.name).cpu().numpy())
                  for f in dataclasses.fields(want)),
              f"gather_factors({method}) is not the factors")
        check((launches > 0) == (method == "column_id"),
              f"compress_blocks({method}, mesh=): {launches} K1 launches")
        errs = par.batched_rel_diff_fro(got, blocks)
        say("24-mesh-stack", method=method, blocks=[8, 2048, 2048], rank=16,
            bitwise_unsharded=True, k1_launches=launches,
            max_rel_err=float(errs.max()), ms=seconds * 1e3)

    # a c64 stack (real and imaginary parts two Laplace stacks) through the
    # column ID: K2 on the rank's shard
    cblocks = torch.complex(laplace_blocks(torch, gen, 4, 1024),
                            laplace_blocks(torch, gen, 4, 1024))
    twin = same_state(gen)
    before = k1.qrcp_panel_complex.launch_count
    got = par.compress_blocks(cblocks, gen, 16, method="column_id",
                              mesh=mesh)
    torch.cuda.synchronize()
    launches = k1.qrcp_panel_complex.launch_count - before
    want = par.compress_blocks(cblocks, twin, 16, method="column_id")
    check(all(torch.equal(getattr(got, f.name), getattr(want, f.name))
              for f in dataclasses.fields(want)) and launches > 0,
          f"compress_blocks(c64 column_id, mesh=): not the unsharded call, "
          f"or {launches} K2 launches")
    errs = par.batched_rel_diff_fro(got, cblocks)
    check(float(errs.max()) <= 5e-2, f"c64 column ID rel err "
          f"{float(errs.max())}")
    say("24-mesh-stack", method="column_id", dtype="complex64",
        blocks=[4, 1024, 1024], rank=16, bitwise_unsharded=True,
        k2_launches=launches, max_rel_err=float(errs.max()))

    # the adaptive stack: phase 14's four decaying blocks
    stack = torch.stack([decaying_block(torch, rt, gen, 2048, r)
                         for r in (24, 36, 48, 60)])
    twin = same_state(gen)
    svd, ranks, _ = par.compress_blocks_adaptive(stack, gen, 1e-3, 8, 64,
                                                 mesh=mesh)
    want = par.compress_blocks_adaptive(stack, twin, 1e-3, 8, 64)
    check(torch.equal(ranks, want[1]) and all(
        torch.equal(getattr(svd, f), getattr(want[0], f))
        for f in ("u", "s", "vt")),
        "compress_blocks_adaptive(mesh=) is not the unsharded call")
    errs = par.batched_rel_diff_fro(svd, stack)
    check(float(errs.max()) <= 5e-3, f"adaptive rel err {float(errs.max())}")
    say("24-mesh-adaptive", blocks=[4, 2048, 2048], ranks=ranks.tolist(),
        max_rel_err=float(errs.max()), bitwise_unsharded=True)

    # the refined batch: cell 17's stack, fixed rounds and growth
    rstack, crossings = config_1hb_stack(torch)
    for name, kw in (("fixed", dict(round_rank=56, tol=1e-8)),
                     ("growth", dict(tol=1e-8))):
        twin = same_state(gen)
        outs = rt.refined_rsvd_fused_batch(rstack, gen, mesh=mesh, **kw)
        want = rt.refined_rsvd_fused_batch(rstack, twin, **kw)
        check(all(torch.equal(o.u, w.u) and torch.equal(o.s, w.s)
                  for o, w in zip(outs, want)),
              f"refined batch ({name}, mesh=) is not the unsharded call")
        errs = check_stack(torch, f"24-mesh-refined-{name}", outs, rstack,
                           crossings, range(8))
        say("24-mesh-refined", mode=name, blocks=list(rstack.shape),
            ranks=[o.rank for o in outs], max_rel_err=max(errs),
            bitwise_unsharded=True)

    # phase 22's stream: 64 f32 Laplace blocks, 5.20 GB
    sides = np.random.default_rng(22).integers(1024, 8193, (64, 2))
    sblocks = stream_blocks(torch, gen, sides, torch.float32)
    line = {}
    for label, kw in (("unsharded", {}), ("mesh", {"mesh": mesh})):
        g = torch.Generator(device="cuda").manual_seed(2222)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = par.compress_heterogeneous(sblocks, g, rank=16,
                                         method="sketched_two_sided_id", **kw)
        torch.cuda.synchronize()
        line[label] = (res, time.perf_counter() - t0)
    (res, secs), (want, w_secs) = line["mesh"], line["unsharded"]
    check([r.index for r in res] == list(range(64)) and all(
        (x.rank, x.rel_residual) == (y.rank, y.rel_residual) and all(
            torch.equal(getattr(x.factors, f), getattr(y.factors, f))
            for f in ("c", "x", "r", "row_ind", "col_ind"))
        for x, y in zip(res, want)),
        "the stream on the mesh is not the unsharded stream")
    worst = max(r.rel_residual for r in res)
    check(worst <= 5e-3, f"mesh stream rel err {worst}")
    say("24-mesh-stream-f32", **stream_line(res, sblocks, secs),
        unsharded_seconds=w_secs, unsharded_blocks_per_s=64 / w_secs,
        bitwise_unsharded=True)
    run_stream = lambda: par.compress_heterogeneous(  # noqa: E731
        sblocks, gen, rank=16, method="sketched_two_sided_id", mesh=mesh)

    # phase 23's refined stream through the CLI on the mesh, resumed
    phase_volume(torch, rt, gen, volume, phase="24-mesh-cli-volume",
                 extra=("--mesh",))
    check(dist.is_initialized(), "the CLI ended the caller's group")

    # one 16384^2 f32 block (1 GiB) as a row-sharded operator
    a = laplace_blocks(torch, gen, 1, 16384)[0]
    errs = {}
    for label, op in (("row_sharded", par.RowShardedOperator(a, mesh,
                                                             "blocks")),
                      ("dense", rt.DenseOperator(a))):
        g = torch.Generator(device="cuda").manual_seed(16384)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = rt.sample_range_by_rank(op, g, 16, 5)
        svd = rt.SVD.compute_from_range_estimate(q, op)
        torch.cuda.synchronize()
        errs[label] = (float(rt.rel_diff_fro(svd.to_mat(), a)),
                       (time.perf_counter() - t0) * 1e3)
    check(abs(errs["row_sharded"][0] - errs["dense"][0])
          <= 1e-3 * errs["dense"][0],
          f"row-sharded rel err {errs['row_sharded'][0]} against the dense "
          f"route's {errs['dense'][0]}")
    say("24-mesh-row-sharded", shape=[16384, 16384], rank=16,
        rel_err=errs["row_sharded"][0], dense_rel_err=errs["dense"][0],
        ms=errs["row_sharded"][1], dense_ms=errs["dense"][1])

    # two ranks on one card
    work = tempfile.mkdtemp(prefix="rc_split_")
    try:
        probe = spawn_two("--nccl-probe", work, deadline=60)
        nccl_two = all(rc == 0 for rc, _ in probe)
        inputs = split_inputs(torch, rt, gen)
        torch.save(inputs, f"{work}/inputs.pt")
        want = split_calls(torch, rt, inputs, mesh)
        t0 = time.perf_counter()
        ranks = spawn_two("--split-rank", work, "gloo",
                          deadline=SPLIT_DEADLINE_S)
        seconds = time.perf_counter() - t0
        check(all(rc == 0 for rc, _ in ranks),
              "the two ranks on one card failed: " + " | ".join(
                  f"rc {rc}: {log[-1500:]}" for rc, log in ranks))
        found = [torch.load(f"{work}/rank{r}.pt", weights_only=False)
                 for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    compared = {name: same_arrays(found[0]["out"][name], w)
                for name, w in want.items() if name != "stream"}
    got_s, want_s = found[0]["out"]["stream"], want["stream"]
    blocks = len(want_s["errs"])
    compared["stream"] = {
        "bitwise": same_arrays(got_s, want_s)["bitwise"],
        "blocks_with_other_pivots": sum(not all(np.array_equal(
            got_s[f"{f}{i}"], want_s[f"{f}{i}"]) for f in ("row_ind",
                                                            "col_ind"))
            for i in range(blocks)),
        "max_rel_err_ratio": float(np.max(abs(got_s["errs"] - want_s["errs"])
                                          / want_s["errs"])),
        "max_rel_err": float(max(got_s["errs"].max(), want_s["errs"].max()))}
    for r in range(2):
        check(found[r]["launches"] > 0, f"split rank {r} launched no K1")
    say("24-mesh-two-ranks-one-card", backend="gloo",
        nccl_two_ranks_one_card="accepted" if nccl_two else "refused",
        nccl_probe=[log.strip().splitlines()[-1:] for _, log in probe],
        seconds=seconds, k1_launches=[f["launches"] for f in found],
        k1_shapes=[[list(s), k, m] for s, k, m in found[0]["shapes"]],
        compared=compared)
    # The rule: bitwise where each rank's kernels are the one rank's (the
    # stack's rSVD and column ID, the refined fixed rounds); elsewhere a
    # rank's batched kernels see another batch count (cuBLAS and cuSOLVER
    # may pick other kernels, a batch of one takes the unbatched ones),
    # its growth stops with its own lanes, or it multiplies half the
    # rows: ranks equal and factors within 1e-6 of the largest entry
    # (adaptive stack, f32; refined growth, f64), 1e-5 (the row-sharded
    # SVD, f32); the ID stream may pick another pivot at a near tie (a
    # block's residual then moves as from one sketch draw to another), so
    # every block of both runs meets the stream's gate, 5e-3, and the
    # blocks with other pivots are counted.
    exact = ("rsvd", "column_id", "refined_fixed")
    loose = {"adaptive": 1e-6, "refined_growth": 1e-6, "rows": 1e-5}
    for name, c in compared.items():
        if name == "stream":
            ok = c["max_rel_err"] <= 5e-3
        elif name in exact:
            ok = c["bitwise"]
        else:
            ok = c["max_rel_diff"] <= loose[name]
        check(ok, f"two ranks on one card: {name} differs from one rank "
                  f"({c})")
    # the ranks' K1 shapes, held against the plain version after the phase
    run_stream.held_after = {"qrcp_panel": sorted(
        set(found[0]["shapes"]) | set(found[1]["shapes"]))}
    return run_stream


# ---------------------------------------------------------------------------
# Phase 25: the twins of examples/*.py
# ---------------------------------------------------------------------------

#: the H-matrix's sizes (the example's default, then the card's) and the
#: (admissible, dense) blocks of ``examples/hmatrix.py``'s partition there
HMATRIX_BLOCKS = {3000: (1220, 1100), 32768: (12894, 8906)}


def hmatrix_line(out: dict, seconds: float) -> dict:
    ranks = out["ranks"]
    return {"n_points": out["n_points"], "wall_seconds": seconds,
            "admissible": out["admissible"], "dense": out["dense"],
            "far_gbytes": out["far_bytes"] / 1e9,
            "far_max_side": out["far_max_side"],
            "stream_seconds": out["stream_seconds"],
            "stream_blocks_per_s": out["admissible"] / out["stream_seconds"],
            "stream_gbps": out["far_bytes"] / out["stream_seconds"] / 1e9,
            "ranks_min_median_max": [min(ranks), int(statistics.median(ranks)),
                                     max(ranks)],
            "max_rel_residual": out["max_rel_residual"],
            "dense_bytes": out["dense_bytes"], "h_bytes": out["h_bytes"],
            "compression_ratio": out["dense_bytes"] / out["h_bytes"],
            "matvec_rel_err": out["matvec_rel_err"],
            **{k: out[k] for k in ("partition_seconds", "far_build_seconds",
                                   "near_build_seconds", "matvec_seconds",
                                   "reference_seconds")}}


def phase_examples(torch):
    """The seven twins of ``examples/*.py`` through their ``run`` on the
    card at their default sizes, then the H-matrix at 32,768 points: one
    line each with its wall time and the numbers it checks. Each twin's
    own gates raise; the examples that print without a gate are held here
    (the ID's skeleton to 1e-12 and its error to 10 sigma_21; the adaptive
    sampler's last estimate below tol and the QR's error within 5 tol)."""
    import importlib
    import io
    import shutil
    import tempfile

    def twin(name):
        return importlib.import_module(
            f"rusty_compression_tpu_torch.examples.{name}")

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    dev = torch.device("cuda")
    m = twin("interpolative_decomposition")
    out, sec = timed(lambda: m.run(m.make_input(dev), gen(0)))
    check(out["skeleton_err"] <= 1e-12
          and out["two_sided_rel_err"] <= 10 * out["sigma_next"],
          f"interpolative_decomposition: {out}")
    say("25-examples", example="interpolative_decomposition", wall_seconds=sec,
        **{k: out[k] for k in ("qr_rel_err", "column_id_rel_err",
                               "two_sided_rel_err", "skeleton_err",
                               "sigma_next")})

    m = twin("adaptive_sampling")
    out, sec = timed(lambda: m.run(m.make_input(dev), gen(1)))
    check(out["estimated"][-1] < m.REL_TOL
          and out["qr_rel_err"] <= 5 * m.REL_TOL,
          f"adaptive_sampling: {out}")
    say("25-examples", example="adaptive_sampling", wall_seconds=sec,
        rank=out["rank"], blocks=out["blocks"],
        last_estimate=out["estimated"][-1], last_exact=out["exact"][-1],
        qr_rel_err=out["qr_rel_err"])

    m = twin("high_accuracy")
    a, sig = m.make_input()
    out, sec = timed(lambda: m.run(a, sig, gen(0)))
    say("25-examples", example="high_accuracy", wall_seconds=sec,
        size=m.M, **out)

    m = twin("high_accuracy_id")
    a, crossing = m.make_input()
    out, sec = timed(lambda: m.run(a, gen(0)))
    say("25-examples", example="high_accuracy_id", wall_seconds=sec,
        shape=[m.M, m.N], crossing=crossing,
        **{k: out[k] for k in ("rank", "rel_err", "skeleton_bitwise")})

    m = twin("complex_operators")
    a, sig = m.make_input()
    out, sec = timed(lambda: m.run(a, gen(1)))
    bound = 10 * sig[m.RANK] / sig[0]
    check(out["skeleton_err"] <= 1e-3 and all(
        out[k] <= bound for k in ("two_sided_rel_err", "column_id_rel_err",
                                  "compress_two_sided_rel_err")),
          f"complex_operators: {out} (ID gate {bound})")
    say("25-examples", example="complex_operators", wall_seconds=sec,
        size=m.SIZE, rank=m.RANK, id_gate=bound, **out)

    m = twin("block_workload")
    tmp = tempfile.mkdtemp(prefix="rc_chip_smoke_blocks_")
    try:
        log = io.StringIO()
        out, sec = timed(lambda: m.run(m.make_blocks(0, device=dev), gen(1),
                                       f"{tmp}/ckpt", log=log))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    records = [json.loads(line) for line in log.getvalue().splitlines()]
    check(len(records) == out["blocks"] == 8
          and out["max_residual"] <= 5 * m.REL_TOL,
          f"block_workload: {len(records)} records, {out}")
    say("25-examples", example="block_workload", wall_seconds=sec,
        metrics_records=len(records), **out)

    m = twin("hmatrix")
    runs = {}
    for n in HMATRIX_BLOCKS:
        points = m.sphere_points(n)
        x = torch.randn(n, generator=gen(2), device="cuda",
                        dtype=torch.float64).cpu().numpy()
        run = lambda points=points, x=x: m.run(points, x, gen(1))  # noqa: E731
        torch.cuda.reset_peak_memory_stats()
        out, sec = timed(run)
        check((out["admissible"], out["dense"]) == HMATRIX_BLOCKS[n],
              f"hmatrix at {n} points: {out['admissible']} admissible, "
              f"{out['dense']} dense blocks, not {HMATRIX_BLOCKS[n]}")
        say("25-examples", example="hmatrix", **hmatrix_line(out, sec),
            peak_device_gbytes=torch.cuda.max_memory_allocated() / 1e9)
        run.blocks = sum(HMATRIX_BLOCKS[n])
        runs[f"25-hmatrix-{n}"] = run
    # --profile traces the H-matrix at each size
    first = next(iter(runs.values()))
    first.cells = runs
    return first


def profile(torch, name: str, run, calls: int = 5) -> None:
    """Device-busy time, idle share and device time by kernel name over
    ``calls`` warm calls of ``run`` (torch.profiler). The wall time is taken
    inside the profiled region, so it carries the tracing's cost per
    launch but not the profiler's start and stop. The device events are
    summed by name straight from the trace's raw events (``key_averages``
    gives the same sums, but builds an event tree first that outlasts the
    script's limit over the millions of kernels of the largest H-matrix).
    ``run.chunks`` / ``run.blocks``, where set, give kernels per chunk or
    per block."""
    from torch.autograd import DeviceType
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
    totals: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ns, count = totals.get(e.name(), (0, 0))
            totals[e.name()] = (ns + e.duration_ns(), count + 1)
    rows = [(key, ns / 1e6 / traced, count / traced)
            for key, (ns, count) in totals.items()]
    check(bool(rows), f"profile of {name}: no device time recorded")
    rows.sort(key=lambda row: -row[1])
    busy = sum(row[1] for row in rows)
    kernels = sum(row[2] for row in rows)
    per_unit = {}
    for unit in ("chunks", "blocks"):
        if getattr(run, unit, None):
            per_unit.update({f"{unit}_per_call": getattr(run, unit),
                             f"kernels_per_{unit[:-1]}":
                             kernels / getattr(run, unit)})
    say("profile", cell=name, wall_ms_per_call=wall, device_busy_ms=busy,
        idle_share=1 - busy / wall, kernels_per_call=kernels, **per_unit,
        top=[{"kernel": key[:60], "ms": ms, "per_call": cnt}
             for key, ms, cnt in rows[:6]])


def main(argv) -> int:
    if "--split-rank" in argv:
        return split_worker(argv)
    if "--nccl-probe" in argv:
        return nccl_probe_worker(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    import rusty_compression_tpu_torch as rt
    from rusty_compression_tpu_torch.ops.kernels import qrcp as k1

    card = phase_card(torch)
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = phase_kernel(torch, k1, gen)
    tsqr_row = phase_tsqr(torch, gen)
    phase_reference(torch, rt)
    phase_route(torch, torch.Generator(device="cuda").manual_seed(14))
    phase_route_gs(torch, k1)

    # The main paths: each phase with the four counts at 0 just before it
    # and read just after; `must` names the kernels its path has to launch.
    # Phases from 6 on draw from generators of their own, so that what they
    # compute does not depend on how much the phases before them drew.
    # `late` says which of a phase's K1 shapes have a size that its data
    # decides; phase 2 holds those right after the phase, outside the count.
    gens = {seed: torch.Generator(device="cuda").manual_seed(seed)
            for seed in range(6, 25)}
    volume = int(argv[argv.index("--volume") + 1]) if "--volume" in argv \
        else 1024
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
        ("11-config-2-hilbert", ("qrcp_panel", "qrcp_panel_f64"), no_late,
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
        # the tol <= 1e-8 pipelines, f64 / c128: K3 / K4 pivot the ID cores
        ("15-refined-rsvd-4096", None, no_late,
         lambda: phase_refined_rsvd(torch, rt, gens[15])),
        ("16-growth-512", None, no_late,
         lambda: phase_growth(torch, rt, gens[16])),
        ("17-batched-growth", None, no_late,
         lambda: phase_batched_growth(torch, rt, gens[17])),
        ("18-hilbert-column-id", "qrcp_panel_f64", no_late,
         lambda: phase_hilbert_id(torch, rt, gens[18])),
        ("19-two-sided-id-8192", "qrcp_panel_f64", no_late,
         lambda: phase_two_sided_refined(torch, rt, gens[19])),
        ("20-refined-c128-2048", "qrcp_panel_c128", no_late,
         lambda: phase_refined_complex(torch, rt, gens[20])),
        ("21-front-door-highacc", None, no_late,
         lambda: phase_refined_front_door(torch, rt, gens[21])),
        # the stream's K1 panels: (chunk, 24 or 16, bucket side), k = 16
        ("22-block-stream-f32", "qrcp_panel",
         lambda shape, k, masked: (not masked and k == 16
                                   and shape[1] in (16, 24)
                                   and shape[2] in (1024, 2048, 4096, 8192)),
         lambda: phase_block_stream(torch, rt, k1, gens[22])),
        ("23-volume-1e-8", None, no_late,
         lambda: phase_volume(torch, rt, gens[23], volume)),
        # every launch of the mesh phase is at rank 16: phase 22's stream
        # shapes, the split's stack and stream, the row-sharded sketch's
        # pivoted QR; phase 2 holds each new one after the phase
        ("24-mesh", "qrcp_panel", lambda shape, k, masked: k == 16,
         lambda: phase_mesh(torch, rt, k1, gens[24], volume)),
        # the complex example launches K2; the f64 twins launch K3
        ("25-examples", "qrcp_panel_complex", no_late,
         lambda: phase_examples(torch)),
    ]
    from rusty_compression_tpu_torch.ops.kernels import tsqr
    from rusty_compression_tpu_torch.ops.svd import compute_svd

    launches = {name: 0 for name in KERNELS}
    launches_tsqr = 0
    for phase, must, late, drive in paths:
        for name in KERNELS:
            getattr(k1, name).launch_count = 0
            getattr(k1, name).launched_shapes.clear()
        tsqr.tsqr.launch_count = 0
        compute_svd.through_qr_count = 0
        run = drive()
        torch.cuda.synchronize()
        counts = {name: getattr(k1, name).launch_count for name in KERNELS}
        counts["tsqr"] = tsqr.tsqr.launch_count
        # SVDs that took the QR-first route (K5's QR, one small SVD)
        counts["svd_through_qr"] = compute_svd.through_qr_count
        launches_tsqr += counts["tsqr"]
        for name in (must,) if isinstance(must, str) else must or ():
            check(counts[name] > 0, f"phase {phase} launched no {name} "
                  f"kernel")
        say("launches", path=phase, **counts, shapes={
            name: sorted([list(shape), *rest] for shape, *rest
                         in getattr(k1, name).launched_shapes)
            for name in KERNELS})
        for name in KERNELS:
            launches[name] += counts[name]
            checks.hold_launched(name, late)
            for shape, k, masked in getattr(run, "held_after", {}).get(
                    name, ()):
                if (shape, k, masked) not in checks.held[name]:
                    checks.hold(name, shape if shape[0] > 1 else shape[1:],
                                k, masked, reps=5)
        if "--profile" in argv:
            for cell, traced in getattr(run, "cells", {phase: run}).items():
                profile(torch, cell, traced, calls=1 if phase.startswith("25")
                        else 2 if phase.startswith(("22", "23", "24")) else 5)
        del run
        torch.cuda.empty_cache()
    kernels = checks.summary()
    import torch.distributed as dist

    if dist.is_initialized():   # the group of phase 24's mesh
        dist.destroy_process_group()

    print(card)
    from rusty_compression_tpu_torch.ops.kernels.library import ENTRY_POINTS

    csrc = "rusty_compression_tpu_torch/csrc/"
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": csrc + ENTRY_POINTS[k1.KERNELS[name].entry][0],
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": kernels[name]["max_abs_err"],
        "ms": kernels[name]["ms"], "device_ms": kernels[name]["device_ms"],
        "plain_ms": kernels[name]["plain_ms"],
        "bound_ms": kernels[name]["bound_ms"],
        "bound_by": kernels[name]["bound_by"], "library_ms": None}
        for name, replaces in KERNELS.items()] + [{
        "name": "tsqr", "route": "cuda", "source": csrc + "tsqr.cu",
        "replaces": "torch.linalg.qr (cuSOLVER geqrf + orgqr)",
        "launches": launches_tsqr, **tsqr_row}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
