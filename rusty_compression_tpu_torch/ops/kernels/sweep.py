"""Times K1-K4 at every cluster size on one NVIDIA card.

    python3 -m rusty_compression_tpu_torch.ops.kernels.sweep [--quick | --clocks]
        [--grids G,G,...]

For each panel shape of the main paths and each cluster size, the layout
``layout_at`` gives is forced on the wrapper; the result is held against
the plain version (pivots equal, q and r within 1e-4; 1e-9 in f64 and
c128) and timed:
``device_ms`` is the mean of 10 launches queued behind a busy card, the
kernel alone without the wrapper's host time. One JSON line per (kernel, shape, cluster
size), with ``chosen`` marking the size ``panel_layout`` picks; the first
line carries the card's name and power limit and the ptxas reports. The
layout rule's ``_SPLIT_ELEMENTS`` was set from this table. K3 and K4 (f64,
c128) run each shape with its norm rule at every cluster that holds Q
and the residual in shared memory; every kernel runs each shape at the
layout the rule picks (the cooperative grid where no cluster holds the
panel); where that grid splits Q over its CTAs, also at each count of ``--grids`` (by default the
most CTAs the grid takes, ``MAX_GRID``), lowered to leave no CTA past the
last column, where the slices still fit in shared memory.
``--quick`` runs one launch per layout and no timing: the first check of
a new build.

``--clocks`` builds the kernels with ``-DRC_QRCP_CLOCKS`` instead and
prints, for the layout ``panel_layout`` picks at each shape, the cycles a
step spends in each of its parts as thread 0 of the first panel's first
CTA sees them
(``clock64``; barrier waits count where they are waited): where a step's
time goes, on a machine where the vendor's kernel profilers do not run.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import subprocess
import sys

SHAPES = {
    "qrcp_panel": [
        ((24, 16384), 16, False), ((16, 16384), 16, False),
        ((24, 2048), 16, False), ((37, 301), 29, True),
        ((8, 24, 2048), 16, False), ((136, 256), 128, True),
        ((24, 32), 16, False), ((24, 16389), 16, True),
        # Q does not replicate in a CTA: the grid (layouts 1, 1, 2, 3)
        ((1024, 1024), 64, False), ((264, 512), 256, True),
        ((4096, 100), 100, False), ((20000, 40), 32, False)],
    "qrcp_panel_complex": [
        ((53, 8192), 43, False), ((43, 8192), 43, False),
        ((136, 256), 128, True), ((37, 301), 29, True),
        ((8, 24, 2048), 16, False), ((53, 8191), 43, True),
        ((1024, 512), 64, False), ((2048, 100), 100, False),
        ((12000, 40), 32, False)],
    # (shape, k, mask, norm rule): the 1e-8 ID cores of configs 2h and 4h
    # and of the high-accuracy ID example, config 2's f64 sketch
    "qrcp_panel_f64": [
        ((32, 1024), 32, False, "recompute"),
        ((72, 1024), 64, True, "downdate"),
        ((256, 8192), 256, False, "recompute"),
        ((169, 8192), 169, False, "recompute"),
        ((453, 1500), 453, False, "recompute"),
        ((500, 500), 480, False, "recompute"),
        ((37, 301), 29, True, "downdate"),
        # gs over the JAX package's 12 MiB working set; the second keeps
        # its CTAs' vectors in global memory
        ((4096, 512), 64, False, "downdate"),
        ((16384, 58), 50, False, "downdate")],
    "qrcp_panel_c128": [
        ((64, 2048), 64, False, "recompute"),
        ((96, 2048), 96, False, "recompute"),
        ((37, 301), 29, True, "downdate"),
        ((3, 24, 2048), 16, False, "downdate"),
        ((8192, 40), 32, False, "downdate"),
        # below ROW_SPLIT_ROWS rows: shares of Q that fit beside no slice
        # (the residual in L2), and shares that do not fit (Q in L2)
        ((1000, 1000), 600, False, "downdate"),
        ((1900, 2000), 400, False, "recompute")],
}


def device_ms(torch, fn, reps: int = 10) -> float:
    """Device time per launch: the card is kept busy while the host queues
    ``reps`` launches, so that they run back to back and the wrapper's
    host time is not in the reading."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


CLOCK_PARTS = ("cta_argmax", "candidates_barrier_join", "qhv", "v_update",
               "norm_qi", "column_pass")
#: The parts of a step of the grid that splits Q over its CTAs (layout 1),
#: each barrier on its own.
SPLIT_CLOCK_PARTS = ("argmax_candidates_out", "candidates_barrier",
                     "join_own_projections_part", "parts_barrier",
                     "rows_of_v", "v_barrier", "v_in_norm_qi", "column_pass")


def ptxas_lines(report: str) -> list[str]:
    """The registers and spills of each kernel instantiation in a
    ``-Xptxas -v`` report, each instantiation named as
    ``<scalar, norm rule, layout>`` (the template's arguments)."""
    lines = []
    for line in report.splitlines():
        name = re.search(r"Function properties for \S*qrcp_panel_kernelI"
                         r"(\w+?)Li(\d)ELi(\d)E", line)
        if name:
            scalar, rule, layout = name.groups()
            lines.append(f"<{scalar.lstrip('0123456789')}, {rule}, {layout}>")
        elif "registers" in line or "spill" in line:
            lines.append(line.strip())
    return lines


def read_clocks(library, entry: str, reset: bool) -> list[int]:
    fn = getattr(library.handle(entry), entry.replace("panel", "clocks"))
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = (ctypes.c_longlong * 8)()
    err = fn(out, int(reset))
    if err != 0:
        raise RuntimeError(f"{entry}: reading the clocks failed ({err})")
    return list(out)


def main(argv) -> int:
    import torch

    from . import library
    from . import qrcp as k1

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    quick = "--quick" in argv
    clocks = "--clocks" in argv
    grids = [int(x) for x in argv[argv.index("--grids") + 1].split(",")] \
        if "--grids" in argv else [k1.MAX_GRID]
    if clocks:
        library.count_clocks()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    built = library.build()
    reports = {spec.entry: ptxas_lines(built[spec.entry][1])
               for spec in k1.KERNELS.values()}
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "ptxas": reports}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = 0
    for name, shapes in SHAPES.items():
        wrapper, spec = getattr(k1, name), k1.KERNELS[name]
        dtype, wide = spec.dtype, spec.wide
        for shape, k, masked, *rule in shapes:
            norms = rule[0] if rule else None
            *_, m, n = shape
            real = dtype.to_real() if dtype.is_complex else dtype
            a = torch.randn(shape, generator=gen, device="cuda", dtype=real)
            if dtype.is_complex:
                a = torch.complex(a, torch.randn(shape, generator=gen,
                                                 device="cuda", dtype=real))
            a = a * torch.logspace(0.0, -1.0, n, device="cuda", dtype=real)
            used = None
            if masked:
                used = torch.zeros(n, dtype=torch.bool, device="cuda")
                used[::7] = True
            q0, r0, piv0 = k1.qrcp_panel_plain(a, k, used,
                                               norms or "downdate")
            chosen = k1.panel_layout(m, n, k, a.element_size(), wide)
            layouts = [x for cluster in k1.CLUSTER_SIZES
                       if (x := k1.layout_at(m, n, k, a.element_size(),
                                             cluster, wide))]
            if wide:   # K3, K4: only clusters that hold the panel
                layouts = [x for x in layouts if x.resid_in_smem]
            layouts += [chosen] if chosen not in layouts else []
            for count in grids if chosen.q_share else ():
                count = -(-n // -(-n // min(count, n)))
                other = k1.layout_at(m, n, k, a.element_size(), count,
                                     wide, 1)
                if other and other.resid_in_smem and other not in layouts:
                    layouts.append(other)
            for layout in layouts:
                if clocks and layout != chosen:
                    continue
                run = lambda: k1._panel(  # noqa: E731
                    wrapper, a, k, used, layout, norms)
                row = {"kernel": name, "shape": list(shape), "k": k,
                       "norms": norms, "chosen": layout == chosen,
                       **dataclasses.asdict(layout)}
                try:
                    q, r, piv = run()
                    torch.cuda.synchronize()
                except RuntimeError as exc:
                    print(json.dumps({**row, "error": str(exc)}), flush=True)
                    failed += layout == chosen
                    continue
                row["pivots_equal"] = torch.equal(piv.long(), piv0)
                row["max_abs_err"] = max(float((q - q0).abs().max()),
                                         float((r - r0).abs().max()))
                ok = row["pivots_equal"] and row["max_abs_err"] <= spec.tol
                failed += not ok
                if clocks:
                    read_clocks(library, spec.entry, reset=True)
                    run()
                    torch.cuda.synchronize()
                    cycles = read_clocks(library, spec.entry, reset=False)
                    parts = SPLIT_CLOCK_PARTS if layout.code == 1 else \
                        CLOCK_PARTS
                    row["cycles_per_step"] = {
                        part: round(count / k)
                        for part, count in zip(parts, cycles)}
                elif not quick:
                    row["device_ms"] = device_ms(torch, run)
                print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
