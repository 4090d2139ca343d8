"""The readings that a cell's limits are set from, run on the card apart
from the benchmark's own runs (which never run the control).

    python3 benchmark/calibrate.py --workload <config>.<traffic> \\
        --seeds 11,12,... --control-seeds 21,22,23 [--out FILE]

For each seed of ``--seeds``: the cell's data, one warm-up call and one
call of the timed entry at the cell's own size, and every number the
cell's check measures on it. For each seed of ``--control-seeds`` the
same with the cell's control in the program's place (``cells/*.json``):
a plain reference pipeline computed in the precision below the
configuration's. Prints one JSON line
a reading, then the summary: per number the largest reading of the
program (the lower reading) and the smallest of the control (the upper
reading), beside the cell's limit.
"""

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.core import data as data_mod  # noqa: E402
from benchmark.core import entry, registry  # noqa: E402


def readings(workload: str, seeds, control_seeds, device=None,
             scale: dict | None = None, emit=print) -> dict:
    import torch

    bench = registry.load_benchmark()
    cell = registry.find_cell(bench, workload)
    config = {**registry.load_config(bench, cell["config"]), **(scale or {})}
    traffic = registry.load_traffic(cell["traffic"])
    cell_file = registry.load_cell(workload)
    check = registry.load_check(traffic["output"])
    if device is None:
        device = torch.device("cuda", 0)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    params = traffic.get("check_params", {})
    runs = {"program": [], "control": []}
    for side, side_seeds in (("program", seeds), ("control", control_seeds)):
        ctrl = cell_file["control"] if side == "control" else None
        for seed in side_seeds:
            data = data_mod.make_data(config, seed, device)
            call = entry.make_call(traffic, data, seed, ctrl)
            try:
                call()
                sync()
                t0 = time.perf_counter()
                out = call()
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                del call
                gen = torch.Generator(device=device).manual_seed(
                    entry.program_seed(seed) + 1)
                numbers = check.measure(data, out, params, gen)
                rank = next(getattr(out, f).shape[-1]
                            for f in ("x", "s", "c") if hasattr(out, f))
            except Exception as e:  # a control that fails has failed
                numbers, ms, rank = {"error": repr(e)[:300]}, None, None
            row = {"side": side, "seed": seed, "ms": ms, "rank": rank,
                   **numbers}
            runs[side].append(row)
            emit(json.dumps(row))
            del data
    summary = {}
    for name, limit in cell_file["limits"].items():
        lower = max((r.get(name, math.inf) for r in runs["program"]),
                    default=None)
        upper = min((r.get(name, math.inf) for r in runs["control"]),
                    default=None)
        summary[name] = {"lower": lower, "upper": upper, "limit": limit}
    return {"workload": workload, "summary": summary, "runs": runs}


def main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    result = readings(args.workload, ints(args.seeds),
                      ints(args.control_seeds))
    print(json.dumps({"summary": result["summary"]}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
