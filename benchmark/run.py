"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 benchmark/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks`` last); the numbers
the check compares stand beside their limits on the last lines of standard
error. Exit codes: 2 an unknown name, 3 no card (or too few), 4 JAX loaded;
no result is printed then.

The caller is one process with one host thread. The compile caches are
kept at fixed paths inside the checkout: the port
builds its kernels into ``rusty_compression_tpu_torch/_build/``, and
Triton's and torch's extension caches go under ``benchmark/.cache/``.
"""

import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_CACHE = ROOT / "benchmark" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
# one host thread for the caller's process, the port's host LAPACK work
# included: with the default of a thread a core, the host SVD of the
# rsvd_tol1e-8 cell ran slower and spread three times as wide (PERF.md)
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
sys.path.insert(0, str(ROOT))

from benchmark.core import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], _T0))
