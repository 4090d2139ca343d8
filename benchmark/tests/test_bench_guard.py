"""The guard against JAX: top-level names compared whole, and a whole run
of a cell in a fresh interpreter that loads none of them."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.core import guard

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_are_compared_whole():
    modules = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
               "rusty_compression_tpu", "rusty_compression_tpu.ops",
               "rusty_compression_tpu_torch", "rusty_compression_tpu_torch.x",
               "jaxtyping", "flaxen", "torch"]
    assert guard.forbidden_modules(modules) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "rusty_compression_tpu", "rusty_compression_tpu.ops"]
    with pytest.raises(guard.JaxLoaded):
        guard.require_no_jax("test", ["rusty_compression_tpu.config"])
    guard.require_no_jax("test", ["rusty_compression_tpu_torch.config"])


RUN = """
import json, sys, time, types
sys.path.insert(0, {root!r})
import torch
from benchmark.core import cli, guard, registry
if {late!r}:
    load = registry.load_check

    def load_check(name):
        measure = load(name).measure

        def late(*args, **kwargs):  # as an import inside the check would
            sys.modules["jax"] = types.ModuleType("jax")
            return measure(*args, **kwargs)
        return types.SimpleNamespace(measure=late)
    registry.load_check = load_check
try:
    result = cli.run(["--workload", {cell!r}, "--seed", "5", "--seconds",
                      "0.2", "--trace", "1"], time.perf_counter(),
                     device=torch.device("cpu"), scale={scale!r})
    out = {{"forbidden": guard.forbidden_modules(),
           "correct": result["correct"]}}
except guard.JaxLoaded as e:
    out = {{"refused": str(e)}}
print(json.dumps(out))
"""

SCALES = {"bem_block_8k_f64.two_sided_id_tol1e-8": {"rows": 256, "cols": 192},
          "bem_stack_16k_f32.rsvd_rank16": {"blocks": 2, "rows": 192,
                                            "cols": 160}}


def _run(cell: str, late: bool) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT), cell=cell,
                                          scale=SCALES[cell], late=late)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(SCALES))
def test_a_run_loads_no_jax(cell):
    assert _run(cell, late=False) == {"forbidden": [], "correct": True}


def test_a_module_loaded_by_the_check_is_caught_at_exit():
    """The check and the references run after the window: what they load
    is seen by the guard at exit, and the run gives no result."""
    result = _run("bem_stack_16k_f32.rsvd_rank16", late=True)
    assert result["refused"].startswith("at exit: sys.modules holds jax")


def test_run_without_a_card_prints_nothing_and_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "bem_block_8k_f64.two_sided_id_tol1e-8", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 3 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_unknown_workload_prints_nothing_and_fails():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "no.such_cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
