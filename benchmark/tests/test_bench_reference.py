"""The plain references: they import nothing of the port (nor JAX), and at
a size the CPU holds they agree with the port on the same blocks."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.core import data as data_mod
from benchmark.core import registry
from benchmark.reference import measures, pipelines, spectrum

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "benchmark" / "reference"
BENCH = registry.load_benchmark()


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for name in names:
            assert name.split(".")[0] in ("__future__", "types", "numpy",
                                          "scipy", "torch", "benchmark",
                                          "math", "statistics"), name
            if name.startswith("benchmark"):
                assert name.startswith("benchmark.reference"), name


def test_reference_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.pipelines, "
            "benchmark.reference.measures, benchmark.reference.spectrum\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    tops = set(eval(out.stdout))
    assert not tops & {"jax", "jaxlib", "flax", "rusty_compression_tpu",
                       "rusty_compression_tpu_torch"}


def _data(config_name, scale, seed=3):
    config = {**registry.load_config(BENCH, config_name), **scale}
    return data_mod.make_data(config, seed, "cpu")


def test_measures_on_exact_factors():
    a = torch.randn(300, 200, dtype=torch.float64)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    assert measures.rel_resid(a, u * s, vt) < 1e-14
    assert measures.proj_resid(a, u, s, vt) < 1e-14
    assert measures.orth_err(u) < 1e-13
    assert measures.fro(a) == pytest.approx(float(a.norm()))
    assert measures.is_index_set(torch.tensor([3, 1, 2, 2]), 5, 3)
    assert not measures.is_index_set(torch.tensor([3, 3, 2]), 5, 3)
    assert not measures.is_index_set(torch.tensor([3, 7, 2]), 5, 3)
    sigma = spectrum.singular_values(a, torch.Generator().manual_seed(0),
                                     width=512)
    assert np.allclose(sigma, s.numpy(), rtol=1e-12)
    assert spectrum.crossing(sigma, sigma[5] / sigma[0]) == 6


def test_spectrum_of_a_capture_matches_the_exact_one():
    a = _data("bem_block_8k_f64", {"rows": 700, "cols": 600})
    exact = torch.linalg.svdvals(a).numpy()
    sigma = spectrum.singular_values(a, torch.Generator().manual_seed(1),
                                     width=256)
    k = spectrum.crossing(exact, 1e-8)
    assert spectrum.crossing(sigma, 1e-8) == k
    assert np.abs(sigma[:k] - exact[:k]).max() / exact[0] < 1e-13


def test_refined_two_sided_id_agrees_with_the_port():
    import rusty_compression_tpu_torch as rt

    a = _data("bem_block_8k_f64", {"rows": 384, "cols": 320})
    gen = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    check = registry.load_check("two_sided_id")
    port = check.measure(a, rt.refined_two_sided_id(a, gen(), tol=1e-8),
                         {"tol": 1e-8}, gen())
    ref_out = pipelines.refined_two_sided_id(a, gen(), tol=1e-8)
    ref = check.measure(a, ref_out, {"tol": 1e-8}, gen())
    for numbers in (port, ref):
        assert numbers["resid"] < 1e-8
        assert numbers["skeleton"] == 0 and numbers["identity"] == 0
    assert abs(port["rank_excess"] - ref["rank_excess"]) <= 3


def test_refined_rsvd_agrees_with_the_port():
    import rusty_compression_tpu_torch as rt

    a = _data("bem_block_8k_f64", {"rows": 384, "cols": 320})
    port = rt.refined_rsvd(a, torch.Generator().manual_seed(2), tol=1e-8)
    ref = pipelines.refined_rsvd(a, torch.Generator().manual_seed(3),
                                 tol=1e-8)
    assert port.s.shape == ref.s.shape
    assert float((port.s - ref.s).abs().max() / ref.s[0]) < 1e-12
    check = registry.load_check("svd")
    for out in (port, ref):
        n = check.measure(a, out, {"tol": 1e-8},
                          torch.Generator().manual_seed(4))
        assert n["resid"] < 1e-7 and n["orth"] < 1e-12 and n["proj"] < 1e-12
        assert n["rank_gap"] == 0 and n["sv_err"] < 1e-12


def test_rank16_references_agree_with_the_port():
    import rusty_compression_tpu_torch as rt
    from rusty_compression_tpu_torch.config import CompressionConfig

    stack = _data("bem_stack_16k_f32", {"blocks": 3, "rows": 256,
                                        "cols": 320})
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    svd = registry.load_check("svd")
    port = svd.measure(stack, rt.compress(stack, gen(),
                                          CompressionConfig.RANK(16)),
                       {}, gen())
    ref_out = pipelines.rsvd(stack, gen(), 16)
    ref = svd.measure(stack, ref_out, {}, gen())
    assert port["resid"] < 2 * ref["resid"]
    assert ref["resid"] < 2 * port["resid"]


def test_tf32_rounds_to_ten_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0,
                      2.0 ** -100], dtype=torch.float32)
    y = pipelines.tf32(x)
    assert y.tolist()[:2] == [1.0, 1.0 + 2 ** -10]
    assert y[3] == -3.0
    z = torch.randn(10000)
    assert float(((pipelines.tf32(z) - z) / z).abs().max()) <= 2 ** -11
