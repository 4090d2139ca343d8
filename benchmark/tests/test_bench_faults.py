"""Whole runs of each cell at a size the CPU holds, with the look for a
card skipped: a sound run is correct; the cell's control, and each fault
the cell can have planted under the timed path, are not.

Faults (where the cell can have them): a step that returns its state
unchanged (a capture round that adds no direction), half of the batch left
out (the other half's answers copied over it), and an answer altered where
it is produced. A one-card cell has no exchange between cards to leave
out; a single block has no batch."""

import time

import pytest
import torch

from benchmark.core import cli, data as data_mod, entry, registry

from conftest import SMALL

BENCH = registry.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def run_cell(cell: str, device=None, scale=None, seed=11) -> dict:
    scale = SMALL[cell.split(".")[0]] if scale is None else scale
    return cli.run(["--workload", cell, "--seed", str(seed), "--seconds",
                    "0.3", "--trace", "0"], time.perf_counter(),
                   device=device or torch.device("cpu"), scale=scale)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result = run_cell(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"GB_per_s", "call_ms_p95",
                                      "peak_mem_GB", "setup_s"}


def control_correct(cell: str, device, scale, seed: int) -> bool:
    entry_ = registry.find_cell(BENCH, cell)
    config = {**registry.load_config(BENCH, entry_["config"]), **scale}
    traffic = registry.load_traffic(entry_["traffic"])
    cell_file = registry.load_cell(cell)
    data = data_mod.make_data(config, seed, device)
    out = entry.make_call(traffic, data, seed, cell_file["control"])()
    check = registry.load_check(traffic["output"])
    gen = torch.Generator(device=device).manual_seed(1)
    return cli.judge(check, data, [out], traffic.get("check_params", {}),
                     cell_file["limits"], gen)[0]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(cell, seed):
    assert not control_correct(cell, torch.device("cpu"),
                               SMALL[cell.split(".")[0]], seed)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(card, cell):
    """At the cell's widths with fewer blocks, on the card's own kernels
    (which cuBLAS picks by shape)."""
    scale = {"blocks": 4} if cell.startswith("bem_stack") else {}
    for seed in (1, 2, 3):
        assert not control_correct(cell, card, scale, seed)


# -- faults -----------------------------------------------------------------

def _state_unchanged(monkeypatch):
    from rusty_compression_tpu_torch import highacc

    monkeypatch.setattr(highacc, "_deflate",
                        lambda basis, u: torch.zeros_like(u))


def _pivots_altered(monkeypatch):
    from rusty_compression_tpu_torch import highacc_id

    core = highacc_id._core_qrcp

    def altered(b):
        r, ind = core(b)
        ind = ind.clone()
        ind[[0, 1]] = ind[[1, 0]]
        return r, ind

    monkeypatch.setattr(highacc_id, "_core_qrcp", altered)


def _singular_value_altered(monkeypatch):
    from rusty_compression_tpu_torch import highacc

    core = highacc._core_svd

    def altered(b):
        uh, s, vh = core(b)
        s = s.clone()
        s[..., 0] *= 1 + 1e-6
        return uh, s, vh

    monkeypatch.setattr(highacc, "_core_svd", altered)


def _svd_altered(monkeypatch):
    from rusty_compression_tpu_torch.models.svd import SVD

    keep = SVD.compress_svd_rank

    def altered(self, max_rank):
        out = keep(self, max_rank)
        s = out.s.clone()
        s[..., 0] *= 1.01
        return SVD(out.u, s, out.vt)

    monkeypatch.setattr(SVD, "compress_svd_rank", altered)


def _halves(fn, join):
    """``fn`` over the first half of a stack, its answers copied onto the
    second half."""
    def half(blocks, *args, **kwargs):
        out = fn(blocks[: blocks.shape[0] // 2], *args, **kwargs)
        return join(out)
    return half


def _rsvd_half(monkeypatch):
    from rusty_compression_tpu_torch.models.svd import SVD
    from rusty_compression_tpu_torch.parallel import mesh

    twice = lambda x: torch.cat([x, x])  # noqa: E731
    monkeypatch.setitem(mesh._METHODS, "rsvd", _halves(
        mesh._METHODS["rsvd"],
        lambda o: SVD(twice(o.u), twice(o.s), twice(o.vt))))


FAULTS = [
    ("bem_block_8k_f64.two_sided_id_tol1e-8", _state_unchanged),
    ("bem_block_8k_f64.two_sided_id_tol1e-8", _pivots_altered),
    ("bem_block_8k_f64.rsvd_tol1e-8", _state_unchanged),
    ("bem_block_8k_f64.rsvd_tol1e-8", _singular_value_altered),
    ("bem_stack_16k_f32.rsvd_rank16", _rsvd_half),
    ("bem_stack_16k_f32.rsvd_rank16", _svd_altered),
]


@pytest.mark.parametrize(
    "cell, plant", FAULTS,
    ids=[f"{c}-{p.__name__.strip('_')}" for c, p in FAULTS])
def test_a_planted_fault_is_not_correct(monkeypatch, cell, plant):
    assert cell in CELLS
    plant(monkeypatch)
    result = run_cell(cell)
    assert not result["correct"], result["checks"]


def test_every_cell_has_its_faults():
    assert {c for c, _ in FAULTS} == set(CELLS)
