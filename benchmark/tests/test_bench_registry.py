"""BENCHMARK.json against the benchmark's contract, and every name it holds
found in a file of its own."""

import json
import re

import pytest

from benchmark.core import registry

BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj"
                    r"|head|rows|cols|rank|expan")


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_run_length_fits_a_full_check_of_24_cells():
    per_run = BENCH["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_entries_have_only_the_contract_keys(kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[kind]
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        extra = set(e) - keys
        assert extra <= ({"workloads"} if kind in ("end_to_end", "per_layer")
                         else set()), (e["name"], extra)
        assert keys <= set(e), e["name"]
        assert NAME.match(e["name"])
        for text in ("why", "layer", "source"):
            if text in e and kind != "end_to_end" and kind != "per_layer":
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"GB_per_s", "call_ms_p95", "peak_mem_GB", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    entry = registry.find_cell(BENCH, cell)
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200
    config = registry.load_config(BENCH, entry["config"])
    traffic = registry.load_traffic(entry["traffic"])
    limits = registry.load_cell(cell)["limits"]
    check = registry.load_check(traffic["output"])
    assert limits and all(v >= 0 for v in limits.values())
    assert traffic["entry"].split(".")[0] == "rusty_compression_tpu_torch"
    assert check.measure
    for name in registry.metric_names(BENCH, cell, True):
        registry.load_metric(name)
    for name in registry.metric_names(BENCH, cell, False):
        registry.load_metric(name)
    assert set(config["reduced"]) <= set(config)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(config):
    loaded = registry.load_config(BENCH, config["name"])
    assert loaded["reduced"] == config["reduced"]
    assert config["file"].startswith("benchmark/configs/")
    for key in config["reduced"]:
        assert not WIDTHS.search(key), key
        assert key in loaded.get("source_values", {})
    assert any(c["config"] == config["name"] for c in BENCH["workloads"])


@pytest.mark.parametrize("kind, name", [
    ("workload", "nope.nothing"), ("workload", "../BENCHMARK"),
    ("traffic", "no_such_traffic"), ("metric", "no_such_metric"),
    ("check", "no_such_output"), ("metric", "../core/cli")])
def test_unknown_names_are_refused(kind, name):
    load = {"workload": lambda n: registry.find_cell(BENCH, n),
            "traffic": registry.load_traffic,
            "metric": registry.load_metric,
            "check": registry.load_check}[kind]
    with pytest.raises(registry.UnknownName):
        load(name)


def test_metrics_of_a_cell_follow_their_workloads_keys():
    cell = "bem_block_8k_f64.two_sided_id_tol1e-8"
    traced = registry.metric_names(BENCH, cell, True)
    assert "K3_roofline" in traced
    assert "K3_roofline" not in registry.metric_names(
        BENCH, "bem_block_8k_f64.rsvd_tol1e-8", True)
    assert registry.metric_names(BENCH, cell, False) == [
        "GB_per_s", "call_ms_p95", "peak_mem_GB", "setup_s"]
