"""Finds a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names the cells, the
configurations and the metrics; each name leads to a file of its own under
``benchmark/``. An unknown name, or a name whose file is missing, raises
``UnknownName``: a run never guesses.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
BENCHMARK_JSON = ROOT / "BENCHMARK.json"

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class UnknownName(LookupError):
    """A workload, configuration, traffic mix, metric or check that the
    benchmark does not have."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name) or ".." in name:
        raise UnknownName(f"{what} {name!r} is not a valid name")
    return name


def _file(folder: str, name: str, suffix: str, what: str) -> Path:
    path = HERE / folder / f"{check_name(name, what)}{suffix}"
    if not path.is_file():
        raise UnknownName(f"no {what} {name!r} (looked for "
                          f"{path.relative_to(ROOT)})")
    return path


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Path = BENCHMARK_JSON) -> dict:
    return _json(path)


def find_cell(bench: dict, workload: str) -> dict:
    """The ``workloads`` entry named ``workload``."""
    check_name(workload, "workload")
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise UnknownName(f"no workload {workload!r} in BENCHMARK.json")


def load_config(bench: dict, name: str) -> dict:
    """The configuration's file, as ``BENCHMARK.json``'s entry names it."""
    check_name(name, "configuration")
    for entry in bench["configs"]:
        if entry["name"] == name:
            path = (ROOT / entry["file"]).resolve()
            if HERE not in path.parents or not path.is_file():
                raise UnknownName(f"configuration {name!r}: no file "
                                  f"{entry['file']!r} under benchmark/")
            config = _json(path)
            if config.get("name") != name:
                raise UnknownName(f"{entry['file']} names "
                                  f"{config.get('name')!r}, not {name!r}")
            return config
    raise UnknownName(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str) -> dict:
    return _json(_file("traffic", name, ".json", "traffic mix"))


def load_cell(workload: str) -> dict:
    """The cell's own file: compared numbers, limits, control."""
    return _json(_file("cells", workload, ".json", "cell file"))


def _module(folder: str, name: str, what: str) -> ModuleType:
    path = _file(folder, name, ".py", what)
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder}.{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_metric(name: str) -> ModuleType:
    """``metrics/<name>.py``: a module with ``read(records)``."""
    module = _module("metrics", name, "per-layer metric")
    if not callable(getattr(module, "read", None)):
        raise UnknownName(f"metrics/{name}.py has no read(records)")
    return module


def load_check(name: str) -> ModuleType:
    """``checks/<name>.py``: a module with ``measure(...)``."""
    module = _module("checks", name, "check")
    if not callable(getattr(module, "measure", None)):
        raise UnknownName(f"checks/{name}.py has no measure(...)")
    return module


def metric_names(bench: dict, workload: str, trace: bool) -> list[str]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    (``trace`` false) or its per-layer metrics (``trace`` true). A metric
    with a ``workloads`` key belongs to the cells it lists, one without
    it to every cell."""
    kind = "per_layer" if trace else "end_to_end"
    return [m["name"] for m in bench[kind]
            if workload in m.get("workloads", [workload])]
