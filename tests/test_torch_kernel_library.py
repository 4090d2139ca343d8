"""The one module that builds, loads and launches the port's native code
(``ops/kernels/library.py``): its table of C entry points against the
sources, the names of its libraries, its launch errors, and that no other
module of the kernel layer compiles or loads a library.

Nothing here needs ``nvcc`` or a card; the compile-and-cache function is
run with g++ on a small C file (``tests/test_torch_native.py`` builds the
host planner through it too). ``tests/test_torch_cuda.py`` launches every
wrapper on the card.
"""

import ast
import re
import shutil
from pathlib import Path

import pytest

from torch_threads import one_thread  # noqa: F401 (autouse)

PKG = Path(__file__).resolve().parents[1] / "rusty_compression_tpu_torch"


@pytest.fixture(scope="module")
def lib():
    import torch  # noqa: F401  (the port imports it; kept out of collection)

    from rusty_compression_tpu_torch.ops.kernels import library

    return library


def c_entry_points(text: str) -> dict[str, int]:
    """The functions declared inside the source's ``extern "C"`` blocks,
    with their counts of parameters."""
    found = {}
    for block in re.findall(r'extern "C" \{(.*?)\}  // extern "C"', text,
                            re.S):
        for name, params in re.findall(r"\bint (rc_\w+)\(([^)]*)\)", block):
            found[name] = len(params.split(","))
    return found


def test_every_row_is_declared_in_its_source(lib):
    declared = {}
    for source in sorted(lib.CSRC.glob("*.cu")):
        declared.update({name: (source.name, count) for name, count in
                         c_entry_points(source.read_text()).items()
                         if "_clocks_" not in name})
    assert {name: (source, len(args)) for name, (source, args)
            in lib.ENTRY_POINTS.items()} == declared
    assert ({source for source, _ in lib.ENTRY_POINTS.values()}
            == {path.name for path in lib.CSRC.glob("*.cu")})
    assert len(lib.ENTRY_POINTS) == 6


@pytest.mark.parametrize("edit,renamed", [
    (None, False),
    ("kernel.cu", True),
    ("common.cuh", True),
    ("inner.cuh", True),       # included by common.cuh, not by the source
    ("unrelated.cuh", False),
    ("define", True),
])
def test_the_library_name_follows_the_source_headers_and_defines(
        lib, tmp_path, edit, renamed):
    files = {"kernel.cu": '#include "common.cuh"\n#include <math.h>\n',
             "common.cuh": '#pragma once\n#include "inner.cuh"\n',
             "inner.cuh": "#pragma once\n", "unrelated.cuh": "\n"}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    source = tmp_path / "kernel.cu"
    flags = list(lib.NVCC_FLAGS)
    before = lib.library_path(source, flags)
    if edit == "define":
        flags.append("-DRC_QRCP_CLOCKS")
    elif edit is not None:
        (tmp_path / edit).write_text(files[edit] + "// edited\n")
    after = lib.library_path(source, flags)
    assert (after != before) == renamed
    assert after.parent == lib.BUILD_DIR
    assert re.fullmatch(r"libkernel_[0-9a-f]{12}\.so", after.name)


def test_compile_sources_builds_once_and_leaves_no_temporary_file(
        lib, tmp_path, monkeypatch):
    cc = shutil.which("g++")
    if cc is None:
        pytest.skip("no g++ to compile with")
    monkeypatch.setattr(lib, "BUILD_DIR", tmp_path / "_build")
    good = tmp_path / "good.c"
    good.write_text("int rc_answer(void) { return 42; }\n")
    flags = ["-O1", "-fPIC", "-shared", "-x", "c"]
    path, _ = lib.compile_sources([good], cc, flags)[good]
    assert path == lib.library_path(good, flags) and path.exists()
    assert lib.compile_sources([good], cc, flags)[good] == (path, "")
    bad = tmp_path / "bad.c"
    bad.write_text("int rc_answer(void) { return }\n")
    with pytest.raises(lib.BuildError, match="libbad_"):
        lib.compile_sources([bad], cc, flags)
    assert sorted(p.name for p in lib.BUILD_DIR.iterdir()) == [path.name]


@pytest.mark.parametrize("err,why", [
    (-1, "the card cannot schedule a cluster of this layout"),
    (-2, "the layout's or plan's numbers do not fit together"),
    (700, "CUDA error 700"),
])
def test_launch_errors(lib, err, why):
    raised = lib.launch_error(err, "qrcp_panel_f64", "PanelLayout(...)")
    assert isinstance(raised, RuntimeError)
    assert str(raised) == ("qrcp_panel_f64: kernel launch failed for "
                           f"PanelLayout(...): {why}")


def imported_modules(tree: ast.AST) -> set[str]:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.update(f"{node.module or ''}.{a.name}".lstrip(".")
                         for a in node.names)
            names.add(node.module or "")
    return names


def test_only_the_library_compiles_and_loads():
    """In the kernel layer and ``native.py`` only ``library.py`` imports
    ``hashlib`` or ``tempfile``, starts a process other than
    ``nvidia-smi``, or renames a file; ``ctypes.CDLL`` is called there and
    in ``native.py``'s loader alone; ``tsqr.py`` does not import
    ``qrcp``."""
    files = [*sorted((PKG / "ops" / "kernels").glob("*.py")),
             PKG / "native.py"]
    assert "library.py" in [f.name for f in files]
    for path in files:
        if path.name == "library.py":
            continue
        tree = ast.parse(path.read_text())
        assert not imported_modules(tree) & {"hashlib", "tempfile"}, path
        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute):
                continue
            assert node.attr not in ("replace", "Popen", "mkstemp") or (
                not isinstance(node.value, ast.Name)
                or node.value.id not in ("os", "subprocess", "tempfile")), \
                (path.name, node.attr)
            if node.attr == "CDLL":
                assert path.name == "native.py", path.name
            if node.attr in ("run", "call", "check_output") and isinstance(
                    node.value, ast.Name) and node.value.id == "subprocess":
                command = next(n for n in ast.walk(tree)
                               if isinstance(n, ast.Call) and n.func is node)
                assert isinstance(command.args[0], ast.List)
                assert command.args[0].elts[0].value == "nvidia-smi"
    tsqr = ast.parse((PKG / "ops" / "kernels" / "tsqr.py").read_text())
    assert not any(name.endswith("qrcp") or ".qrcp." in name
                   for name in imported_modules(tsqr))
