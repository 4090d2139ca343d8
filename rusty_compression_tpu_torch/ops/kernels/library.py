"""How the port's native code is compiled, cached, loaded and launched.

``ENTRY_POINTS`` is the one table of the kernels' C entry points; a new
kernel is one row here and a wrapper. A CUDA source is compiled for
``sm_90a`` with ``nvcc`` (a plain C interface: seconds, and no PyTorch
headers) at the first use of one of its entry points; ``native.py``
builds the C++ host planner with g++ through ``compile_sources`` too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

__all__ = ["ENTRY_POINTS", "BuildError", "library_path", "compile_sources",
           "build", "count_clocks", "entry", "handle", "launch"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P, _I = ctypes.c_void_p, ctypes.c_int
#: Each C entry point: its source under ``csrc/`` and its arguments as the
#: source declares them, the stream last.
ENTRY_POINTS = {
    "rc_qrcp_panel_f32": ("qrcp.cu", (_P,) * 11 + (_I,) * 9 + (_P,)),
    "rc_qrcp_panel_c64": ("qrcp_c64.cu", (_P,) * 11 + (_I,) * 9 + (_P,)),
    "rc_qrcp_panel_f64": ("qrcp_f64.cu", (_P,) * 11 + (_I,) * 10 + (_P,)),
    "rc_qrcp_panel_c128": ("qrcp_c128.cu", (_P,) * 11 + (_I,) * 10 + (_P,)),
    "rc_tsqr_f32": ("tsqr.cu", (_P,) * 7 + (_I,) * 11 + (_P,)),
    "rc_tsqr_f64": ("tsqr.cu", (_P,) * 7 + (_I,) * 11 + (_P,)),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
#: What the C entry points return beside CUDA's own error codes.
LAUNCH_ERRORS = {
    -1: "the card cannot schedule a cluster of this layout",
    -2: "the layout's or plan's numbers do not fit together",
}
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)
_defines: tuple[str, ...] = ()
_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    """``nvcc`` was not found, or a compiler failed."""


def library_path(source: Path, flags: Sequence[str]) -> Path:
    """Where the library of ``source`` built with ``flags`` lives (built or
    not), named by a hash of the source, the local headers it includes
    (its ``#include "…"`` lines, followed into those headers) and the
    flags, defines included."""
    digest, files, todo = hashlib.sha256(), [], [source]
    while todo:
        path = todo.pop()
        if path not in files:
            files.append(path)
            text = path.read_bytes()
            digest.update(text)
            todo += [path.parent / name.decode()
                     for name in _INCLUDE.findall(text)]
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:12]}.so"


def compile_sources(sources: Sequence[Path], compiler: str,
                    flags: Sequence[str]) -> dict[Path, tuple[Path, str]]:
    """Compile each of ``sources`` whose ``library_path`` is not there, all
    started together, each into a file of this process and thread that is
    then renamed: no process loads a partial library. Returns, by source,
    the library's path and the compiler's report (``nvcc``'s: ptxas's
    registers, shared memory and spills; empty for a library found)."""
    built, running, failures = {}, [], []
    for source in dict.fromkeys(sources):
        lib = library_path(source, flags)
        if lib.exists():
            built[source] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}."
                            f"{threading.get_ident()}.tmp")
        running.append((source, lib, tmp, subprocess.Popen(
            [compiler, *flags, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for source, lib, tmp, proc in running:
        report = proc.communicate()[1]
        if proc.returncode == 0:
            os.replace(tmp, lib)
            built[source] = (lib, report)
        else:
            tmp.unlink(missing_ok=True)
            failures.append(f"{lib.name}:\n{report}")
    if failures:
        raise BuildError(f"{compiler} failed:\n" + "\n".join(failures))
    return built


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (set CUDA_HOME)")


def _compile_entries(names) -> dict[str, tuple[Path, str]]:
    sources = {name: CSRC / ENTRY_POINTS[name][0] for name in names}
    built = compile_sources(list(sources.values()), _nvcc(), [
        *NVCC_FLAGS, *(f"-D{name}" for name in _defines)])
    return {name: built[source] for name, source in sources.items()}


def build() -> dict[str, tuple[Path, str]]:
    """Compile every CUDA source of ``ENTRY_POINTS``. Returns, by entry
    point, the library's path and the compiler's report."""
    return _compile_entries(ENTRY_POINTS)


def count_clocks() -> None:
    """Build the CUDA sources with ``RC_QRCP_CLOCKS`` from here on (the
    step clocks of ``sweep.py --clocks``): call it before the first load."""
    global _defines
    _defines = ("RC_QRCP_CLOCKS",)


def handle(name: str) -> ctypes.CDLL:
    """The loaded library that holds entry point ``name`` (its source built
    first where its library is not there), the entry point declared."""
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(_compile_entries([name])[name][0]))
            fn = getattr(lib, name)  # kept by ``lib`` as its attribute
            fn.argtypes = list(ENTRY_POINTS[name][1])
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


def entry(name: str):
    """The C entry point ``name``, loaded with its argument list."""
    return getattr(handle(name), name)


def launch_error(err: int, caller: str, plan) -> RuntimeError:
    """The error of return code ``err`` of ``caller``'s launch at ``plan``."""
    why = LAUNCH_ERRORS.get(err, f"CUDA error {err}")
    return RuntimeError(f"{caller}: kernel launch failed for {plan}: {why}")


def launch(name: str, device: torch.device, args: Sequence, caller: str,
           plan) -> None:
    """Run entry point ``name`` on ``device``'s current stream with ``args``
    (a tensor passed as its data pointer); raise ``launch_error`` for a
    nonzero return code. Does not synchronise."""
    args = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]
    fn = entry(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise launch_error(err, caller, plan)
