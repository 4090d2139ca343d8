"""K1 and K2: fused column-pivoted Gram–Schmidt QR panels — CUDA kernels
and their plain PyTorch version.

Ports of the Pallas TPU kernels of
``rusty_compression_tpu/ops/pallas/qrcp.py``: K1 is ``qrcp_panel`` (f32,
``csrc/qrcp.cu``), K2 is ``qrcp_panel_complex`` (c64,
``csrc/qrcp_c64.cu``). Both instantiate the one step loop of
``csrc/qrcp_common.cuh``: one panel over a thread-block cluster, the
columns split over its CTAs, each CTA's residual slice in its shared
memory where it fits (``panel_layout`` decides, from the shape alone).
Each source is compiled for ``sm_90a`` with ``nvcc`` into ``_build/`` at
the first use of either kernel on a CUDA tensor (one ``nvcc`` per source,
started together) and bound through ``ctypes`` (a plain C interface, so a
build takes seconds and needs neither ninja nor PyTorch's headers).

``qrcp_panel`` and ``qrcp_panel_complex`` run the plain version for a
tensor on the CPU and launch their kernel for a CUDA tensor, or raise;
they never fall back. Each counts its kernel launches in its
``launch_count`` and keeps the distinct shapes it launched at in its
``launched_shapes``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from ...utils.dtypes import real_dtype

__all__ = ["qrcp_panel", "qrcp_panel_complex", "qrcp_panel_plain",
           "kernel_fits", "panel_layout", "PanelLayout", "build"]

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
_HEADER = _CSRC / "qrcp_common.cuh"
#: C entry point -> its source.
_SOURCES = {"rc_qrcp_panel_f32": _CSRC / "qrcp.cu",
            "rc_qrcp_panel_c64": _CSRC / "qrcp_c64.cu"}
_BUILD_DIR = _PKG / "_build"

#: Dynamic shared memory the kernel may request: an H100 block gets at
#: most 232,448 bytes, less the kernel's 1 KB of static shared memory.
SMEM_LIMIT_BYTES = 232448 - 1024
#: Cluster sizes the kernels take (16 is Hopper's non-portable maximum).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_THREADS = 1024
#: Residual elements a CTA may hold before the layout rule splits the
#: panel over a larger cluster: below it a step's fixed cost (barriers,
#: reorthogonalization) outweighs the column pass (``sweep.py``'s table).
_SPLIT_ELEMENTS = 4608


@dataclasses.dataclass(frozen=True)
class PanelLayout:
    """How one panel lies on the card: ``cluster`` CTAs, each owning
    ``width`` neighbouring columns and running ``threads`` threads with
    ``smem_bytes`` of dynamic shared memory; the residual slice in the
    owner's shared memory (``resid_in_smem``) or in a global workspace."""
    cluster: int
    width: int
    threads: int
    resid_in_smem: bool
    smem_bytes: int


def _basis_bytes(m: int, k: int, cluster: int, threads: int,
                 itemsize: int) -> int:
    """Shared memory every CTA needs whatever the layout: Q (m, k), the
    (q_{i-1}, q_i) pairs, the cluster's candidate pivot columns (two
    buffers of ``cluster`` columns; one buffer for a CTA alone), the
    projections and one partial sum per thread."""
    buffers = 2 if cluster > 1 else 1
    return itemsize * (m * k + 2 * m + buffers * cluster * m + k + threads)


def _threads(m: int, width: int) -> int:
    """Block size for a slice of ``width`` columns: every column of a wide
    slice gets a thread; a narrow slice gets several threads per column
    over row ranges of at least 8 rows; never fewer than 128. (A warp for
    every four columns of Q at k = 128 was slower: the barriers of a full
    block cost more than the second round of ``Q^H v``.)"""
    tw = -(-width // 32) * 32
    if tw >= MAX_THREADS:
        return MAX_THREADS
    split = max(1, min(m // 8, MAX_THREADS // tw))
    return max(128, split * tw)


def kernel_fits(m: int, k: int, itemsize: int = 4) -> bool:
    """Whether the kernels take an (m, n) panel at k steps, for any n: Q,
    replicated in every CTA, has to fit in shared memory beside the
    vectors of a full block; the residual may lie in global memory."""
    return _basis_bytes(m, k, 1, MAX_THREADS, itemsize) <= SMEM_LIMIT_BYTES


def layout_at(m: int, n: int, k: int, itemsize: int, cluster: int
              ) -> PanelLayout | None:
    """The layout of the panel over ``cluster`` CTAs: the residual slice
    (m, ceil(n / cluster)), its last R row and its norms in shared memory
    exactly when they fit there beside Q, else in global memory; None
    when not even Q and the cluster's candidate columns fit."""
    width = -(-n // cluster)
    threads = _threads(m, width)
    basis = _basis_bytes(m, k, cluster, threads, itemsize)
    smem = basis + itemsize * (m * width + width) + 4 * width
    if smem <= SMEM_LIMIT_BYTES:
        return PanelLayout(cluster, width, threads, True, smem)
    if basis <= SMEM_LIMIT_BYTES:
        return PanelLayout(cluster, width, threads, False, basis)
    return None


@functools.lru_cache(maxsize=1024)
def panel_layout(m: int, n: int, k: int, itemsize: int = 4
                 ) -> PanelLayout | None:
    """The layout of an (m, n) panel at k steps and ``itemsize`` bytes an
    element (4 for K1, 8 for K2), or None where ``kernel_fits`` is false.

    The smallest cluster whose residual slice fits in shared memory takes
    the panel, doubled while a CTA would still hold more than
    ``_SPLIT_ELEMENTS`` residual elements. A panel whose slice fits no
    cluster keeps its residual in global memory and takes the largest
    cluster that leaves a CTA at least a warp of columns."""
    if not kernel_fits(m, k, itemsize):
        return None
    layouts = [layout for cluster in CLUSTER_SIZES
               if (layout := layout_at(m, n, k, itemsize, cluster))]
    chosen = None
    for layout in layouts:
        if layout.resid_in_smem:
            chosen = layout
            if m * layout.width <= _SPLIT_ELEMENTS:
                break
    if chosen is None:
        wide = [layout for layout in layouts
                if layout.width >= 32 or layout.cluster == 1]
        chosen = wide[-1]
    return chosen


def abs2(x: torch.Tensor) -> torch.Tensor:
    """``|x|^2``, real; ``re^2 + im^2`` for complex input, as the complex
    kernels compute it (no hypot, so near-ties fall the same way)."""
    if x.is_complex():
        return x.real ** 2 + x.imag ** 2
    return x.abs() ** 2


def qrcp_panel_plain(a: torch.Tensor, k: int, used: torch.Tensor | None = None):
    """k-step pivoted Gram–Schmidt QRCP of ``a`` (..., m, n), any float or
    complex dtype: the port of ``ops.pivoted_qr._qrcp_gs`` plus the
    kernel's ``used`` mask (columns marked there are never pivots).

    Returns ``(q, r_orig, piv)``: q (..., m, k), r_orig (..., k, n) in
    original column order, piv (..., k) int64 in selection order.
    """
    *batch, m, n = a.shape
    rdt = real_dtype(a.dtype)
    resid = a.clone()
    norms = abs2(a).sum(-2).to(rdt)
    if used is not None:
        norms = torch.where(used.to(a.device) > 0, -1.0, norms)
    q = a.new_zeros((*batch, m, k))
    r = a.new_zeros((*batch, k, n))
    piv = torch.zeros((*batch, k), dtype=torch.int64, device=a.device)
    for i in range(k):
        # torch.argmax returns the first maximal index, as jnp.argmax does.
        j = torch.argmax(norms, dim=-1, keepdim=True)           # (..., 1)
        v = torch.take_along_dim(resid, j.unsqueeze(-2), dim=-1)[..., 0]
        v = v - (q @ (q.mH @ v.unsqueeze(-1)))[..., 0]
        nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        inv = torch.where(nv > 0, 1.0 / torch.where(nv > 0, nv, 1.0), 0.0)
        qi = v * inv.to(a.dtype)
        r_row = (qi.conj().unsqueeze(-2) @ resid)[..., 0, :]
        resid = resid - qi.unsqueeze(-1) * r_row.unsqueeze(-2)
        norms = torch.where(norms < 0, norms,
                            torch.clamp(norms - abs2(r_row), min=0.0))
        norms = norms.scatter(-1, j, -1.0)
        q[..., :, i] = qi
        r[..., i, :] = r_row
        piv[..., i] = j[..., 0]
    return q, r, piv


_libs: dict = {}
_lib_lock = threading.Lock()
#: Preprocessor names the sources are built with; ``sweep.py --clocks``
#: sets ``RC_QRCP_CLOCKS`` here before the first build.
_build_defines: tuple[str, ...] = ()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("qrcp_panel: nvcc not found (set CUDA_HOME)")


def build() -> dict[str, tuple[Path, str]]:
    """Compile the kernels' sources for sm_90a into ``_build/``, one
    ``nvcc`` per source and all started together, skipping a source whose
    library is already there. Returns, by C entry point, the library's
    path and the compiler's report (registers, shared memory, spills;
    empty for a library that was found)."""
    header = _HEADER.read_bytes()
    out, running = {}, []
    for entry, source in _SOURCES.items():
        digest = hashlib.sha256(source.read_bytes() + header + " ".join(
            _build_defines).encode()).hexdigest()[:12]
        lib = _BUILD_DIR / f"lib{source.stem}_{digest}.so"
        if lib.exists():
            out[entry] = (lib, "")
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler",
               "-fPIC", *(f"-D{name}" for name in _build_defines),
               "-o", tmp, str(source)]
        running.append((entry, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for entry, lib, tmp, proc in running:
        _, report = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{lib.name}:\n{report}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
        out[entry] = (lib, report)
    if failures:
        raise RuntimeError("qrcp_panel: nvcc failed:\n" + "\n".join(failures))
    return out


def _entry(name: str):
    """The C entry point ``name``, from its library (built on first use)."""
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build()[name][0]))
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _libs[name] = (lib, fn)
        return _libs[name][1]


#: What the C entry points return beside CUDA's own error codes.
_LAUNCH_ERRORS = {
    -1: "the card cannot schedule a cluster of this layout",
    -2: "the layout's numbers do not fit together",
}


def _panel(wrapper, entry: str, a: torch.Tensor, k: int,
           used: torch.Tensor | None, layout: PanelLayout | None = None):
    """What ``qrcp_panel`` and ``qrcp_panel_complex`` share: the checks,
    the plain version on the CPU, the launch of ``entry`` on the card.
    ``layout`` replaces the rule's choice (the kernel tests and the layout
    sweep force cluster sizes with it)."""
    name = wrapper.__name__
    if a.ndim not in (2, 3):
        raise ValueError(f"{name} expects (m, n) or (B, m, n), got "
                         f"shape {tuple(a.shape)}")
    *batch, m, n = a.shape
    k = int(k)
    if not 1 <= k <= min(m, n):
        raise ValueError(f"{name} needs 1 <= k <= min(m, n), got k={k} "
                         f"for a ({m}, {n}) panel")
    if used is not None and tuple(used.shape) not in ((n,), (*batch, n)):
        raise ValueError(f"used must have shape ({n},) or "
                         f"{(*batch, n)}, got {tuple(used.shape)}")
    if a.device.type == "cpu":
        q, r, piv = qrcp_panel_plain(a, k, used)
        return q, r, piv.to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {a.device}")
    if not a.is_contiguous() or a.is_conj():
        raise ValueError(f"{name} needs a contiguous panel (and no lazy "
                         f"conjugate: call resolve_conj())")
    if layout is None:
        layout = panel_layout(m, n, k, a.element_size())
    if layout is None:
        raise ValueError(
            f"{name}: Q of a ({m}, {n}) panel at k={k} needs "
            f"{_basis_bytes(m, k, 1, MAX_THREADS, a.element_size())} bytes of "
            f"shared memory, more than the {SMEM_LIMIT_BYTES} the kernel "
            f"may request")
    nb = batch[0] if batch else 1
    if used is not None:
        if used.device != a.device:
            raise ValueError("used must be on the panel's device")
        used = used.to(torch.float32).expand(*batch, n).contiguous()
    fn = _entry(entry)
    q = torch.empty((*batch, m, k), dtype=a.dtype, device=a.device)
    r = torch.empty((*batch, k, n), dtype=a.dtype, device=a.device)
    piv = torch.empty((*batch, k), dtype=torch.int32, device=a.device)
    resid = norms = None
    if not layout.resid_in_smem:
        resid = torch.empty_like(a)
        norms = torch.empty((*batch, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), used.data_ptr() if used is not None else None,
                 q.data_ptr(), r.data_ptr(), piv.data_ptr(),
                 resid.data_ptr() if resid is not None else None,
                 norms.data_ptr() if norms is not None else None,
                 nb, m, n, k, layout.cluster, layout.threads,
                 int(layout.resid_in_smem), layout.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed for {layout}: "
            f"{_LAUNCH_ERRORS.get(err, f'CUDA error {err}')}")
    wrapper.launch_count += 1
    wrapper.launched_shapes.add(((nb, m, n), k, used is not None))
    return q, r, piv


def qrcp_panel(a: torch.Tensor, k: int, *, used: torch.Tensor | None = None):
    """k-step pivoted Gram–Schmidt QR of an f32 panel (m, n) or batch of
    panels (B, m, n): the contract of the JAX package's ``qrcp_panel``.

    Returns ``(q, r_orig, piv)``: q (..., m, k) orthonormal, r_orig
    (..., k, n) in *original* column order, piv (..., k) int32 pivot
    columns in selection order. ``used`` (n,) or (B, n) marks columns that
    are never chosen. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (K1, one cluster of CTAs per panel, laid out by
    ``panel_layout``) or raises.
    """
    if a.dtype != torch.float32:
        raise ValueError(f"qrcp_panel is f32-only, got {a.dtype}")
    return _panel(qrcp_panel, "rc_qrcp_panel_f32", a, k, used)


def qrcp_panel_complex(a: torch.Tensor, k: int, *,
                       used: torch.Tensor | None = None):
    """The ``qrcp_panel`` contract for a complex64 panel or batch of
    panels: the JAX package's ``qrcp_panel_complex``, with q and r_orig
    complex64. A CUDA tensor launches K2 or raises.

    The JAX function's ``packed`` argument is gone: it chose between two
    output layouts of the planar TPU kernel, and the card reads the
    interleaved complex64 tensor as it is.
    """
    if a.dtype != torch.complex64:
        raise ValueError(f"qrcp_panel_complex is c64-only, got {a.dtype}")
    return _panel(qrcp_panel_complex, "rc_qrcp_panel_c64", a, k, used)


qrcp_panel.launch_count = 0
qrcp_panel_complex.launch_count = 0
#: The distinct ``((panels, m, n), k, masked)`` each wrapper has launched
#: its kernel at, beside the count: what a check against the plain version
#: must cover.
qrcp_panel.launched_shapes = set()
qrcp_panel_complex.launched_shapes = set()
