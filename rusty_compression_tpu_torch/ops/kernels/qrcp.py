"""K1: fused column-pivoted Gram–Schmidt QR panel — CUDA kernel and its
plain PyTorch version.

Port of the Pallas TPU kernel ``rusty_compression_tpu/ops/pallas/qrcp.py``
(``qrcp_panel`` / ``_qrcp_kernel``). The kernel is ``csrc/qrcp.cu``; it is
compiled for ``sm_90a`` with ``nvcc`` into ``_build/`` at its first use on
a CUDA tensor and bound through ``ctypes`` (a plain C interface, so the
build takes seconds and needs neither ninja nor PyTorch's headers).

``qrcp_panel`` runs the plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor, or raises; it never falls back.
``qrcp_panel.launch_count`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from ...utils.dtypes import real_dtype

__all__ = ["qrcp_panel", "qrcp_panel_plain", "kernel_fits", "build"]

_PKG = Path(__file__).resolve().parents[2]
_SOURCE = _PKG / "csrc" / "qrcp.cu"
_BUILD_DIR = _PKG / "_build"

#: Dynamic shared memory the kernel may request: an H100 block gets at
#: most 232,448 bytes, less the kernel's 1 KB of static shared memory.
SMEM_LIMIT_BYTES = 232448 - 1024


def smem_bytes(m: int, k: int) -> int:
    """Shared memory the kernel needs: Q (m, k) plus two m-vectors, f32."""
    return 4 * (m * k + 2 * m)


def kernel_fits(m: int, k: int) -> bool:
    """The kernel's fit rule: the residual lives in global memory, so only
    Q and two m-vectors have to fit in shared memory, whatever n is."""
    return smem_bytes(m, k) <= SMEM_LIMIT_BYTES


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
    norms = (a.abs() ** 2).sum(-2).to(rdt)
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
                            torch.clamp(norms - r_row.abs() ** 2, min=0.0))
        norms = norms.scatter(-1, j, -1.0)
        q[..., :, i] = qi
        r[..., i, :] = r_row
        piv[..., i] = j[..., 0]
    return q, r, piv


_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("qrcp_panel: nvcc not found (set CUDA_HOME)")


def build() -> tuple[Path, str]:
    """Compile ``csrc/qrcp.cu`` for sm_90a into ``_build/`` unless a
    library of the same source is already there. Returns the library's
    path and the compiler's report (registers, shared memory, spills)."""
    src = _SOURCE.read_bytes()
    lib = _BUILD_DIR / f"libqrcp_{hashlib.sha256(src).hexdigest()[:12]}.so"
    if lib.exists():
        return lib, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", tmp, str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"qrcp_panel: nvcc failed:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib, proc.stderr


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            fn = lib.rc_qrcp_panel_f32
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def qrcp_panel(a: torch.Tensor, k: int, *, used: torch.Tensor | None = None):
    """k-step pivoted Gram–Schmidt QR of an f32 panel (m, n) or batch of
    panels (B, m, n): the contract of the JAX package's ``qrcp_panel``.

    Returns ``(q, r_orig, piv)``: q (..., m, k) orthonormal, r_orig
    (..., k, n) in *original* column order, piv (..., k) int32 pivot
    columns in selection order. ``used`` (n,) or (B, n) marks columns that
    are never chosen. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (one CTA per panel) or raises.
    """
    if a.dtype != torch.float32:
        raise ValueError(f"qrcp_panel is f32-only, got {a.dtype}")
    if a.ndim not in (2, 3):
        raise ValueError(f"qrcp_panel expects (m, n) or (B, m, n), got "
                         f"shape {tuple(a.shape)}")
    *batch, m, n = a.shape
    k = int(k)
    if not 1 <= k <= min(m, n):
        raise ValueError(f"qrcp_panel needs 1 <= k <= min(m, n), got k={k} "
                         f"for a ({m}, {n}) panel")
    if used is not None and tuple(used.shape) not in ((n,), (*batch, n)):
        raise ValueError(f"used must have shape ({n},) or "
                         f"{(*batch, n)}, got {tuple(used.shape)}")
    if a.device.type == "cpu":
        q, r, piv = qrcp_panel_plain(a, k, used)
        return q, r, piv.to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"qrcp_panel runs on cpu or cuda, got {a.device}")
    if not a.is_contiguous():
        raise ValueError("qrcp_panel needs a contiguous panel")
    if not kernel_fits(m, k):
        raise ValueError(
            f"qrcp_panel: Q of a ({m}, {n}) panel at k={k} needs "
            f"{smem_bytes(m, k)} bytes of shared memory, more than the "
            f"{SMEM_LIMIT_BYTES} the kernel may request")
    nb = batch[0] if batch else 1
    if used is not None:
        if used.device != a.device:
            raise ValueError("used must be on the panel's device")
        used = used.to(torch.float32).expand(*batch, n).contiguous()
    lib = _library()
    q = torch.empty((*batch, m, k), dtype=torch.float32, device=a.device)
    r = torch.empty((*batch, k, n), dtype=torch.float32, device=a.device)
    piv = torch.empty((*batch, k), dtype=torch.int32, device=a.device)
    resid = torch.empty_like(a)
    norms = torch.empty((*batch, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rc_qrcp_panel_f32(
            a.data_ptr(), used.data_ptr() if used is not None else None,
            q.data_ptr(), r.data_ptr(), piv.data_ptr(), resid.data_ptr(),
            norms.data_ptr(), nb, m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"qrcp_panel: kernel launch failed, CUDA error "
                           f"{err}")
    qrcp_panel.launch_count += 1
    return q, r, piv


qrcp_panel.launch_count = 0
