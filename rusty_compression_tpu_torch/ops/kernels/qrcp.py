"""K1–K4: fused column-pivoted Gram–Schmidt QR panels — CUDA kernels and
their plain PyTorch versions.

K1 and K2 are ports of the Pallas TPU kernels of
``rusty_compression_tpu/ops/pallas/qrcp.py``: K1 is ``qrcp_panel`` (f32,
``csrc/qrcp.cu``), K2 is ``qrcp_panel_complex`` (c64,
``csrc/qrcp_c64.cu``). K3 (``qrcp_panel_f64``, ``csrc/qrcp_f64.cu``) and
K4 (``qrcp_panel_c128``, ``csrc/qrcp_c128.cu``) take the place of what the
JAX package runs off its accelerator for f64 and c128: the ``_qrcp_gs``
loop (norm rule ``"downdate"``, K1's) and LAPACK ``?geqp3`` for the tol
<= 1e-8 ID cores (norm rule ``"recompute"``: each column's norm summed
afresh in every step's pass). All four instantiate the one step loop of
``csrc/qrcp_common.cuh``: one panel over a thread-block cluster, the
columns split over its CTAs, each CTA's residual slice in its shared
memory where it fits; a panel whose Q does not fit a cluster runs as one
cooperative grid (``panel_layout`` decides, from the shape alone), so
every kernel takes every panel. Each source is compiled for ``sm_90a``
with ``nvcc`` into ``_build/`` at the first use of any kernel on a CUDA
tensor (one ``nvcc`` per source, started together) and bound through
``ctypes`` (a plain C interface, so a build takes seconds and needs
neither ninja nor PyTorch's headers).

Each wrapper runs the plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor, or raises; none falls back. Each counts its
kernel launches in its ``launch_count`` and keeps the distinct shapes it
launched at in its ``launched_shapes``.
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

__all__ = ["qrcp_panel", "qrcp_panel_complex", "qrcp_panel_f64",
           "qrcp_panel_c128", "qrcp_panel_plain", "qrcp_core_plain",
           "kernel_fits", "panel_layout", "PanelLayout", "KERNELS", "build"]

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
_HEADER = _CSRC / "qrcp_common.cuh"
_BUILD_DIR = _PKG / "_build"


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One kernel: its C entry point, its source under ``csrc/``, the dtype
    its wrapper takes (``label`` names it in errors), whether it is one of
    K3 and K4 (``wide``: f64 norms, the two norm rules) and the entry-wise
    tolerance of its q and r against the plain version
    (the same arithmetic summed in another order)."""
    entry: str
    source: str
    dtype: torch.dtype
    label: str
    wide: bool
    tol: float


#: The kernels by wrapper name: the one table that the routes, the layout
#: sweep (``sweep.py``) and ``chip_smoke.py`` read.
KERNELS = {
    "qrcp_panel": KernelSpec("rc_qrcp_panel_f32", "qrcp.cu", torch.float32,
                             "f32", False, 1e-4),
    "qrcp_panel_complex": KernelSpec("rc_qrcp_panel_c64", "qrcp_c64.cu",
                                     torch.complex64, "c64", False, 1e-4),
    "qrcp_panel_f64": KernelSpec("rc_qrcp_panel_f64", "qrcp_f64.cu",
                                 torch.float64, "f64", True, 1e-9),
    "qrcp_panel_c128": KernelSpec("rc_qrcp_panel_c128", "qrcp_c128.cu",
                                  torch.complex128, "c128", True, 1e-9),
}
#: The dtypes of K3 and K4.
WIDE_DTYPES = tuple(spec.dtype for spec in KERNELS.values() if spec.wide)

#: Dynamic shared memory the kernel may request: an H100 block gets at
#: most 232,448 bytes, less the kernel's 1 KB of static shared memory.
SMEM_LIMIT_BYTES = 232448 - 1024
#: Cluster sizes the kernels take (16 is Hopper's non-portable maximum).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_THREADS = 1024
#: CTAs of the cooperative grid at most: one an SM, under the H100 SXM's
#: 132.
MAX_GRID = 128
#: From this many rows on the grid keeps Q in global memory and spreads a
#: step's reorthogonalization over a CTA's threads by rows (layouts 2, 3).
ROW_SPLIT_ROWS = 2048
#: The norm rules of K3 and K4, as the C entry points number them (K1 and
#: K2 downdate).
NORM_RULES = {"downdate": 0, "recompute": 1}
#: Residual elements a CTA may hold before the layout rule splits the
#: panel over a larger cluster: below it a step's fixed cost (barriers,
#: reorthogonalization) outweighs the column pass (``sweep.py``'s table).
_SPLIT_ELEMENTS = 4608
#: Columns of Q a CTA of the grid that splits Q may keep before the layout
#: rule spreads Q over more CTAs (``sweep.py --grids``).
_GRID_SHARE = 16

@dataclasses.dataclass(frozen=True)
class PanelLayout:
    """How one panel lies on the card: ``cluster`` CTAs, each owning
    ``width`` neighbouring columns and running ``threads`` threads with
    ``smem_bytes`` of dynamic shared memory; the residual slice in the
    owner's shared memory (``resid_in_smem``) or in a global workspace.
    ``code`` is the kernel's layout template, as the C entry points number
    it: 0 a cluster; else one cooperative grid (``grid``), 1 with each
    CTA holding ``q_share`` columns of Q in its shared memory (the
    columns t = rank mod ``cluster``), 2 with Q in global memory and
    each CTA's block spread over the rows, 3 the same with a CTA's vectors
    there too (``vectors_in_smem`` false), 4 with Q in global memory and
    each warp taking four columns of Q at a time."""
    cluster: int
    width: int
    threads: int
    resid_in_smem: bool
    smem_bytes: int
    code: int = 0
    q_share: int = 0

    @property
    def grid(self) -> bool:
        return self.code != 0

    @property
    def vectors_in_smem(self) -> bool:
        return self.code != 3


def _basis_bytes(m: int, k: int, cluster: int, threads: int,
                 itemsize: int, normsize: int = 4, code: int = 0) -> int:
    """Shared memory every CTA of layout ``code`` needs whatever the
    residual's place: in a cluster Q (m, k), the (q_{i-1}, q_i) pairs, the
    cluster's candidate pivot columns (two buffers of ``cluster`` columns;
    one buffer for a CTA alone), the projections and one partial sum per
    thread. In the grid the candidates lie in global memory and a CTA
    holds the pivot column, the pairs and the projections: with Q split
    (1) its share of Q and only that many projections, with Q in global
    memory (2, 4) k projections, and (3) none of these vectors. With
    8-byte norms (``normsize``: K3, K4), and in the grid at either norm
    size, one partial norm per thread too, as the C side's ``smem_need``
    counts."""
    if code == 1:
        share = -(-k // cluster)
        vectors = 3 * m + share + share * m
    elif code in (2, 4):
        vectors = 3 * m + k
    elif code == 3:
        vectors = 0
    else:
        buffers = 2 if cluster > 1 else 1
        vectors = m * k + buffers * cluster * m + 2 * m + k
    partial_norms = normsize * threads if normsize == 8 or code else 0
    return itemsize * (vectors + threads) + partial_norms


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


def kernel_fits(m: int, k: int, itemsize: int = 4,
                wide: bool = False) -> bool:
    """Whether the kernels take an (m, n) panel at k steps, for any n: true
    for all four. The grid layout that needs the least shared memory
    (3: Q and a CTA's vectors in global memory) keeps only a partial sum
    and a partial norm per thread there, whatever m and k."""
    return _basis_bytes(m, k, 1, MAX_THREADS, itemsize, 8 if wide else 4,
                        3) <= SMEM_LIMIT_BYTES


def _q_replicates(m: int, k: int, itemsize: int) -> bool:
    """Whether Q, replicated in every CTA of a cluster, fits in shared
    memory beside the vectors of a full block: K1's and K2's domain of
    cluster layouts (with the residual in shared memory or in L2)."""
    return _basis_bytes(m, k, 1, MAX_THREADS, itemsize) <= SMEM_LIMIT_BYTES


def layout_at(m: int, n: int, k: int, itemsize: int, cluster: int,
              wide: bool = False, code: int = 0) -> PanelLayout | None:
    """The layout ``code`` of the panel over ``cluster`` CTAs (a cluster,
    or the CTAs of a cooperative grid: ``PanelLayout``): the residual
    slice (m, ceil(n / cluster)), its last R row and its norms in shared
    memory exactly when they fit there beside the basis, else in global
    memory; None when not even the basis fits."""
    width = -(-n // cluster)
    threads = _threads(m, width)
    normsize = 8 if wide else 4
    basis = _basis_bytes(m, k, cluster, threads, itemsize, normsize, code)
    q_share = -(-k // cluster) if code == 1 else 0
    smem = basis + itemsize * (m * width + width) + normsize * width
    if smem <= SMEM_LIMIT_BYTES:
        return PanelLayout(cluster, width, threads, True, smem, code,
                           q_share)
    if basis <= SMEM_LIMIT_BYTES:
        return PanelLayout(cluster, width, threads, False, basis, code,
                           q_share)
    return None


def _cluster_layout(m: int, n: int, k: int, itemsize: int,
                    wide: bool) -> PanelLayout | None:
    """K1's rule: the smallest cluster whose residual slice fits in shared
    memory takes the panel, doubled while a CTA would still hold more than
    ``_SPLIT_ELEMENTS`` residual elements. A panel whose slice fits no
    cluster keeps its residual in global memory and takes the largest
    cluster that leaves a CTA at least a warp of columns (K1, K2), or
    has no cluster layout (K3, K4: it goes to the grid). K1 and K2 have
    none either where Q does not replicate (``_q_replicates``)."""
    if not (wide or _q_replicates(m, k, itemsize)):
        return None
    layouts = [layout for cluster in CLUSTER_SIZES
               if (layout := layout_at(m, n, k, itemsize, cluster, wide))]
    chosen = None
    for layout in layouts:
        if layout.resid_in_smem:
            chosen = layout
            if m * layout.width <= _SPLIT_ELEMENTS:
                break
    if chosen is None and not wide:
        wide_slices = [layout for layout in layouts
                       if layout.width >= 32 or layout.cluster == 1]
        chosen = wide_slices[-1]
    return chosen


def grid_counts(n: int) -> list[int]:
    """The CTA counts a grid over n columns may take: at most
    ``MAX_GRID``, and none that leaves a CTA past the last column."""
    return [g for g in range(1, min(MAX_GRID, n) + 1)
            if (g - 1) * -(-n // g) < n]


def _grid_layout(m: int, n: int, k: int, itemsize: int,
                 wide: bool) -> PanelLayout:
    """The layout of a panel that no cluster holds, over a count of CTAs
    (at most ``MAX_GRID``, none past the last column).

    Below ``ROW_SPLIT_ROWS`` rows Q is split over the CTAs (layout 1)
    wherever the shares fit: beside residual slices that fit too, the
    fewest CTAs whose slices are at most a warp wide and whose shares at
    most ``_GRID_SHARE`` columns, else the most (``sweep.py --grids``: a
    step's column pass shrinks with the slice until a warp spans it, the
    part of -Q Q^H v with the share); else the most CTAs, the residual in
    global memory (a slice read from L2 a step costs far less than all of
    Q read by every CTA: ``sweep.py``'s (1000, 1000) k=600). Where no
    share fits, Q lies in global memory, read by warps four columns at a
    time (4); from ``ROW_SPLIT_ROWS`` rows on, by the block over the rows
    (2; 3 where a CTA's vectors do not fit beside its partial sums). Both
    take the fewest CTAs whose slices fit in shared memory, else the
    most."""
    counts = grid_counts(n)
    code = 2
    if m < ROW_SPLIT_ROWS:
        fits = [x for g in counts
                if (x := layout_at(m, n, k, itemsize, g, wide, 1))
                and x.resid_in_smem]
        if fits:
            narrow = [x for x in fits
                      if x.width <= 32 and x.q_share <= _GRID_SHARE]
            return narrow[0] if narrow else fits[-1]
        split = layout_at(m, n, k, itemsize, counts[-1], wide, 1)
        if split is not None:
            return split
        code = 4

    def at(g: int) -> PanelLayout:
        return (layout_at(m, n, k, itemsize, g, wide, code)
                or layout_at(m, n, k, itemsize, g, wide, 3))

    fits = [x for g in counts if (x := at(g)).resid_in_smem]
    return fits[0] if fits else at(counts[-1])


@functools.lru_cache(maxsize=1024)
def panel_layout(m: int, n: int, k: int, itemsize: int = 4,
                 wide: bool = False) -> PanelLayout:
    """The layout of an (m, n) panel at k steps, ``itemsize`` bytes an
    element, for K1 and K2 or, with ``wide`` (f64 norms), for K3 and K4.

    A cluster where one holds the panel (``_cluster_layout``), any other
    panel one cooperative grid (``_grid_layout``)."""
    return (_cluster_layout(m, n, k, itemsize, wide)
            or _grid_layout(m, n, k, itemsize, wide))


def abs2(x: torch.Tensor) -> torch.Tensor:
    """``|x|^2``, real; ``re^2 + im^2`` for complex input, as the complex
    kernels compute it (no hypot, so near-ties fall the same way)."""
    if x.is_complex():
        return x.real ** 2 + x.imag ** 2
    return x.abs() ** 2


def qrcp_panel_plain(a: torch.Tensor, k: int, used: torch.Tensor | None = None,
                     norms: str = "downdate"):
    """k-step pivoted Gram–Schmidt QRCP of ``a`` (..., m, n), any float or
    complex dtype: the port of ``ops.pivoted_qr._qrcp_gs`` plus the
    kernel's ``used`` mask (columns marked there are never pivots), and
    the plain version of all four kernels.

    ``norms`` is the rule for the column norms the pivot is taken by:
    ``"downdate"`` (``_qrcp_gs``'s and K1's: the squared norms less
    |r_row|^2, carried over every step) or ``"recompute"`` (every norm
    taken afresh from the residual each step: see ``qrcp_core_plain``).

    Returns ``(q, r_orig, piv)``: q (..., m, k), r_orig (..., k, n) in
    original column order, piv (..., k) int64 in selection order.
    """
    if norms not in NORM_RULES:
        raise ValueError(f"norms must be one of {list(NORM_RULES)}, got "
                         f"{norms!r}")
    recompute = norms == "recompute"
    *batch, m, n = a.shape
    rdt = real_dtype(a.dtype)
    resid = a.clone()
    taken = torch.zeros((*batch, n), dtype=torch.bool, device=a.device)
    if used is not None:
        taken = taken | (used.to(a.device) > 0)
    nrm = None if recompute else torch.where(
        taken, -1.0, abs2(a).sum(-2).to(rdt))
    q = a.new_zeros((*batch, m, k))
    r = a.new_zeros((*batch, k, n))
    piv = torch.zeros((*batch, k), dtype=torch.int64, device=a.device)
    for i in range(k):
        if recompute:
            nrm = torch.linalg.vector_norm(resid, dim=-2).masked_fill(
                taken, -1.0)
        # torch.argmax returns the first maximal index, as jnp.argmax does.
        j = torch.argmax(nrm, dim=-1, keepdim=True)             # (..., 1)
        v = torch.take_along_dim(resid, j.unsqueeze(-2), dim=-1)[..., 0]
        v = v - (q @ (q.mH @ v.unsqueeze(-1)))[..., 0]
        nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        inv = torch.where(nv > 0, 1.0 / torch.where(nv > 0, nv, 1.0), 0.0)
        qi = v * inv.to(a.dtype)
        r_row = (qi.conj().unsqueeze(-2) @ resid)[..., 0, :]
        resid = resid - qi.unsqueeze(-1) * r_row.unsqueeze(-2)
        if recompute:
            taken = taken.scatter(-1, j, True)
        else:
            nrm = torch.where(nrm < 0, nrm,
                              torch.clamp(nrm - abs2(r_row), min=0.0))
            nrm = nrm.scatter(-1, j, -1.0)
        q[..., :, i] = qi
        r[..., i, :] = r_row
        piv[..., i] = j[..., 0]
    return q, r, piv


def qrcp_core_plain(b: torch.Tensor):
    """min(m, n)-step column-pivoted Gram–Schmidt QR of ``b`` (..., m, n)
    with the column norms recomputed from the residual each step: the
    pivot rule of the port's tol <= 1e-8 ID cores
    (``highacc_id._core_qrcp``), and K3's and K4's ``"recompute"`` rule.

    The pivot is the column of largest residual norm, as in ``?geqp3``.
    The downdated rule (``qrcp_panel_plain``'s default) carries the
    squared norms over the steps, and at tol 1e-8 the squared norms it
    subtracts cancel to roundoff: on a captured core of ``hilbert(1024)``
    it left ``?geqp3``'s pivots at step 14 of 16 (Laplace block, step 97
    of 143). ``?geqp3`` recomputes a norm whenever its downdate has
    cancelled that far. One reorthogonalization pass per pivot column.

    Returns ``(q, r_orig, piv)`` as ``qrcp_panel_plain`` does.
    """
    return qrcp_panel_plain(b.resolve_conj(), min(b.shape[-2:]),
                            norms="recompute")


#: Whether each C entry point is one of K3 and K4's.
_WIDE_ENTRIES = {spec.entry: spec.wide for spec in KERNELS.values()}
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
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def compile_sources(entries: dict[str, Path],
                    depends: bytes = b"") -> dict[str, tuple[Path, str]]:
    """Compile the sources of ``entries`` (C entry point -> its source) for
    sm_90a into ``_build/``, one ``nvcc`` per distinct source and all
    started together, skipping a source whose library is already there
    (named by a hash of the source, ``depends``, the headers it includes,
    and the build's defines). Returns, by C entry point, the library's
    path and the compiler's report (registers, shared memory, spills;
    empty for a library that was found)."""
    built, running = {}, []
    for source in dict.fromkeys(entries.values()):
        digest = hashlib.sha256(source.read_bytes() + depends + " ".join(
            _build_defines).encode()).hexdigest()[:12]
        lib = _BUILD_DIR / f"lib{source.stem}_{digest}.so"
        if lib.exists():
            built[source] = (lib, "")
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler",
               "-fPIC", *(f"-D{name}" for name in _build_defines),
               "-o", tmp, str(source)]
        running.append((source, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for source, lib, tmp, proc in running:
        _, report = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{lib.name}:\n{report}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
        built[source] = (lib, report)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return {entry: built[source] for entry, source in entries.items()}


def build() -> dict[str, tuple[Path, str]]:
    """Compile K1-K4 (``compile_sources``: each source with the header it
    includes). Returns, by C entry point, the library's path and the
    compiler's report."""
    return compile_sources({spec.entry: _CSRC / spec.source
                            for spec in KERNELS.values()},
                           _HEADER.read_bytes())


def _entry(name: str):
    """The C entry point ``name``, from its library (built on first use)."""
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build()[name][0]))
            fn = getattr(lib, name)
            # K3 and K4 take a norm rule besides the layout
            ints = 10 if _WIDE_ENTRIES[name] else 9
            fn.argtypes = [ctypes.c_void_p] * 11 + [
                ctypes.c_int] * ints + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _libs[name] = (lib, fn)
        return _libs[name][1]


#: What the C entry points return beside CUDA's own error codes.
_LAUNCH_ERRORS = {
    -1: "the card cannot schedule a cluster of this layout",
    -2: "the layout's numbers do not fit together",
}


def _panel(wrapper, a: torch.Tensor, k: int, used: torch.Tensor | None,
           layout: PanelLayout | None = None, norms: str | None = None):
    """What the four wrappers share: the checks, the plain version on the
    CPU, the launch of the wrapper's kernel (``KERNELS``) on the card.
    ``layout`` replaces the rule's choice (the kernel tests and the layout
    sweep force cluster sizes with it). ``norms`` is K3's and K4's norm
    rule (None for K1, K2)."""
    name = wrapper.__name__
    spec = KERNELS[name]
    if a.dtype != spec.dtype:
        raise ValueError(f"{name} is {spec.label}-only, got {a.dtype}")
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
    wide = spec.wide
    if wide and norms not in NORM_RULES:
        raise ValueError(f"{name}: norms must be one of {list(NORM_RULES)}, "
                         f"got {norms!r}")
    if a.device.type == "cpu":
        q, r, piv = qrcp_panel_plain(a, k, used, norms or "downdate")
        return q, r, piv.to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {a.device}")
    if not a.is_contiguous() or a.is_conj():
        raise ValueError(f"{name} needs a contiguous panel (and no lazy "
                         f"conjugate: call resolve_conj())")
    if layout is None:
        layout = panel_layout(m, n, k, a.element_size(), wide)
    nb = batch[0] if batch else 1
    if used is not None:
        if used.device != a.device:
            raise ValueError("used must be on the panel's device")
        used = used.to(torch.float32).expand(*batch, n).contiguous()
    fn = _entry(spec.entry)
    q = torch.empty((*batch, m, k), dtype=a.dtype, device=a.device)
    r = torch.empty((*batch, k, n), dtype=a.dtype, device=a.device)
    piv = torch.empty((*batch, k), dtype=torch.int32, device=a.device)
    norm_dtype = real_dtype(a.dtype) if wide else torch.float32
    resid = norm_ws = None
    if not layout.resid_in_smem:
        resid = torch.empty_like(a)
        norm_ws = torch.empty((*batch, n), dtype=norm_dtype, device=a.device)
    # (first panel, panels) of each launch: the grid runs one panel a
    # launch, as all of its CTAs must be resident at once
    launches = ([(p, 1) for p in range(nb)] if layout.grid else [(0, nb)])
    grid_ws = [None] * 4
    if layout.grid:
        # Q (with Q split over the CTAs: their parts of -Q Q^H v and v'),
        # the candidates and their bests ((norm, index) pairs), and the
        # CTAs' vectors where they do not fit in shared memory:
        # (cluster, vec_stride(m, k))
        q_size = (layout.cluster + 1) * m if layout.q_share else k * m
        grid_ws = [torch.empty(q_size, dtype=a.dtype, device=a.device),
                   torch.empty((2, layout.cluster, m), dtype=a.dtype,
                               device=a.device),
                   torch.empty((2, layout.cluster, 2), dtype=norm_dtype,
                               device=a.device),
                   None if layout.vectors_in_smem else torch.empty(
                       (layout.cluster, (3 * m + k + 1) // 2 * 2),
                       dtype=a.dtype, device=a.device)]

    def ptr(x, p):
        return None if x is None else (x[p] if batch else x).data_ptr()

    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        for first, count in launches:
            args = [ptr(x, first) for x in (a, used, q, r, piv, resid,
                                            norm_ws)]
            args += [x.data_ptr() if x is not None else None
                     for x in grid_ws]
            tail = [int(layout.resid_in_smem), layout.code]
            if wide:
                tail.append(NORM_RULES[norms])
            err = fn(*args, count, m, n, k, layout.cluster, layout.threads,
                     *tail, layout.smem_bytes, stream)
            if err != 0:
                raise RuntimeError(
                    f"{name}: kernel launch failed for {layout}: "
                    f"{_LAUNCH_ERRORS.get(err, f'CUDA error {err}')}")
            wrapper.launch_count += 1
    key = ((nb, m, n), k, used is not None)
    wrapper.launched_shapes.add((*key, norms) if wide else key)
    return q, r, piv


def qrcp_panel(a: torch.Tensor, k: int, *, used: torch.Tensor | None = None):
    """k-step pivoted Gram–Schmidt QR of an f32 panel (m, n) or batch of
    panels (B, m, n): the contract of the JAX package's ``qrcp_panel``.

    Returns ``(q, r_orig, piv)``: q (..., m, k) orthonormal, r_orig
    (..., k, n) in *original* column order, piv (..., k) int32 pivot
    columns in selection order. ``used`` (n,) or (B, n) marks columns that
    are never chosen. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (K1: one cluster of CTAs per panel, or one
    cooperative grid a panel where Q does not fit a cluster, laid out by
    ``panel_layout``) or raises.
    """
    return _panel(qrcp_panel, a, k, used)


def qrcp_panel_complex(a: torch.Tensor, k: int, *,
                       used: torch.Tensor | None = None):
    """The ``qrcp_panel`` contract for a complex64 panel or batch of
    panels: the JAX package's ``qrcp_panel_complex``, with q and r_orig
    complex64. A CUDA tensor launches K2 or raises.

    The JAX function's ``packed`` argument is gone: it chose between two
    output layouts of the planar TPU kernel, and the card reads the
    interleaved complex64 tensor as it is.
    """
    return _panel(qrcp_panel_complex, a, k, used)


def qrcp_panel_f64(a: torch.Tensor, k: int, *,
                   used: torch.Tensor | None = None, norms: str = "downdate"):
    """The ``qrcp_panel`` contract for an f64 panel or batch of panels,
    with the norm rule ``norms``: ``"downdate"`` (K1's rule, the JAX
    package's ``_qrcp_gs``) or ``"recompute"`` (each column's norm summed
    afresh every step, the pivots of ``?geqp3`` on the tol <= 1e-8 ID
    cores); plain version ``qrcp_panel_plain`` under the same rule. A CUDA
    tensor launches K3 (a cluster per panel, or a cooperative grid a
    panel where Q does not fit a cluster: every panel has a layout) or
    raises.
    """
    return _panel(qrcp_panel_f64, a, k, used, norms=norms)


def qrcp_panel_c128(a: torch.Tensor, k: int, *,
                    used: torch.Tensor | None = None, norms: str = "downdate"):
    """``qrcp_panel_f64`` for a complex128 panel or batch of panels
    (``r_orig[i, c] = q[:, i]^H a[:, c]``, the norms real): a CUDA tensor
    launches K4 or raises."""
    return _panel(qrcp_panel_c128, a, k, used, norms=norms)


#: The wrapper of each floating dtype.
PANEL_KERNELS = {spec.dtype: globals()[name] for name, spec in KERNELS.items()}

for _wrapper in PANEL_KERNELS.values():
    _wrapper.launch_count = 0
    #: The distinct ``((panels, m, n), k, masked)`` (and, for K3 and K4,
    #: the norm rule) each wrapper has launched its kernel at, beside the
    #: count: what a check against the plain version must cover.
    _wrapper.launched_shapes = set()
