"""K5: the thin Q of a stack of tall real panels by tall-skinny QR (TSQR) —
the CUDA kernel and its plain PyTorch version.

K5 has no Pallas twin: the JAX package leaves this QR to XLA. On the card
it takes the place of ``torch.linalg.qr`` (cuSOLVER's ``geqrf`` + ``orgqr``,
one Householder column at a time over the whole panel, one matrix of a
stack after another) for real f32 / f64 panels (B, m, n) with m >= n and
n <= ``MAX_WIDTH``. The algorithm and its reasons are in
``csrc/tsqr.cu``: leaves of rows reduced chunk by chunk against an R in
shared memory, a tree of the leaves' R, and Q formed by replaying the
reflectors from the root down. ``tsqr_plan`` picks the leaf height (and the
threads a column, the chunk, the fan-in) from the shape alone;
``tsqr_plain`` computes the same reflectors in the same order with
PyTorch operations (the sums in another order): the plain version that the
CPU tests and ``chip_smoke.py`` hold the kernel against.

The source is compiled for ``sm_90a`` into ``_build/`` at the first use on
a CUDA tensor, with K1-K4's ``compile_sources``, and bound through
``ctypes``. ``tsqr`` runs the plain version for a CPU tensor and launches
the kernel for a CUDA tensor, or raises; it counts its calls in
``tsqr.launch_count`` (one a call, stack or not: the two kernels of a
call are launched together).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from pathlib import Path

import torch

from . import qrcp

__all__ = ["tsqr", "tsqr_plain", "tsqr_plan", "TsqrPlan", "kernel_takes",
           "MAX_WIDTH", "DTYPES", "build"]

_SOURCE = Path(qrcp._CSRC) / "tsqr.cu"
#: The C entry point of each dtype.
ENTRIES = {torch.float32: "rc_tsqr_f32", torch.float64: "rc_tsqr_f64"}
DTYPES = tuple(ENTRIES)
#: The widest panel K5 takes: two threads a column, 256 a CTA (the block
#: the registers of a 32-row chunk a thread allow); the R and one chunk in
#: shared memory take 133 KB in f64 at this width.
MAX_WIDTH = 128
#: The thread layouts the source instantiates, (threads a column, rows of a
#: chunk a thread holds), for panels up to 32 columns and up to 128. The
#: throughput layouts hold 32 rows a thread: the fewest instructions an
#: element where the card holds more leaves than it has SMs. Up to 32
#: columns the latency layout spreads a column over four threads, for
#: stacks that leave the card short of CTAs: a CTA of one warp issuing
#: 32-row loops takes longer a step than four warps with 8 rows each.
#: (Four threads with 16 rows each took longer than two with 32 at 64 and
#: 128 columns, so wider panels keep the one layout.)
THROUGHPUT_LAYOUTS = ((1, 32), (2, 32))
LATENCY_LAYOUTS = ((4, 8), (2, 32))
#: The tree's fan-in: a node's children merge one after another in one CTA,
#: so two gives the shortest path (``(F - 1) / log2 F`` is least at 2).
FANIN = 2
#: SMs of the H100 SXM, and the shared memory of one (228 KB): the number of
#: leaves the card holds at once, for the plan's count of steps.
SMS = 132
SMEM_PER_SM = 233472


@dataclasses.dataclass(frozen=True)
class TsqrPlan:
    """How K5 lays out a (batch, m, n) stack: ``groups`` threads a column
    holding ``rows`` rows of a chunk each (chunks of ``groups * rows``
    rows), ``leaves`` leaves a matrix of
    ``height`` rows each (the last takes the rest, at least n), a tree of
    fan-in ``fanin``, ``threads`` a CTA with ``smem_bytes`` of dynamic
    shared memory (R, two reflector buffers, the taus)."""
    m: int
    n: int
    groups: int
    rows: int
    leaves: int
    height: int
    fanin: int
    threads: int
    smem_bytes: int

    @property
    def chunk(self) -> int:
        return self.rows * self.groups

    @property
    def counts(self) -> list[int]:
        """Nodes at each level of the tree, leaves first, root last."""
        counts = [self.leaves]
        while counts[-1] > 1:
            counts.append(-(-counts[-1] // self.fanin))
        return counts

    @property
    def slots(self) -> int:
        return sum(self.counts)

    @property
    def last_rows(self) -> int:
        return self.m - (self.leaves - 1) * self.height

    @property
    def tau_rows(self) -> int:
        """Rows of taus a slot keeps: one a chunk of the tallest leaf, then
        one a chunk of the node's R merged into its parent."""
        rows = max(self.height, self.last_rows)
        return -(-rows // self.chunk) + -(-self.n // self.chunk)


def _leaf_steps(rows: int, n: int, chunk: int) -> int:
    """Steps of a leaf of ``rows`` rows: a chunk reduces the columns that
    have a head, all n once R has n rows."""
    return sum(min(n, min(n, c * chunk) + chunk)
               for c in range(-(-rows // chunk)))


def _merge_steps(n: int, chunk: int) -> int:
    """Steps of merging one child's R: chunk rows c0.. start at step c0."""
    return sum(n - c0 for c0 in range(0, n, chunk))


def _plan_at(batch: int, m: int, n: int, itemsize: int, groups: int,
             rows: int) -> TsqrPlan:
    """The plan of layout (groups, rows) whose leaf count, a power of two
    up to ``m // n``, makes the critical path shortest: the steps of one
    leaf (factor and replay) times the waves of leaves the card runs one
    after another, plus two merges' steps a level of the tree (up and
    down); on a tie the fewer leaves."""
    chunk = rows * groups
    threads = -(-n * groups // 32) * 32
    # a chunk's reflectors (each thread's rows padded by 16 bytes), its
    # taus, R (or, in the Q kernel, W)
    smem = itemsize * (n * groups * (rows + 16 // itemsize) + n + n * n)
    per_sm = max(1, min(16, 1024 // threads, SMEM_PER_SM // smem))
    best = None
    leaves = 1
    while leaves == 1 or m // leaves >= n:
        height = chunk * -(-m // (leaves * chunk))
        last = m - (leaves - 1) * height
        if last >= n:
            plan = TsqrPlan(m, n, groups, rows, leaves, height, FANIN,
                            threads, smem)
            waves = -(-batch * leaves // (SMS * per_sm))
            cost = (2 * waves * _leaf_steps(max(height, last), n, chunk)
                    + 2 * (len(plan.counts) - 1) * (FANIN - 1)
                    * _merge_steps(n, chunk))
            if best is None or cost < best[0]:
                best = (cost, plan)
        leaves *= 2
    return best[1]


@functools.lru_cache(maxsize=1024)
def tsqr_plan(batch: int, m: int, n: int, itemsize: int) -> TsqrPlan:
    """The layout of a (batch, m, n) stack, from its shape alone: the
    throughput layout for its width, or, up to 32 columns, the latency
    layout where the throughput layout's plan gives the card fewer than two
    CTAs an SM."""
    wide = int(n > 32)
    plan = _plan_at(batch, m, n, itemsize, *THROUGHPUT_LAYOUTS[wide])
    if batch * plan.leaves < 2 * SMS and not wide:
        plan = _plan_at(batch, m, n, itemsize, *LATENCY_LAYOUTS[wide])
    return plan


#: A single panel (a stack of one) goes to K5 only with at least this many
#: rows a column: below it cuSOLVER's ``geqrf`` + ``orgqr`` measured faster
#: on the H100 (one matrix fills too few of K5's leaves to hide its chain of
#: steps): (8192, 96) f64 1.21 ms against 1.29, (8192, 112) 1.50 against
#: 1.48, (8192, 128) 1.87 against 1.67, (2048, 48) 0.38 against 0.33;
#: (8192, 32) 0.28 against 0.43. Every stack of two or more is faster on
#: K5 at every width up to 128 ((4, 8192, 128) f64 2.0 ms against 6.7).
SINGLE_PANEL_ROWS_PER_COLUMN = 80


def kernel_takes(device: torch.device, dtype: torch.dtype, batch: int,
                 m: int, n: int) -> bool:
    """Whether K5 takes a (batch, m, n) stack: a real f32 / f64 tensor on
    the card, 1 <= n <= min(m, ``MAX_WIDTH``), and a stack of two or more
    or a single panel of at least ``SINGLE_PANEL_ROWS_PER_COLUMN`` rows a
    column. Every other panel keeps ``torch.linalg.qr``."""
    return (device.type == "cuda" and dtype in DTYPES
            and 1 <= n <= min(m, MAX_WIDTH)
            and (batch > 1 or m >= SINGLE_PANEL_ROWS_PER_COLUMN * n))


# ---------------------------------------------------------------------------
# The plain version: the kernel's reflectors, in its order, as tensor code
# ---------------------------------------------------------------------------


def _reflector(alpha: torch.Tensor, sigma: torch.Tensor):
    """LAPACK's dlarfg without its rescaling, by the kernel's formulas: beta,
    tau and the scale of the tail for (alpha; tail), |tail|^2 = sigma, from
    s = 1 / |(alpha; tail)|: beta = -sign(alpha) / s, tau = 1 + |alpha| s,
    scale = sign(alpha) / (|alpha| + 1 / s); the identity (tau = 0) where
    the tail is exactly zero."""
    zero = sigma == 0
    sq = alpha * alpha + sigma
    inv = torch.rsqrt(sq)
    norm = sq * inv
    mag = alpha.abs()
    beta = torch.where(zero, alpha, torch.where(alpha < 0, norm, -norm))
    tau = torch.where(zero, 0.0, 1.0 + mag * inv)
    r = 1.0 / (mag + norm)
    scale = torch.where(zero, 0.0, torch.where(alpha < 0, -r, r))
    return beta, tau, scale


def _head_vector(x: torch.Tensor, j: int, r: int,
                 scale: torch.Tensor | None = None):
    """Step j's reflector over the chunk rows: the whole column j (scaled)
    when its head is in S (j < r), else 1 at the head row j - r, the rows
    below it, zeros above."""
    if j < r:
        col = x[:, :, j]
        return col if scale is None else col * scale[:, None]
    h = j - r
    v = torch.zeros_like(x[:, :, j])
    v[:, h] = 1.0
    tail = x[:, h + 1:, j]
    v[:, h + 1:] = tail if scale is None else tail * scale[:, None]
    return v


def _factor_chunk(x: torch.Tensor, s: torch.Tensor, tau: torch.Tensor,
                  r: int, jlo: int, jhi: int) -> None:
    """The kernel's ``factor_chunk`` over a batch of chunks, in place: x
    (P, C, n) the chunk, s (P, n, n) the R it is reduced against (r rows
    so far), tau (P, n) each step's tau."""
    for j in range(jlo, jhi):
        if j < r:
            alpha = s[:, j, j]
            sigma = (x[:, :, j] * x[:, :, j]).sum(-1)
        else:
            h = j - r
            alpha = x[:, h, j].clone()
            sigma = (x[:, h + 1:, j] * x[:, h + 1:, j]).sum(-1)
        beta, t, scale = _reflector(alpha, sigma)
        v = _head_vector(x, j, r, scale)
        if j < r:
            x[:, :, j] = v
            s[:, j, j] = beta
        else:
            x[:, j - r + 1:, j] = v[:, j - r + 1:]
            x[:, j - r, j] = beta
        tau[:, j] = t
        d = (v[:, :, None] * x[:, :, j + 1:]).sum(1)
        if j < r:
            d = d + s[:, j, j + 1:]
        w = t[:, None] * d
        x[:, :, j + 1:] -= v[:, :, None] * w[:, None, :]
        if j < r:
            s[:, j, j + 1:] -= w


def _replay_chunk(x: torch.Tensor, vk: torch.Tensor, w_rows: torch.Tensor,
                  tau: torch.Tensor, r: int, jlo: int, jhi: int) -> None:
    """The kernel's ``replay_chunk``, in place: the reflectors stored in vk
    (P, C, n) with taus tau (P, n), steps jhi - 1 down to jlo, applied to
    (w_rows; x)."""
    for j in range(jhi - 1, jlo - 1, -1):
        v = _head_vector(vk, j, r)
        d = (v[:, :, None] * x).sum(1)
        if j < r:
            d = d + w_rows[:, j, :]
        w = tau[:, j, None] * d
        x -= v[:, :, None] * w[:, None, :]
        if j < r:
            w_rows[:, j, :] -= w


def _chunks_of(t: torch.Tensor, c0: int, chunk: int, rows: int):
    """Rows [c0, c0 + chunk) of t (P, rows, n), zero past ``rows``."""
    out = t.new_zeros((t.shape[0], chunk, t.shape[-1]))
    out[:, :min(chunk, rows - c0)] = t[:, c0:c0 + chunk]
    return out


def tsqr_plain(y: torch.Tensor, plan: TsqrPlan | None = None):
    """``(q, r)`` of a real (m, n) panel or (B, m, n) stack, m >= n: K5's
    reflectors computed with PyTorch operations on y's device, the tree
    level by level. ``q`` is y's shape with orthonormal columns, ``r``
    (..., n, n) upper triangular with a non-negative diagonal, ``q r = y``.
    ``plan`` defaults to ``tsqr_plan``'s."""
    *lead, m, n = y.shape
    y3 = y.reshape(-1, m, n)
    batch = y3.shape[0]
    if plan is None:
        plan = tsqr_plan(batch, m, n, y.element_size())
    chunk, leaves, height, fanin = (plan.chunk, plan.leaves, plan.height,
                                    plan.fanin)
    tall = chunk * -(-max(height, plan.last_rows) // chunk)
    p = batch * leaves

    # leaves, zero-padded to the tallest (the padding's reflectors are
    # identities, which the kernel does not run)
    pad = y3.new_zeros((batch, leaves, tall, n))
    for leaf in range(leaves):
        rows = y3[:, leaf * height:
                  m if leaf == leaves - 1 else (leaf + 1) * height]
        pad[:, leaf, :rows.shape[1]] = rows
    pad = pad.reshape(p, tall, n)
    nchunks = tall // chunk
    s = y3.new_zeros((p, n, n))
    vt = torch.empty_like(pad)
    taus = y3.new_zeros((p, nchunks, n))
    for c in range(nchunks):
        r = min(n, c * chunk)
        x = pad[:, c * chunk:(c + 1) * chunk].clone()
        _factor_chunk(x, s, taus[:, c], r, 0, min(n, r + chunk))
        if r < n:
            s[:, r:min(n, r + chunk)] = x[:, :n - r]
        vt[:, c * chunk:(c + 1) * chunk] = x

    # the tree, level by level; a node with fewer than `fanin` children has
    # zero R in the others' places (identities again)
    counts = plan.counts
    nsub = -(-n // chunk)
    levels = []      # per level: the children's reflectors and taus
    rs = s.reshape(batch, leaves, n, n)
    for level in range(len(counts) - 1):
        parents = counts[level + 1]
        kids = torch.cat([rs, rs.new_zeros(
            (batch, parents * fanin - counts[level], n, n))], 1)
        kids = kids.reshape(batch * parents, fanin, n, n)
        merged = kids[:, 0].clone()
        vkids = torch.zeros_like(kids)
        tkids = kids.new_zeros((batch * parents, fanin, nsub, n))
        for ch in range(1, fanin):
            rc = torch.triu(kids[:, ch])
            for sc, c0 in enumerate(range(0, n, chunk)):
                x = _chunks_of(rc, c0, chunk, n)
                _factor_chunk(x, merged, tkids[:, ch, sc], n, c0, n)
                vkids[:, ch, c0:c0 + chunk] = x[:, :n - c0]
        levels.append((vkids, tkids))
        rs = merged.reshape(batch, parents, n, n)

    root = torch.triu(rs[:, 0])
    sign = torch.where(torch.diagonal(root, dim1=-2, dim2=-1) < 0, -1.0,
                       1.0).to(y.dtype)
    r_out = sign[:, :, None] * root
    ws = torch.diag_embed(sign)[:, None]          # (batch, 1, n, n)
    for level in range(len(counts) - 2, -1, -1):
        parents = counts[level + 1]
        vkids, tkids = levels[level]
        w = ws.reshape(batch * parents, n, n).clone()
        wkids = torch.zeros_like(vkids)
        for ch in range(fanin - 1, 0, -1):
            for sc in range(nsub - 1, -1, -1):
                c0 = sc * chunk
                x = w.new_zeros((batch * parents, chunk, n))
                vk = _chunks_of(vkids[:, ch], c0, chunk, n)
                _replay_chunk(x, vk, w, tkids[:, ch, sc], n, c0, n)
                wkids[:, ch, c0:c0 + chunk] = x[:, :n - c0]
        wkids[:, 0] = w
        ws = wkids.reshape(batch, parents * fanin, n, n)[:, :counts[level]]

    w = ws.reshape(p, n, n).clone()
    q = torch.empty_like(pad)
    for c in range(nchunks - 1, -1, -1):
        r = min(n, c * chunk)
        x = pad.new_zeros((p, chunk, n))
        if r < n:
            x[:, :n - r] = w[:, r:r + chunk]
        _replay_chunk(x, vt[:, c * chunk:(c + 1) * chunk], w, taus[:, c],
                      r, 0, min(n, r + chunk))
        q[:, c * chunk:(c + 1) * chunk] = x
    q = q.reshape(batch, leaves, tall, n)
    out = torch.cat([q[:, leaf, :height] for leaf in range(leaves - 1)]
                    + [q[:, -1, :plan.last_rows]], 1)
    return out.reshape(y.shape), r_out.reshape(*lead, n, n)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

_libs: dict = {}
_lib_lock = threading.Lock()


def build() -> dict[str, tuple[Path, str]]:
    """Compile ``csrc/tsqr.cu`` (``qrcp.compile_sources``). Returns, by C
    entry point, the library's path and the compiler's report."""
    return qrcp.compile_sources({entry: _SOURCE for entry in
                                 ENTRIES.values()})


def _entry(name: str):
    """The C entry point ``name``, from its library (built on first use)."""
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build()[name][0]))
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _libs[name] = (lib, fn)
        return _libs[name][1]


def tsqr(y: torch.Tensor, *, want_r: bool = False):
    """``(q, r)``: the thin QR of a real f32 / f64 panel (m, n) or stack
    (B, m, n), m >= n, n <= ``MAX_WIDTH``; ``q`` orthonormal, of y's
    shape; ``r`` upper triangular with a non-negative diagonal (None unless
    ``want_r``, on the card). A CPU tensor runs ``tsqr_plain``; a CUDA
    tensor launches K5 (two kernels, batch x leaves CTAs each, laid out by
    ``tsqr_plan``) or raises."""
    if y.dtype not in DTYPES:
        raise ValueError(f"tsqr takes float32 or float64, got {y.dtype}")
    if y.ndim not in (2, 3):
        raise ValueError(f"tsqr expects (m, n) or (B, m, n), got shape "
                         f"{tuple(y.shape)}")
    *lead, m, n = y.shape
    if not 1 <= n <= min(m, MAX_WIDTH):
        raise ValueError(f"tsqr needs 1 <= n <= min(m, {MAX_WIDTH}), got a "
                         f"({m}, {n}) panel")
    batch = lead[0] if lead else 1
    plan = tsqr_plan(batch, m, n, y.element_size())
    if y.device.type == "cpu":
        q, r = tsqr_plain(y, plan)
        return q, r if want_r else None
    if y.device.type != "cuda":
        raise ValueError(f"tsqr runs on cpu or cuda, got {y.device}")
    if batch == 0:
        return torch.empty_like(y), None
    y = y.contiguous()
    fn = _entry(ENTRIES[y.dtype])
    q = torch.empty_like(y)
    nn = n * n
    rws = y.new_empty(batch * plan.slots * nn)
    taus = y.new_empty(batch * plan.slots * plan.tau_rows * n)
    wws = y.new_empty(batch * plan.leaves * nn if len(plan.counts) > 1
                      else 1)
    counters = torch.zeros(batch * plan.slots, dtype=torch.int32,
                           device=y.device)
    r = y.new_empty((*lead, n, n)) if want_r else None
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), q.data_ptr(),
                 None if r is None else r.data_ptr(), rws.data_ptr(),
                 taus.data_ptr(), wws.data_ptr(), counters.data_ptr(),
                 batch, m, n, plan.leaves, plan.height, plan.fanin,
                 plan.tau_rows, plan.groups, plan.rows, plan.threads,
                 plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(
            f"tsqr: kernel launch failed for {plan}: "
            f"{'the plan numbers do not fit' if err == -2 else f'CUDA error {err}'}")
    tsqr.launch_count += 1
    return q, r


tsqr.launch_count = 0


def bound_ms(batch: int, m: int, n: int, itemsize: int) -> dict:
    """Least time the card could take for one call: y read once and Q
    written once (2 B m n items) at 3.35 TB/s, against the 4 B m n^2
    operations of the factorization and the forming of Q at 67 TFLOP/s
    (f32 outside the tensor cores; f64 on them, IEEE f64)."""
    by_bytes = 2 * batch * m * n * itemsize / 3.35e12 * 1e3
    by_ops = 4 * batch * m * n * n / 67e12 * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}

