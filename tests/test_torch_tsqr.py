"""K5 on the CPU: the plain version of the tall-skinny QR kernel against
Householder QR (``torch.linalg.qr``), its plan, and ``thin_q``'s route.

Nothing here launches a kernel; ``tests/test_torch_cuda.py`` holds K5 to
this plain version on the card. Limits, with u the unit roundoff of the
type: ‖QᵀQ − I‖ and ‖QR − Y‖/‖Y‖ within 10 n u (Householder's bounds are
n u times a small constant); the span ‖QQᵀ − Q₀Q₀ᵀ‖ against
``torch.linalg.qr``'s Q₀ within 10 n u cond(Y), the span's own
sensitivity. Rank-deficient panels and zero columns have no unique span
past their rank: there Q must still be orthonormal and reproduce Y.
"""

import types

import numpy as np
import pytest

from torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def k5():
    import torch  # noqa: F401  (the port imports it; kept out of collection)

    from rusty_compression_tpu_torch.ops.kernels import tsqr

    return tsqr


def _panel(kind: str, shape, dtype: str, seed: int = 0):
    """A test panel (numpy) of ``kind`` and its condition number."""
    rng = np.random.default_rng(seed)
    *batch, m, n = shape
    if kind in ("gauss", "ragged", "square"):
        return rng.standard_normal(shape), 10.0
    if kind == "ill":
        cond = 1e6 if dtype == "float32" else 1e12
        u = np.linalg.qr(rng.standard_normal((*batch, m, n)))[0]
        v = np.linalg.qr(rng.standard_normal((*batch, n, n)))[0]
        y = (u * np.geomspace(1.0, 1.0 / cond, n)) @ np.swapaxes(v, -1, -2)
        return y, cond
    if kind == "rank":
        return (rng.standard_normal((*batch, m, 3))
                @ rng.standard_normal((*batch, 3, n))), None
    if kind == "zero":
        y = rng.standard_normal(shape)
        y[..., [0, n // 2, n - 1]] = 0.0
        return y, None
    raise ValueError(kind)


CASES = [
    # (kind, shape): a stack over several leaves, rows not a multiple of
    # the leaf height, m = n, the ill-conditioned, rank-deficient and
    # zero-column panels; a 128-wide panel (two threads a column)
    ("gauss", (3, 300, 21)),
    ("ragged", (2, 517, 33)),
    ("square", (2, 40, 40)),
    ("ill", (2, 600, 24)),
    ("rank", (2, 300, 20)),
    ("zero", (1, 333, 36)),
    ("gauss", (1, 300, 128)),
]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind,shape", CASES)
def test_plain_is_householder(k5, kind, shape, dtype):
    import torch

    y_np, cond = _panel(kind, shape, dtype)
    y = torch.tensor(y_np, dtype=getattr(torch, dtype))
    n = shape[-1]
    u = float(torch.finfo(y.dtype).eps) / 2
    q, r = k5.tsqr_plain(y)
    assert q.shape == y.shape and r.shape == (*shape[:-2], n, n)
    eye = torch.eye(n, dtype=y.dtype)
    assert float((q.mT @ q - eye).abs().max()) <= 10 * n * u
    assert float((q @ r - y).norm() / y.norm()) <= 10 * n * u
    assert torch.equal(r, torch.triu(r))
    assert bool((torch.diagonal(r, dim1=-2, dim2=-1) >= 0).all())
    if cond is not None:
        q0 = torch.linalg.qr(y)[0]
        span = float((q @ q.mT - q0 @ q0.mT).abs().max())
        assert span <= 10 * n * u * cond


def test_plain_keeps_a_zero_panel_orthonormal(k5):
    """An all-zero stack: every reflector is the identity, Q = [D; 0] in
    each leaf's first rows replayed, orthonormal; R = 0."""
    import torch

    y = torch.zeros((2, 200, 9), dtype=torch.float64)
    q, r = k5.tsqr_plain(y)
    assert torch.equal(q.mT @ q, torch.eye(9, dtype=y.dtype).expand(2, 9, 9))
    assert float(r.abs().max()) == 0.0


# The plans of the main path's shapes (the benchmark's cells): (batch, m,
# n, itemsize) -> (threads a column, rows a thread, leaves, leaf height)
PLANS = {
    (64, 16384, 21, 4): (1, 32, 32, 512),   # cell 4's 64 sketches
    (1, 8192, 32, 8): (4, 8, 128, 64),      # cells 1, 3: rounds of 32
    (1, 8192, 64, 8): (2, 32, 64, 128),     # round 3
    (1, 8192, 128, 8): (2, 32, 64, 128),    # round 4
    (400, 256, 16, 8): (1, 32, 4, 64),      # an H-matrix bucket
}


@pytest.mark.parametrize("key", sorted(PLANS))
def test_plan_of_the_main_shapes(k5, key):
    plan = k5.tsqr_plan(*key)
    assert (plan.groups, plan.rows, plan.leaves, plan.height) == PLANS[key]


@pytest.mark.parametrize("batch,m,n,itemsize", [
    (1, 8192, 21, 8), (3, 1000, 7, 4), (1, 128, 128, 8), (5, 129, 128, 4),
    (2, 1000, 100, 8), (1, 64, 1, 4), (4096, 300, 30, 8), (1, 10**5, 20, 4)])
def test_plan_invariants(k5, batch, m, n, itemsize):
    """Every leaf has at least n rows (so S is made of real rows), the
    leaves but the last a whole number of chunks; the tree's slots and the
    taus' rows are what the kernel's arithmetic needs."""
    plan = k5.tsqr_plan(batch, m, n, itemsize)
    assert plan.m == m and plan.n == n
    assert plan.height >= n and plan.last_rows >= n
    assert plan.leaves == 1 or plan.height % plan.chunk == 0
    assert plan.leaves & (plan.leaves - 1) == 0
    assert plan.threads % 32 == 0 and plan.threads >= n * plan.groups
    assert plan.counts[0] == plan.leaves and plan.counts[-1] == 1
    assert plan.slots == sum(plan.counts)
    tall = max(plan.height, plan.last_rows)
    assert plan.tau_rows == -(-tall // plan.chunk) + -(-n // plan.chunk)
    assert plan.smem_bytes <= 232448 - 1024


def test_forced_plans_agree(k5):
    """The plain version under another leaf count and layout: the same Q
    to rounding (the reflectors change, the factorization does not)."""
    import dataclasses

    import torch

    y = torch.tensor(np.random.default_rng(3).standard_normal((2, 700, 12)))
    base = k5.tsqr_plan(2, 700, 12, 8)
    q0, r0 = k5.tsqr_plain(y, base)
    for leaves, rows, groups in ((1, 32, 1), (4, 8, 4), (8, 32, 1)):
        chunk = rows * groups
        plan = dataclasses.replace(base, leaves=leaves, rows=rows,
                                   groups=groups,
                                   height=chunk * -(-700 // (leaves * chunk)))
        q, r = k5.tsqr_plain(y, plan)
        assert float((q - q0).abs().max()) <= 1e-13
        assert float((r - r0).abs().max()) <= 1e-13


class _Card(types.SimpleNamespace):
    """A stand-in for a tensor on the card: what ``thin_q`` reads."""

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], tuple):
            shape = shape[0]
        if -1 in shape:
            rest = int(np.prod([s for s in shape if s != -1]))
            shape = tuple(int(np.prod(self.shape)) // rest if s == -1 else s
                          for s in shape)
        return _Card(device=self.device, dtype=self.dtype,
                     shape=tuple(shape))


@pytest.mark.parametrize("dtype,shape,kernel", [
    ("float32", (64, 16384, 21), True),    # a stack: one call
    ("float64", (2, 3, 300, 128), True),   # a stack of any rank, 128 wide
    ("float64", (8192, 32), True),         # a single tall panel
    ("float64", (8192, 102), True),        # 80 rows a column and more
    ("float64", (8192, 103), False),       # fewer: cuSOLVER
    ("float64", (8192, 128), False),
    ("float64", (2, 8192, 129), False),    # wider: cuSOLVER
    ("float64", (8192, 256), False),       # the 1e-8 basis's final QR
    ("complex128", (8192, 32), False),     # complex: cuSOLVER
    ("complex64", (2, 4096, 16), False),
    ("float32", (2, 20, 40), False),       # m < n
    ("float16", (4096, 16), False),        # no half-precision kernel
])
def test_thin_q_route(monkeypatch, dtype, shape, kernel):
    """``thin_q`` hands a real f32/f64 card stack of at most 128 columns
    (m >= n; a single panel with at least 80 rows a column) to K5, as one
    call over the flattened stack, and every other input to
    ``torch.linalg.qr``. The kernel and the tensor are stand-ins."""
    import torch

    from rusty_compression_tpu_torch.ops import orthogonalize as orth

    seen = []
    monkeypatch.setattr(orth.tsqr, "tsqr", lambda y: seen.append(
        ("k5", y.shape)) or (y, None))
    monkeypatch.setattr(torch.linalg, "qr", lambda y: seen.append(
        ("qr", y.shape)) or (y, None))
    card = _Card(device=torch.device("cuda"), dtype=getattr(torch, dtype),
                 shape=shape)
    out = orth.thin_q(card)
    m, n = shape[-2:]
    assert out.shape == shape
    assert seen == ([("k5", (int(np.prod(shape[:-2])), m, n))] if kernel
                    else [("qr", shape)])
    assert k5_takes(card, shape) == kernel


def k5_takes(card, shape) -> bool:
    from rusty_compression_tpu_torch.ops.kernels import tsqr

    *lead, m, n = shape
    return tsqr.kernel_takes(card.device, card.dtype,
                             int(np.prod(lead)), m, n)


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex128"])
def test_cpu_route_is_householder_bitwise(dtype):
    """On the CPU ``thin_q`` and ``orthonormalize(method="auto" | "qr")``
    return ``torch.linalg.qr``'s Q bit for bit."""
    import torch

    from rusty_compression_tpu_torch.ops.orthogonalize import (
        orthonormalize, thin_q)

    rng = np.random.default_rng(5)
    y = torch.tensor(rng.standard_normal((3, 90, 17)),
                     dtype=getattr(torch, dtype))
    q0 = torch.linalg.qr(y, mode="reduced")[0]
    assert torch.equal(thin_q(y), q0)
    assert torch.equal(orthonormalize(y, "auto"), q0)
    assert torch.equal(orthonormalize(y, "qr"), q0)


@pytest.mark.parametrize("dtype,shape,message", [
    ("complex64", (100, 10), "float32 or float64"),
    ("float64", (100, 129), "n <= min"),
    ("float32", (10, 20), "n <= min"),
    ("float64", (4, 100, 10, 3), "expects"),
])
def test_wrapper_refuses(k5, dtype, shape, message):
    import torch

    with pytest.raises(ValueError, match=message):
        k5.tsqr(torch.zeros(shape, dtype=getattr(torch, dtype)))


def test_wrapper_on_cpu_runs_plain(k5):
    """A CPU tensor runs the plain version and counts no launch."""
    import torch

    y = torch.tensor(np.random.default_rng(7).standard_normal((2, 90, 5)))
    before = k5.tsqr.launch_count
    q, r = k5.tsqr(y, want_r=True)
    q0, r0 = k5.tsqr_plain(y)
    assert torch.equal(q, q0) and torch.equal(r, r0)
    assert k5.tsqr.launch_count == before
