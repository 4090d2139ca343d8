"""K1 and K2 over the whole domain of the Pallas panel kernel, on the CPU.

The Pallas kernel (``rusty_compression_tpu/ops/pallas/qrcp.py``) takes
any f32 panel whose working set fits VMEM, and the JAX package's ``auto``
route picks it wherever ``_pallas_fits`` holds at small rank or width.
K1 and K2 run a panel whose Q does not replicate in every CTA of a
cluster as one cooperative grid (layout codes 1-4), so the port's route
on the card is the JAX package's. Nothing here launches a kernel: the
layout rule is exact arithmetic (no tolerance), the routes are checked
with stand-ins for the kernels, and the plain version that stands for K1
on the CPU is held against the Pallas kernel in interpret mode on a panel
outside the cluster domain (pivots exactly equal, q and r within 1e-4,
K1's tolerance on the card: the same arithmetic in another order).
"""

import types

import numpy as np
import pytest

import chip_smoke

from torch_threads import one_thread  # noqa: F401 (autouse)

# The layouts the cluster rule gave every K1/K2 case of chip_smoke.py's
# phase 2 before K1 and K2 had a grid, (m, n, k, itemsize): (cluster,
# width, threads, residual in shared memory, shared-memory bytes).
CLUSTER_LAYOUTS = {
    (24, 16384, 16, 4): (16, 1024, 1024, True, 115456),
    (16, 16384, 16, 4): (16, 1024, 1024, True, 81088),
    (24, 2048, 16, 4): (16, 128, 384, True, 19712),
    (37, 301, 29, 4): (4, 76, 384, True, 19280),
    (16, 2048, 16, 4): (8, 256, 512, True, 22720),
    (136, 256, 128, 4): (8, 32, 544, True, 99776),
    (24, 32, 16, 4): (1, 32, 128, True, 5728),
    (24, 16389, 16, 4): (16, 1025, 1024, True, 115560),
    (600, 40, 8, 4): (8, 5, 1024, True, 78568),
    (72, 1024, 64, 4): (16, 64, 576, True, 49728),
    (72, 128, 64, 4): (2, 64, 576, True, 41664),
    (80, 144, 72, 4): (4, 36, 640, True, 40896),
    (2048, 2048, 16, 4): (4, 512, 1024, False, 217152),
    (53, 8192, 43, 8): (16, 512, 1024, False, 41184),
    (43, 8192, 43, 8): (16, 512, 1024, True, 217296),
    (136, 256, 128, 8): (8, 32, 544, True, 199424),
    (37, 301, 29, 8): (4, 76, 384, True, 38256),
    (24, 2048, 16, 8): (16, 128, 384, True, 38912),
    (53, 8191, 43, 8): (16, 512, 1024, False, 41184),
    (600, 40, 8, 8): (8, 5, 1024, True, 157116),
    (37, 1024, 27, 8): (16, 64, 256, True, 40032),
    (27, 1024, 27, 8): (8, 128, 384, True, 42192),
    (35, 1024, 27, 8): (8, 128, 512, True, 54288),
}
ITEMSIZE = {"qrcp_panel": 4, "qrcp_panel_complex": 8}


@pytest.fixture(scope="module")
def k1():
    import torch  # noqa: F401  (the port imports it; kept out of collection)

    from rusty_compression_tpu_torch.ops.kernels import qrcp

    return qrcp


def _assert_valid(k1, layout, m, n, k, itemsize):
    """What the C side's launcher checks, and the rule's own invariants."""
    assert layout.smem_bytes <= k1.SMEM_LIMIT_BYTES
    assert layout.threads % 32 == 0 and 128 <= layout.threads <= 1024
    assert layout.width == -(-n // layout.cluster)
    basis = k1._basis_bytes(m, k, layout.cluster, layout.threads, itemsize,
                            4, layout.code)
    slice_bytes = itemsize * (m * layout.width + layout.width) \
        + 4 * layout.width
    assert layout.smem_bytes == basis + (
        slice_bytes if layout.resid_in_smem else 0)
    if layout.grid:
        assert not k1._q_replicates(m, k, itemsize)
        assert 1 <= layout.cluster <= k1.MAX_GRID
        assert (layout.cluster - 1) * layout.width < n   # none past the edge
    else:
        assert layout.cluster in k1.CLUSTER_SIZES


@pytest.mark.parametrize("itemsize", [4, 8])
def test_every_panel_of_the_pallas_domain_gets_a_layout(k1, itemsize):
    """Every panel the JAX package's auto route gives the Pallas kernel (k
    <= 64 or n <= 128, working set under 12 MiB at 4 bytes an element;
    the port's c64 at 8) has a K1/K2 layout, a grid where Q does not
    replicate; config 2's (1024, 1024) at k = 64 among them."""
    from rusty_compression_tpu_torch.ops.pivoted_qr import _working_set_fits

    seen_grid = 0
    for m in (8, 100, 640, 1024, 1500, 2047, 2048, 3000, 4096, 12000):
        for n in (16, 100, 128, 192, 256, 512, 1000, 1024, 4096, 16384):
            for k in (8, 16, 52, 53, 64, 100, 128):
                k = min(k, m, n)
                if not ((k <= 64 or n <= 128)
                        and _working_set_fits(m, n, k, itemsize)):
                    continue
                assert k1.kernel_fits(m, k, itemsize)
                layout = k1.panel_layout(m, n, k, itemsize)
                _assert_valid(k1, layout, m, n, k, itemsize)
                seen_grid += layout.grid
    assert seen_grid > 20
    assert k1.panel_layout(1024, 1024, 64, 4).grid


def test_phase2_cluster_cases_keep_their_layout(k1):
    """Each K1/K2 case of phase 2 that had a cluster layout keeps it, to
    the byte; each other case (those added with the grid) is a grid."""
    covered = set()
    for name, itemsize in ITEMSIZE.items():
        for shape, k, _, *_ in chip_smoke.KERNEL_CASES[name]:
            m, n = shape[-2:]
            layout = k1.panel_layout(m, n, k, itemsize)
            key = (m, n, k, itemsize)
            if key in CLUSTER_LAYOUTS:
                covered.add(key)
                assert (layout.cluster, layout.width, layout.threads,
                        layout.resid_in_smem, layout.smem_bytes,
                        layout.code) == (*CLUSTER_LAYOUTS[key], 0)
            else:
                assert layout.grid, key
    assert covered == set(CLUSTER_LAYOUTS)


def test_phase2_holds_every_grid_layout_code(k1):
    """Phase 2 holds K1 and K2 in each grid layout code, by the rule's
    choice or, where the rule never picks a code for the dtype, forced
    (the fourth element of a case)."""
    for name, itemsize in ITEMSIZE.items():
        codes = set()
        for shape, k, _, *forced in chip_smoke.KERNEL_CASES[name]:
            layout = k1.panel_layout(*shape[-2:], k, itemsize)
            codes.add(forced[0] if forced else layout.code)
        assert codes >= {0, 1, 2, 3, 4}, (name, codes)


@pytest.mark.parametrize("m,n,k,itemsize,code,ctas,share", [
    (1024, 1024, 64, 4, 1, 32, 2),    # config 2 in f32: the split grid
    (640, 192, 96, 4, 1, 6, 16),      # 16 columns of Q a CTA
    (264, 512, 256, 4, 1, 16, 16),    # the pivot rule at block_size=256
    (1024, 512, 64, 8, 1, 26, 3),     # c64
    (4096, 100, 100, 4, 2, 10, 0),    # from ROW_SPLIT_ROWS rows: Q in L2
    (2048, 100, 100, 8, 2, 10, 0),
    (20000, 40, 32, 4, 3, 20, 0),     # a CTA's vectors in global memory
    (12000, 40, 32, 8, 3, 20, 0),
])
def test_grid_layouts_of_k1_k2(k1, m, n, k, itemsize, code, ctas, share):
    """K3's grid rule at 4-byte norms: one partial norm per thread in the
    grid (none in a cluster), as the C side's ``smem_need`` counts it."""
    layout = k1.panel_layout(m, n, k, itemsize)
    assert (layout.code, layout.cluster, layout.q_share) == (code, ctas,
                                                             share)
    _assert_valid(k1, layout, m, n, k, itemsize)
    cluster_basis = k1._basis_bytes(m, k, 1, 1024, itemsize, 4, 0)
    assert cluster_basis == itemsize * (m * k + 3 * m + k + 1024)
    grid_basis = k1._basis_bytes(m, k, ctas, 1024, itemsize, 4, code)
    vectors = {1: 3 * m + share + share * m, 2: 3 * m + k, 3: 0}[code]
    assert grid_basis == itemsize * (vectors + 1024) + 4 * 1024


def _jax_modes(monkeypatch, m, n, k):
    """The JAX package's ``auto`` for an f32 (m, n) at k with Pallas
    available, and without it."""
    import jax.numpy as jnp
    from rusty_compression_tpu.ops import pivoted_qr as jpq

    modes = []
    for available in (True, False):
        monkeypatch.setattr(jpq, "pallas_available", lambda: available)
        modes.append(jpq._resolve_mode("auto", m, n, k, jnp.float32))
    return modes


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_resolve_mode_is_the_jax_rule_on_the_card(k1, monkeypatch, dtype):
    """On the card the port resolves f32 ``auto`` to ``"kernel"`` exactly
    where the JAX package resolves it to ``"pallas"`` (Pallas available),
    and to its ``"gs"`` and ``"blocked"`` elsewhere. c64 (the port's
    written deviation: the JAX package kept c64 off its kernel) takes K2
    only where the JAX package would take Pallas in f32 and the working
    set fits at 8 bytes an element, else the JAX package's route without
    Pallas."""
    import torch

    from rusty_compression_tpu_torch.ops.pivoted_qr import (
        _resolve_mode, _working_set_fits)

    cuda, dt = torch.device("cuda"), getattr(torch, dtype)
    kernels = 0
    for m in (24, 72, 500, 1024, 2048, 4096, 16384):
        for n in (100, 128, 129, 512, 513, 1024, 16384):
            for k in (16, 64, 65, 100):
                k = min(k, m, n)
                with_pallas, without = _jax_modes(monkeypatch, m, n, k)
                got = _resolve_mode("auto", m, n, k, dt, cuda)
                if dtype == "float32":
                    want = {"pallas": "kernel"}.get(with_pallas, with_pallas)
                elif (with_pallas == "pallas"
                      and _working_set_fits(m, n, k, 8)):
                    want = "kernel"
                else:
                    want = without
                assert got == want, (m, n, k)
                kernels += got == "kernel"
    assert kernels > 20
    assert _resolve_mode("auto", 1024, 1024, 64, torch.float32,
                         cuda) == "kernel"


@pytest.mark.parametrize("dtype,wrapper", [
    ("float32", "qrcp_panel"), ("complex64", "qrcp_panel_complex")])
def test_gs_launches_k1_k2_over_the_stack(k1, monkeypatch, dtype, wrapper):
    """``_gs`` on an f32 / c64 tensor of the card hands the whole stack to
    K1 / K2 (``_over_stack``) and never runs the plain loop; on the CPU it
    runs the plain loop. The kernel and the tensor are stand-ins."""
    import torch

    from rusty_compression_tpu_torch.ops import pivoted_qr as pq

    seen = []
    monkeypatch.setattr(pq, "_over_stack",
                        lambda fn, a, k: seen.append((fn, a, k)) or "K")

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain loop ran for a card tensor")

    monkeypatch.setattr(pq, "qrcp_panel_plain", no_plain)
    card = types.SimpleNamespace(device=torch.device("cuda"),
                                 dtype=getattr(torch, dtype),
                                 numel=lambda: 2 * 4096 * 100)
    assert pq._gs(card, 100) == "K"
    assert seen == [(getattr(k1, wrapper), card, 100)]
    monkeypatch.undo()
    a = torch.ones((2, 6, 5), dtype=getattr(torch, dtype))
    q, r, piv = pq._gs(a, 3)
    assert q.shape == (2, 6, 3) and piv.dtype == torch.int64


def test_pivot_rule_takes_the_kernel_for_every_shortlist(k1):
    """The blocked route's ``auto`` pivot rule is the kernel for every
    dtype on the card, whatever the shortlist (at block_size=256 the
    (264, 512) one runs K1 as a grid), and the plain rule on the CPU."""
    import torch

    from rusty_compression_tpu_torch.ops.pivoted_qr import _pivot_rule

    for dtype in k1.PANEL_KERNELS:
        assert _pivot_rule("auto", dtype, torch.device("cuda")) == "kernel"
        assert _pivot_rule("auto", dtype, torch.device("cpu")) == "plain"
    assert k1.panel_layout(264, 512, 256, 4).grid


@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_pallas_outside_the_cluster_domain(k1, masked):
    """At (640, 192) k = 96, where Q does not replicate in a CTA (K1 runs
    it as a grid of 6 CTAs), the plain version equals the Pallas kernel in
    interpret mode: pivots exactly, q and r within 1e-4."""
    import jax.numpy as jnp
    import torch
    from rusty_compression_tpu.ops.pallas.qrcp import qrcp_panel as jax_panel

    rng = np.random.default_rng(12)
    a = (rng.standard_normal((640, 192))
         * np.geomspace(1.0, 0.1, 192)).astype(np.float32)
    used = (np.arange(192) % 7 == 0) if masked else None
    assert not k1._q_replicates(640, 96, 4)
    want = jax_panel(jnp.asarray(a), 96, interpret=True,
                     used=None if used is None else jnp.asarray(used))
    got = k1.qrcp_panel(torch.tensor(a), 96, used=None if used is None
                        else torch.tensor(used))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-4)

