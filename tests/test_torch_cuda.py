"""K1 and K2 on the card: the CUDA kernels against their plain version, and
the routes that launch them.

These tests need an NVIDIA card (marker ``cuda``) and skip without one.
This file imports neither JAX nor the JAX package, so that on a machine
with a card and no JAX it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances: pivots exactly equal; q and r to 1e-4 absolute (f32 and c64,
another summation order).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def k1():
    """The kernels' module, on a machine with a card; skips otherwise."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from rusty_compression_tpu_torch.ops.kernels import qrcp

    return qrcp


def _panel(shape, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * np.geomspace(1.0, 0.1, shape[-1])
    return torch.tensor(a, dtype=torch.float32, device="cuda")


@pytest.mark.parametrize("shape,k,masked", [
    ((24, 2048), 16, False),      # the 2048^2 batch's sketch
    ((16, 2048), 16, False),      # the LQ of C at rank 16
    ((37, 301), 29, True),        # ragged, with a used mask
    ((33, 5), 5, False),          # fewer columns than a warp, k = n
    ((5, 40), 5, False),          # k = m: the residual runs out
    ((3, 24, 2048), 16, False),   # a batch: one CTA per panel
])
def test_kernel_matches_plain(k1, shape, k, masked):
    import torch

    a = _panel(shape)
    used = None
    if masked:
        used = torch.zeros(shape[-1], dtype=torch.bool, device="cuda")
        used[::7] = True
    before = k1.qrcp_panel.launch_count
    q, r, piv = k1.qrcp_panel(a, k, used=used)
    torch.cuda.synchronize()
    assert k1.qrcp_panel.launch_count == before + 1
    q0, r0, piv0 = k1.qrcp_panel_plain(a, k, used)
    assert torch.equal(piv.long(), piv0)
    assert float((q - q0).abs().max()) <= 1e-4
    assert float((r - r0).abs().max()) <= 1e-4


def test_rank_deficient_pivots_stay_permutation(k1):
    import torch

    a = torch.zeros((6, 4), dtype=torch.float32, device="cuda")
    a[2, :] = 1.0
    _, _, piv = k1.qrcp_panel(a, 4)
    assert sorted(piv.tolist()) == [0, 1, 2, 3]
    used = torch.tensor([True, False, False, False], device="cuda")
    _, _, piv = k1.qrcp_panel(a, 3, used=used)
    assert 0 not in piv.tolist()


def test_kernel_rejects_what_it_cannot_take(k1):
    import torch

    a = _panel((24, 64))
    with pytest.raises(ValueError, match="f32-only"):
        k1.qrcp_panel(a.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        k1.qrcp_panel(a.mT, 4)
    with pytest.raises(ValueError, match="shared memory"):
        k1.qrcp_panel(_panel((4096, 100)), 100)
    with pytest.raises(ValueError, match="device"):
        k1.qrcp_panel(a, 4, used=torch.zeros(64, dtype=torch.bool))


def test_auto_mode_takes_the_kernel(k1):
    """pivoted_qr / pivoted_lq on an f32 CUDA tensor launch K1 once."""
    import torch

    from rusty_compression_tpu_torch import pivoted_lq, pivoted_qr

    a = _panel((24, 2048))
    before = k1.qrcp_panel.launch_count
    q, r, ind = pivoted_qr(a, max_rank=16)
    l, _, _ = pivoted_lq(a.mT.contiguous(), max_rank=16)
    torch.cuda.synchronize()
    assert k1.qrcp_panel.launch_count == before + 2
    np.testing.assert_allclose((q @ r)[:, :16].cpu().numpy(),
                               a[:, ind[:16]].cpu().numpy(), atol=1e-4)
    assert torch.equal(l, torch.tril(l))


def _complex_panel(shape, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    a = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
         * np.geomspace(1.0, 0.1, shape[-1]))
    return torch.tensor(a, dtype=torch.complex64, device="cuda")


@pytest.mark.parametrize("shape,k,masked", [
    ((53, 2048), 43, False),      # the core of a complex ID at rank 43
    ((43, 2048), 43, False),      # the LQ of C: k = m
    ((37, 301), 29, True),        # ragged, with a used mask
    ((33, 5), 5, False),          # fewer columns than a warp, k = n
    ((3, 24, 2048), 16, False),   # a batch: one CTA per panel
])
def test_complex_kernel_matches_plain(k1, shape, k, masked):
    import torch

    a = _complex_panel(shape)
    used = None
    if masked:
        used = torch.zeros(shape[-1], dtype=torch.bool, device="cuda")
        used[::7] = True
    before = k1.qrcp_panel_complex.launch_count
    q, r, piv = k1.qrcp_panel_complex(a, k, used=used)
    torch.cuda.synchronize()
    assert k1.qrcp_panel_complex.launch_count == before + 1
    q0, r0, piv0 = k1.qrcp_panel_plain(a, k, used)
    assert torch.equal(piv.long(), piv0)
    assert float((q - q0).abs().max()) <= 1e-4
    assert float((r - r0).abs().max()) <= 1e-4


def test_complex_kernel_rank_deficient_and_rejections(k1):
    import torch

    a = torch.zeros((6, 4), dtype=torch.complex64, device="cuda")
    a[2, :] = 1.0 + 1.0j
    _, _, piv = k1.qrcp_panel_complex(a, 4)
    assert sorted(piv.tolist()) == [0, 1, 2, 3]
    b = _complex_panel((24, 64))
    with pytest.raises(ValueError, match="c64-only"):
        k1.qrcp_panel_complex(b.to(torch.complex128), 4)
    with pytest.raises(ValueError, match="contiguous"):
        k1.qrcp_panel_complex(b.mH, 4)
    with pytest.raises(ValueError, match="shared memory"):
        k1.qrcp_panel_complex(_complex_panel((2048, 100)), 100)


def test_blocked_route_launches_the_panel_kernel(k1):
    """Blocked RRQR on the card: one K1 launch per panel on the shortlist
    (f32), one K2 launch per panel (c64); same pivots as the plain rule
    given the same sketch matrix."""
    import torch

    from rusty_compression_tpu_torch import pivoted_qr
    from rusty_compression_tpu_torch.ops.pivoted_qr import (
        _qrcp_blocked_from_gaussian)

    for make, wrapper in ((_panel, k1.qrcp_panel),
                          (_complex_panel, k1.qrcp_panel_complex)):
        a = make((300, 400), seed=3)
        before = wrapper.launch_count
        q, r, ind = pivoted_qr(a, max_rank=96, mode="blocked", block_size=32)
        torch.cuda.synchronize()
        assert wrapper.launch_count == before + 3
        assert float((q.mH @ q - torch.eye(96, device="cuda")).abs().max()
                     ) <= 1e-5
        assert float(((q @ r)[:, :96] - a[:, ind[:96]]).abs().max()) <= 1e-4
        g = torch.randn((40, 300), device="cuda").to(a.dtype)
        piv_k = _qrcp_blocked_from_gaussian(a, g, 96, 32,
                                            pivot_kernel="kernel")[2]
        piv_p = _qrcp_blocked_from_gaussian(a, g, 96, 32,
                                            pivot_kernel="plain")[2]
        assert torch.equal(piv_k, piv_p)


def test_complex_auto_mode_takes_k2(k1):
    """pivoted_qr / pivoted_lq on a c64 CUDA tensor launch K2 once each,
    and the lazy conjugate of pivoted_lq's ``a.mH`` is written out."""
    import torch

    from rusty_compression_tpu_torch import pivoted_lq, pivoted_qr

    a = _complex_panel((53, 2048))
    before = k1.qrcp_panel_complex.launch_count
    q, r, ind = pivoted_qr(a, max_rank=43)
    c = a.mH[:, :20].resolve_conj().contiguous()   # (2048, 20)
    l, ql, row_ind = pivoted_lq(c)
    torch.cuda.synchronize()
    assert k1.qrcp_panel_complex.launch_count == before + 2
    assert float(((q @ r)[:, :43] - a[:, ind[:43]]).abs().max()) <= 1e-4
    assert float(((l @ ql)[:20] - c[row_ind[:20]]).abs().max()) <= 1e-4
    assert torch.equal(l, torch.tril(l))
