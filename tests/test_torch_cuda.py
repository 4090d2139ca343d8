"""K1 on the card: the CUDA kernel against its plain version.

These tests need an NVIDIA card (marker ``cuda``) and skip without one.
This file imports neither JAX nor the JAX package, so that on a machine
with a card and no JAX it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances: pivots exactly equal; q and r to 1e-4 absolute (f32, another
summation order).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def k1():
    """The K1 module, on a machine with a card; skips otherwise."""
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
