"""K2, the fused complex64 pivoted-QR panel, held against the JAX package.

On the CPU the wrapper ``qrcp_panel_complex`` runs the plain PyTorch
version; the JAX side runs the planar Pallas kernel in interpret mode (both
output layouts) or the ``"gs"`` loop. Mirrors
``tests/test_pivoted_qr.py``'s complex Pallas tests. The kernel itself is
checked on the card by ``test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: pivots exactly equal; q and r to 1e-5 absolute (c64: the same
arithmetic in f32, another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from rusty_compression_tpu.ops.pallas.qrcp import (
    qrcp_panel_complex as jax_panel)

import rusty_compression_tpu as rc
from test_torch_parity import low_rank, n, port, t  # noqa: F401 (fixture)

ATOL = 1e-5


def _kernels():
    from rusty_compression_tpu_torch.ops.kernels import qrcp

    return qrcp


def _assert_same_panel(got, want):
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), atol=ATOL)
    np.testing.assert_allclose(n(got[1]), np.asarray(want[1]), atol=ATOL)


@pytest.mark.parametrize("packed", [True, False])
def test_matches_pallas_interpret(port, packed):
    """One kernel here for the TPU's two output layouts."""
    a = low_rank(0, (64, 48), 1e-2, np.complex64)
    want = jax_panel(jnp.asarray(a), 16, interpret=True, packed=packed)
    got = _kernels().qrcp_panel_complex(t(a), 16)
    assert got[2].dtype == port.torch.int32
    assert got[0].dtype == got[1].dtype == port.torch.complex64
    _assert_same_panel(got, want)


def test_kernel_mode_matches_jax_gs(port):
    """mode="kernel" on a c64 CPU tensor: the plain version under the
    ?geqp3 contract, with the JAX gs pivots and factors."""
    a = low_rank(1, (70, 50), 1e-6, np.complex64)
    jq, jr, jind = rc.pivoted_qr(jnp.asarray(a), max_rank=20, mode="gs")
    q, r, ind = port.rt.pivoted_qr(t(a), max_rank=20, mode="kernel")
    _assert_same_panel((q, r, ind), (jq, jr, jind))
    qn = n(q)
    assert np.linalg.norm(qn.conj().T @ qn - np.eye(20)) < 1e-5


def test_used_mask(port):
    rng = np.random.default_rng(2)
    a = (rng.standard_normal((48, 32))
         + 1j * rng.standard_normal((48, 32))).astype(np.complex64)
    used = np.zeros(32, dtype=bool)
    used[[0, 5, 17]] = True
    want = jax_panel(jnp.asarray(a), 8, used=jnp.asarray(used),
                     interpret=True)
    got = _kernels().qrcp_panel_complex(t(a), 8, used=t(used))
    assert not set(n(got[2]).tolist()) & {0, 5, 17}
    _assert_same_panel(got, want)


@pytest.mark.parametrize("k,used_col", [(4, None), (3, 0)])
def test_rank_deficient_pivots_stay_permutation(port, k, used_col):
    a = np.zeros((6, 4), np.complex64)
    a[2, :] = 1.0 + 1.0j
    used = np.zeros(4, bool)
    if used_col is not None:
        used[used_col] = True
    _, _, want = jax_panel(jnp.asarray(a), k, used=jnp.asarray(used),
                           interpret=True)
    _, _, piv = _kernels().qrcp_panel_complex(t(a), k, used=t(used))
    piv = n(piv).tolist()
    assert len(set(piv)) == k and used_col not in piv
    np.testing.assert_array_equal(piv, np.asarray(want))


def test_c128_and_f32_rejected(port):
    k2 = _kernels().qrcp_panel_complex
    with pytest.raises(ValueError, match="c64-only"):
        k2(t(np.zeros((16, 8), np.complex128)), 4)
    with pytest.raises(ValueError, match="c64-only"):
        k2(t(np.zeros((16, 8), np.float32)), 4)
    with pytest.raises(ValueError, match="f32-only"):
        port.rt.pivoted_qr(t(np.zeros((16, 8), np.complex128)),
                           mode="kernel")


def test_batch_is_one_panel_per_block(port):
    a = np.stack([low_rank(s, (30, 40), 1e-2, np.complex64)
                  for s in range(3)])
    k2 = _kernels().qrcp_panel_complex
    got = k2(t(a), 12)
    for b in range(3):
        want = jax_panel(jnp.asarray(a[b]), 12, interpret=True)
        _assert_same_panel([x[b] for x in got], want)


def test_cpu_tensors_take_the_plain_version(port):
    """On a CPU tensor the wrapper launches nothing, and its result is the
    plain version's bit for bit."""
    k1 = _kernels()
    a = t(low_rank(4, (20, 30), 1e-2, np.complex64))
    got = k1.qrcp_panel_complex(a, 10)
    assert k1.qrcp_panel_complex.launch_count == 0
    want = k1.qrcp_panel_plain(a, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


def test_plain_norms_are_re2_plus_im2(port):
    """The plain version squares the parts, as the kernels do, and takes no
    hypot: exact on values where a hypot would round."""
    torch = port.torch
    x = torch.tensor([3e-20 + 4e-20j, 1.0 + 1e-4j], dtype=torch.complex64)
    want = x.real ** 2 + x.imag ** 2
    assert torch.equal(_kernels().abs2(x), want)
    assert torch.equal(_kernels().abs2(x.real), x.real ** 2)


@pytest.mark.parametrize("shape,k,used_shape", [
    ((8,), 1, None),           # not a matrix
    ((8, 6), 0, None),         # no step
    ((8, 6), 7, None),         # more steps than columns
    ((8, 6), 3, (5,)),         # mask of the wrong width
])
def test_wrapper_rejects_bad_arguments(port, shape, k, used_shape):
    torch = port.torch
    a = torch.zeros(shape, dtype=torch.complex64)
    used = None if used_shape is None else torch.zeros(used_shape)
    with pytest.raises(ValueError):
        _kernels().qrcp_panel_complex(a, k, used=used)


def test_fit_rule_counts_eight_bytes(port):
    """Q (m, k), the q pairs, one candidate column, the projections and a
    partial sum per thread: 4 bytes an element for K1, 8 for K2. A panel
    whose Q does not replicate in a CTA at 8 bytes runs K2 as a grid."""
    k1 = _kernels()
    assert (k1.panel_layout(53, 8192, 43, 8).smem_bytes
            == 8 * (53 * 43 + 2 * 53 + 2 * 16 * 53 + 43 + 1024))
    assert k1.kernel_fits(136, 128, 8) and k1.kernel_fits(53, 43, 8)
    assert k1.kernel_fits(400, 136) and k1.kernel_fits(400, 136, 8)
    assert k1._q_replicates(400, 136, 4) and not k1._q_replicates(400, 136, 8)
    assert not k1.panel_layout(400, 1000, 136, 4).grid
    assert k1.panel_layout(400, 1000, 136, 8).grid
