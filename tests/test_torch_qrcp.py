"""K1, the fused pivoted-QR panel, held against the JAX package.

On the CPU the wrapper ``qrcp_panel`` runs its plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode or the JAX
``_qrcp_gs`` loop. Mirrors ``tests/test_pivoted_qr.py``'s Pallas tests:
matches gs, the full-rank contract, the ``used`` mask, rank-deficient
pivots staying a permutation, f64 rejected by the kernel entry. The
kernel itself is checked on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``.

Tolerances: pivots exactly equal; q and r to 1e-5 absolute in f32 (same
arithmetic, another summation order) and 1e-10 in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from rusty_compression_tpu.ops.pallas.qrcp import qrcp_panel as jax_panel
from rusty_compression_tpu.ops.pivoted_qr import _qrcp_gs as jax_qrcp_gs

import rusty_compression_tpu as rc
from test_torch_parity import low_rank, n, port, t  # noqa: F401 (fixture)
from torch_threads import one_thread  # noqa: F401 (autouse)

ATOL = {np.float32: 1e-5, np.float64: 1e-10}


def _kernels():
    from rusty_compression_tpu_torch.ops.kernels import qrcp

    return qrcp


def _assert_same_panel(got, want, atol):
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), atol=atol)
    np.testing.assert_allclose(n(got[1]), np.asarray(want[1]), atol=atol)


def test_matches_pallas_interpret(port):
    a = low_rank(0, (80, 50), 1e-2)
    want = jax_panel(jnp.asarray(a), 20, interpret=True)
    k1 = _kernels()
    got = k1.qrcp_panel(t(a), 20)
    assert got[2].dtype == port.torch.int32
    _assert_same_panel(got, want, ATOL[np.float32])


@pytest.mark.parametrize("dtype,shape", [(np.float32, (60, 40)),
                                         (np.float64, (40, 60))])
def test_plain_version_matches_jax_gs(port, dtype, shape):
    a = low_rank(1, shape, 1e-3, dtype)
    q, r, piv, used = jax.jit(jax_qrcp_gs, static_argnums=1)(
        jnp.asarray(a), 15)
    got = _kernels().qrcp_panel_plain(t(a), 15)
    _assert_same_panel(got, (q, r, piv), ATOL[dtype])


def test_contract_full_rank(port):
    """mode="kernel" on a CPU tensor: the wrapper's plain version under
    the ?geqp3 contract, with the JAX gs pivots."""
    a = np.random.default_rng(2).standard_normal((40, 30)).astype(np.float32)
    q, r, ind = port.rt.pivoted_qr(t(a), mode="kernel")
    qn, rn, ind = n(q), n(r), n(ind)
    assert np.linalg.norm(qn.T @ qn - np.eye(30)) < 1e-5
    np.testing.assert_allclose(qn @ rn, a[:, ind], atol=1e-5)
    d = np.abs(np.diag(rn))
    assert np.all(d[1:] <= d[:-1] + 1e-6)
    _, _, jind = rc.pivoted_qr(jnp.asarray(a), mode="gs")
    np.testing.assert_array_equal(ind, np.asarray(jind))


def test_used_mask(port):
    """Columns flagged ``used`` are never selected, as in the Pallas kernel."""
    a = np.random.default_rng(3).standard_normal((48, 32)).astype(np.float32)
    used = np.zeros(32, dtype=bool)
    used[[0, 5, 17]] = True
    want = jax_panel(jnp.asarray(a), 8, used=jnp.asarray(used),
                     interpret=True)
    got = _kernels().qrcp_panel(t(a), 8, used=t(used))
    assert not set(n(got[2]).tolist()) & {0, 5, 17}
    _assert_same_panel(got, want, ATOL[np.float32])


@pytest.mark.parametrize("k,used_col", [(4, None), (3, 0)])
def test_rank_deficient_pivots_stay_permutation(port, k, used_col):
    """The -1 exclusion sentinel survives the norm downdates: identical
    columns of a rank-one panel are each picked once."""
    a = np.zeros((6, 4), np.float32)
    a[2, :] = 1.0
    used = np.zeros(4, bool)
    if used_col is not None:
        used[used_col] = True
    _, _, want = jax_panel(jnp.asarray(a), k, used=jnp.asarray(used),
                           interpret=True)
    _, _, piv = _kernels().qrcp_panel(t(a), k, used=t(used))
    piv = n(piv).tolist()
    assert len(set(piv)) == k and used_col not in piv
    np.testing.assert_array_equal(piv, np.asarray(want))


def test_f64_rejected(port):
    a = t(np.zeros((16, 8)))
    with pytest.raises(ValueError, match="f32-only"):
        _kernels().qrcp_panel(a, 4)
    with pytest.raises(ValueError, match="f32-only"):
        port.rt.pivoted_qr(a, mode="kernel")


def test_batch_is_one_panel_per_block(port):
    """A (B, m, n) stack gives each block's own factorization, as the
    JAX package's vmap of the Gram-Schmidt loop does."""
    a = np.stack([low_rank(s, (30, 40), 1e-2) for s in range(3)])
    q, r, piv, _ = jax.jit(jax.vmap(lambda x: jax_qrcp_gs(x, 12)))(
        jnp.asarray(a))
    got = _kernels().qrcp_panel(t(a), 12)
    _assert_same_panel(got, (q, r, piv), ATOL[np.float32])
    one = _kernels().qrcp_panel(t(a[1]), 12)
    np.testing.assert_array_equal(n(one[2]), n(got[2][1]))


def test_cpu_tensors_take_the_plain_version(port):
    """On a CPU tensor the wrapper launches nothing: the launch count
    stays put and the result is the plain version's, bit for bit."""
    k1 = _kernels()
    a = t(low_rank(4, (20, 30), 1e-2))
    before = k1.qrcp_panel.launch_count
    got = k1.qrcp_panel(a, 10)
    assert k1.qrcp_panel.launch_count == before == 0
    want = k1.qrcp_panel_plain(a, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.parametrize("shape,k,used_shape", [
    ((8,), 1, None),           # not a matrix
    ((8, 6), 0, None),         # no step
    ((8, 6), 7, None),         # more steps than columns
    ((8, 6), 3, (5,)),         # mask of the wrong width
])
def test_wrapper_rejects_bad_arguments(port, shape, k, used_shape):
    torch = port.torch
    a = torch.zeros(shape, dtype=torch.float32)
    used = None if used_shape is None else torch.zeros(used_shape)
    with pytest.raises(ValueError):
        _kernels().qrcp_panel(a, k, used=used)
