"""The port's main path, end to end, held against the JAX package.

* rSVD half: ``__graft_entry__.entry()``'s batched rSVD (4 x 256 x 192,
  rank 32, oversample 8, one power iteration) with each block's Omega
  rebuilt from the JAX per-block keys.
* ID half: the one-read batched two-sided ID of three 120 x 90 blocks at
  rank 24 with each block's JAX sketch.
* The port imports neither JAX nor the JAX package.

Tolerances: singular values to 1e-5 of the largest (f32); reconstruction
errors within 1e-6 of the JAX package's; pivots exactly equal; factors to
1e-5 of their largest entry; skeleton to 1e-4.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_parity import (assert_same_two_sided, block_keys,  # noqa: F401
                               jax_gaussian, jax_sketch, low_rank, n, port, t)


def test_entry_batched_rsvd_matches_jax(port):
    from __graft_entry__ import entry

    from rusty_compression_tpu_torch.parallel.batch import (
        _rsvd_block_from_omega, batched_rel_diff_fro)
    from rusty_compression_tpu.parallel.batch import (
        batched_rel_diff_fro as jax_errors)

    fn, (blocks, key) = entry()
    u, s, vt = jax.jit(fn)(blocks, key)
    b, m, ncols = blocks.shape
    omega = np.stack([jax_gaussian(k, (ncols, 40), np.float32)
                      for k in block_keys(key, b)])
    got = _rsvd_block_from_omega(t(blocks), t(omega), 32, power_iters=1)
    assert got.u.shape == (b, m, 32) and got.vt.shape == (b, 32, ncols)
    s = np.asarray(s)
    np.testing.assert_allclose(n(got.s), s, atol=1e-5 * s.max())
    import rusty_compression_tpu as rc

    want_err = np.asarray(jax_errors(rc.SVD(u, s, vt), blocks))
    err = n(batched_rel_diff_fro(got, t(blocks)))
    np.testing.assert_allclose(err, want_err, atol=1e-6)


def test_batched_sketched_two_sided_id_matches_jax(port):
    from rusty_compression_tpu_torch.parallel.batch import batched_rel_diff_fro
    from rusty_compression_tpu_torch.sampling import (
        _sketched_column_id_from_sketch)
    from rusty_compression_tpu.parallel.batch import (
        batched_rel_diff_fro as jax_errors,
        batched_sketched_two_sided_id as jax_batched)

    blocks = np.stack([low_rank(50 + i, (120, 90), 1e-4) for i in range(3)])
    key = jax.random.key(53)
    want = jax.jit(lambda x, k: jax_batched(x, k, rank=24))(
        jnp.asarray(blocks), key)
    g_h = np.stack([jax_sketch(k, 120, 32, np.float32)
                    for k in block_keys(key, 3)])
    got = _sketched_column_id_from_sketch(
        port.rt.DenseOperator(t(blocks)), t(g_h), 24).two_sided_id()
    assert_same_two_sided(got, want, 1e-5)
    for i in range(3):
        sk = blocks[i][np.ix_(n(got.row_ind[i, :24]), n(got.col_ind[i, :24]))]
        np.testing.assert_allclose(n(got.x[i]), sk, rtol=1e-4,
                                   atol=1e-4 * np.abs(sk).max())
    np.testing.assert_allclose(
        n(batched_rel_diff_fro(got, t(blocks))),
        np.asarray(jax_errors(want, jnp.asarray(blocks))), atol=1e-6)


def test_main_path_from_a_generator(port):
    """The public batched entry points with a torch generator: every block
    within the gates the JAX package's tests use."""
    from rusty_compression_tpu_torch.parallel import (
        batched_rel_diff_fro, batched_rsvd, batched_sketched_two_sided_id)

    torch = port.torch
    g = torch.Generator().manual_seed(7)
    blocks = t(np.stack([low_rank(60 + i, (120, 90), 1e-4)
                         for i in range(3)]))
    bound = 10 * 1e-4 ** (24 / 89)
    ts = batched_sketched_two_sided_id(blocks, g, 24)
    assert torch.all(batched_rel_diff_fro(ts, blocks) < bound)
    cols = torch.take_along_dim(blocks, ts.col_ind[:, None, :24], dim=-1)
    sk = torch.take_along_dim(cols, ts.row_ind[:, :24, None], dim=-2)
    np.testing.assert_allclose(n(ts.x), n(sk), rtol=1e-4,
                               atol=1e-4 * float(sk.abs().max()))
    svd = batched_rsvd(blocks, g, 24, oversample=8, power_iters=1)
    assert torch.all(batched_rel_diff_fro(svd, blocks) < bound)


def test_public_names_mirror_the_jax_package(port):
    import rusty_compression_tpu as rc
    from rusty_compression_tpu import parallel as jpar

    from rusty_compression_tpu_torch import parallel

    assert set(port.rt.__all__) <= set(rc.__all__)
    assert set(parallel.__all__) <= set(jpar.__all__)


def test_import_loads_no_jax():
    code = ("import sys, rusty_compression_tpu_torch, "
            "rusty_compression_tpu_torch.parallel, "
            "rusty_compression_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'rusty_compression_tpu.'))"
            " or m == 'rusty_compression_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
