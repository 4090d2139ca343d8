"""Utilities of the port: dtypes, errors, kernel matrices, logging,
metrics, the peak-rate model (``mfu``), permutations, the matmul
precision policy, profiling and random matrices.

Not ported from ``rusty_compression_tpu.utils``, and why:

* ``backend.py``, the probe that asks a subprocess whether the device
  accepts complex dtypes: some TPU backends reject every complex op, and
  the JAX package then routes complex work through all-real planar and
  host paths. A CUDA card takes c64 and c128 in every op the port uses
  (K2 is a c64 kernel), so the port has no such route and nothing to
  probe. For the same reason the port has no twin of
  ``__graft_entry__.dryrun_multichip``'s branch that stubs
  ``backend._accepts_complex`` to False: the route it drives does not
  exist here.
* ``doublefloat.py``: the f64 emulation of the TPU (see ``highacc``).
"""
