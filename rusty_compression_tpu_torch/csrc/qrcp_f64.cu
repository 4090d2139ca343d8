// K3: k-step column-pivoted Gram-Schmidt QR of an f64 panel, for sm_90a,
// with two rules for the column norms.
//
// Replaces no Pallas kernel: the JAX package computes the same function on
// its host or in XLA, because its accelerator has no f64. It takes the
// place of
// - rusty_compression_tpu/highacc_id.py:64 (_host_qrcp, LAPACK ?geqp3 on
//   the host), the pivots of the tol <= 1e-8 ID cores: norm rule
//   `recompute`;
// - rusty_compression_tpu/ops/pivoted_qr.py:62 (_qrcp_gs, a jnp loop),
//   which that package's pivoted_qr runs for f64 and complex128: norm rule
//   `downdate`, the contract of K1 (qrcp.cu).
// Contract as K1's: q (m, k) orthonormal, r_orig (k, n) in ORIGINAL column
// order, piv (k,) int32 in selection order, `used` columns never chosen,
// ties to the lowest index. Every sum accumulates in f64.
//
// The norm rules. `downdate` carries norms - |s|^2 over every step, as K1
// does. At tol 1e-8 that cancels to roundoff: on a captured core of
// hilbert(1024) it leaves ?geqp3's pivots at step 14 of 16. ?geqp3 itself
// recomputes a norm once its downdate has cancelled far enough.
// `recompute` takes the norm afresh each step without a second pass: the
// column pass of step i already reads every residual element after the
// downdate of step i - 1, so it also sums their |x|^2 (the norm before
// step i, exact to rounding) and sets the norm to that sum less |s_i|^2.
// The cancellation is then one step's.
//
// What bounds it on the H100: by the roofline, operations, at 4 real
// operations per element and step (2 for the R row, 2 for the downdate)
// plus 4 m i for the reorthogonalization of step i (2 m k^2 over the k
// steps), over the card's peak f64 rate (67 TFLOP/s, the FP64 tensor-core
// rate): 33 us for the (256, 8192) core of an 8192^2 Laplace block at
// k = 256. In fact the latency of a step, as for K1: the k steps depend
// on each other.
//
// What the design does about it. Small panels take K1's design unchanged
// (qrcp.cu): one cluster of 1-16 CTAs, Q replicated in every CTA's shared
// memory, the residual slices in shared memory, one cluster barrier a
// step. The 1e-8 cores do not fit it: Q of the (256, 8192) core is 512
// KiB, and its 16 MiB residual is 1 MiB a CTA over a cluster of 16, which
// would then stream from L2 every step (K1's L2 layout, 44 GB/s an SM on
// the 2048^2 f32 blocks). So those panels run as one cooperative grid of
// up to 128 CTAs, one an SM:
// - the residual is spread over the grid, so that each slice lies in its
//   CTA's shared memory (16 MiB over 128 CTAs is 128 KiB a CTA) and the
//   column pass never leaves the SM;
// - one grid barrier a step, in place of the cluster barrier: each CTA
//   writes its best and its candidate column to global memory, and after
//   the barrier every warp joins the bests and every CTA copies the
//   winning column; buffers alternate by step parity, as in a cluster;
// - Q lies once in global memory, written by CTA 0 and read by every CTA
//   from L2 for its own copy of the reorthogonalization (the same code
//   and order in every CTA, so q_i is bitwise the same everywhere and
//   nothing is broadcast). Only one CTA reorthogonalizing would read Q
//   once a step instead of once a CTA, but would cost a second grid
//   barrier a step; reading 2 m i words from L2 per CTA is the simpler
//   choice, and PERF.md keeps what it measures;
// - from 2048 rows on (kRowSplitRows) a CTA spreads its
//   reorthogonalization and norm over all its threads by rows, joined by
//   block reductions, so that a step of a tall panel is not one warp's
//   walk down thousands of rows of Q;
// - where m is so large that a CTA's vectors (the pairs, the pivot column
//   and the projections, 3 m + k elements) do not fit in its shared
//   memory beside the partial sums, they lie in its own part of a global
//   workspace, so that every panel has a layout.
// There are no atomics besides the grid barrier's own: a run repeats
// bitwise.

#include "qrcp_common.cuh"

extern "C" {

// Launches one group of `group` CTAs per panel of the (batch, m, n) stack
// `a` on `stream`: a cluster (grid 0) or a cooperative grid (grid 1).
// `used` is null or (batch, n) f32 with > 0 marking excluded columns.
// `resid` (batch, m, n) and `norms` (batch, n) f64 are scratch for the
// global-memory residual and may be null when `resid_in_smem` is set; the
// grid needs `qws` (batch, k, m), `cand` (batch, 2, group, m) and `best`
// (batch, 2, group) of 16 bytes, and, for one panel whose vectors do not
// fit in shared memory, `vecs` (group, vec_stride(m, k)); `vecs` is null
// otherwise. `norm_rule` is 0 (downdate) or 1
// (recompute). Returns 0, the CUDA error of the launch, -1 when the card
// cannot place the group, or -2 for layout numbers that do not fit
// together; does not synchronise.
int rc_qrcp_panel_f64(const double* a, const float* used, double* q,
                      double* r, int* piv, double* resid, double* norms,
                      double* qws, double* cand, void* best, double* vecs,
                      int batch, int m, int n, int k, int group, int threads,
                      int resid_in_smem, int grid, int norm_rule,
                      int smem_bytes, void* stream) {
  return rc_qrcp::launch_wide<double>(a, used, q, r, piv, resid, norms, qws,
                                      cand, best, vecs, batch, m, n, k, group,
                                      threads, resid_in_smem, grid, norm_rule,
                                      smem_bytes, stream);
}

#ifdef RC_QRCP_CLOCKS
int rc_qrcp_clocks_f64(long long* out, int reset) {
  return rc_qrcp::clocks(out, reset);
}
#endif

}  // extern "C"
