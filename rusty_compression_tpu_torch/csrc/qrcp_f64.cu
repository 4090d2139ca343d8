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
// - Q is spread over the grid too: CTA r keeps the columns t = r (mod G)
//   of Q in its shared memory (2 of the (256, 8192) core's 256 columns at
//   G = 128, 4 KiB), so no CTA reads Q from L2;
// - three grid barriers a step. (1) Each CTA writes its best and its
//   candidate column to global memory; after the barrier one warp a CTA
//   joins the bests (all warps of all CTAs reading the same lines of L2
//   cost 17.8 k cycles a step at 85 CTAs) and every CTA copies the winning
//   column v. (2) Each CTA projects v on its own columns of Q and writes
//   its part of -Q Q^H v, an m-vector; after the barrier CTA r sums its
//   share of the rows of the parts, in rank order, into v'. (3) After the
//   barrier every CTA reads v', takes its norm in the same order as every
//   other warp, and holds q_i bit for bit as the others do. The grid reads
//   about 3 G m words from L2 a step, where a CTA that kept none of Q read
//   2 m i (42 MB a step over 82 CTAs at i = 256);
// - the rule picks the fewest CTAs whose slices are at most a warp wide
//   and whose shares of Q at most 16 columns, else the most (128): the
//   column pass shrinks with the slice until a warp spans it;
// - a step of the (256, 8192) core now costs ~23 k cycles (sweep.py
//   --clocks, one H100): the column pass 5.4 k, the three barriers 1.9-
//   2.4 k each (cooperative groups' grid.sync(), about 1 us; a hand-written
//   release/acquire counter saved 2-5 % of the kernel and was not kept),
//   then four L2 round trips (the bests, v, the parts, v') and the CTA's
//   argmax; the 65.7 k of the design that re-read Q in every CTA went to
//   the reorthogonalization (33.5 k) and the barrier with its join (21.4 k);
// - below 2048 rows, where no slice fits beside the shares, the residual
//   lies in global memory and Q stays split over 128 CTAs (c128 (1000,
//   1000) k = 600: 15 ms, against 111 ms with Q in L2, a warp four columns
//   at a time); where no share fits either, Q lies once in global memory
//   in just that way (kGridWarps: written by CTA 0, and each CTA
//   reorthogonalizes v itself from L2); one grid barrier a step;
// - from 2048 rows on, Q lies once in global memory and each CTA
//   reorthogonalizes v from L2 with its block spread over the rows and
//   joined by block reductions, so that a step of a tall panel is not one
//   warp's walk down thousands of rows of Q (below 2048 rows this ran
//   2.6-2.9 times slower than kGridWarps); one grid barrier a step;
// - where m is so large that a CTA's vectors (the pairs, the pivot column
//   and the projections, 3 m + k elements) do not fit in its shared
//   memory beside the partial sums, they lie in its own part of a global
//   workspace, so that every panel has a layout.
// There are no atomics besides the grid barrier's own, and every sum has a
// fixed order: a run repeats bitwise.

#include "qrcp_common.cuh"

extern "C" {

// Launches one group of `group` CTAs per panel of the (batch, m, n) stack
// `a` on `stream`, in the layout `layout`: 0 a cluster, 1 a cooperative
// grid with Q split over its CTAs, 2 the grid with Q in global memory, 3
// the same with the CTAs' vectors there too, 4 the grid with Q in global
// memory read a warp four columns at a time (PanelLayout.code).
// `used` is null or (batch, n) f32 with > 0 marking excluded columns.
// `resid` (batch, m, n) and `norms` (batch, n) f64 are scratch for the
// global-memory residual and may be null when `resid_in_smem` is set; the
// grid needs `qws` ((group + 1, m) in layout 1, (batch, k, m) in 2 and 3),
// `cand` (batch, 2, group, m) and `best` (batch, 2, group) of 16 bytes,
// and, in layout 3, `vecs` (group, vec_stride(m, k)); `vecs` is null
// otherwise. A grid runs one panel (batch 1). `norm_rule` is 0 (downdate) or 1
// (recompute). Returns 0, the CUDA error of the launch, -1 when the card
// cannot place the group, or -2 for layout numbers that do not fit
// together; does not synchronise.
int rc_qrcp_panel_f64(const double* a, const float* used, double* q,
                      double* r, int* piv, double* resid, double* norms,
                      double* qws, double* cand, void* best, double* vecs,
                      int batch, int m, int n, int k, int group, int threads,
                      int resid_in_smem, int layout, int norm_rule,
                      int smem_bytes, void* stream) {
  return rc_qrcp::launch_wide<double>(a, used, q, r, piv, resid, norms, qws,
                                      cand, best, vecs, batch, m, n, k, group,
                                      threads, resid_in_smem, layout,
                                      norm_rule, smem_bytes, stream);
}

#ifdef RC_QRCP_CLOCKS
int rc_qrcp_clocks_f64(long long* out, int reset) {
  return rc_qrcp::clocks(out, reset);
}
#endif

}  // extern "C"
