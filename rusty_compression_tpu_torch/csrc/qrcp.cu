// K1: k-step column-pivoted Gram-Schmidt QR of an f32 panel, for sm_90a.
//
// Replaces the Pallas TPU kernel rusty_compression_tpu/ops/pallas/qrcp.py
// (qrcp_panel / _qrcp_kernel), with the same contract: q (m, k)
// orthonormal, r_orig (k, n) in ORIGINAL column order
// (r_orig[i, c] = q[:, i]^T a[:, c]), piv (k,) int32 in selection order.
// Each step:
//   1. argmax of the column-norm table; ties go to the lowest index
//      (jnp.argmax); `used` columns start at the -1 sentinel, never win;
//   2. gather the pivot column of the residual;
//   3. one reorthogonalization pass against the basis built so far;
//   4. normalise, with a zero-norm guard;
//   5. R row = q_i^T resid;
//   6. rank-1 residual downdate;
//   7. norms = norms < 0 ? norms : max(norms - r^2, 0), then the chosen
//      column is set to -1 (without the sentinel, exhausted columns of a
//      rank-deficient panel would tie at 0 and be picked twice).
//
// What bounds it on the H100: by the roofline, bytes at the wide sketch
// panels ((24, 16384): the panel read once, q, r and piv written once) and
// operations at the square shortlists ((136, 256) at k = 128). In fact
// neither: the k steps depend on each other (step i + 1 picks its pivot
// from the norms step i left), each step is a few thousand operations per
// SM, and so the kernel is bound by the latency of a step: its barriers
// and the round trips to wherever the residual lies. What a design can do
// is keep the residual next to the threads, put many SMs on one panel and
// spend few barriers a step.
//
// What this design does about it (the step loop is in qrcp_common.cuh,
// written once for f32, complex64 and, in K3 and K4, f64 and complex128):
// - One panel is one thread-block cluster of C = 1, 2, 4, 8 or 16 CTAs;
//   CTA c owns the columns [c w, (c + 1) w), w = ceil(n / C). A batch of
//   panels is a grid of clusters.
// - The CTA's residual slice (m, w), its last R row and its norm slice
//   stay in its shared memory for the whole step loop whenever they fit
//   beside Q; the 1.5 MB sketch of a 16384-wide block is sixteen slices
//   of 96 KB. A slice that fits no cluster of 16 stays in the CTA's part
//   of a global workspace (L2), with the same access pattern. The
//   wrapper's layout rule (panel_layout in ops/kernels/qrcp.py) chooses
//   C, the layout and the block size from (m, n, k) alone.
// - One cluster barrier a step. Each CTA joins the (value, index) best of
//   its norm slice and writes it, with that column of its slice, into
//   every CTA's candidate buffer through distributed shared memory.
//   After the barrier every warp of every CTA joins the C candidates
//   itself with `better`, so all agree on j with ties to the lowest
//   index, and all hold the pivot column already: there is no second
//   exchange and the owner need not wait before it downdates. The
//   buffers alternate by step parity. Steps 3 and 4 are replicated in
//   every CTA on a replicated Q (same code, same order, bitwise the same
//   q_i), so nothing is broadcast. There are no atomics: a run repeats
//   bitwise.
// - The column pass (5-7) uses every thread and touches each residual
//   element once a step: the downdate of step i - 1 is folded into the
//   pass of step i (read, downdate by (q_{i-1}, s_{i-1}), write, dot with
//   q_i; the two q values come in one load), and the last downdate is
//   never made. A warp lies over 32 neighbouring columns of a row of the
//   slice (conflict-free in shared memory, coalesced in L2); where the
//   slice is narrower than the block several threads share a column over
//   row ranges and join their partial dot products in shared memory in a
//   fixed order. The norm downdate keeps each thread's best for the next
//   step's argmax, which therefore costs no pass of its own.
// - Q is column-major in shared memory, so a warp reads neighbouring
//   words in both loops of step 3 whatever k is, four columns at a time
//   for independent chains; q_out is written (m, k) row-major at the end.
// - Four block barriers a step beside the cluster barrier, and small
//   panels run as one CTA with as few as 128 threads.
// - Where Q, replicated in every CTA, does not fit one CTA's shared memory
//   (m k + 3 m + k + 1024 elements in 227 KB: k <= 52 at 1024 rows), the
//   panel runs as one cooperative grid of up to 128 CTAs, one panel a
//   launch, in K3's layouts (qrcp_f64.cu): below 2048 rows Q split over
//   the CTAs' shared memory, from 2048 rows on Q in global memory. The
//   Pallas kernel took any panel whose working set fit in VMEM (config
//   2's (1024, 1024) at k = 64 among them); with the grid K1 takes every
//   panel. The grid's step is a chain of three barriers and L2 round
//   trips, slower a step than a cluster's.
// Every dot product accumulates in f32. What is left of a step is a chain
// of dependent latencies (two warp argmaxes, the barrier, two reduction
// rounds, a norm) of a few microseconds whatever the panel's size.
// wgmma has no use here (each step is a matrix-vector product); a
// pivots-only variant is later work.

#include "qrcp_common.cuh"

extern "C" {

// Launches one group of `group` CTAs per panel of the (batch, m, n) stack
// `a` on `stream`, in the layout `layout`: 0 a cluster, 1-4 the
// cooperative grid of rc_qrcp_panel_f64 (qrcp_f64.cu), which also says
// what the workspaces `qws`, `cand`, `best` (here 8 bytes an entry) and
// `vecs` hold; a grid runs one panel (batch 1), and they are null for a
// cluster. `used` is null or (batch, n) with > 0 marking excluded columns.
// `resid` (batch, m, n) and `norms` (batch, n) are scratch for the
// global-memory residual and may be null when `resid_in_smem` is set.
// `threads` and `smem_bytes` are the block size and the dynamic shared
// memory of the layout. The norms are downdated (kDowndate). Returns 0,
// the CUDA error of the launch, -1 when the card cannot place the group,
// or -2 for layout numbers that do not fit together; does not synchronise.
int rc_qrcp_panel_f32(const float* a, const float* used, float* q, float* r,
                      int* piv, float* resid, float* norms, float* qws,
                      float* cand, void* best, float* vecs, int batch, int m,
                      int n, int k, int group, int threads, int resid_in_smem,
                      int layout, int smem_bytes, void* stream) {
  return rc_qrcp::launch_rule<float, rc_qrcp::kDowndate>(
      a, used, q, r, piv, resid, norms, qws, cand, best, vecs, batch, m, n, k,
      group, threads, resid_in_smem, layout, smem_bytes, stream);
}

#ifdef RC_QRCP_CLOCKS
int rc_qrcp_clocks_f32(long long* out, int reset) {
  return rc_qrcp::clocks(out, reset);
}
#endif

}  // extern "C"
