// K2: k-step column-pivoted Gram-Schmidt QR of a complex64 panel, for
// sm_90a.
//
// Replaces the Pallas TPU kernels of
// rusty_compression_tpu/ops/pallas/qrcp.py (qrcp_panel_complex; bodies
// _qrcp_complex_kernel and _qrcp_complex_kernel_packed), with the same
// contract as K1 (qrcp.cu) for complex input: q (m, k) with orthonormal
// columns, r_orig (k, n) in ORIGINAL column order
// (r_orig[i, c] = q[:, i]^H a[:, c]), piv (k,) int32 in selection order.
// Each step:
//   1. argmax of the REAL column-norm table; ties go to the lowest index;
//      `used` columns start at the -1 sentinel and never win;
//   2. gather the pivot column of the residual;
//   3. one reorthogonalization pass: qv = Q^H v, v -= Q qv;
//   4. normalise, with a zero-norm guard;
//   5. R row = conj(q_i)^T resid;
//   6. rank-1 residual downdate;
//   7. norms = norms < 0 ? norms : max(norms - |r|^2, 0), then the chosen
//      column is set to -1.
// |x|^2 is re^2 + im^2 throughout, as in the TPU kernel; every sum
// accumulates in f32.
//
// The TPU kernel worked on two planar (re, im) f32 planes, with four real
// products for each complex one, because Mosaic has no complex type, and
// came in two output layouts because some backends rejected five outputs.
// Here a complex64 tensor is read as it lies in memory, interleaved
// (re, im) float pairs (float2), so there is one kernel, one layout and
// no planar split.
//
// What bounds it on the H100: by the roofline, operations
// (16 m n k + 16 m k^2 real operations against 8 (mn + mk + kn) bytes).
// In fact, as for K1, the latency of a step: the k steps depend on each
// other, so what counts is how near the residual lies to the threads, how
// many SMs share a panel and how many barriers a step costs.
//
// What this design does about it: K1's, at 8 bytes an element. The step
// loop is the one template of qrcp_common.cuh, instantiated for float2
// (see the note in qrcp.cu): one panel over a thread-block cluster,
// columns split over its CTAs, the residual, R-row and norm slices in the
// owners' shared memory, one cluster barrier a step with the candidate
// pivot columns exchanged through distributed shared memory, steps 3 and
// 4 replicated on a column-major Q, every thread in a column pass that
// touches each residual element once a step. The (43, 8192) LQ panel of
// the 8192-wide complex ID fits the shared memory of sixteen CTAs. The
// (53, 8192) core does not (a slice of 512 columns is 217 KB beside
// 18 KB of Q): its slices stay in the global workspace (L2), now pulled
// on by sixteen SMs, each thread with several independent loads in
// flight (the row loop is unrolled, a warp's accesses coalesced). A
// panel whose Q does not fit a CTA beside the vectors (m k + 3 m + k +
// 1024 elements in 227 KB, half K1's count) runs as K1's does then: one
// cooperative grid a panel (qrcp_f64.cu).

#include "qrcp_common.cuh"

extern "C" {

// As rc_qrcp_panel_f32, for a complex64 stack (interleaved re, im
// floats): q, r, resid, qws, cand and vecs complex64, norms f32.
int rc_qrcp_panel_c64(const void* a, const float* used, void* q, void* r,
                      int* piv, void* resid, float* norms, void* qws,
                      void* cand, void* best, void* vecs, int batch, int m,
                      int n, int k, int group, int threads, int resid_in_smem,
                      int layout, int smem_bytes, void* stream) {
  return rc_qrcp::launch_rule<float2, rc_qrcp::kDowndate>(
      (const float2*)a, used, (float2*)q, (float2*)r, piv, (float2*)resid,
      norms, (float2*)qws, (float2*)cand, best, (float2*)vecs, batch, m, n, k,
      group, threads, resid_in_smem, layout, smem_bytes, stream);
}

#ifdef RC_QRCP_CLOCKS
int rc_qrcp_clocks_c64(long long* out, int reset) {
  return rc_qrcp::clocks(out, reset);
}
#endif

}  // extern "C"
