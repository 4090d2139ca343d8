// K4: k-step column-pivoted Gram-Schmidt QR of a complex128 panel, for
// sm_90a, with K3's two norm rules.
//
// Replaces no Pallas kernel (the JAX package's accelerator has no
// complex128): it takes the place of
// - rusty_compression_tpu/highacc_id.py:64 (_host_qrcp, LAPACK ?geqp3 on
//   the host) for the complex tol <= 1e-8 ID cores: norm rule `recompute`;
// - rusty_compression_tpu/ops/pivoted_qr.py:62 (_qrcp_gs), which that
//   package runs for complex128: norm rule `downdate`.
// Contract as K2's (qrcp_c64.cu): r_orig[i, c] = q[:, i]^H a[:, c], the
// REAL norm table, |x|^2 taken as re^2 + im^2, every sum in f64.
//
// What bounds it on the H100: operations, 16 real operations per element
// and step and 8 m k^2 for the reorthogonalization, over the card's peak
// f64 rate (67 TFLOP/s, the FP64 tensor-core rate); in fact, as for K1-K3,
// the latency of a step.
//
// What the design does about it: K3's (qrcp_f64.cu), at 16 bytes an
// element, read as it lies in memory (interleaved re, im doubles:
// double2): a cluster with Q in every CTA's shared memory where it fits,
// else one cooperative grid with the residual and Q split over its CTAs'
// shared memory and the reorthogonalization split over the grid (config
// 6c's (64, 2048) core: 64 CTAs of one column of Q each), and from 2048
// rows on Q (and, where m is very large, the CTA's vectors) in global
// memory.

#include "qrcp_common.cuh"

extern "C" {

// As rc_qrcp_panel_f64, for a complex128 stack (interleaved re, im
// doubles): q, r, resid, qws, cand and vecs complex128, norms f64.
int rc_qrcp_panel_c128(const void* a, const float* used, void* q, void* r,
                       int* piv, void* resid, double* norms, void* qws,
                       void* cand, void* best, void* vecs, int batch, int m,
                       int n, int k, int group, int threads, int resid_in_smem,
                       int layout, int norm_rule, int smem_bytes,
                       void* stream) {
  return rc_qrcp::launch_wide<double2>(
      (const double2*)a, used, (double2*)q, (double2*)r, piv,
      (double2*)resid, norms, (double2*)qws, (double2*)cand, best,
      (double2*)vecs, batch, m, n, k, group, threads, resid_in_smem, layout,
      norm_rule, smem_bytes, stream);
}

#ifdef RC_QRCP_CLOCKS
int rc_qrcp_clocks_c128(long long* out, int reset) {
  return rc_qrcp::clocks(out, reset);
}
#endif

}  // extern "C"
