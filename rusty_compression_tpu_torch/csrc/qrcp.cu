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
// What bounds it on the H100: each step reads and rewrites the whole
// (m, n) residual, so k steps move about 3 k m n 4 bytes; at the sketch
// of a 16384^2 block (24 x 16384, k = 16) that is 1.5 MB of residual,
// too large for one SM's 227 KB of shared memory but resident in the
// 50 MB L2. One CTA works on one panel, so a single panel runs on one
// of the 132 SMs and the step loop is latency-bound: the rate is one
// SM's L2 bandwidth plus eight block-wide barriers per step.
//
// What this simple design does about it: the residual and the norm
// table live in a global workspace (L2), with one thread per column so
// that the resid[r * n + c] reads and writes of a warp are coalesced;
// the R row, the rank-1 downdate and the norm downdate share one pass
// over each column. Q (m x k), the pivot column and the projections sit
// in shared memory; that is the fit rule the wrapper checks:
// (m k + 2 m) 4 bytes of dynamic shared memory. A batch of panels is a
// grid of CTAs, one per panel. Every dot product accumulates in f32.
// The Mosaic one-hot masks of the TPU kernel are gone: columns are
// indexed directly. Spreading one panel over a cluster or several CTAs,
// and wgmma, are later work.

#include "qrcp_common.cuh"

namespace {

using namespace rc_qrcp;

__global__ void __launch_bounds__(kThreads)
qrcp_panel_kernel(const float* __restrict__ a, const float* __restrict__ used,
                  float* __restrict__ q_out, float* __restrict__ r_out,
                  int* __restrict__ piv_out, float* __restrict__ resid,
                  float* __restrict__ norms, int m, int n, int k) {
  extern __shared__ float smem[];
  float* qs = smem;         // (m, k) basis, row-major like q_out
  float* v = qs + m * k;    // (m) pivot column, then q_i
  float* qv = v + m;        // (k <= m) projections Q^T v
  __shared__ ArgMax warp_best[kWarps];
  __shared__ float s_inv;
  __shared__ int s_piv;

  const size_t panel = blockIdx.x;
  const size_t mn = (size_t)m * n;
  a += panel * mn;
  resid += panel * mn;
  norms += panel * n;
  q_out += panel * m * k;
  r_out += panel * k * n;
  piv_out += panel * k;
  if (used != nullptr) used += panel * n;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int x = tid; x < m * k; x += kThreads) qs[x] = 0.f;
  // Copy the panel into the residual workspace and take the column norms.
  for (int c = tid; c < n; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < m; ++r) {
      const float x = a[(size_t)r * n + c];
      resid[(size_t)r * n + c] = x;
      s += x * x;
    }
    norms[c] = (used != nullptr && used[c] > 0.f) ? -1.f : s;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    // 1. Block-wide argmax. Each thread scans its columns in ascending
    // order with a strict comparison, so it keeps its lowest index.
    ArgMax best{-INFINITY, n};
    for (int c = tid; c < n; c += kThreads) {
      const float x = norms[c];
      if (x > best.v) best = ArgMax{x, c};
    }
    best = warp_argmax(best);
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = warp_argmax(warp_best[lane]);
      if (lane == 0) s_piv = best.i;
    }
    __syncthreads();
    const int j = s_piv;

    // 2. Gather the pivot column.
    for (int r = tid; r < m; r += kThreads) v[r] = resid[(size_t)r * n + j];
    __syncthreads();

    // 3. Reorthogonalize: v -= Q (Q^T v) over the i columns built so far
    // (the later columns of Q are zero, as in the TPU kernel).
    for (int t = warp; t < i; t += kWarps) {
      float s = 0.f;
      for (int r = lane; r < m; r += 32) s += qs[r * k + t] * v[r];
      s = warp_sum(s);
      if (lane == 0) qv[t] = s;
    }
    __syncthreads();
    for (int r = tid; r < m; r += kThreads) {
      float s = 0.f;
      for (int t = 0; t < i; ++t) s += qs[r * k + t] * qv[t];
      v[r] -= s;
    }
    __syncthreads();

    // 4. Normalise; a zero column gives a zero q_i.
    if (warp == 0) {
      float s = 0.f;
      for (int r = lane; r < m; r += 32) s += v[r] * v[r];
      s = warp_sum(s);
      if (lane == 0) {
        const float nv = sqrtf(s);
        s_inv = nv > 0.f ? 1.f / nv : 0.f;
        piv_out[i] = j;
      }
    }
    __syncthreads();
    for (int r = tid; r < m; r += kThreads) {
      const float x = v[r] * s_inv;
      v[r] = x;
      qs[r * k + i] = x;
    }
    __syncthreads();

    // 5-7. One pass per column: R row, rank-1 downdate, norm downdate.
    float* r_row = r_out + (size_t)i * n;
    for (int c = tid; c < n; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < m; ++r) s += v[r] * resid[(size_t)r * n + c];
      for (int r = 0; r < m; ++r) resid[(size_t)r * n + c] -= v[r] * s;
      r_row[c] = s;
      const float nc = norms[c];
      norms[c] = (c == j) ? -1.f : (nc < 0.f ? nc : fmaxf(nc - s * s, 0.f));
    }
    __syncthreads();
  }

  for (int x = tid; x < m * k; x += kThreads) q_out[x] = qs[x];
}

}  // namespace

extern "C" {

// Launches one CTA per panel of the (batch, m, n) stack `a` on `stream`.
// `used` is null or (batch, n) with > 0 marking excluded columns;
// `resid` (batch, m, n) and `norms` (batch, n) are scratch. Returns the
// CUDA error of the launch (0 on success); does not synchronise.
int rc_qrcp_panel_f32(const float* a, const float* used, float* q, float* r,
                      int* piv, float* resid, float* norms, int batch, int m,
                      int n, int k, void* stream) {
  // Q (m, k) plus two m-vectors: the fit rule the wrapper checks.
  const size_t smem = sizeof(float) * ((size_t)m * k + 2 * (size_t)m);
  cudaError_t err = cudaFuncSetAttribute(
      qrcp_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qrcp_panel_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      a, used, q, r, piv, resid, norms, m, n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
