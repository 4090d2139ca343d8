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
// What bounds it on the H100: as for K1, each step reads the whole
// (m, n) residual twice and writes it once, now at 8 bytes an element:
// about 3 k m n 8 bytes over the run. The residual of the 8192-wide
// core (53 x 8192) is 3.5 MB: it lives in a global workspace that stays
// in the 50 MB L2, one CTA per panel, so the step loop runs at one SM's
// L2 bandwidth. By the roofline the work is bound by operations
// (16 m n k + 16 m k^2 real operations against 8 (mn + mk + kn) bytes),
// but this design is far from either bound: it is latency- and
// single-SM-bound like K1.
//
// What this simple design does about it: K1's. One thread per column, so
// a warp's reads of resid[r * n + c] are coalesced 8-byte accesses; the R
// row, the rank-1 downdate and the norm downdate share one pass over each
// column; Q (m x k), the pivot column and the projections sit in shared
// memory, (m k + 2 m) 8 bytes, which is the fit rule the wrapper checks.
// A batch of panels is a grid of CTAs.

#include "qrcp_common.cuh"

namespace {

using namespace rc_qrcp;

// conj(a) * b
__device__ __forceinline__ float2 conj_mul(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

// acc + a * b
__device__ __forceinline__ float2 mul_add(float2 acc, float2 a, float2 b) {
  return make_float2(acc.x + (a.x * b.x - a.y * b.y),
                     acc.y + (a.x * b.y + a.y * b.x));
}

__device__ __forceinline__ float abs2(float2 a) { return a.x * a.x + a.y * a.y; }

__global__ void __launch_bounds__(kThreads)
qrcp_panel_c64_kernel(const float2* __restrict__ a,
                      const float* __restrict__ used,
                      float2* __restrict__ q_out, float2* __restrict__ r_out,
                      int* __restrict__ piv_out, float2* __restrict__ resid,
                      float* __restrict__ norms, int m, int n, int k) {
  extern __shared__ float2 smem[];
  float2* qs = smem;         // (m, k) basis, row-major like q_out
  float2* v = qs + m * k;    // (m) pivot column, then q_i
  float2* qv = v + m;        // (k <= m) projections Q^H v
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

  for (int x = tid; x < m * k; x += kThreads) qs[x] = make_float2(0.f, 0.f);
  // Copy the panel into the residual workspace and take the column norms.
  for (int c = tid; c < n; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < m; ++r) {
      const float2 x = a[(size_t)r * n + c];
      resid[(size_t)r * n + c] = x;
      s += abs2(x);
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

    // 3. Reorthogonalize: v -= Q (Q^H v) over the i columns built so far.
    for (int t = warp; t < i; t += kWarps) {
      float2 s = make_float2(0.f, 0.f);
      for (int r = lane; r < m; r += 32) {
        const float2 p = conj_mul(qs[r * k + t], v[r]);
        s.x += p.x;
        s.y += p.y;
      }
      s.x = warp_sum(s.x);
      s.y = warp_sum(s.y);
      if (lane == 0) qv[t] = s;
    }
    __syncthreads();
    for (int r = tid; r < m; r += kThreads) {
      float2 s = make_float2(0.f, 0.f);
      for (int t = 0; t < i; ++t) s = mul_add(s, qs[r * k + t], qv[t]);
      v[r] = make_float2(v[r].x - s.x, v[r].y - s.y);
    }
    __syncthreads();

    // 4. Normalise; a zero column gives a zero q_i.
    if (warp == 0) {
      float s = 0.f;
      for (int r = lane; r < m; r += 32) s += abs2(v[r]);
      s = warp_sum(s);
      if (lane == 0) {
        const float nv = sqrtf(s);
        s_inv = nv > 0.f ? 1.f / nv : 0.f;
        piv_out[i] = j;
      }
    }
    __syncthreads();
    for (int r = tid; r < m; r += kThreads) {
      const float2 x = make_float2(v[r].x * s_inv, v[r].y * s_inv);
      v[r] = x;
      qs[r * k + i] = x;
    }
    __syncthreads();

    // 5-7. One pass per column: R row, rank-1 downdate, norm downdate.
    float2* r_row = r_out + (size_t)i * n;
    for (int c = tid; c < n; c += kThreads) {
      float2 s = make_float2(0.f, 0.f);
      for (int r = 0; r < m; ++r) {
        const float2 p = conj_mul(v[r], resid[(size_t)r * n + c]);
        s.x += p.x;
        s.y += p.y;
      }
      const float2 neg = make_float2(-s.x, -s.y);
      for (int r = 0; r < m; ++r) {
        const size_t at = (size_t)r * n + c;
        resid[at] = mul_add(resid[at], v[r], neg);
      }
      r_row[c] = s;
      const float nc = norms[c];
      norms[c] = (c == j) ? -1.f
                          : (nc < 0.f ? nc : fmaxf(nc - abs2(s), 0.f));
    }
    __syncthreads();
  }

  for (int x = tid; x < m * k; x += kThreads) q_out[x] = qs[x];
}

}  // namespace

extern "C" {

// Launches one CTA per panel of the (batch, m, n) complex64 stack `a`
// (interleaved re, im floats) on `stream`. `used` is null or (batch, n)
// f32 with > 0 marking excluded columns; `resid` (batch, m, n) complex64
// and `norms` (batch, n) f32 are scratch. Returns the CUDA error of the
// launch (0 on success); does not synchronise.
int rc_qrcp_panel_c64(const void* a, const float* used, void* q, void* r,
                      int* piv, void* resid, float* norms, int batch, int m,
                      int n, int k, void* stream) {
  // Q (m, k) plus two m-vectors at 8 bytes: the fit rule the wrapper checks.
  const size_t smem = sizeof(float2) * ((size_t)m * k + 2 * (size_t)m);
  cudaError_t err = cudaFuncSetAttribute(
      qrcp_panel_c64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qrcp_panel_c64_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)a, used, (float2*)q, (float2*)r, piv, (float2*)resid,
      norms, m, n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
