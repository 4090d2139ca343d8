// The pivoted-QR panel kernel shared by K1 (qrcp.cu, f32) and K2
// (qrcp_c64.cu, complex64 as interleaved float2): the scalar operations of
// both types, the warp reductions, the step loop written once over the
// scalar type, and its launcher. The design is described in qrcp.cu.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include <mutex>

namespace rc_qrcp {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;

// Launcher results that are not CUDA errors.
constexpr int kErrBadLayout = -2;        // layout numbers out of range
constexpr int kErrNotSchedulable = -1;   // the card cannot place the cluster

// With -DRC_QRCP_CLOCKS thread 0 of the first panel's first CTA adds the cycles
// it spends in each part of a step to g_clocks (ops/kernels/sweep.py
// --clocks builds and reads it); without it the marks compile to nothing.
#ifdef RC_QRCP_CLOCKS
__device__ long long g_clocks[8];
#define RC_CLOCK_START() long long rc_last = clock64()
#define RC_CLOCK_MARK(slot)                                \
  do {                                                     \
    if (blockIdx.x == 0 && tid == 0) {                     \
      const long long rc_now = clock64();                  \
      g_clocks[slot] += rc_now - rc_last;                  \
      rc_last = rc_now;                                    \
    }                                                      \
  } while (0)
// Copies the counts to `out` (8 values), or sets them to 0 for `reset`.
inline int clocks(long long* out, int reset) {
  if (reset) {
    const long long zero[8] = {0};
    return (int)cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, g_clocks, 8 * sizeof(long long));
}
#else
#define RC_CLOCK_START()
#define RC_CLOCK_MARK(slot)
#endif

struct ArgMax {
  float v;
  int i;
};

// Larger value wins; equal values go to the lower index. Indices are
// distinct, so this is a total order and any reduction tree agrees.
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float2 warp_sum(float2 x) {
  return make_float2(warp_sum(x.x), warp_sum(x.y));
}

__device__ __forceinline__ ArgMax warp_argmax(ArgMax a) {
  for (int o = 16; o > 0; o >>= 1) {
    ArgMax b{__shfl_xor_sync(0xffffffffu, a.v, o),
             __shfl_xor_sync(0xffffffffu, a.i, o)};
    a = better(a, b);
  }
  return a;
}

// acc + conj(a) * b
__device__ __forceinline__ float conj_mul_add(float acc, float a, float b) {
  return acc + a * b;
}
__device__ __forceinline__ float2 conj_mul_add(float2 acc, float2 a,
                                               float2 b) {
  return make_float2(acc.x + (a.x * b.x + a.y * b.y),
                     acc.y + (a.x * b.y - a.y * b.x));
}

// acc - a * b
__device__ __forceinline__ float mul_sub(float acc, float a, float b) {
  return acc - a * b;
}
__device__ __forceinline__ float2 mul_sub(float2 acc, float2 a, float2 b) {
  return make_float2(acc.x - (a.x * b.x - a.y * b.y),
                     acc.y - (a.x * b.y + a.y * b.x));
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float scale(float a, float s) { return a * s; }
__device__ __forceinline__ float2 scale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// |a|^2 as re^2 + im^2 (no hypot), as the plain version takes it.
__device__ __forceinline__ float abs2(float a) { return a * a; }
__device__ __forceinline__ float abs2(float2 a) { return a.x * a.x + a.y * a.y; }

// q_{i-1}[r] and q_i[r] side by side, so that the column pass reads both
// with one load.
template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T prev;
  T cur;
};

// Candidate buffers of a CTA: two (by step parity) in a cluster, one alone.
__host__ __device__ inline int cand_buffers(int cluster) {
  return cluster > 1 ? 2 : 1;
}

// Dynamic shared memory of one CTA: the (q_{i-1}, q_i) pairs (m), Q (m, k),
// the cluster's candidate columns (buffers x cluster x m), the projections
// (k), one partial sum per thread and, in the shared-memory layout, the
// residual slice (m, w), its last R row (w) and its norms (w). The
// wrapper's layout rule computes the same number.
__host__ __device__ inline size_t smem_need(int m, int k, int w, int cluster,
                                            int threads, int resid_in_smem,
                                            size_t itemsize) {
  size_t bytes = itemsize * ((size_t)m * k + 2 * (size_t)m + k + threads +
                             (size_t)cand_buffers(cluster) * cluster * m);
  if (resid_in_smem) {
    bytes += itemsize * ((size_t)m * w + w) + sizeof(float) * w;
  }
  return bytes;
}

// How the threads of a CTA lie over its slice: `tw` neighbouring columns
// by `nsplit` row ranges. A warp lies over 32 neighbouring columns of one
// row range, so its accesses to a row of the slice are conflict-free in
// shared memory and coalesced in global memory. Where the slice is wider
// than the block, a thread walks `iters` columns and nsplit is 1.
struct Slice {
  int c0;        // first column owned
  int wl;        // columns owned (ragged edge; 0 for a CTA past the edge)
  int tw, nsplit, split, cl;
  int r0, r1;    // this thread's row range
  int iters;     // 1 at most when nsplit > 1
  bool in_pass;
};

// Steps 5-7 of step i over the CTA's own slice, with the downdate of step
// i - 1 folded in (the residual in memory lags one step behind): each
// element is read once, downdated by (q_{i-1}, s_{i-1}), written, and
// enters the dot product with q_i. Then R row, norm downdate, and the
// threads' bests for the next argmax. Threads that share a column join
// their partial dot products in a fixed order. `s_prev` is row i - 1 of R
// over the slice, `s_next` takes row i (the same array in shared memory).
template <typename T>
__device__ __forceinline__ ArgMax column_pass(
    T* resid, size_t ld, float* norms, const T* s_prev, T* s_next, T* r_row,
    const Pair<T>* pq, T* part, const Slice& g, int i, int j, int n) {
  ArgMax best{-INFINITY, n};
  for (int it = 0; it < g.iters; ++it) {
    const int c = g.cl + it * g.tw;
    const bool live = g.in_pass && c < g.wl;
    T s{};
    if (live) {
      const T sp = i > 0 ? s_prev[c] : T{};
      // kRows loads are issued before the first store: the compiler may
      // not move a load of the residual over a store to it by itself.
      constexpr int kRows = 32 / sizeof(T);
      int r = g.r0;
      for (; r + kRows <= g.r1; r += kRows) {
        T x[kRows];
        Pair<T> q[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          x[u] = resid[(r + u) * ld + c];
          q[u] = pq[r + u];
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          x[u] = mul_sub(x[u], q[u].prev, sp);
          resid[(r + u) * ld + c] = x[u];
          s = conj_mul_add(s, q[u].cur, x[u]);
        }
      }
      for (; r < g.r1; ++r) {
        const Pair<T> q = pq[r];
        const T x = mul_sub(resid[r * ld + c], q.prev, sp);
        resid[r * ld + c] = x;
        s = conj_mul_add(s, q.cur, x);
      }
    }
    if (g.nsplit > 1) {
      // Only the column's first thread needs the sum now; the others read
      // it from `s_prev` in the next step.
      if (g.in_pass) part[threadIdx.x] = s;
      __syncthreads();
      if (live && g.split == 0) {
        s = T{};
        for (int p = 0; p < g.nsplit; ++p) s = add(s, part[p * g.tw + g.cl]);
      }
    }
    if (live && g.split == 0) {
      r_row[c] = s;
      if (s_next != r_row) s_next[c] = s;
      const float nc = norms[c];
      const float x = (g.c0 + c == j) ? -1.f
                      : (nc < 0.f ? nc : fmaxf(nc - abs2(s), 0.f));
      norms[c] = x;
      if (x > best.v) best = ArgMax{x, g.c0 + c};
    }
  }
  return best;
}

// One panel per thread-block cluster; CTA `rank` of the cluster owns the
// columns [rank * w, (rank + 1) * w) of the panel. The residual slice, its
// last R row and its norms lie in the CTA's shared memory (resid_in_smem)
// or in its part of global memory (resid_ws, norms_ws, r_out).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
qrcp_panel_kernel(const T* __restrict__ a, const float* __restrict__ used,
                  T* __restrict__ q_out, T* r_out, int* __restrict__ piv_out,
                  T* resid_ws, float* norms_ws, int m, int n, int k, int w,
                  int resid_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ ArgMax warp_best[kMaxWarps];
  __shared__ ArgMax cand_best[2 * kMaxCluster];

  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const size_t panel = blockIdx.x / nranks;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  a += panel * (size_t)m * n;
  q_out += panel * (size_t)m * k;
  r_out += panel * (size_t)k * n;
  piv_out += panel * k;
  if (used != nullptr) used += panel * n;

  Slice g;
  g.c0 = rank * w;
  g.wl = max(0, min(w, n - g.c0));
  g.tw = min(nthreads, (w + 31) & ~31);
  g.nsplit = nthreads / g.tw;
  g.split = tid / g.tw;
  g.cl = tid - g.split * g.tw;
  const int rows_per = (m + g.nsplit - 1) / g.nsplit;
  g.r0 = min(m, g.split * rows_per);
  g.r1 = min(m, g.r0 + rows_per);
  g.in_pass = g.split < g.nsplit;
  g.iters = (g.wl + g.tw - 1) / g.tw;

  Pair<T>* pq = reinterpret_cast<Pair<T>*>(smem_raw);  // (m)
  T* qs = reinterpret_cast<T*>(pq + m);    // (k, m): column t at qs + t * m
  T* cand = qs + (size_t)m * k;            // (buffers, nranks, m)
  T* qv = cand + (size_t)cand_buffers(nranks) * nranks * m;  // (k)
  T* part = qv + k;                        // (nthreads) partial sums
  T* resid_s = part + nthreads;            // slice (m, w) in shared memory
  T* srow_s = resid_s + (size_t)m * w;     // (w) last R row of the slice
  float* norms_s = reinterpret_cast<float*>(srow_s + w);  // (w)
  T* resid_g = resid_ws + panel * (size_t)m * n + g.c0;
  float* norms_g = norms_ws + panel * n + g.c0;
  // Generic views for the one-time prologue and the candidate column.
  T* resid = resid_in_smem ? resid_s : resid_g;
  float* norms = resid_in_smem ? norms_s : norms_g;
  const size_t ld = resid_in_smem ? w : n;

  // Copy the slice into the residual and take the column norms; each
  // thread keeps the best of the columns whose norm it writes.
  ArgMax best{-INFINITY, n};
  for (int it = 0; it < g.iters; ++it) {
    const int c = g.cl + it * g.tw;
    const bool live = g.in_pass && c < g.wl;
    float s = 0.f;
    if (live) {
      for (int r = g.r0; r < g.r1; ++r) {
        const T x = a[(size_t)r * n + g.c0 + c];
        resid[r * ld + c] = x;
        s += abs2(x);
      }
    }
    if (g.nsplit > 1) {
      float* partf = reinterpret_cast<float*>(part);
      if (g.in_pass) partf[tid] = s;
      __syncthreads();
      if (live && g.split == 0) {
        s = 0.f;
        for (int p = 0; p < g.nsplit; ++p) s += partf[p * g.tw + g.cl];
      }
    }
    if (live && g.split == 0) {
      const float x = (used != nullptr && used[g.c0 + c] > 0.f) ? -1.f : s;
      norms[c] = x;
      if (x > best.v) best = ArgMax{x, g.c0 + c};
    }
  }

  RC_CLOCK_START();
  for (int i = 0; i < k; ++i) {
    // 1. Argmax of the norm table, one cluster barrier. The threads' bests
    // (taken while the norms were written) are joined per warp and per
    // CTA. Each CTA then writes its best and that column of its slice
    // into every CTA's candidate buffer (distributed shared memory),
    // with the pending downdate applied; after the barrier every warp of
    // every CTA joins the candidates itself, so all agree on j with ties
    // to the lowest index, and all hold the pivot column: no second
    // exchange, and the owner may go on downdating. The buffers
    // alternate by step, because a CTA may write the next candidates
    // while a slower peer still reads these.
    best = warp_argmax(best);
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    best = warp_argmax(lane < nwarps ? warp_best[lane]
                                     : ArgMax{-INFINITY, n});
    RC_CLOCK_MARK(0);   // the CTA's argmax
    const int buf = nranks > 1 ? (i & 1) : 0;
    T* cand_i = cand + (size_t)buf * nranks * m;
    ArgMax* cand_best_i = cand_best + buf * kMaxCluster;
    {
      const int cb = best.i - g.c0;        // meaningful when the CTA has columns
      const bool has = g.wl > 0;
      const T sp = (has && i > 0)
                       ? (resid_in_smem ? srow_s[cb]
                                        : r_out[(size_t)(i - 1) * n + best.i])
                       : T{};
      for (int x = tid; x < nranks * m; x += nthreads) {
        const int dest = x / m;
        const int r = x - dest * m;
        T val{};
        if (has) {
          val = resid[r * ld + cb];
          if (i > 0) val = mul_sub(val, pq[r].cur, sp);
        }
        cluster.map_shared_rank(cand_i, dest)[rank * m + r] = val;
      }
      if (tid < nranks) {
        cluster.map_shared_rank(cand_best_i, tid)[rank] = best;
      }
    }
    if (nranks > 1) cluster.sync(); else __syncthreads();
    best = warp_argmax(lane < nranks ? cand_best_i[lane]
                                     : ArgMax{-INFINITY, n});
    const int j = best.i;
    RC_CLOCK_MARK(1);   // candidates out, cluster barrier, joined
    T* v = cand_i + (size_t)(j / w) * m;   // 2. the pivot column, in place

    // 3. Reorthogonalize against the i columns built so far, replicated
    // in every CTA: v -= Q (Q^H v). Q is column-major, so a warp reads
    // neighbouring words in both loops. A warp takes four columns of Q at
    // a time and a thread four partial sums, to have independent chains.
    if (i > 0) {
      for (int tb = warp; tb < i; tb += 4 * nwarps) {
        const T* q0 = qs + (size_t)tb * m;
        const T* q1 = qs + (size_t)min(tb + nwarps, i - 1) * m;
        const T* q2 = qs + (size_t)min(tb + 2 * nwarps, i - 1) * m;
        const T* q3 = qs + (size_t)min(tb + 3 * nwarps, i - 1) * m;
        T s0{}, s1{}, s2{}, s3{};
        for (int r = lane; r < m; r += 32) {
          const T vr = v[r];
          s0 = conj_mul_add(s0, q0[r], vr);
          s1 = conj_mul_add(s1, q1[r], vr);
          s2 = conj_mul_add(s2, q2[r], vr);
          s3 = conj_mul_add(s3, q3[r], vr);
        }
        s0 = warp_sum(s0);
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        s3 = warp_sum(s3);
        if (lane == 0) {
          qv[tb] = s0;
          if (tb + nwarps < i) qv[tb + nwarps] = s1;
          if (tb + 2 * nwarps < i) qv[tb + 2 * nwarps] = s2;
          if (tb + 3 * nwarps < i) qv[tb + 3 * nwarps] = s3;
        }
      }
      __syncthreads();
      RC_CLOCK_MARK(2);   // Q^H v
      for (int r = tid; r < m; r += nthreads) {
        T x0 = v[r], x1{}, x2{}, x3{};
        int t = 0;
#pragma unroll 2
        for (; t + 4 <= i; t += 4) {
          const T* qt = qs + (size_t)t * m + r;
          x0 = mul_sub(x0, qt[0], qv[t]);
          x1 = mul_sub(x1, qt[m], qv[t + 1]);
          x2 = mul_sub(x2, qt[2 * m], qv[t + 2]);
          x3 = mul_sub(x3, qt[3 * m], qv[t + 3]);
        }
        for (; t < i; ++t) x0 = mul_sub(x0, qs[(size_t)t * m + r], qv[t]);
        v[r] = add(add(x0, x1), add(x2, x3));
      }
      __syncthreads();
      RC_CLOCK_MARK(3);   // v -= Q (Q^H v)
    }

    // 4. Normalise (every warp takes the norm itself, in the same order);
    // a zero column gives a zero q_i. q_i becomes column i of Q and the
    // newer half of the pairs.
    float nv = 0.f;
    for (int r = lane; r < m; r += 32) nv += abs2(v[r]);
    nv = sqrtf(warp_sum(nv));
    const float inv = nv > 0.f ? 1.f / nv : 0.f;
    for (int r = tid; r < m; r += nthreads) {
      const T x = scale(v[r], inv);
      qs[(size_t)i * m + r] = x;
      pq[r] = Pair<T>{i > 0 ? pq[r].cur : T{}, x};
    }
    if (rank == 0 && tid == 0) piv_out[i] = j;
    __syncthreads();
    RC_CLOCK_MARK(4);   // norm and q_i

    // 5-7. The column pass, compiled once for each address space.
    T* r_row = r_out + (size_t)i * n + g.c0;
    if (resid_in_smem) {
      best = column_pass<T>(resid_s, w, norms_s, srow_s, srow_s, r_row, pq,
                            part, g, i, j, n);
    } else {
      best = column_pass<T>(resid_g, n, norms_g,
                            r_out + (size_t)max(i - 1, 0) * n + g.c0, r_row,
                            r_row, pq, part, g, i, j, n);
    }
    RC_CLOCK_MARK(5);   // column pass
  }

  // q_out is (m, k) row-major.
  if (rank == 0) {
    for (int x = tid; x < m * k; x += nthreads) {
      q_out[x] = qs[(size_t)(x % k) * m + x / k];
    }
  }
  // No CTA may exit while a peer can still write into its shared memory.
  if (nranks > 1) cluster.sync();
}

// Launches `batch` clusters of `cluster` CTAs with `threads` threads and
// `smem_bytes` of dynamic shared memory each. Returns 0, a CUDA error, or
// one of the kErr codes; does not synchronise.
template <typename T>
int launch_panel(const T* a, const float* used, T* q, T* r, int* piv,
                 T* resid_ws, float* norms_ws, int batch, int m, int n, int k,
                 int cluster, int threads, int resid_in_smem, int smem_bytes,
                 void* stream) {
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 ||
                          cluster == 8 || cluster == kMaxCluster;
  if (!cluster_ok || threads < 32 || threads > kMaxThreads || threads % 32 ||
      batch < 1 || m < 1 || n < 1 || k < 1) {
    return kErrBadLayout;
  }
  const int w = (n + cluster - 1) / cluster;
  if (smem_need(m, k, w, cluster, threads, resid_in_smem, sizeof(T)) >
          (size_t)smem_bytes ||
      (!resid_in_smem && (resid_ws == nullptr || norms_ws == nullptr))) {
    return kErrBadLayout;
  }
  auto kernel = qrcp_panel_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  // Whether the card can place one such cluster is asked once per layout.
  struct Seen { int cluster, threads, smem; };
  static Seen seen[64];
  static int nseen = 0;
  static std::mutex lock;
  {
    std::lock_guard<std::mutex> guard(lock);
    bool known = false;
    for (int x = 0; x < nseen; ++x) {
      known = known || (seen[x].cluster == cluster &&
                        seen[x].threads == threads &&
                        seen[x].smem == smem_bytes);
    }
    if (!known) {
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (clusters < 1) return kErrNotSchedulable;
      if (nseen < 64) seen[nseen++] = Seen{cluster, threads, smem_bytes};
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a, used, q, r, piv, resid_ws,
                           norms_ws, m, n, k, w, resid_in_smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace rc_qrcp
