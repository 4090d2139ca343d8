// The pivoted-QR panel kernel shared by K1 (qrcp.cu, f32), K2
// (qrcp_c64.cu, complex64 as interleaved float2), K3 (qrcp_f64.cu, f64)
// and K4 (qrcp_c128.cu, complex128 as interleaved double2): the scalar
// operations of the four types, the warp reductions, the step loop written
// once over the scalar type, and its launchers. The design is described in
// qrcp.cu; the norm rules K3 and K4 add, and the grid layouts all four
// take where Q does not fit a cluster, in qrcp_f64.cu.

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

// How the column norms of the next step are taken (K1 and K2: kDowndate).
constexpr int kDowndate = 0;    // norms - |s|^2, carried over every step
constexpr int kRecompute = 1;   // |x|^2 summed in this step's pass, - |s|^2

// Where a group's CTAs keep what they share, and how a CTA reorthogonalizes
// (the kernel's kLayout, which the wrapper's rule picks: PanelLayout.code).
constexpr int kCluster = 0;     // a cluster: Q and the vectors in shared memory
constexpr int kGridSmem = 1;    // a cooperative grid: Q split over the CTAs
constexpr int kGridTall = 2;    // the grid, Q in global memory, rows split
constexpr int kGridGlobal = 3;  // the same, the CTAs' vectors in global too
constexpr int kGridWarps = 4;   // the grid, Q in global memory, warps over Q

// kGridSmem: CTA r of G keeps the columns t = r (mod G) of Q in its shared
// memory, and a step reorthogonalizes the pivot column v over the grid:
// each CTA projects v on its own columns and writes its part of -Q Q^H v
// (an m-vector) to global memory; behind a barrier CTA r sums rows
// [r m/G, (r+1) m/G) of the G parts, in order, into v' = v - Q Q^H v;
// behind a second barrier every CTA reads v' and normalises it itself.
// So a step has three grid barriers (the candidates', the parts', v''s:
// each stage needs what every CTA wrote in the one before) and the grid
// reads about 3 G m words from L2, where a CTA that kept nothing of Q read
// all of it (2 m i words, every CTA, every step). What bounds a step now
// is its chain of latencies: the barriers (about 2 k cycles each), four
// L2 round trips and the column pass (qrcp_f64.cu has the cycles).
//
// kGridTall, kGridGlobal: from 2048 rows on (the wrapper's ROW_SPLIT_ROWS)
// Q lies in global memory (written by CTA 0, read by all) and each CTA reorthogonalizes v itself, its whole
// block taking four columns at a time, each thread a stride of rows (one
// block reduction per four columns of Q): a warp that walks thousands of
// rows alone waits on its L2 loads one after another (sweep.py --clocks:
// Q^H v took 160 k cycles a step at (4096, 512) k = 64 and 407 k at
// (16384, 58) k = 50 with a warp a column group). The layouts are
// template parameters: as a runtime branch the row split cost the shorter
// grids 40 %.
//
// kGridWarps: below 2048 rows, where no grid holds the shares of Q even
// with the residual in global memory (m and k both large), Q lies in
// global memory and each CTA reorthogonalizes v itself, a warp taking four
// columns of Q at a time as in a cluster. Below 2048 rows kGridTall's
// block over the rows, a block barrier every four columns, ran 2.6-2.9
// times slower (sweep.py: c128 (1000, 1000) k = 600, f64 (1500, 1500)
// k = 1500). Every CTA still reads all of Q from L2 each step: c128
// (1900, 2000) k = 400 takes 103 ms, where the split grid with the
// residual in L2 takes 15 ms at (1000, 1000) k = 600.

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

// The type of a column norm: f32 for K1 and K2, f64 for K3 and K4.
template <typename T> struct NormOf;
template <> struct NormOf<float> { using type = float; };
template <> struct NormOf<float2> { using type = float; };
template <> struct NormOf<double> { using type = double; };
template <> struct NormOf<double2> { using type = double; };
template <typename T> using Norm = typename NormOf<T>::type;

template <typename N>
struct ArgMax {
  N v;
  int i;
};

// Larger value wins; equal values go to the lower index. Indices are
// distinct, so this is a total order and any reduction tree agrees.
template <typename N>
__device__ __forceinline__ ArgMax<N> better(ArgMax<N> a, ArgMax<N> b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float2 warp_sum(float2 x) {
  return make_float2(warp_sum(x.x), warp_sum(x.y));
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ double2 warp_sum(double2 x) {
  return make_double2(warp_sum(x.x), warp_sum(x.y));
}

template <typename N>
__device__ __forceinline__ ArgMax<N> warp_argmax(ArgMax<N> a) {
  for (int o = 16; o > 0; o >>= 1) {
    ArgMax<N> b{__shfl_xor_sync(0xffffffffu, a.v, o),
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
__device__ __forceinline__ double conj_mul_add(double acc, double a,
                                               double b) {
  return acc + a * b;
}
__device__ __forceinline__ double2 conj_mul_add(double2 acc, double2 a,
                                                double2 b) {
  return make_double2(acc.x + (a.x * b.x + a.y * b.y),
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
__device__ __forceinline__ double mul_sub(double acc, double a, double b) {
  return acc - a * b;
}
__device__ __forceinline__ double2 mul_sub(double2 acc, double2 a,
                                           double2 b) {
  return make_double2(acc.x - (a.x * b.x - a.y * b.y),
                      acc.y - (a.x * b.y + a.y * b.x));
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ double2 add(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float scale(float a, float s) { return a * s; }
__device__ __forceinline__ float2 scale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}
__device__ __forceinline__ double scale(double a, double s) { return a * s; }
__device__ __forceinline__ double2 scale(double2 a, double s) {
  return make_double2(a.x * s, a.y * s);
}

// |a|^2 as re^2 + im^2 (no hypot), as the plain version takes it.
__device__ __forceinline__ float abs2(float a) { return a * a; }
__device__ __forceinline__ float abs2(float2 a) { return a.x * a.x + a.y * a.y; }
__device__ __forceinline__ double abs2(double a) { return a * a; }
__device__ __forceinline__ double abs2(double2 a) {
  return a.x * a.x + a.y * a.y;
}

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float clamp0(float x) { return fmaxf(x, 0.f); }
__device__ __forceinline__ double clamp0(double x) { return fmax(x, 0.0); }

// A load of Q: from shared memory, or from L2 where Q lies in global
// memory (written by another CTA of the group: L1 is not coherent).
template <bool kGlobal, typename T>
__device__ __forceinline__ T ldq(const T* p) {
  if constexpr (kGlobal) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

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

// Elements of one CTA's part of vec_ws in the grid layout: the pairs (2m),
// the pivot column (m) and the projections (k), rounded up to an even
// count so that every CTA's pairs stay aligned.
__host__ __device__ inline size_t vec_stride(int m, int k) {
  return ((size_t)3 * m + k + 1) & ~(size_t)1;
}

// Columns of Q each CTA of a kGridSmem grid of `group` keeps.
__host__ __device__ inline int q_share(int k, int group) {
  return (k + group - 1) / group;
}

// Dynamic shared memory of one CTA. In a cluster: the (q_{i-1}, q_i) pairs
// (m), Q (m, k), the cluster's candidate columns (buffers x cluster x m),
// the projections (k) and one partial sum per thread. In the grid the
// candidates lie in global memory, and the CTA keeps the pairs, the pivot
// column (m) and the projections: with Q split (kGridSmem) its share of Q
// (q_share columns) and as many projections; with Q in global memory k
// projections (kGridTall, kGridWarps), or none of these vectors where m is
// too large for them (kGridGlobal: they lie in the CTA's part of a global
// workspace). With f64 norms, and in the grid, one partial norm per
// thread. In the shared-memory layout of the residual, the slice (m, w),
// its last R row (w) and its norms (w).
// The wrapper's layout rule computes the same number.
__host__ __device__ inline size_t smem_need(int m, int k, int w, int group,
                                            int threads, int resid_in_smem,
                                            int layout, size_t itemsize,
                                            size_t normsize) {
  size_t vectors = 0;
  if (layout == kCluster) {
    vectors = (size_t)m * k + (size_t)cand_buffers(group) * group * m +
              2 * (size_t)m + k;
  } else if (layout == kGridSmem) {
    const size_t share = (size_t)q_share(k, group);
    vectors = (size_t)3 * m + share + share * m;
  } else if (layout == kGridTall || layout == kGridWarps) {
    vectors = (size_t)3 * m + k;
  }
  size_t bytes = itemsize * (vectors + threads);
  if (normsize == 8 || layout != kCluster) bytes += normsize * threads;
  if (resid_in_smem) {
    bytes += itemsize * ((size_t)m * w + w) + normsize * w;
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
// enters the dot product with q_i. Then R row, norm update, and the
// threads' bests for the next argmax. Threads that share a column join
// their partial dot products in a fixed order. `s_prev` is row i - 1 of R
// over the slice, `s_next` takes row i (the same array in shared memory).
// kRecompute also sums |x|^2 of the downdated elements: the column's norm
// before this step, exact to rounding, from which |s|^2 is taken; the
// cancellation is then one step's, where kDowndate's is i steps'.
template <typename T, int kRule>
__device__ __forceinline__ ArgMax<Norm<T>> column_pass(
    T* resid, size_t ld, Norm<T>* norms, const T* s_prev, T* s_next, T* r_row,
    const Pair<T>* pq, T* part, Norm<T>* partn, const Slice& g, int i, int j,
    int n) {
  using N = Norm<T>;
  ArgMax<N> best{-INFINITY, n};
  for (int it = 0; it < g.iters; ++it) {
    const int c = g.cl + it * g.tw;
    const bool live = g.in_pass && c < g.wl;
    T s{};
    N ss = 0;
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
          if (kRule == kRecompute) ss += abs2(x[u]);
        }
      }
      for (; r < g.r1; ++r) {
        const Pair<T> q = pq[r];
        const T x = mul_sub(resid[r * ld + c], q.prev, sp);
        resid[r * ld + c] = x;
        s = conj_mul_add(s, q.cur, x);
        if (kRule == kRecompute) ss += abs2(x);
      }
    }
    if (g.nsplit > 1) {
      // Only the column's first thread needs the sum now; the others read
      // it from `s_prev` in the next step.
      if (g.in_pass) {
        part[threadIdx.x] = s;
        if (kRule == kRecompute) partn[threadIdx.x] = ss;
      }
      __syncthreads();
      if (live && g.split == 0) {
        s = T{};
        for (int p = 0; p < g.nsplit; ++p) s = add(s, part[p * g.tw + g.cl]);
        if (kRule == kRecompute) {
          ss = 0;
          for (int p = 0; p < g.nsplit; ++p) ss += partn[p * g.tw + g.cl];
        }
      }
    }
    if (live && g.split == 0) {
      r_row[c] = s;
      if (s_next != r_row) s_next[c] = s;
      const N nc = norms[c];
      const N from = kRule == kRecompute ? ss : nc;
      const N x = (g.c0 + c == j) ? N(-1)
                  : (nc < N(0) ? nc : clamp0(from - abs2(s)));
      norms[c] = x;
      if (x > best.v) best = ArgMax<N>{x, g.c0 + c};
    }
  }
  return best;
}

// One panel per group of CTAs; CTA `rank` of the group owns the columns
// [rank * w, (rank + 1) * w) of the panel. The residual slice, its last R
// row and its norms lie in the CTA's shared memory (resid_in_smem) or in
// its part of global memory (resid_ws, norms_ws, r_out).
//
// The group is a thread-block cluster (kLayout kCluster, where Q fits in
// every CTA's shared memory) or the whole cooperative grid of one launch
// (kGridSmem, kGridTall, kGridGlobal, kGridWarps, where it does not). In a cluster every CTA holds Q and the candidate columns come
// through distributed shared memory. In the grid the candidates come through
// global memory (cand_ws, best_ws) behind a grid barrier, and Q is split
// over the CTAs' shared memory (kGridSmem: q_ws then holds the CTAs' parts
// of -Q Q^H v and v', (group + 1) m elements) or lies once in global
// memory (kGridTall, kGridGlobal, kGridWarps: q_ws, written by rank 0,
// read from L2 by all). The grid's CTAs keep their vectors (pairs, pivot
// column, projections) in shared memory (kGridSmem, kGridTall,
// kGridWarps), or, where m is too large for that (kGridGlobal), each in its
// own part of vec_ws: written and read back by the CTA's own threads
// across a __syncthreads, which makes the writes visible to them. The
// layout is a template parameter, so that the shared-memory layouts keep
// their shared-memory loads.
template <typename T, int kRule, int kLayout>
__global__ void __launch_bounds__(kMaxThreads)
qrcp_panel_kernel(const T* __restrict__ a, const float* __restrict__ used,
                  T* __restrict__ q_out, T* r_out, int* __restrict__ piv_out,
                  T* resid_ws, Norm<T>* norms_ws, T* q_ws, T* cand_ws,
                  ArgMax<Norm<T>>* best_ws, T* vec_ws, int m, int n, int k,
                  int w, int resid_in_smem, int group) {
  using N = Norm<T>;
  constexpr bool kGrid = kLayout != kCluster;
  constexpr bool kSplitQ = kLayout == kGridSmem;
  constexpr bool kVecGlobal = kLayout == kGridGlobal;
  constexpr bool kRowsSplit = kLayout == kGridTall || kVecGlobal;
  // Clock slots of the norm and q_i, and of the column pass: kGridSmem
  // times its barriers and the stages of its reorthogonalization in 1-5.
  constexpr int kNormSlot = kSplitQ ? 6 : 4;
  constexpr int kPassSlot = kSplitQ ? 7 : 5;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ ArgMax<N> warp_best[kMaxWarps];
  __shared__ ArgMax<N> cand_best[2 * kMaxCluster];
  __shared__ int pivot_s;   // the grid's pivot, joined by warp 0

  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = kGrid ? group : (int)cluster.num_blocks();
  const int rank = kGrid ? (int)(blockIdx.x % group)
                         : (int)cluster.block_rank();
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

  unsigned char* vec_base =
      kVecGlobal ? reinterpret_cast<unsigned char*>(
                       vec_ws + (size_t)blockIdx.x * vec_stride(m, k))
                 : smem_raw;
  Pair<T>* pq = reinterpret_cast<Pair<T>*>(vec_base);  // (m)
  // Columns of Q this CTA keeps: its share in kGridSmem (share column u is
  // column rank + u * nranks of Q), all k in a cluster.
  const int share = kSplitQ ? q_share(k, nranks) : k;
  // Q, column t at qs + t * m: in shared memory after the pairs, or in
  // global memory (kGridTall, kGridGlobal, kGridWarps).
  T* qs = (kGrid && !kSplitQ) ? q_ws + panel * (size_t)k * m
                              : reinterpret_cast<T*>(pq + m);
  // (buffers, nranks, m) in a cluster; the pivot column (m) in the grid
  T* cand = !kGrid ? qs + (size_t)m * k
                   : (kSplitQ ? qs + (size_t)share * m
                              : reinterpret_cast<T*>(pq + m));
  // the projections (share)
  T* qv = cand + (kGrid ? (size_t)m
                        : (size_t)cand_buffers(nranks) * nranks * m);
  // (nthreads) partial sums, first in shared memory when the vectors are not
  T* part = kVecGlobal ? reinterpret_cast<T*>(smem_raw) : qv + share;
  // kGridSmem: the CTAs' parts of -Q Q^H v (nranks, m), then v' (m)
  T* parts = q_ws + panel * (size_t)(nranks + 1) * m;
  T* vnew = parts + (size_t)nranks * m;
  // (nthreads) partial norms, with f64 norms and in the grid
  N* partn = reinterpret_cast<N*>(part + nthreads);
  T* resid_s = (sizeof(N) == 8 || kGrid)
                   ? reinterpret_cast<T*>(partn + nthreads)
                   : part + nthreads;  // slice (m, w)
  T* srow_s = resid_s + (size_t)m * w;     // (w) last R row of the slice
  N* norms_s = reinterpret_cast<N*>(srow_s + w);  // (w)
  T* resid_g = resid_ws + panel * (size_t)m * n + g.c0;
  N* norms_g = norms_ws + panel * n + g.c0;
  // Generic views for the one-time prologue and the candidate column.
  T* resid = resid_in_smem ? resid_s : resid_g;
  N* norms = resid_in_smem ? norms_s : norms_g;
  const size_t ld = resid_in_smem ? w : n;

  // Copy the slice into the residual and take the column norms; each
  // thread keeps the best of the columns whose norm it writes.
  ArgMax<N> best{-INFINITY, n};
  for (int it = 0; it < g.iters; ++it) {
    const int c = g.cl + it * g.tw;
    const bool live = g.in_pass && c < g.wl;
    N s = 0;
    if (live) {
      for (int r = g.r0; r < g.r1; ++r) {
        const T x = a[(size_t)r * n + g.c0 + c];
        resid[r * ld + c] = x;
        s += abs2(x);
      }
    }
    if (g.nsplit > 1) {
      N* partf = reinterpret_cast<N*>(part);
      if (g.in_pass) partf[tid] = s;
      __syncthreads();
      if (live && g.split == 0) {
        s = 0;
        for (int p = 0; p < g.nsplit; ++p) s += partf[p * g.tw + g.cl];
      }
    }
    if (live && g.split == 0) {
      const N x = (used != nullptr && used[g.c0 + c] > 0.f) ? N(-1) : s;
      norms[c] = x;
      if (x > best.v) best = ArgMax<N>{x, g.c0 + c};
    }
  }

  RC_CLOCK_START();
  for (int i = 0; i < k; ++i) {
    // 1. Argmax of the norm table, one group barrier. The threads' bests
    // (taken while the norms were written) are joined per warp and per
    // CTA. Each CTA then writes its best and that column of its slice,
    // with the pending downdate applied, where every CTA of the group can
    // read it: into every CTA's candidate buffer (distributed shared
    // memory) in a cluster, into its slot of the global candidates in the
    // grid. After the barrier every warp of every CTA joins the
    // candidates itself (in the grid one warp a CTA, for the CTA), so all
    // agree on j with ties to the lowest index, and all hold the pivot
    // column: no second exchange, and the owner may go on downdating. The
    // buffers alternate by step, because a CTA may write the next
    // candidates while a slower peer still reads these.
    best = warp_argmax(best);
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    best = warp_argmax(lane < nwarps ? warp_best[lane]
                                     : ArgMax<N>{-INFINITY, n});
    RC_CLOCK_MARK(0);   // the CTA's argmax
    const int cb = best.i - g.c0;        // meaningful when the CTA has columns
    const bool has = g.wl > 0;
    const T sp = (has && i > 0)
                     ? (resid_in_smem ? srow_s[cb]
                                      : r_out[(size_t)(i - 1) * n + best.i])
                     : T{};
    T* v;   // 2. the pivot column
    int j;
    if constexpr (kGrid) {
      const size_t slot = (panel * 2 + (i & 1)) * (size_t)nranks;
      T* cand_i = cand_ws + slot * m;
      ArgMax<N>* best_i = best_ws + slot;
      for (int r = tid; r < m; r += nthreads) {
        T val{};
        if (has) {
          val = resid[r * ld + cb];
          if (i > 0) val = mul_sub(val, pq[r].cur, sp);
        }
        cand_i[(size_t)rank * m + r] = val;
      }
      if (tid == 0) best_i[rank] = best;
      if constexpr (kSplitQ) { RC_CLOCK_MARK(0); }   // with the candidates out
      cg::this_grid().sync();
      if constexpr (kSplitQ) { RC_CLOCK_MARK(1); }   // the candidates' barrier
      // One warp a CTA joins the bests: every warp of every CTA reading
      // the same few lines of L2 cost 17.8 k cycles a step at 85 CTAs.
      if (warp == 0) {
        ArgMax<N> join{-INFINITY, n};
#pragma unroll 4
        for (int x = lane; x < nranks; x += 32) {
          join = better(join, ArgMax<N>{__ldcg(&best_i[x].v),
                                        __ldcg(&best_i[x].i)});
        }
        join = warp_argmax(join);
        if (lane == 0) pivot_s = join.i;
      }
      __syncthreads();
      j = pivot_s;
      v = cand;
      for (int r = tid; r < m; r += nthreads) {
        v[r] = __ldcg(cand_i + (size_t)(j / w) * m + r);
      }
      __syncthreads();
    } else {
      const int buf = nranks > 1 ? (i & 1) : 0;
      T* cand_i = cand + (size_t)buf * nranks * m;
      ArgMax<N>* cand_best_i = cand_best + buf * kMaxCluster;
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
      if (nranks > 1) cluster.sync(); else __syncthreads();
      best = warp_argmax(lane < nranks ? cand_best_i[lane]
                                       : ArgMax<N>{-INFINITY, n});
      j = best.i;
      v = cand_i + (size_t)(j / w) * m;   // in place
    }
    RC_CLOCK_MARK(kSplitQ ? 2 : 1);   // candidates out, barrier, joined

    // 3. Reorthogonalize v against the i columns of Q: v -= Q (Q^H v).
    // kGridSmem splits it over the grid, Q staying where it lies:
    // (a) each CTA projects v on its own columns of Q, a warp a column;
    // (b) it writes its part of -Q Q^H v to global memory (a CTA that owns
    //     no column below i writes nothing, and nobody reads its part);
    // (c) behind a barrier, CTA rank sums rows [rank rows, (rank + 1) rows)
    //     of the parts, a warp a row, its lanes over the parts in rank
    //     order, and writes those rows of v' = v + the sum;
    // (d) behind a second barrier every CTA reads all of v'.
    // Each element of v' is summed once, by one CTA, so every CTA holds it
    // bit for bit, and q_i with it (the norm below is taken by every warp
    // in the same order).
    if constexpr (kSplitQ) {
      if (i > 0) {
        const int own = i > rank ? (i - 1 - rank) / nranks + 1 : 0;
        for (int u = warp; u < own; u += nwarps) {
          const T* qu = qs + (size_t)u * m;
          T s0{}, s1{};
          int r = lane;
          for (; r + 32 < m; r += 64) {
            s0 = conj_mul_add(s0, qu[r], v[r]);
            s1 = conj_mul_add(s1, qu[r + 32], v[r + 32]);
          }
          if (r < m) s0 = conj_mul_add(s0, qu[r], v[r]);
          s0 = warp_sum(add(s0, s1));
          if (lane == 0) qv[u] = s0;
        }
        __syncthreads();
        if (own > 0) {
          for (int r = tid; r < m; r += nthreads) {
            T x{};
            for (int u = 0; u < own; ++u) {
              x = mul_sub(x, qs[(size_t)u * m + r], qv[u]);
            }
            parts[(size_t)rank * m + r] = x;
          }
        }
        RC_CLOCK_MARK(2);   // the own projections and part
        cg::this_grid().sync();
        RC_CLOCK_MARK(3);   // the parts' barrier
        const int owners = min(i, nranks);
        const int rows = (m + nranks - 1) / nranks;
        const int ra = min(m, rank * rows);
        const int rb = min(m, ra + rows);
        for (int r = ra + warp; r < rb; r += nwarps) {
          T x{};
#pragma unroll 4
          for (int p = lane; p < owners; p += 32) {
            x = add(x, __ldcg(parts + (size_t)p * m + r));
          }
          x = warp_sum(x);
          if (lane == 0) vnew[r] = add(v[r], x);
        }
        RC_CLOCK_MARK(4);   // the CTA's rows of v'
        cg::this_grid().sync();
        RC_CLOCK_MARK(5);   // v''s barrier
        for (int r = tid; r < m; r += nthreads) v[r] = __ldcg(vnew + r);
        __syncthreads();
      }
    } else if (i > 0) {
      // Replicated in every CTA. Q is column-major, so a warp reads
      // neighbouring words in both loops. A warp takes four columns of Q
      // at a time and a thread four partial sums, to have independent
      // chains; in kGridTall and kGridGlobal the whole block takes four
      // columns at a time, each thread a stride of rows, and joins the
      // sums through `part` (two buffers by group parity, one barrier a
      // group). Either way the order of every sum is fixed, so every CTA
      // of the grid computes the same q_i bit for bit.
      if constexpr (kRowsSplit) {
        for (int t0 = 0, g = 0; t0 < i; t0 += 4, ++g) {
          const T* q0 = qs + (size_t)t0 * m;
          const T* q1 = qs + (size_t)min(t0 + 1, i - 1) * m;
          const T* q2 = qs + (size_t)min(t0 + 2, i - 1) * m;
          const T* q3 = qs + (size_t)min(t0 + 3, i - 1) * m;
          T s0{}, s1{}, s2{}, s3{};
          for (int r = tid; r < m; r += nthreads) {
            const T vr = v[r];
            s0 = conj_mul_add(s0, ldq<kGrid>(q0 + r), vr);
            s1 = conj_mul_add(s1, ldq<kGrid>(q1 + r), vr);
            s2 = conj_mul_add(s2, ldq<kGrid>(q2 + r), vr);
            s3 = conj_mul_add(s3, ldq<kGrid>(q3 + r), vr);
          }
          T* buf = part + (g & 1) * 4 * nwarps;
          s0 = warp_sum(s0);
          s1 = warp_sum(s1);
          s2 = warp_sum(s2);
          s3 = warp_sum(s3);
          if (lane == 0) {
            buf[4 * warp] = s0;
            buf[4 * warp + 1] = s1;
            buf[4 * warp + 2] = s2;
            buf[4 * warp + 3] = s3;
          }
          __syncthreads();
          if (warp == 0) {
            for (int u = 0; u < 4 && t0 + u < i; ++u) {
              const T x = warp_sum(lane < nwarps ? buf[4 * lane + u] : T{});
              if (lane == 0) qv[t0 + u] = x;
            }
          }
        }
      } else {
        for (int tb = warp; tb < i; tb += 4 * nwarps) {
          const T* q0 = qs + (size_t)tb * m;
          const T* q1 = qs + (size_t)min(tb + nwarps, i - 1) * m;
          const T* q2 = qs + (size_t)min(tb + 2 * nwarps, i - 1) * m;
          const T* q3 = qs + (size_t)min(tb + 3 * nwarps, i - 1) * m;
          T s0{}, s1{}, s2{}, s3{};
          for (int r = lane; r < m; r += 32) {
            const T vr = v[r];
            s0 = conj_mul_add(s0, ldq<kGrid>(q0 + r), vr);
            s1 = conj_mul_add(s1, ldq<kGrid>(q1 + r), vr);
            s2 = conj_mul_add(s2, ldq<kGrid>(q2 + r), vr);
            s3 = conj_mul_add(s3, ldq<kGrid>(q3 + r), vr);
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
      }
      __syncthreads();
      RC_CLOCK_MARK(2);   // Q^H v
      for (int r = tid; r < m; r += nthreads) {
        T x0 = v[r], x1{}, x2{}, x3{};
        int t = 0;
#pragma unroll 2
        for (; t + 4 <= i; t += 4) {
          const T* qt = qs + (size_t)t * m + r;
          x0 = mul_sub(x0, ldq<kGrid>(qt), qv[t]);
          x1 = mul_sub(x1, ldq<kGrid>(qt + m), qv[t + 1]);
          x2 = mul_sub(x2, ldq<kGrid>(qt + 2 * m), qv[t + 2]);
          x3 = mul_sub(x3, ldq<kGrid>(qt + 3 * m), qv[t + 3]);
        }
        for (; t < i; ++t) {
          x0 = mul_sub(x0, ldq<kGrid>(qs + (size_t)t * m + r), qv[t]);
        }
        v[r] = add(add(x0, x1), add(x2, x3));
      }
      __syncthreads();
      RC_CLOCK_MARK(3);   // v -= Q (Q^H v)
    }

    // 4. Normalise (every warp takes the norm itself, in the same order;
    // with kRowsSplit the block joins the threads' sums through `partn`,
    // and every thread adds the warps' in the same order); a zero column
    // gives a zero q_i. q_i becomes column i of Q and the newer half of
    // the pairs. In the grid one CTA writes column i of Q, and of q_out as
    // it goes: its owner in kGridSmem, into its share; rank 0 elsewhere,
    // into q_ws, which the next step's barrier publishes.
    N nv = 0;
    if constexpr (kRowsSplit) {
      for (int r = tid; r < m; r += nthreads) nv += abs2(v[r]);
      nv = warp_sum(nv);
      if (lane == 0) partn[warp] = nv;
      __syncthreads();
      nv = 0;
      for (int x = 0; x < nwarps; ++x) nv += partn[x];
      nv = root(nv);
    } else {
      for (int r = lane; r < m; r += 32) nv += abs2(v[r]);
      nv = root(warp_sum(nv));
    }
    const N inv = nv > N(0) ? N(1) / nv : N(0);
    const bool owner = kSplitQ ? rank == i % nranks : rank == 0;
    for (int r = tid; r < m; r += nthreads) {
      const T x = scale(v[r], inv);
      if constexpr (kSplitQ) {
        if (owner) qs[(size_t)(i / nranks) * m + r] = x;
      } else if (!kGrid || owner) {
        qs[(size_t)i * m + r] = x;
      }
      if (kGrid && owner) q_out[(size_t)r * k + i] = x;
      pq[r] = Pair<T>{i > 0 ? pq[r].cur : T{}, x};
    }
    if (rank == 0 && tid == 0) piv_out[i] = j;
    __syncthreads();
    RC_CLOCK_MARK(kNormSlot);   // (v' in,) norm and q_i

    // 5-7. The column pass, compiled once for each address space.
    T* r_row = r_out + (size_t)i * n + g.c0;
    if (resid_in_smem) {
      best = column_pass<T, kRule>(resid_s, w, norms_s, srow_s, srow_s, r_row,
                                   pq, part, partn, g, i, j, n);
    } else {
      best = column_pass<T, kRule>(resid_g, n, norms_g,
                                   r_out + (size_t)max(i - 1, 0) * n + g.c0,
                                   r_row, r_row, pq, part, partn, g, i, j, n);
    }
    RC_CLOCK_MARK(kPassSlot);   // column pass
  }

  if constexpr (!kGrid) {
    // q_out is (m, k) row-major.
    if (rank == 0) {
      for (int x = tid; x < m * k; x += nthreads) {
        q_out[x] = qs[(size_t)(x % k) * m + x / k];
      }
    }
    // No CTA may exit while a peer can still write into its shared memory.
    if (nranks > 1) cluster.sync();
  }
}

// Whether the card can place one group of a layout, asked once per
// (kernel, group, threads, shared memory) and remembered.
template <typename Kernel>
int schedulable(Kernel kernel, int group, int threads, int smem_bytes,
                const cudaLaunchConfig_t& cfg, bool grid) {
  struct Seen { const void* fn; int group, threads, smem; };
  static Seen seen[64];
  static int nseen = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int x = 0; x < nseen; ++x) {
    if (seen[x].fn == fn && seen[x].group == group &&
        seen[x].threads == threads && seen[x].smem == smem_bytes) {
      return 0;
    }
  }
  cudaError_t err;
  if (grid) {
    // The whole grid must be resident at once for its barrier.
    int device = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if ((long long)per_sm * sms < (long long)cfg.gridDim.x) {
      return kErrNotSchedulable;
    }
  } else {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return kErrNotSchedulable;
  }
  if (nseen < 64) seen[nseen++] = Seen{fn, group, threads, smem_bytes};
  return 0;
}

// Launches `batch` groups of `group` CTAs with `threads` threads and
// `smem_bytes` of dynamic shared memory each: clusters (kCluster) or one
// cooperative grid of one panel (the global workspaces q_ws, cand_ws and
// best_ws are then needed, and vec_ws, (group, vec_stride) elements, in
// kGridGlobal alone; it is null elsewhere).
// Returns 0, a CUDA error, or one of the kErr codes; does not synchronise.
template <typename T, int kRule, int kLayout>
int launch(const T* a, const float* used, T* q, T* r, int* piv, T* resid_ws,
           Norm<T>* norms_ws, T* q_ws, T* cand_ws, ArgMax<Norm<T>>* best_ws,
           T* vec_ws, int batch, int m, int n, int k, int group, int threads,
           int resid_in_smem, int smem_bytes, void* stream) {
  constexpr bool kGrid = kLayout != kCluster;
  const bool group_ok =
      kGrid ? group >= 1
            : (group == 1 || group == 2 || group == 4 || group == 8 ||
               group == kMaxCluster);
  if (!group_ok || threads < 32 || threads > kMaxThreads || threads % 32 ||
      batch < 1 || m < 1 || n < 1 || k < 1) {
    return kErrBadLayout;
  }
  const int w = (n + group - 1) / group;
  if (smem_need(m, k, w, group, threads, resid_in_smem, kLayout, sizeof(T),
                sizeof(Norm<T>)) > (size_t)smem_bytes ||
      ((kLayout == kGridGlobal) != (vec_ws != nullptr)) ||
      (vec_ws != nullptr && batch != 1) ||
      (!resid_in_smem && (resid_ws == nullptr || norms_ws == nullptr)) ||
      (kGrid && (q_ws == nullptr || cand_ws == nullptr ||
                 best_ws == nullptr || batch != 1))) {
    return kErrBadLayout;
  }
  auto kernel = qrcp_panel_kernel<T, kRule, kLayout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (!kGrid && group > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }

  cudaLaunchAttribute attr[1];
  if (kGrid) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  } else {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = group;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * group);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  const int placed = schedulable(kernel, group, threads, smem_bytes, cfg,
                                 kGrid);
  if (placed != 0) return placed;
  err = cudaLaunchKernelEx(&cfg, kernel, a, used, q, r, piv, resid_ws,
                           norms_ws, q_ws, cand_ws, best_ws, vec_ws, m, n,
                           k, w, resid_in_smem, group);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One norm rule in the layout `layout` (kCluster, kGridSmem, kGridTall,
// kGridGlobal or kGridWarps); `best_ws` holds ArgMax<Norm<T>>. K1 and K2
// take kDowndate.
template <typename T, int kRule>
int launch_rule(const T* a, const float* used, T* q, T* r, int* piv,
                T* resid_ws, Norm<T>* norms_ws, T* q_ws, T* cand_ws,
                void* best_ws, T* vec_ws, int batch, int m, int n, int k,
                int group, int threads, int resid_in_smem, int layout,
                int smem_bytes, void* stream) {
  auto* best = static_cast<ArgMax<Norm<T>>*>(best_ws);
  switch (layout) {
    case kCluster:
      return launch<T, kRule, kCluster>(a, used, q, r, piv, resid_ws,
                                        norms_ws, q_ws, cand_ws, best,
                                        vec_ws, batch, m, n, k, group,
                                        threads, resid_in_smem, smem_bytes,
                                        stream);
    case kGridSmem:
      return launch<T, kRule, kGridSmem>(a, used, q, r, piv, resid_ws,
                                         norms_ws, q_ws, cand_ws, best,
                                         vec_ws, batch, m, n, k, group,
                                         threads, resid_in_smem, smem_bytes,
                                         stream);
    case kGridTall:
      return launch<T, kRule, kGridTall>(a, used, q, r, piv, resid_ws,
                                         norms_ws, q_ws, cand_ws, best,
                                         vec_ws, batch, m, n, k, group,
                                         threads, resid_in_smem, smem_bytes,
                                         stream);
    case kGridGlobal:
      return launch<T, kRule, kGridGlobal>(a, used, q, r, piv, resid_ws,
                                           norms_ws, q_ws, cand_ws, best,
                                           vec_ws, batch, m, n, k, group,
                                           threads, resid_in_smem,
                                           smem_bytes, stream);
    case kGridWarps:
      return launch<T, kRule, kGridWarps>(a, used, q, r, piv, resid_ws,
                                          norms_ws, q_ws, cand_ws, best,
                                          vec_ws, batch, m, n, k, group,
                                          threads, resid_in_smem, smem_bytes,
                                          stream);
  }
  return kErrBadLayout;
}

// K3 and K4: the norm rule and the layout, as the wrapper asks.
template <typename T>
int launch_wide(const T* a, const float* used, T* q, T* r, int* piv,
                T* resid_ws, Norm<T>* norms_ws, T* q_ws, T* cand_ws,
                void* best_ws, T* vec_ws, int batch, int m, int n, int k,
                int group, int threads, int resid_in_smem, int layout,
                int norm_rule, int smem_bytes, void* stream) {
  if (norm_rule == kDowndate) {
    return launch_rule<T, kDowndate>(a, used, q, r, piv, resid_ws, norms_ws,
                                     q_ws, cand_ws, best_ws, vec_ws, batch, m,
                                     n, k, group, threads, resid_in_smem,
                                     layout, smem_bytes, stream);
  }
  if (norm_rule == kRecompute) {
    return launch_rule<T, kRecompute>(a, used, q, r, piv, resid_ws, norms_ws,
                                      q_ws, cand_ws, best_ws, vec_ws, batch,
                                      m, n, k, group, threads, resid_in_smem,
                                      layout, smem_bytes, stream);
  }
  return kErrBadLayout;
}

}  // namespace rc_qrcp
