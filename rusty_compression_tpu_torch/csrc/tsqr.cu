// K5: the thin Q (and R) of a stack of tall real panels, (batch, m, n) with
// m >= n and n <= 128, f32 or f64, by tall-skinny QR (TSQR), for sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves this QR to XLA. It takes
// the place of torch.linalg.qr on the card, that is cuSOLVER's geqrf +
// orgqr, which runs one Householder column at a time over the whole panel
// (geqr2: a reduction over all m rows, then an update, a launch-wide wait
// each column) and one matrix of a stack after another.
//
// The algorithm is Householder QR with its reductions put in a tree; it does
// the same work in the same precision (f32 FMAs, no TF32; f64 in f64) and is
// as stable. For each matrix:
// 1. Leaves. CTA l owns rows [l h, l h + h) (the last leaf the rest, so
//    every leaf has at least n rows). It keeps an n x n R in shared memory,
//    S, and streams its rows through in chunks of C rows. A chunk is
//    reduced against S by Householder reflectors of length 1 + C: step j
//    takes its head from S row j and its tail from the chunk (structured:
//    S is upper triangular, so the other rows of S are untouched). While S
//    has fewer than n rows (the first chunks) the rows of the chunk that
//    are reduced become rows of S, so that S is always made of real rows:
//    a reflector with a head in a row of zeros would leave Q with weight
//    there on a rank-deficient panel.
// 2. Tree. The leaves' R go up a tree of fan-in F (atomic counters: the
//    last CTA of a node's children to finish merges them, with no wait and
//    no second launch): S = R of the first child, the others streamed
//    through in chunks of C rows by the same routine (their steps below the
//    chunk's first row are identities and are skipped).
// 3. Q. A second kernel, one CTA a leaf, replays the reflectors onto
//    [D; 0], D = sign(diag R_root) (so R = D R_root has a non-negative
//    diagonal): from the root down to its leaf, each CTA replaying the
//    nodes of its own path (a node's replay is repeated under each of its
//    leaves, which costs no time on the path), then its own chunks in
//    reverse, writing each of its rows of Q once. The reflectors of the
//    leaves are kept in Q's own buffer, which the replay overwrites.
// 4. Batching: one launch of each kernel covers the stack, batch x leaves
//    CTAs.
// A reflector whose tail is exactly zero is the identity (tau = 0), as in
// LAPACK's dlarfg, so rank-deficient panels and zero columns give an
// orthonormal Q. (dlarfg's rescaling of norms beyond the type's range is
// left out.)
//
// Thread layout: column k of the panel belongs to G neighbouring lanes of a
// warp, each holding R rows of a chunk in registers (C = G R rows a chunk):
// one thread a column with 32 rows up to 32 columns, two with 32 rows each
// up to 128 (the throughput layouts), or, up to 32 columns where the stack
// leaves the card short of CTAs, four with 8 rows each (the latency
// layout: four warps in place of one). A factor step: the G threads of
// column j reduce its tail (register sums and log2 G shuffles), form the
// reflector, publish it to shared memory (two buffers, so one block barrier
// a step); every later column takes its dot with the reflector the same
// way and updates its registers and its entry of S. The Q kernel stages a
// chunk's reflectors in shared memory first; its columns do not interact,
// so its steps need no barrier at all. Each thread's rows of a reflector
// lie together, padded by 16 bytes, so that the G segments a warp reads at
// once fall in different banks, four f32 or two f64 values a load.
//
// What bounds it on the H100: by the roofline, the bytes of y read once and
// Q written once at 3.35 TB/s (52.6 us for the (64, 16384, 21) f32 stack),
// or the 4 m n^2 operations at 67 TFLOP/s ((8192, 128) f64: 8 us). In fact
// the latency of the chain of steps: a column's reflector needs the
// previous column's, so a matrix's critical path is n steps a chunk, on
// each level of the tree, up and down again, and a factor step costs
// about 1,300-1,800 cycles and a replay step 500-850 on the card. The
// design against it: a chunk's rows live in registers, a step touches
// memory only in shared memory, the replay has no barrier, the leaf height
// is chosen (ops/kernels/tsqr.py) from a count of the steps so that the
// card holds all leaves at once and the tree is no deeper than it must be,
// and nodes merge in the CTA that finishes last, without a launch per
// level. A stack fills the card with leaves and hides the chain; a single
// wide panel does not, and there torch.linalg.qr stays faster (the
// wrapper's route, kernel_takes).

#include <cuda_runtime.h>

namespace rc_tsqr {

template <typename T>
struct Args {
  const T* y;       // (batch, m, n) input
  T* q;             // (batch, m, n): the leaves' reflectors, then Q
  T* r_out;         // (batch, n, n) R with a non-negative diagonal, or null
  T* rws;           // (batch, slots, n, n): each node's R, then the
                    //   reflectors of the children merged into their parent
  T* taus;          // (batch, slots, tau_rows, n): tau by chunk and step,
                    //   a leaf's chunks first, then the chunks of the
                    //   node's R merged into its parent (the last rows)
  T* wws;           // (batch, leaves, n, n): a CTA's W of its next node
  int* counters;    // (batch, slots): zero before the call
  int m, n, leaves, height, fanin, tau_rows, slots;
};

// Lanes of the G threads of this thread's column.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  const unsigned lane = threadIdx.x & 31u;
  return G == 1 ? (1u << lane) : (((1u << G) - 1u) << (lane & ~(G - 1u)));
}

// The sum of four partial sums (the dot products and norms of a step keep
// four, so that a thread's products are not one chain of dependent FMAs).
template <typename T>
__device__ __forceinline__ T sum4(const T (&p)[4]) {
  return (p[0] + p[1]) + (p[2] + p[3]);
}

template <int G, typename T>
__device__ __forceinline__ T group_sum(T v, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

// LAPACK's dlarfg without its rescaling: beta, tau and the scale of the
// tail for the vector (alpha; tail) with |tail|^2 = sigma, from one
// reciprocal square root and one reciprocal (the f64 square root and
// divisions of the plain formulas are each a chain of dependent steps on
// the critical path): with s = 1 / |(alpha; tail)|, beta = -sign(alpha) /
// s, tau = (beta - alpha) / beta = 1 + |alpha| s, and 1 / (alpha - beta) =
// sign(alpha) / (|alpha| + 1 / s).
template <typename T>
__device__ __forceinline__ void reflector(T alpha, T sigma, T& beta, T& tau,
                                          T& scale) {
  if (sigma == T(0)) {
    beta = alpha;
    tau = T(0);
    scale = T(0);
    return;
  }
  const T sq = alpha * alpha + sigma;
  const T inv = rsqrt(sq);
  const T norm = sq * inv;
  const T mag = fabs(alpha);
  beta = alpha < T(0) ? norm : -norm;
  tau = T(1) + mag * inv;
  const T r = rcp(mag + norm);
  scale = alpha < T(0) ? -r : r;
}

// A reflector in shared memory: the R rows of thread g of a column group
// lie together, row t G + g at g P + t, with P = R + 16 bytes of padding,
// so that the G segments a warp reads at once fall in different banks.
template <typename T, int R>
__host__ __device__ constexpr int padded() {
  return R + 16 / (int)sizeof(T);
}

// acc[t & 3] += v[t] * x[t] over this thread's R rows of a reflector.
__device__ __forceinline__ void dot4(const float* v, const float* x,
                                     float (&acc)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(v);
  acc[0] += u.x * x[0];
  acc[1] += u.y * x[1];
  acc[2] += u.z * x[2];
  acc[3] += u.w * x[3];
}
__device__ __forceinline__ void dot4(const double* v, const double* x,
                                     double (&acc)[4]) {
  const double2 u = *reinterpret_cast<const double2*>(v);
  const double2 u2 = *reinterpret_cast<const double2*>(v + 2);
  acc[0] += u.x * x[0];
  acc[1] += u.y * x[1];
  acc[2] += u2.x * x[2];
  acc[3] += u2.y * x[3];
}
template <typename T, int R>
__device__ __forceinline__ void dot_rows(const T* v, const T (&x)[R],
                                         T (&acc)[4]) {
#pragma unroll
  for (int t = 0; t < R; t += 4) dot4(v + t, x + t, acc);
}

// x[t] -= w v[t] over this thread's R rows.
__device__ __forceinline__ void axpy4(const float* v, float w, float* x) {
  const float4 u = *reinterpret_cast<const float4*>(v);
  x[0] -= w * u.x;
  x[1] -= w * u.y;
  x[2] -= w * u.z;
  x[3] -= w * u.w;
}
__device__ __forceinline__ void axpy4(const double* v, double w, double* x) {
  const double2 u = *reinterpret_cast<const double2*>(v);
  const double2 u2 = *reinterpret_cast<const double2*>(v + 2);
  x[0] -= w * u.x;
  x[1] -= w * u.y;
  x[2] -= w * u2.x;
  x[3] -= w * u2.y;
}
template <typename T, int R>
__device__ __forceinline__ void update_rows(const T* v, T w, T (&x)[R]) {
#pragma unroll
  for (int t = 0; t < R; t += 4) axpy4(v + t, w, x + t);
}

// x[t] *= scale over this thread's R rows, stored to v.
__device__ __forceinline__ void scale4(float* v, float scale, float* x) {
  x[0] *= scale;
  x[1] *= scale;
  x[2] *= scale;
  x[3] *= scale;
  *reinterpret_cast<float4*>(v) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void scale4(double* v, double scale, double* x) {
  x[0] *= scale;
  x[1] *= scale;
  x[2] *= scale;
  x[3] *= scale;
  *reinterpret_cast<double2*>(v) = make_double2(x[0], x[1]);
  *reinterpret_cast<double2*>(v + 2) = make_double2(x[2], x[3]);
}

// Reduces the chunk x (this thread's rows t G + g of column k) against S,
// steps [jlo, jhi). S has r rows: step j < r takes its head from S row j
// and its tail from every row of the chunk; step j >= r its head from chunk
// row h = j - r and its tail from the rows below it. On return x holds the
// reflectors' tails (and, in the rows that became rows of S, R), S the
// updated R, tau_s[j] each step's tau. A step: the G threads of column j
// form the reflector and publish it to `vbuf` (two buffers, so one block
// barrier a step); every later column applies it to its registers and its
// entry of S row j.
template <typename T, int G, int R>
__device__ void factor_chunk(T (&x)[R], T* S, T* vbuf, T* tau_s, int n,
                             int r, int jlo, int jhi, int k, int g,
                             unsigned mask) {
  constexpr int P = padded<T, R>();
  for (int j = jlo; j < jhi; ++j) {
    T* mine_v = vbuf + ((j & 1) * G + g) * P;
    const bool in_s = j < r;
    if (k == j) {
      T p[4] = {T(0), T(0), T(0), T(0)}, alpha = T(0), beta, tau, scale;
      if (in_s) {  // the head in S, the whole chunk the tail
#pragma unroll
        for (int t = 0; t < R; ++t) p[t & 3] += x[t] * x[t];
        if (g == 0) alpha = S[j * n + j];
      } else {     // the head in chunk row h, the rows below it the tail
        const int h = j - r;
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const int i = t * G + g;
          if (i > h) p[t & 3] += x[t] * x[t];
          else if (i == h) alpha = x[t];
        }
      }
      const T sigma = group_sum<G>(sum4(p), mask);
      alpha = group_sum<G>(alpha, mask);
      reflector(alpha, sigma, beta, tau, scale);
      if (in_s) {
#pragma unroll
        for (int t = 0; t < R; t += 4) scale4(mine_v + t, scale, x + t);
      } else {
        const int h = j - r;
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const int i = t * G + g;
          if (i > h) {
            x[t] *= scale;
            mine_v[t] = x[t];
          } else {
            if (i == h) x[t] = beta;
            mine_v[t] = i == h ? T(1) : T(0);
          }
        }
      }
      if (g == 0) {
        tau_s[j] = tau;
        if (in_s) S[j * n + j] = beta;
      }
    }
    __syncthreads();
    const T tau = tau_s[j];
    if (tau != T(0)) {
      const bool mine = k > j && k < n;
      T p[4] = {(in_s && mine && g == 0) ? S[j * n + k] : T(0), T(0), T(0),
                T(0)};
      dot_rows<T, R>(mine_v, x, p);
      const T w = tau * group_sum<G>(sum4(p), mask);
      if (mine) {
        update_rows<T, R>(mine_v, w, x);
        if (in_s && g == 0) S[j * n + k] -= w;
      }
    }
  }
}

// Writes the reflectors of a chunk, rows [row0, row1) of `src` (row length
// n; rows outside read as zero), transposed into `vt`: column j's
// reflector at vt + (j G + g) P, its tail as stored, with 1 at its head
// row and zeros above where its head is a chunk row (j >= r).
template <typename T, int G, int R>
__device__ void stage_reflectors(const T* src, int row0, int row1, T* vt,
                                 int n, int r, int k, int g) {
  constexpr int P = padded<T, R>();
  if (k >= n) return;
  const int h = k - r;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int i = t * G + g, row = row0 + i;
    T v = row < row1 ? src[(size_t)row * n + k] : T(0);
    if (k >= r && i <= h) v = i == h ? T(1) : T(0);
    vt[(k * G + g) * P + t] = v;
  }
}

// The reflectors of factor_chunk (staged in vt by stage_reflectors, taus
// tau_s), steps jhi - 1 down to jlo, applied to (W; x): W the n x n rows
// of S, x this thread's rows of the chunk's part of Q, column k. The
// columns do not interact, so the steps need no barrier.
template <typename T, int G, int R>
__device__ void replay_chunk(T (&x)[R], const T* vt, T* W, const T* tau_s,
                             int n, int r, int jlo, int jhi, int k, int g,
                             unsigned mask) {
  constexpr int P = padded<T, R>();
  for (int j = jhi - 1; j >= jlo; --j) {
    const T tau = tau_s[j];
    if (tau == T(0)) continue;
    const T* v = vt + (j * G + g) * P;
    const bool in_s = j < r;
    T p[4] = {(in_s && k < n && g == 0) ? W[j * n + k] : T(0), T(0), T(0),
              T(0)};
    dot_rows<T, R>(v, x, p);
    const T d = group_sum<G>(sum4(p), mask);
    if (k < n) {
      const T w = tau * d;
      update_rows<T, R>(v, w, x);
      if (in_s && g == 0) W[j * n + k] -= w;
    }
  }
}

__device__ __forceinline__ int next_count(int count, int fanin) {
  return (count + fanin - 1) / fanin;
}

// The most threads a CTA of G threads a column has: G x 32 columns for one
// thread a column or four (n <= 32), G x 128 for two.
__host__ __device__ constexpr int max_threads(int G, int R) {
  return G == 1 || R == 8 ? 32 * G : 128 * G;
}

template <typename T, int G, int R>
__global__ void __launch_bounds__(max_threads(G, R))
    tsqr_factor_kernel(Args<T> a) {
  constexpr int C = G * R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const int n = a.n;
  T* vbuf = reinterpret_cast<T*>(smem_raw);  // the Q kernel's layout
  T* tau_s = vbuf + n * G * padded<T, R>();
  T* S = tau_s + n;
  const int b = blockIdx.x / a.leaves, leaf = blockIdx.x % a.leaves;
  const int tid = threadIdx.x, k = tid / G, g = tid % G;
  const unsigned mask = group_mask<G>();
  const size_t nn = (size_t)n * n;
  const int row0 = leaf * a.height;
  const int row1 = leaf == a.leaves - 1 ? a.m : row0 + a.height;
  const T* y = a.y + (size_t)b * a.m * n;
  T* v = a.q + (size_t)b * a.m * n;
  T* rws = a.rws + (size_t)b * a.slots * nn;
  T* taus = a.taus + (size_t)b * a.slots * a.tau_rows * n;
  int* counters = a.counters + (size_t)b * a.slots;
  T x[R];

  const int chunks = (row1 - row0 + C - 1) / C;
  for (int c = 0; c < chunks; ++c) {
    const int r = min(n, c * C), base = row0 + c * C;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int row = base + t * G + g;
      x[t] = (row < row1 && k < n) ? y[(size_t)row * n + k] : T(0);
    }
    factor_chunk<T, G, R>(x, S, vbuf, tau_s, n, r, 0, min(n, r + C), k, g,
                          mask);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = t * G + g, row = base + i;
      if (k < n) {
        if (r + i < n) S[(r + i) * n + k] = x[t];
        if (row < row1) v[(size_t)row * n + k] = x[t];
      }
    }
    for (int j = tid; j < n; j += blockDim.x)
      taus[((size_t)leaf * a.tau_rows + c) * n + j] = tau_s[j];
    __syncthreads();
  }

  int node = leaf, count = a.leaves, off = 0;
  while (true) {
    T* dst = rws + (size_t)(off + node) * nn;
    for (int e = tid; e < n * n; e += blockDim.x) dst[e] = S[e];
    if (count == 1) break;
    __threadfence();
    __syncthreads();
    const int parent = node / a.fanin, first = parent * a.fanin;
    const int nchild = min(a.fanin, count - first);
    if (tid == 0)
      last = atomicAdd(counters + off + count + parent, 1) == nchild - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const T* r0 = rws + (size_t)(off + first) * nn;
    for (int e = tid; e < n * n; e += blockDim.x) S[e] = __ldcg(r0 + e);
    __syncthreads();
    for (int ch = 1; ch < nchild; ++ch) {
      T* rc = rws + (size_t)(off + first + ch) * nn;
      T* tc = taus + ((size_t)(off + first + ch) * a.tau_rows + a.tau_rows -
                      (n + C - 1) / C) * n;
      for (int c0 = 0, sc = 0; c0 < n; c0 += C, ++sc) {
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const int i = c0 + t * G + g;
          x[t] = (i < n && i <= k && k < n) ? __ldcg(rc + i * n + k) : T(0);
        }
        factor_chunk<T, G, R>(x, S, vbuf, tau_s, n, n, c0, n, k, g, mask);
        __syncthreads();
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const int i = c0 + t * G + g;
          if (i < n && k < n) rc[i * n + k] = x[t];
        }
        for (int j = tid; j < n; j += blockDim.x)
          tc[(size_t)sc * n + j] = tau_s[j];
        __syncthreads();
      }
    }
    node = parent;
    off += count;
    count = next_count(count, a.fanin);
  }
}

template <typename T, int G, int R>
__global__ void __launch_bounds__(max_threads(G, R))
    tsqr_q_kernel(Args<T> a) {
  constexpr int C = G * R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n;
  T* vt = reinterpret_cast<T*>(smem_raw);
  T* tau_s = vt + n * G * padded<T, R>();
  T* W = tau_s + n;
  const int b = blockIdx.x / a.leaves, leaf = blockIdx.x % a.leaves;
  const int tid = threadIdx.x, k = tid / G, g = tid % G;
  const unsigned mask = group_mask<G>();
  const size_t nn = (size_t)n * n;
  const int row0 = leaf * a.height;
  const int row1 = leaf == a.leaves - 1 ? a.m : row0 + a.height;
  T* q = a.q + (size_t)b * a.m * n;
  const T* rws = a.rws + (size_t)b * a.slots * nn;
  const T* taus = a.taus + (size_t)b * a.slots * a.tau_rows * n;
  T* wws = a.wws + ((size_t)b * a.leaves + leaf) * nn;

  // The tree's levels: count and first slot of each (at most 32 levels).
  int counts[32], offs[32], top = 0;
  counts[0] = a.leaves;
  offs[0] = 0;
  while (counts[top] > 1) {
    counts[top + 1] = next_count(counts[top], a.fanin);
    offs[top + 1] = offs[top] + counts[top];
    ++top;
  }
  const T* root = rws + (size_t)offs[top] * nn;
  for (int e = tid; e < n * n; e += blockDim.x) {
    const int i = e / n, c = e % n;
    const T d = root[i * n + i] < T(0) ? T(-1) : T(1);
    W[e] = i == c ? d : T(0);
    if (leaf == 0 && a.r_out != nullptr)
      a.r_out[(size_t)b * nn + e] = c >= i ? d * root[e] : T(0);
  }
  __syncthreads();

  T x[R];
  int span = 1;  // leaves under a node of level top - 1 ... 1
  for (int l = 1; l < top; ++l) span *= a.fanin;
  for (int level = top; level >= 1; --level, span /= a.fanin) {
    // this leaf's node at `level` and its child (at level - 1) on the path
    const int child = leaf / span, node = child / a.fanin;
    const int first = node * a.fanin, cstar = child - first;
    const int nchild = min(a.fanin, counts[level - 1] - first);
    for (int ch = nchild - 1; ch >= 1 && ch >= cstar; --ch) {
      const T* rc = rws + (size_t)(offs[level - 1] + first + ch) * nn;
      const T* tc = taus + ((size_t)(offs[level - 1] + first + ch) *
                                a.tau_rows + a.tau_rows - (n + C - 1) / C) * n;
      for (int sc = (n - 1) / C; sc >= 0; --sc) {
        const int c0 = sc * C;
#pragma unroll
        for (int t = 0; t < R; ++t) x[t] = T(0);
        stage_reflectors<T, G, R>(rc, c0, n, vt, n, n, k, g);
        for (int j = tid; j < n; j += blockDim.x) tau_s[j] = tc[sc * n + j];
        __syncthreads();
        replay_chunk<T, G, R>(x, vt, W, tau_s, n, n, c0, n, k, g, mask);
        if (ch == cstar) {
#pragma unroll
          for (int t = 0; t < R; ++t) {
            const int i = c0 + t * G + g;
            if (i < n && k < n) wws[i * n + k] = x[t];
          }
        }
        __syncthreads();
      }
    }
    if (cstar >= 1) {
      for (int e = tid; e < n * n; e += blockDim.x) W[e] = wws[e];
      __syncthreads();
    }
  }

  const int chunks = (row1 - row0 + C - 1) / C;
  for (int c = chunks - 1; c >= 0; --c) {
    const int r = min(n, c * C), base = row0 + c * C;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = t * G + g;
      x[t] = (k < n && r + i < n) ? W[(r + i) * n + k] : T(0);
    }
    stage_reflectors<T, G, R>(q, base, row1, vt, n, r, k, g);
    for (int j = tid; j < n; j += blockDim.x)
      tau_s[j] = taus[((size_t)leaf * a.tau_rows + c) * n + j];
    __syncthreads();
    replay_chunk<T, G, R>(x, vt, W, tau_s, n, r, 0, min(n, r + C), k, g,
                          mask);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int row = base + t * G + g;
      if (k < n && row < row1) q[(size_t)row * n + k] = x[t];
    }
    __syncthreads();
  }
}

// Dynamic shared memory of either kernel: a chunk's reflectors, its taus,
// S (the factor kernel) or W (the Q kernel).
template <typename T, int G, int R>
constexpr int smem_bytes(int n) {
  return (int)sizeof(T) * (n * G * padded<T, R>() + n + n * n);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory, once per size.
template <typename K>
cudaError_t allow_smem(K kernel, int smem, int& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

template <typename T, int G, int R>
int launch(const Args<T>& a, int batch, int threads, int smem,
           cudaStream_t stream) {
  if (threads > max_threads(G, R) || smem != smem_bytes<T, G, R>(a.n))
    return -2;
  auto factor = tsqr_factor_kernel<T, G, R>;
  auto form_q = tsqr_q_kernel<T, G, R>;
  static int allowed_factor = 48 * 1024, allowed_q = 48 * 1024;
  cudaError_t err = allow_smem(factor, smem, allowed_factor);
  if (err == cudaSuccess) err = allow_smem(form_q, smem, allowed_q);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)batch * (unsigned)a.leaves;
  factor<<<grid, threads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  form_q<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The slots of a tree over `leaves` leaves at fan-in `fanin`, and its
// depth in levels above the leaves.
inline void tree(int leaves, int fanin, int* slots, int* levels) {
  *slots = 0;
  *levels = 0;
  for (int c = leaves; ; c = (c + fanin - 1) / fanin) {
    *slots += c;
    if (c == 1) break;
    ++*levels;
  }
}

template <typename T>
int run(const T* y, T* q, T* r_out, T* rws, T* taus, T* wws, int* counters,
        int batch, int m, int n, int leaves, int height, int fanin,
        int tau_rows, int groups, int rows, int threads, int smem,
        void* stream) {
  const int C = groups * rows;
  int slots, levels;
  if (leaves < 1 || fanin < 2) return -2;
  tree(leaves, fanin, &slots, &levels);
  const int last_rows = m - (leaves - 1) * height;
  const int chunks =
      ((last_rows > height ? last_rows : height) + C - 1) / C;
  if (batch < 1 || n < 1 || n > 128 || m < n || height < n ||
      last_rows < n || levels >= 32 || tau_rows != chunks + (n + C - 1) / C ||
      threads % 32 != 0 ||
      threads != (n * groups + 31) / 32 * 32)
    return -2;
  Args<T> a{y, q, r_out, rws, taus, wws, counters, m, n, leaves, height,
            fanin, tau_rows, slots};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (groups * 100 + rows) {
    case 132:
      return launch<T, 1, 32>(a, batch, threads, smem, s);
    case 232:
      return launch<T, 2, 32>(a, batch, threads, smem, s);
    case 408:
      return launch<T, 4, 8>(a, batch, threads, smem, s);
    default:
      return -2;
  }
}

}  // namespace rc_tsqr

extern "C" {

// Thin QR of the (batch, m, n) stack `y` into `q` (and R into `r_out`
// unless it is null) on `stream`: the factor kernel then the Q kernel,
// batch x leaves CTAs each, leaves of `height` rows (the last the rest),
// a tree of fan-in `fanin`, `groups` threads a column, `threads` a CTA,
// `smem` bytes of dynamic shared memory. The workspaces `rws` (batch,
// slots, n, n), `taus` (batch, slots, tau_rows, n), `wws` (batch, leaves,
// n, n) and the zeroed `counters` (batch, slots) are the wrapper's
// (ops/kernels/tsqr.py). Returns 0, a CUDA error of a launch, or -2 for
// numbers that do not fit together; does not synchronise.
int rc_tsqr_f32(const float* y, float* q, float* r_out, float* rws,
                float* taus, float* wws, int* counters, int batch, int m,
                int n, int leaves, int height, int fanin, int tau_rows,
                int groups, int rows, int threads, int smem, void* stream) {
  return rc_tsqr::run<float>(y, q, r_out, rws, taus, wws, counters, batch,
                             m, n, leaves, height, fanin, tau_rows, groups,
                             rows, threads, smem, stream);
}

int rc_tsqr_f64(const double* y, double* q, double* r_out, double* rws,
                double* taus, double* wws, int* counters, int batch, int m,
                int n, int leaves, int height, int fanin, int tau_rows,
                int groups, int rows, int threads, int smem, void* stream) {
  return rc_tsqr::run<double>(y, q, r_out, rws, taus, wws, counters, batch,
                              m, n, leaves, height, fanin, tau_rows, groups,
                              rows, threads, smem, stream);
}

}  // extern "C"
