// The ordering step's column passes for DirectLiNGAM, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX ordering step (repro/core/ordering.py,
// step_standardize, gram_mean, col_moments, residualize) is plain jnp that
// XLA fuses on the TPU. In the port the same step was ~70 composed PyTorch
// launches, a float64 copy of the working buffer among them; these kernels
// take their place on the card, through repro_torch/kernels/step_passes.py,
// for LocalReducer (repro_torch/core/ordering.py). Each takes a batch of b
// buffers, x (b, m, w) row-major float32 (a single fit is the batch of
// one), blockIdx.y the batch element; an element's results are those of a
// launch on it alone, bit for bit.
//
// One step, in launch order:
//   1. col_stats_kernel, stats_merge_kernel: each column's float64 mean and
//      centred sum of squares, from one read of x. A thread holds one
//      column's 32-sample slab in registers, takes its two-pass mean and
//      centred sum there, and merges the slabs of its split in order
//      (Chan's merge); the merge kernel (a warp a column) merges the splits
//      in a fixed order and writes mu, var = max(M2 / m, 1e-12) and
//      rstd = 1/sqrt(var) in float32, as step_standardize rounds them.
//   2. standardize_moments_kernel: x_std = (x - mu) * rstd written in
//      float32, and in the same pass the column sums of log cosh x_std and
//      x_std exp(-x_std^2 / 2) in float64, each term the single-variable
//      form of moment_terms.cuh's integrand (add_term with a = 1, b = 0):
//      H(x_j) and kernel B1's H(r_ij) come from the same arithmetic.
//   3. gram_kernel: the sums x_std^T x_std over the samples, accumulated in
//      float64 on the FP64 tensor cores (mma.sync m16n8k8 f64; products of
//      float32 values are exact in float64), over the upper 64 x 64 tiles
//      only, the entries i <= j written. finish_kernel adds the splits in
//      order, writes C = float32(S / m) as gram_mean rounds it and the
//      float64 G = S / m, each at (i, j) and (j, i), and the column
//      moments' means.
//   4. residualize_kernel: x_j - coef_j x_root for every column but the
//      root, coef_j = G[root, j] sqrt(var_j / var_root): the root's
//      covariances from the float64 sums the step already has, with no read
//      of x to form them. It writes the w - 1 surviving columns into a new
//      (m, w - 1) buffer, so the next step runs at the active width, and
//      keeps the labels: the surviving columns' original indices, the
//      root's into the order. The root stays on the device.
//   Between 3 and 4, after kernel B1 has written the pairs' moments M1, M2:
//   5. score_tiles_kernel, score_root_kernel: the step's scores and root
//      from (cm1, cm2, M1, M2), every column active (the ordering's buffer
//      is compacted at every step). Each entropy H = H_gauss - K1 (m1 -
//      gamma)^2 - K2 m2^2, each diff[i, j] = (H(x_j) + H(r_ij)) - (H(x_i) +
//      H(r_ji)) and each min(diff, 0)^2 in float32 by the composed
//      function's operations in its order, pinned by rounding intrinsics,
//      so every term is the composed term's bits; k_list[i] = minus the
//      float64 sum of row i's terms, the root the first maximum of k_list
//      as torch.argmax takes it (NaN above every number, ties to the lower
//      index). The tile kernel takes a 32 x 32 tile pair (P, Q), P <= Q, a
//      block, reads M1 and M2 at (P, Q) and at (Q, P) once each (so the
//      (w, w) moments are read once a step), and writes each row's sum
//      over the other tile; the root kernel, a block an element, adds a
//      row's tile sums in tile order and takes the argmax. Up to 64
//      columns (at most three tile pairs) score_fused_kernel does both in
//      one launch, a block an element: a narrow step is bound by its
//      launches, not its bytes.
//
// What bounds it: bytes, but for the Gram product. A step reads the (m, w)
// buffer three times and x_std once, and writes x_std and the residualized
// buffer: at (1e6, 100) 2.4 GB, 0.72 ms at 3.35 TB/s. The Gram product,
// m w^2 / 2 float64 FMAs (at (1e6, 100) 1.2e10 with the tiles' padding),
// takes 0.37 ms at the FP64 tensor-core rate (67 TFLOP/s) and runs at ~63%
// of it. The composed step made ~90 passes over the buffer's bytes; what
// the design does about that:
//   * one pass a quantity: no temporaries, no float64 copy of the buffer;
//     statistics, standardization with the moments, the Gram sums and the
//     residual update each read their input once; the partial sums are per
//     split, a few MB;
//   * coalesced reads: a warp reads 32 neighbouring columns of a sample row;
//     in the standardization a thread issues the next slab's 32 loads
//     before this slab's arithmetic;
//   * the Gram sums on the tensor cores, the symmetric half only, the
//     panels copied by cp.async under the previous slab's products and
//     kept in float32 in shared memory (half the bytes of float64).
//
// The scores read 8 w^2 bytes an element (1.9 MB at w = 487, 7.4 MB at 964)
// and write w float64 scores: at 3.35 TB/s 0.6 and 2.2 us, under a
// launch's cost, so their kernels are bound by launches wherever the
// ordering runs them; what their design does about that is one launch
// (two past 64 columns) in place of the composed function's ~30.
//
// Summation order, fixed by m alone: the sample axis is cut into splits of
// whole 32-sample slabs (column passes: at most 512 splits of at least 8
// slabs; Gram: at most 128 splits of at least 32 slabs), each split summed
// in sample order by one thread (column passes) or by one tensor-core chain
// eight samples a step (Gram), the splits merged in a fixed order by the
// merge kernels. No atomics. A column's statistics, moments and each
// pair's C entry are the same bits at every buffer width, column position,
// batch size and run (the tensor cores' products and sums do not depend on
// where a column sits in a tile): the ordering compacted at every step sees
// the masked scan's numbers.
//
// Every launcher returns a cudaError_t as int so that the caller can raise.

#include <cuda_runtime.h>

#include "moment_terms.cuh"

namespace {

constexpr int kColThreads = 128;  // columns a block in the column passes
constexpr int kSlab = 32;         // samples a slab
constexpr int kTile = 64;         // Gram output tile edge
constexpr int kLdf = kTile + 8;   // shared row stride (floats): no bank conflicts
constexpr int kGramThreads = 128;
constexpr int kWarpsMerge = 8;    // columns a block of the merge kernels
constexpr float kEps = 1e-12f;

// The sample range [s0, s1) of split k: `per` slabs each, the last ragged.
__device__ __forceinline__ void split_range(long long m, int per, int k,
                                            long long& s0, long long& s1) {
  s0 = (long long)k * per * kSlab;
  const long long e = s0 + (long long)per * kSlab;
  s1 = e < m ? e : m;
}

// Chan's merge of (nb, mean_b, m2_b) into (n, mean, m2).
__device__ __forceinline__ void chan_merge(double& n, double& mean, double& m2,
                                           double nb, double mean_b,
                                           double m2_b) {
  if (n == 0.0) {
    n = nb;
    mean = mean_b;
    m2 = m2_b;
    return;
  }
  const double nn = n + nb;
  const double delta = mean_b - mean;
  mean = mean + delta * (nb / nn);
  m2 = m2 + m2_b + delta * delta * (n * nb / nn);
  n = nn;
}

// Two-pass mean and centred sum of squares of n values held in v.
template <int N>
__device__ __forceinline__ void slab_stats(const float (&v)[kSlab], int n,
                                           double& mean, double& m2) {
  double s = 0.0;
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if (N == kSlab || t < n) s += (double)v[t];
  }
  mean = s / (double)n;
  double q = 0.0;
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if (N == kSlab || t < n) {
      const double dv = (double)v[t] - mean;
      q = fma(dv, dv, q);
    }
  }
  m2 = q;
}

__global__ void __launch_bounds__(kColThreads)
col_stats_kernel(const float* __restrict__ x, double* __restrict__ part_mean,
                 double* __restrict__ part_m2, long long m, int w, int n_split,
                 int per, int col_tiles) {
  const int k = blockIdx.x / col_tiles;
  const int col = (blockIdx.x - k * col_tiles) * kColThreads + threadIdx.x;
  if (col >= w) return;
  const long long elem = blockIdx.y;
  x += elem * m * w;
  long long s0, s1;
  split_range(m, per, k, s0, s1);
  double n = 0.0, mean = 0.0, m2 = 0.0;
  for (long long s = s0; s < s1; s += kSlab) {
    const int ns = (int)(s1 - s < kSlab ? s1 - s : kSlab);
    float v[kSlab];
    const float* p = x + s * w + col;
    double mb, qb;
    if (ns == kSlab) {
#pragma unroll
      for (int t = 0; t < kSlab; ++t) v[t] = __ldg(p + (long long)t * w);
      slab_stats<kSlab>(v, ns, mb, qb);
    } else {
#pragma unroll
      for (int t = 0; t < kSlab; ++t) {
        v[t] = t < ns ? __ldg(p + (long long)t * w) : 0.0f;
      }
      slab_stats<kSlab - 1>(v, ns, mb, qb);
    }
    chan_merge(n, mean, m2, (double)ns, mb, qb);
  }
  const long long o = (elem * n_split + k) * w + col;
  part_mean[o] = mean;
  part_m2[o] = m2;
}

// One warp a column: lane l merges splits l, l + 32, ... in order, then the
// lanes merge in a fixed tree (Chan's merge, as within a split); mu, var,
// rstd in float32.
__global__ void stats_merge_kernel(const double* __restrict__ part_mean,
                                   const double* __restrict__ part_m2,
                                   float* __restrict__ mu,
                                   float* __restrict__ var,
                                   float* __restrict__ rstd, long long m,
                                   int w, int n_split, int per) {
  const int col = blockIdx.x * kWarpsMerge + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (col >= w) return;
  const long long elem = blockIdx.y;
  double n = 0.0, mean = 0.0, m2 = 0.0;
  for (int k = lane; k < n_split; k += 32) {
    long long s0, s1;
    split_range(m, per, k, s0, s1);
    const long long o = (elem * n_split + k) * w + col;
    chan_merge(n, mean, m2, (double)(s1 - s0), part_mean[o], part_m2[o]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double nb = __shfl_down_sync(0xffffffffu, n, off);
    const double mb = __shfl_down_sync(0xffffffffu, mean, off);
    const double qb = __shfl_down_sync(0xffffffffu, m2, off);
    if (nb != 0.0) chan_merge(n, mean, m2, nb, mb, qb);
  }
  if (lane == 0) {
    const float v = fmaxf((float)(m2 / (double)m), kEps);
    mu[elem * w + col] = (float)mean;
    var[elem * w + col] = v;
    rstd[elem * w + col] = __frsqrt_rn(v);
  }
}

// The next slab's loads are issued before this slab's arithmetic.
__global__ void __launch_bounds__(kColThreads)
standardize_moments_kernel(const float* __restrict__ x,
                           const float* __restrict__ mu,
                           const float* __restrict__ rstd,
                           float* __restrict__ x_std,
                           double* __restrict__ part1,
                           double* __restrict__ part2, long long m, int w,
                           int n_split, int per, int col_tiles) {
  const int k = blockIdx.x / col_tiles;
  const int col = (blockIdx.x - k * col_tiles) * kColThreads + threadIdx.x;
  if (col >= w) return;
  const long long elem = blockIdx.y;
  x += elem * m * w;
  x_std += elem * m * w;
  const float mc = mu[elem * w + col];
  const float rc = rstd[elem * w + col];
  const moment_terms::PairCoef one{1.0f, 0.0f};
  long long s0, s1;
  split_range(m, per, k, s0, s1);
  double acc1 = 0.0, acc2 = 0.0;
  float nxt[kSlab];
  auto fetch = [&](long long s) {
    const int ns = (int)(s1 - s < kSlab ? s1 - s : kSlab);
#pragma unroll
    for (int t = 0; t < kSlab; ++t) {
      nxt[t] = t < ns ? __ldg(x + (s + t) * w + col) : 0.0f;
    }
  };
  fetch(s0);
  for (long long s = s0; s < s1; s += kSlab) {
    const int ns = (int)(s1 - s < kSlab ? s1 - s : kSlab);
    float v[kSlab];
#pragma unroll
    for (int t = 0; t < kSlab; ++t) v[t] = nxt[t];
    if (s + kSlab < s1) fetch(s + kSlab);
#pragma unroll
    for (int t = 0; t < kSlab; ++t) {
      if (t < ns) {
        const float u = __fmul_rn(__fsub_rn(v[t], mc), rc);
        x_std[(s + t) * w + col] = u;
        float t1 = 0.0f, t2 = 0.0f;
        moment_terms::add_term(u, 0.0f, one, t1, t2);
        acc1 += (double)t1;
        acc2 += (double)t2;
      }
    }
  }
  const long long o = (elem * n_split + k) * w + col;
  part1[o] = acc1;
  part2[o] = acc2;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// d += a b for one 16 x 8 x 8 float64 tensor-core tile (mma.sync m16n8k8):
// a thread holds A(g, q), A(g + 8, q), A(g, q + 4), A(g + 8, q + 4), B(q, g),
// B(q + 4, g), and D(g, 2q + h), D(g + 8, 2q + h), h = 0, 1, where g is
// lane / 4 and q lane % 4.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Upper tile u of an nt x nt grid of tiles, row-major over ti <= tj.
__device__ __forceinline__ void upper_tile(int u, int nt, int& ti, int& tj) {
  ti = 0;
  while (u >= nt - ti) {
    u -= nt - ti;
    ++ti;
  }
  tj = ti + u;
}

__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                bool ok) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// Partial Gram sums of one upper 64 x 64 tile over one split: 4 warps, each
// a 32 x 32 quarter as 2 x 4 tensor-core tiles of 16 x 8, eight samples a
// tile step. The two 64-column panels of each 32-sample slab (one on the
// diagonal) are copied as float32 into shared memory by cp.async (4-byte
// granules: rows of x need not be 16-byte aligned; zeros past the split's
// end or the last column), double-buffered so that the next slab's copy
// runs under this slab's products, and widened to float64 as the
// fragments are loaded.
__global__ void __launch_bounds__(kGramThreads)
gram_kernel(const float* __restrict__ x, double* __restrict__ part,
            long long m, int w, int n_split, int per, int n_upper) {
  constexpr int kLoads = kSlab * kTile / kGramThreads;  // a thread, a panel
  constexpr int kRowStep = kGramThreads / kTile;
  constexpr int kPanel = kSlab * kLdf;
  __shared__ __align__(16) float smem[2 * 2 * kPanel];  // 2 slabs x 2 panels
  const int k = blockIdx.x / n_upper;
  const int u = blockIdx.x - k * n_upper;
  const int nt = (w + kTile - 1) / kTile;
  int ti, tj;
  upper_tile(u, nt, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const long long elem = blockIdx.y;
  x += elem * m * w;
  part += (elem * n_split + k) * (long long)w * w;
  long long s0, s1;
  split_range(m, per, k, s0, s1);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 32;  // this warp's rows in the tile
  const int wc = (warp & 1) * 32;   // and columns
  const int g = lane >> 2;
  const int q = lane & 3;
  const int c = threadIdx.x & (kTile - 1);  // staged column
  const int r0 = threadIdx.x / kTile;       // first staged sample
  const bool ca = i0 + c < w;
  const bool cb = j0 + c < w;

  double acc[2][4][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[p][r][h] = 0.0;

  auto stage = [&](long long s, int buf) {
    float* sa = smem + buf * 2 * kPanel;
    float* sb = sa + kPanel;
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int row = r0 + t * kRowStep;
      const bool ok = s + row < s1;
      const float* src = x + (ok ? s + row : s0) * w;
      cp_async4_zfill(sa + row * kLdf + c, src + i0 + (ca ? c : 0), ok && ca);
      if (!diag) {
        cp_async4_zfill(sb + row * kLdf + c, src + j0 + (cb ? c : 0),
                        ok && cb);
      }
    }
  };
  const long long n_slabs = (s1 - s0 + kSlab - 1) / kSlab;
  stage(s0, 0);
  cp_async_commit();
  for (long long sl = 0; sl < n_slabs; ++sl) {
    if (sl + 1 < n_slabs) stage(s0 + (sl + 1) * kSlab, (int)((sl + 1) & 1));
    cp_async_commit();  // possibly empty: keeps "all but the last" exact
    cp_async_wait_prior();
    __syncthreads();
    const float* sa = smem + (int)(sl & 1) * 2 * kPanel;
    const float* pb = diag ? sa : sa + kPanel;
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 8) {
      const float* ra = sa + (kk + q) * kLdf + wr + g;
      const float* rb = pb + (kk + q) * kLdf + wc + g;
      double a[2][4], b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        a[p][0] = (double)ra[p * 16];
        a[p][1] = (double)ra[p * 16 + 8];
        a[p][2] = (double)ra[4 * kLdf + p * 16];
        a[p][3] = (double)ra[4 * kLdf + p * 16 + 8];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        b[r][0] = (double)rb[r * 8];
        b[r][1] = (double)rb[4 * kLdf + r * 8];
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int r = 0; r < 4; ++r) mma_f64(acc[p][r], a[p], b[r]);
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }

  // Entry (i, j) with i <= j only; finish_kernel mirrors it.
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = i0 + wr + p * 16 + (h >> 1) * 8 + g;
        const int j = j0 + wc + r * 8 + q * 2 + (h & 1);
        if (i < w && j < w && i <= j) part[(long long)i * w + j] = acc[p][r][h];
      }
}

// The Gram splits added in order, divided by m: G (float64) and C (float32),
// a thread an upper entry (i <= j) written at (i, j) and (j, i), in the
// first gram_blocks blocks; then the column
// moments' splits, one warp a column as in stats_merge_kernel, divided by m
// (float32).
__global__ void finish_kernel(const double* __restrict__ gram_part,
                              const double* __restrict__ mom1,
                              const double* __restrict__ mom2,
                              double* __restrict__ gram,
                              float* __restrict__ c, float* __restrict__ cm1,
                              float* __restrict__ cm2, long long m, int w,
                              int gram_splits, int col_splits,
                              int gram_blocks) {
  const long long ww = (long long)w * w;
  const long long elem = blockIdx.y;
  if ((int)blockIdx.x < gram_blocks) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= ww) return;
    const long long i = idx / w;
    const long long j = idx - i * w;
    if (i > j) return;
    const double* p = gram_part + elem * gram_splits * ww + idx;
    double s = 0.0;
    for (int k = 0; k < gram_splits; ++k) s += p[k * ww];
    const double gv = s / (double)m;
    gram[elem * ww + idx] = gv;
    gram[elem * ww + j * w + i] = gv;
    c[elem * ww + idx] = (float)gv;
    c[elem * ww + j * w + i] = (float)gv;
    return;
  }
  const int col = (blockIdx.x - gram_blocks) * kWarpsMerge + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (col >= w) return;
  double s1 = 0.0, s2 = 0.0;
  for (int k = lane; k < col_splits; k += 32) {
    const long long o = (elem * col_splits + k) * w + col;
    s1 += mom1[o];
    s2 += mom2[o];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  if (lane == 0) {
    cm1[elem * w + col] = (float)(s1 / (double)m);
    cm2[elem * w + col] = (float)(s2 / (double)m);
  }
}

// The residual update with the buffer compacted: column j of x (b, m, w)
// other than the root, x_j - coef_j x_root, written at column
// j - (j > root) of x_new (b, m, w - 1), its label at the same place of
// labels_new (b, w - 1); the root's label at order[k] and, when one column
// survives, that column's label at order[k + 1] (order (b, d); the labels
// and the order written by the blocks at sample group 0). Each element
// drops its own root.
__global__ void __launch_bounds__(kColThreads)
residualize_kernel(const float* __restrict__ x, const long long* __restrict__ root,
                   const double* __restrict__ gram,
                   const float* __restrict__ var,
                   const long long* __restrict__ labels,
                   float* __restrict__ x_new,
                   long long* __restrict__ labels_new,
                   long long* __restrict__ order, long long m, int w, int d,
                   int k, int col_tiles, int rows_per_block) {
  const int grp = blockIdx.x / col_tiles;
  const int col = (blockIdx.x - grp * col_tiles) * kColThreads + threadIdx.x;
  if (col >= w) return;
  const long long elem = blockIdx.y;
  const int r = (int)root[elem];
  const int wn = w - 1;
  const long long label = labels[elem * w + col];
  if (col == r) {
    if (grp == 0) order[elem * d + k] = label;
    return;
  }
  const int out = col - (col > r);
  if (grp == 0) {
    labels_new[elem * wn + out] = label;
    if (wn == 1) order[elem * d + k + 1] = label;
  }
  const double g = gram[(elem * w + r) * (long long)w + col];
  const float coef = (float)(g * sqrt((double)var[elem * w + col] /
                                      (double)var[elem * w + r]));
  x += elem * m * w;
  x_new += elem * m * wn;
  const long long s0 = (long long)grp * rows_per_block;
  const long long e = s0 + rows_per_block;
  const long long s1 = e < m ? e : m;
#pragma unroll 8
  for (long long s = s0; s < s1; ++s) {
    const float xv = __ldg(x + s * w + col);
    x_new[s * wn + out] = __fsub_rn(xv, __fmul_rn(__ldg(x + s * w + r), coef));
  }
}

constexpr int kScoreTile = 32;     // score tile edge: a warp a tile row
constexpr int kScoreLd = kScoreTile + 1;  // shared row stride, conflict-free
constexpr int kScoreWarps = 8;
constexpr int kFusedTiles = 2;     // up to 2 x 2 tiles: one fused launch
constexpr int kRootThreads = 512;

// The constants of measures.entropy_from_moments, rounded to float32 as
// the composed function's scalar operands are.
struct EntropyConsts {
  float h_gauss;
  float k1;
  float k2;
  float gamma;
};

// (H_gauss - K1 (m1 - gamma)^2) - K2 m2^2, each float32 operation of the
// composed function in its order.
__device__ __forceinline__ float entropy_f32(float m1, float m2,
                                             const EntropyConsts& e) {
  const float a = __fsub_rn(m1, e.gamma);
  const float h = __fsub_rn(e.h_gauss, __fmul_rn(__fmul_rn(a, a), e.k1));
  return __fsub_rn(h, __fmul_rn(__fmul_rn(m2, m2), e.k2));
}

// One score term, (h_col[j] + h_res[i, j]) - (h_col[i] + h_res[j, i]) and
// then torch.clamp(diff, max=0) ** 2: a NaN passes through.
__device__ __forceinline__ float score_term(float hc_j, float h_ij, float hc_i,
                                            float h_ji) {
  const float diff = __fsub_rn(__fadd_rn(hc_j, h_ij), __fadd_rn(hc_i, h_ji));
  const float c = diff > 0.0f ? 0.0f : diff;
  return __fmul_rn(c, c);
}

// The float64 sum of a warp's 32 values, in a fixed tree; lane 0 holds it.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

struct ScoreSmem {
  float h_pq[kScoreTile][kScoreLd];  // H(r_ij), i in tile P, j in tile Q
  float h_qp[kScoreTile][kScoreLd];  // H(r_ji)
  float hc_p[kScoreTile];            // H(x_i), i in tile P
  float hc_q[kScoreTile];            // H(x_j), j in tile Q
};

// The terms of tile pair (p, q), p <= q, of one element: warp by warp a
// tile row, a lane a column. Row i of tile p's terms over tile q's columns
// are summed into part[q * w + i] and, for p < q, row j of tile q's over
// tile p's into part[p * w + j]; the diagonal's term is left out. M1 and M2
// are read at (p, q) and, off the diagonal, at (q, p): once a step.
__device__ __forceinline__ void score_tile_pair(
    ScoreSmem& sm, const float* __restrict__ cm1,
    const float* __restrict__ cm2, const float* __restrict__ m1,
    const float* __restrict__ m2, double* __restrict__ part, int w, int p,
    int q, const EntropyConsts& e) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p0 = p * kScoreTile;
  const int q0 = q * kScoreTile;
  const bool diag = p == q;
  if (warp == 0 && p0 + lane < w) {
    sm.hc_p[lane] = entropy_f32(cm1[p0 + lane], cm2[p0 + lane], e);
  } else if (warp == 1 && q0 + lane < w) {
    sm.hc_q[lane] = entropy_f32(cm1[q0 + lane], cm2[q0 + lane], e);
  }
  for (int r = warp; r < kScoreTile; r += kScoreWarps) {
    if (p0 + r < w && q0 + lane < w) {
      const long long o = (long long)(p0 + r) * w + q0 + lane;
      sm.h_pq[r][lane] = entropy_f32(__ldg(m1 + o), __ldg(m2 + o), e);
    }
    if (!diag && q0 + r < w && p0 + lane < w) {
      const long long o = (long long)(q0 + r) * w + p0 + lane;
      sm.h_qp[r][lane] = entropy_f32(__ldg(m1 + o), __ldg(m2 + o), e);
    }
  }
  __syncthreads();
  const float(*h_qp)[kScoreLd] = diag ? sm.h_pq : sm.h_qp;
  for (int r = warp; r < kScoreTile; r += kScoreWarps) {
    const int i = p0 + r;
    const int j = q0 + lane;
    float t = 0.0f;  // entry (i, j)
    if (i < w && j < w && i != j) {
      t = score_term(sm.hc_q[lane], sm.h_pq[r][lane], sm.hc_p[r],
                     h_qp[lane][r]);
    }
    const double s = warp_sum((double)t);
    if (lane == 0 && i < w) part[(long long)q * w + i] = s;
    if (diag) continue;
    const int jr = q0 + r;
    const int ic = p0 + lane;
    float t2 = 0.0f;  // entry (jr, ic)
    if (jr < w && ic < w) {
      t2 = score_term(sm.hc_p[lane], sm.h_qp[r][lane], sm.hc_q[r],
                      sm.h_pq[lane][r]);
    }
    const double s2 = warp_sum((double)t2);
    if (lane == 0 && jr < w) part[(long long)p * w + jr] = s2;
  }
  __syncthreads();  // the tiles are refilled by the next pair
}

// (a, ia) ranks before (b, ib) in torch.argmax's order: NaN above every
// number, then the larger value, then the lower index.
__device__ __forceinline__ bool ranks_before(double a, int ia, double b,
                                             int ib) {
  const bool na = a != a;
  const bool nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// k_list[i] = -(part[0 * w + i] + part[1 * w + i] + ...), the tile sums
// added in tile order, and root = the first maximum of k_list; a block an
// element, any multiple of 32 threads up to kRootThreads.
__device__ __forceinline__ void score_root(const double* __restrict__ part,
                                           double* __restrict__ k_list,
                                           long long* __restrict__ root,
                                           int w, int nt) {
  __shared__ double s_val[kRootThreads / 32];
  __shared__ int s_idx[kRootThreads / 32];
  double best = 0.0;
  int bi = -1;
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    double s = 0.0;
    for (int t = 0; t < nt; ++t) s += part[(long long)t * w + i];
    const double k = -s;
    k_list[i] = k;
    if (bi < 0 || ranks_before(k, i, best, bi)) {
      best = k;
      bi = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (oi >= 0 && (bi < 0 || ranks_before(ob, oi, best, bi))) {
      best = ob;
      bi = oi;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int v = 1; v < (int)(blockDim.x >> 5); ++v) {
      if (s_idx[v] >= 0 && (bi < 0 || ranks_before(s_val[v], s_idx[v], best,
                                                   bi))) {
        best = s_val[v];
        bi = s_idx[v];
      }
    }
    *root = bi;
  }
}

// A block a tile pair of element blockIdx.y: part (batch, nt, w).
__global__ void __launch_bounds__(32 * kScoreWarps)
score_tiles_kernel(const float* __restrict__ cm1, const float* __restrict__ cm2,
                   const float* __restrict__ m1, const float* __restrict__ m2,
                   double* __restrict__ part, int w, int nt,
                   EntropyConsts e) {
  __shared__ ScoreSmem sm;
  const long long elem = blockIdx.y;
  int p, q;
  upper_tile(blockIdx.x, nt, p, q);
  score_tile_pair(sm, cm1 + elem * w, cm2 + elem * w,
                  m1 + elem * w * (long long)w, m2 + elem * w * (long long)w,
                  part + elem * nt * (long long)w, w, p, q, e);
}

__global__ void __launch_bounds__(kRootThreads)
score_root_kernel(const double* __restrict__ part, double* __restrict__ k_list,
                  long long* __restrict__ root, int w, int nt) {
  const long long elem = blockIdx.y;
  score_root(part + elem * nt * (long long)w, k_list + elem * w, root + elem,
             w, nt);
}

// Up to kFusedTiles tiles a side: a block an element takes every tile pair
// in turn and then the root, in one launch (its tile sums are its own
// writes, visible to the block after the pair's barrier).
__global__ void __launch_bounds__(32 * kScoreWarps)
score_fused_kernel(const float* __restrict__ cm1, const float* __restrict__ cm2,
                   const float* __restrict__ m1, const float* __restrict__ m2,
                   double* __restrict__ part, double* __restrict__ k_list,
                   long long* __restrict__ root, int w, int nt,
                   EntropyConsts e) {
  __shared__ ScoreSmem sm;
  const long long elem = blockIdx.y;
  part += elem * nt * (long long)w;
  for (int u = 0; u < nt * (nt + 1) / 2; ++u) {
    int p, q;
    upper_tile(u, nt, p, q);
    score_tile_pair(sm, cm1 + elem * w, cm2 + elem * w,
                    m1 + elem * w * (long long)w, m2 + elem * w * (long long)w,
                    part, w, p, q, e);
  }
  score_root(part, k_list + elem * w, root + elem, w, nt);
}

}  // namespace

// Column statistics, standardization with the column moments, and the Gram
// sums of x (batch, m, w), in five launches. Scratch: part_a, part_b (the
// statistics) and part_c, part_d (the moments), (batch, col_splits, w)
// doubles; gram_part (batch, gram_splits, w, w) doubles. Outputs: mu, var, rstd, cm1, cm2 (batch, w) float32; x_std
// (batch, m, w) float32; gram (batch, w, w) float64; c (batch, w, w) float32.
extern "C" int step_standardize(const float* x, float* x_std, float* mu,
                                float* var, float* rstd, float* cm1,
                                float* cm2, double* gram, float* c,
                                double* part_a, double* part_b,
                                double* part_c, double* part_d,
                                double* gram_part, long long m, int w,
                                int col_splits, int col_per, int gram_splits,
                                int gram_per, int batch, cudaStream_t stream) {
  if (m < 1 || w < 1 || col_splits < 1 || col_per < 1 || gram_splits < 1 ||
      gram_per < 1 || batch < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int col_tiles = (w + kColThreads - 1) / kColThreads;
  const dim3 col_grid((unsigned)(col_tiles * col_splits), (unsigned)batch);
  col_stats_kernel<<<col_grid, kColThreads, 0, stream>>>(
      x, part_a, part_b, m, w, col_splits, col_per, col_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 merge_grid((unsigned)((w + kWarpsMerge - 1) / kWarpsMerge),
                        (unsigned)batch);
  stats_merge_kernel<<<merge_grid, 32 * kWarpsMerge, 0, stream>>>(
      part_a, part_b, mu, var, rstd, m, w, col_splits, col_per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  standardize_moments_kernel<<<col_grid, kColThreads, 0, stream>>>(
      x, mu, rstd, x_std, part_c, part_d, m, w, col_splits, col_per,
      col_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nt = (w + kTile - 1) / kTile;
  const int n_upper = nt * (nt + 1) / 2;
  const dim3 gram_grid((unsigned)(n_upper * gram_splits), (unsigned)batch);
  gram_kernel<<<gram_grid, kGramThreads, 0, stream>>>(
      x_std, gram_part, m, w, gram_splits, gram_per, n_upper);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int gram_blocks = (int)(((long long)w * w + 255) / 256);
  const dim3 fin_grid(
      (unsigned)(gram_blocks + (w + kWarpsMerge - 1) / kWarpsMerge),
      (unsigned)batch);
  finish_kernel<<<fin_grid, 32 * kWarpsMerge, 0, stream>>>(
      gram_part, part_c, part_d, gram, c, cm1, cm2, m, w, gram_splits,
      col_splits, gram_blocks);
  return (int)cudaGetLastError();
}

// The compacting residual update of x (batch, m, w), w >= 2, on the root
// (batch,) int64, from the step's gram (batch, w, w) float64 and var
// (batch, w) float32; labels (batch, w) and labels_new (batch, w - 1)
// int64, x_new (batch, m, w - 1) float32; the labels of step k written into
// order (batch, d) int64.
extern "C" int step_residualize(const float* x, const long long* root,
                                const double* gram, const float* var,
                                const long long* labels, float* x_new,
                                long long* labels_new, long long* order,
                                long long m, int w, int d, int k,
                                int rows_per_block, int batch,
                                cudaStream_t stream) {
  if (m < 1 || w < 2 || d < w || k < 0 || k + w > d || rows_per_block < 1 ||
      batch < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int col_tiles = (w + kColThreads - 1) / kColThreads;
  const long long groups = (m + rows_per_block - 1) / rows_per_block;
  if (groups * col_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(groups * col_tiles), (unsigned)batch);
  residualize_kernel<<<grid, kColThreads, 0, stream>>>(
      x, root, gram, var, labels, x_new, labels_new, order, m, w, d, k,
      col_tiles, rows_per_block);
  return (int)cudaGetLastError();
}

// The step's scores and root from the column moments cm1, cm2 (batch, w)
// and the pairs' moments m1, m2 (batch, w, w), all float32, every column
// active: k_list (batch, w) float64 and root (batch,) int64; scratch part
// (batch, ceil(w / 32), w) doubles. One launch up to 64 columns, two past.
extern "C" int step_scores_root(const float* cm1, const float* cm2,
                                const float* m1, const float* m2,
                                double* part, double* k_list, long long* root,
                                int w, int batch, float h_gauss, float k1,
                                float k2, float gamma, cudaStream_t stream) {
  if (w < 1 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const int nt = (w + kScoreTile - 1) / kScoreTile;
  const EntropyConsts e{h_gauss, k1, k2, gamma};
  if (nt <= kFusedTiles) {
    score_fused_kernel<<<dim3(1, (unsigned)batch), 32 * kScoreWarps, 0,
                         stream>>>(cm1, cm2, m1, m2, part, k_list, root, w,
                                   nt, e);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)(nt * (nt + 1) / 2), (unsigned)batch);
  score_tiles_kernel<<<grid, 32 * kScoreWarps, 0, stream>>>(
      cm1, cm2, m1, m2, part, w, nt, e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  score_root_kernel<<<dim3(1, (unsigned)batch), kRootThreads, 0, stream>>>(
      part, k_list, root, w, nt);
  return (int)cudaGetLastError();
}
