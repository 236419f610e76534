// Pairwise residual-entropy moment sums for DirectLiNGAM, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pairwise_stats.py::_kernel
// under both of its launches, through wrappers in
// repro_torch/kernels/pairwise_stats.py over one launcher:
//   * pairwise_moments_pallas (B1): wrapper pairwise_moments, all d rows, one
//     slab of m samples, reduce scale 1/m;
//   * pairwise_moment_sums_rows (B2): wrapper pairwise_moment_sums_rows, a
//     row tile, reduce scale 1 (sums); and wrapper pairwise_moment_sums_slabs,
//     which the chunked streaming path launches once per ordering step over
//     all of its (chunk, d) sample slabs.
// Every launcher takes a batch of b datasets, each its own X (m, d) and C
// (d, d), and writes b sets of sums: the batch grid axis (blockIdx.y) that
// the TPU kernel gets under vmap, for the bootstrap and many-dataset fits
// (one launch per ordering step over all resamples). A single fit is the
// batch of one. Element k's blocks read only X[k] and C[k] and write only
// its own partials, so its sums are bit for bit those of a launch on X[k]
// alone.
// For every pair (i, j) of a row tile [row0, row0 + rows) against all d
// columns:
//
//   u_ij(s) = (x_i(s) - C_ij x_j(s)) / sqrt(max(1 - C_ij^2, 1e-12))
//   S1_ij   = sum_s log cosh u_ij(s)
//   S2_ij   = sum_s u_ij(s) exp(-u_ij(s)^2 / 2)
//
// with the integrands of moment_terms.cuh. X is sample-major (m, d), row-major
// fp32, exactly as the ordering step holds it: no padded or transposed copy is
// made, and samples past a split's end are never loaded or iterated.
//
// What bounds it: each (pair, sample) term costs three special-function (MUFU)
// ops, 2 x ex2 and 1 x lg2, at 16 per clock per SM: 3/16 of a clock a term.
// Bytes from device memory do not bound it (X is read from L2 a few times
// per split) and the tensor cores do not apply. What a block copies from L2
// into shared memory can: a block's 128 threads compute 128 x T^2 terms a
// sample (2,048 at T = 4), so it has to stage far fewer than that many
// floats a sample. What the design does about each cost:
//
//   * Integrand: exp2/log2 form with exactly three MUFU ops and nine pinned
//     float ops a term (moment_terms.cuh). Accurate expf, expf and log1pf
//     would cost about forty issue slots a term and make FP32 issue, not
//     MUFU, the bound. No --use_fast_math: B3's pinned standardization
//     stays exact.
//   * Register-tiled pairs: a thread owns a T x T block of pairs (T = 4, 2
//     or 1) and keeps their factors, sub-sums and totals in registers. Per
//     sample it reads T values of x_j (one vector load, the columns start
//     16-byte aligned in shared memory) and T of x_i from shared memory and
//     reuses them over T^2 pairs: 2/T loads a term, 0.5 at T = 4, and T^2
//     independent pair chains to hide MUFU latency.
//   * Overlapped staging of only what a block reads: the block stages its
//     columns of each sample in stages of S samples, double-buffered with
//     cp.async, so the next stage's loads run under this stage's math. Rows
//     of X need not be 16-byte aligned (at d = 487 a row is 1,948 bytes),
//     so there is no TMA (which would need a padded copy of X).
//     - Up to 128 pair blocks a row block (ceil(d / T) <= 128: every cell
//       at d <= 487), a block covers whole rows of pair blocks and stages
//       whole sample rows with 4-byte copies, padded to a multiple of 4
//       floats (zeros): pair_partials_kernel.
//     - Past that (d > 512 at T = 4) the block's 128 pair blocks lie in one
//       or two row blocks, and it stages only their columns
//       (pair_partials_span_kernel, block_span): one x_j span of <= 128 T
//       columns, in two pieces where it wraps into the next row block,
//       each piece at a 16-byte-aligned offset, and the <= 2T x_i columns:
//       <= 520 floats a sample at T = 4 (span_ld). Each thread copies the
//       same 4 x_j floats of every sample (span_copy): one 16-byte cp.async
//       where the source is 16-byte aligned, else two of 8 or four of 4.
//       Whole rows cost d floats a sample, 1.0 a term at d = 2,048 (0.05 at
//       d = 100), and there 16 copies a thread a sample, each with its index
//       arithmetic, beside 48 MUFU ops: on an H100 (700 W) B1 read 51% of
//       its bound at (8,192, 2,048) and 73% at (65,164, 964) staging whole
//       rows, 80% and 84% staging spans.
//     S, from the staged width (pairwise_stats.stage_for): 32 at d <= 256,
//     16 at d = 487, 8 for a span (at most 64 KB of buffers a block,
//     through cudaFuncSetAttribute above 48 KB; three blocks an SM).
//   * Pair blocks, not pair tiles: the T x T pair blocks of the row tile are
//     numbered row-major and dealt 128 to a CUDA block, so only the
//     ragged T-multiple edge and the last warp of the grid carry padding.
//     With T = 4: 0% padded pairs at d = 100 (25 x 25 blocks, 625 threads,
//     the last of 20 warps has 17 of 32 lanes), 0.4% at d = 487 (122 x 122
//     blocks). The launcher picks T from the width (pairwise_stats.tile_for):
//     the largest T whose threads over all splits fill the card with at
//     least 8 warps per SM, a threshold read off the times of every T at
//     the fit paths' widths (kernels/tile_sweep.py). So the narrow
//     staged widths (56 and below at m = 1e6; 154 and below in the rolling
//     refit) use T = 2 or 1 rather than leave SMs idle: at width 8 and
//     m = 1e6 a 4 x 4 block takes 8x the time of 1 x 1.
//
// Summation order, the same at every T, S and staging:
//   * each thread adds a pair's terms in sample order into a sub-sum over 128
//     samples (the reference's ACCUM_CHUNK = 128, pairwise_stats.py
//     _accumulate), and the sub-sums into the split's total;
//   * the sample axis is cut into slabs (one slab of m samples for B1; the
//     chunked path's (chunk, d) slabs for B2), each slab into the splits of
//     split_plan(slab length), a function of that length alone; the grid
//     covers every slab's splits, and a second kernel adds each slab's
//     splits in fixed order, then the slab sums in slab order. No atomics:
//     launches are bit-identical, a pair's sums are bit-identical at every
//     buffer width and tile shape, and one slab-structured launch equals
//     the per-slab launches added in order.
//
// Both launchers return a cudaError_t as int so that the caller can raise
// when a launch was refused.

#include <cuda_runtime.h>

#include "moment_terms.cuh"

namespace {

using moment_terms::PairCoef;

constexpr int kThreads = 128;  // threads a block: 128 pair blocks
constexpr int kChunk = 128;    // samples per sub-sum (ACCUM_CHUNK)

// The sample axis: n_full slabs of `slab` samples, then a ragged slab of
// `tail` samples (none when tail == 0); each slab cut by split_plan.
struct SlabPlan {
  long long slab;
  long long tail;
  int n_full;
  int full_splits;
  int full_per;  // 128-sample chunks per split of a full slab
  int tail_splits;
  int tail_per;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int T>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[T]) {
  if constexpr (T == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (T == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// Stage samples [s0, s0 + n) (n rows of d contiguous floats in X) into buf,
// row stride ld. Element e = threadIdx.x + k * kThreads of the n rows sits
// at (e / d, e % d); (s, v) start at the thread's own and step by (ds, dv).
__device__ __forceinline__ void stage_rows(float* buf, const float* x,
                                           long long s0, int n, int d, int ld,
                                           int s_first, int v_first, int ds,
                                           int dv) {
  const float* src = x + s0 * d;
  const int total = n * d;
  int s = s_first;
  int v = v_first;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    cp_async4(buf + s * ld + v, src + e);
    s += ds;
    v += dv;
    if (v >= d) {
      v -= d;
      ++s;
    }
  }
}

// A span block's staged columns (kSpan): the x_j columns [a0, a0 + la) at
// offset 0 and, where its pair blocks wrap into the next row block, [0, lb)
// at b_off; then its nc x_i columns row0 + min(c0 + k, rows - 1) at c_off.
// Both offsets are multiples of 4 floats, so a pair block's T columns of
// x_j start 16-byte aligned in either piece.
struct Span {
  int a0;
  int la;
  int lb;
  int b_off;
  int c0;
  int nc;
  int c_off;
};

// Row stride of a span stage buffer: the most any block stages, <= kThreads
// x_j pair blocks in two pieces, each padded to 4 floats, and 2T x_i
// columns padded to 4 (pairwise_stats.staged_columns): 520 at T = 4.
template <int T>
__host__ __device__ constexpr int span_ld() {
  return (kThreads * T + 3) / 4 * 4 + (T % 4 ? 4 : 0) + (2 * T + 3) / 4 * 4;
}

// The columns read by pair blocks [first, first + kThreads) (clipped to
// the nb blocks of the grid), nbj pair blocks a row block, nbj > kThreads:
// they lie in at most two row blocks.
template <int T>
__device__ __forceinline__ Span block_span(int first, int nb, int nbj,
                                           int d) {
  const int last = (first + kThreads < nb ? first + kThreads : nb) - 1;
  const int bi0 = first / nbj;
  const int bi1 = last / nbj;
  const int bj1 = last - bi1 * nbj;
  Span sp;
  sp.a0 = (first - bi0 * nbj) * T;
  if (bi1 == bi0) {
    sp.la = ((bj1 + 1) * T < d ? (bj1 + 1) * T : d) - sp.a0;
    sp.lb = 0;
  } else {
    sp.la = d - sp.a0;
    sp.lb = (bj1 + 1) * T;  // bj1 < kThreads < nbj: short of the row's end
  }
  sp.b_off = (sp.la + 3) & ~3;
  sp.c_off = sp.b_off + ((sp.lb + 3) & ~3);
  sp.c0 = bi0 * T;
  sp.nc = (bi1 - bi0 + 1) * T;
  return sp;
}

// A thread's share of each staged span sample: the 4 x_j slots [u, u + 4)
// of the buffer row, u = 4 threadIdx.x, nj (0 to 4) of them copied from
// column col on (the x_j slots of a span take at most 4 kThreads floats:
// 512 at T = 4), and, for threadIdx.x < nc, x_i slot threadIdx.x from
// column xi_col. Fixed for the block, so a sample costs a thread one copy
// of 16 bytes where its source is 16-byte aligned, else two of 8 or four
// of 4, with no index arithmetic.
struct SpanCopy {
  int col;
  int nj;
  int xi_col;
  bool xi;
};

__device__ __forceinline__ SpanCopy span_copy(const Span& sp, int row0,
                                              int row_last) {
  const int u = 4 * threadIdx.x;
  SpanCopy cp;
  if (u < sp.b_off) {  // b_off - 4 < la: at least one column
    cp.col = sp.a0 + u;
    cp.nj = sp.la - u < 4 ? sp.la - u : 4;
  } else {
    cp.col = u - sp.b_off;
    const int left = sp.lb - cp.col;
    cp.nj = left < 0 ? 0 : (left < 4 ? left : 4);
  }
  cp.xi = (int)threadIdx.x < sp.nc;
  const int i = sp.c0 + (int)threadIdx.x;
  cp.xi_col = row0 + (i < row_last ? i : row_last);
  return cp;
}

// Stage the span of samples [s0, s0 + n) into buf, row stride ld.
__device__ __forceinline__ void stage_span(float* buf, const float* x,
                                           long long s0, int n, int d, int ld,
                                           const Span& sp,
                                           const SpanCopy& cp) {
  const float* src = x + s0 * d;
  float* dst = buf + 4 * threadIdx.x;
  float* dst_xi = buf + sp.c_off + threadIdx.x;
  for (int s = 0; s < n; ++s, src += d, dst += ld, dst_xi += ld) {
    const float* p = src + cp.col;
    if (cp.nj == 4) {
      const unsigned lo = static_cast<unsigned>(
          reinterpret_cast<unsigned long long>(p));
      if ((lo & 15u) == 0) {
        cp_async16(dst, p);
      } else if ((lo & 7u) == 0) {
        cp_async8(dst, p);
        cp_async8(dst + 2, p + 2);
      } else {
        cp_async4(dst, p);
        cp_async4(dst + 1, p + 1);
        cp_async4(dst + 2, p + 2);
        cp_async4(dst + 3, p + 3);
      }
    } else {
      for (int q = 0; q < cp.nj; ++q) cp_async4(dst + q, p + q);
    }
    if (cp.xi) cp_async4(dst_xi, src + cp.xi_col);
  }
}

// The partial sums of one block: its split of one slab, its 128 pair blocks.
// kSpan: the block stages only the columns its pair blocks read
// (block_span), for launches with more than kThreads pair blocks a row
// block; otherwise whole sample rows. The terms, their order and the sums
// are the same either way.
template <int T, bool kSpan>
__device__ __forceinline__ void pair_partials(
    const float* __restrict__ x, const float* __restrict__ c,
    float* __restrict__ part1, float* __restrict__ part2, int d, int row0,
    int rows, const SlabPlan& plan, int stage_n, int groups) {
  extern __shared__ __align__(16) float smem[];  // 2 x stage_n x ld
  const int ld = kSpan ? span_ld<T>() : (d + 3) & ~3;
  const int z = blockIdx.x / groups;
  const int g = blockIdx.x - z * groups;

  // This block's batch element: its own X, C and partials.
  const long long elem = blockIdx.y;
  const long long n_z =
      (long long)plan.n_full * plan.full_splits + plan.tail_splits;
  x += elem * ((long long)plan.n_full * plan.slab + plan.tail) * d;
  c += elem * d * d;
  part1 += elem * n_z * rows * d;
  part2 += elem * n_z * rows * d;

  // This block's sample range: split k of one slab.
  const int full_z = plan.n_full * plan.full_splits;
  long long base;
  long long len;
  int k;
  int per;
  if (z < full_z) {
    const int slab = z / plan.full_splits;
    k = z - slab * plan.full_splits;
    base = (long long)slab * plan.slab;
    len = plan.slab;
    per = plan.full_per;
  } else {
    k = z - full_z;
    base = (long long)plan.n_full * plan.slab;
    len = plan.tail;
    per = plan.tail_per;
  }
  const long long s_begin = base + (long long)k * per * kChunk;
  const long long s_stop = s_begin + (long long)per * kChunk;
  const long long s_end = s_stop < base + len ? s_stop : base + len;
  const long long n_samples = s_end - s_begin;

  // This thread's T x T pair block.
  const int nbj = (d + T - 1) / T;
  const int nbi = (rows + T - 1) / T;
  const int pb = g * kThreads + threadIdx.x;
  const bool active = pb < nbi * nbj;
  const int bi = active ? pb / nbj : 0;
  const int bj = active ? pb - bi * nbj : 0;
  const int i0 = bi * T;
  const int j0 = bj * T;

  PairCoef coef[T][T];
  int xi_col[T];  // shared-memory column of x_i (padded rows: any valid row)
#pragma unroll
  for (int r = 0; r < T; ++r) {
    const int i = i0 + r;
    xi_col[r] = row0 + (i < rows ? i : rows - 1);
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const int j = j0 + q;
      const float cij = (active && i < rows && j < d)
          ? c[(long long)(row0 + i) * d + j] : 0.0f;
      coef[r][q] = moment_terms::pair_coef(cij);
    }
  }
  // Shared-memory column of x_j: j0 in a whole row; in a span, j0's place
  // in the first piece or the wrapped one.
  int xj_col = j0;
  Span sp{};
  SpanCopy cp{};
  if constexpr (kSpan) {
    sp = block_span<T>(g * kThreads, nbi * nbj, nbj, d);
    cp = span_copy(sp, row0, rows - 1);
    const int bi0 = sp.c0 / T;
    xj_col = bi == bi0 ? j0 - sp.a0 : sp.b_off + j0;
#pragma unroll
    for (int r = 0; r < T; ++r) xi_col[r] = sp.c_off + (bi - bi0) * T + r;
  }

  float* const buf0 = smem;
  float* const buf1 = smem + stage_n * ld;
  // Zero the pad columns that pair blocks past d read, in both buffers;
  // cp.async never writes them: [d, ld) of a whole row, [la, b_off) of a
  // span.
  if constexpr (kSpan) {
    const int pad = sp.b_off - sp.la;
    for (int e = threadIdx.x; e < 2 * stage_n * pad; e += kThreads) {
      const int row = e / pad;
      smem[row * ld + sp.la + (e - row * pad)] = 0.0f;
    }
  } else if (ld > d) {
    for (int e = threadIdx.x; e < 2 * stage_n * (ld - d); e += kThreads) {
      const int row = e / (ld - d);
      smem[row * ld + d + (e - row * (ld - d))] = 0.0f;
    }
  }
  const int s_first = threadIdx.x / d;
  const int v_first = threadIdx.x - s_first * d;
  const int ds = kThreads / d;
  const int dv = kThreads - ds * d;

  float acc1[T][T], acc2[T][T], sub1[T][T], sub2[T][T];
#pragma unroll
  for (int r = 0; r < T; ++r) {
#pragma unroll
    for (int q = 0; q < T; ++q) {
      acc1[r][q] = acc2[r][q] = sub1[r][q] = sub2[r][q] = 0.0f;
    }
  }

  const long long n_stages = (n_samples + stage_n - 1) / stage_n;
  const int stages_per_chunk = kChunk / stage_n;
  const int n_first = (int)(n_samples < stage_n ? n_samples : stage_n);
  if constexpr (kSpan) {
    stage_span(buf0, x, s_begin, n_first, d, ld, sp, cp);
  } else {
    stage_rows(buf0, x, s_begin, n_first, d, ld, s_first, v_first, ds, dv);
  }
  cp_async_commit();
  for (long long st = 0; st < n_stages; ++st) {
    const long long s0 = s_begin + st * stage_n;
    if (st + 1 < n_stages) {
      const long long left = s_end - (s0 + stage_n);
      const int n = (int)(left < stage_n ? left : stage_n);
      float* const next = (st & 1) ? buf0 : buf1;
      if constexpr (kSpan) {
        stage_span(next, x, s0 + stage_n, n, d, ld, sp, cp);
      } else {
        stage_rows(next, x, s0 + stage_n, n, d, ld, s_first, v_first, ds,
                   dv);
      }
    }
    cp_async_commit();  // possibly empty: keeps "all but the last" exact
    cp_async_wait_prior();
    __syncthreads();
    if (active) {
      const float* b = (st & 1) ? buf1 : buf0;
      const long long left = s_end - s0;
      const int n = (int)(left < stage_n ? left : stage_n);
      for (int s = 0; s < n; ++s) {
        const float* row = b + s * ld;
        float xj[T];
        load_cols<T>(row + xj_col, xj);
        float xi[T];
#pragma unroll
        for (int r = 0; r < T; ++r) xi[r] = row[xi_col[r]];
#pragma unroll
        for (int r = 0; r < T; ++r) {
#pragma unroll
          for (int q = 0; q < T; ++q) {
            moment_terms::add_term(xi[r], xj[q], coef[r][q], sub1[r][q],
                                   sub2[r][q]);
          }
        }
      }
      if ((st + 1) % stages_per_chunk == 0 || st + 1 == n_stages) {
#pragma unroll
        for (int r = 0; r < T; ++r) {
#pragma unroll
          for (int q = 0; q < T; ++q) {
            acc1[r][q] = __fadd_rn(acc1[r][q], sub1[r][q]);
            acc2[r][q] = __fadd_rn(acc2[r][q], sub2[r][q]);
            sub1[r][q] = sub2[r][q] = 0.0f;
          }
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < T; ++r) {
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const int i = i0 + r;
      const int j = j0 + q;
      if (i < rows && j < d) {
        const long long o = ((long long)z * rows + i) * d + j;
        part1[o] = acc1[r][q];
        part2[o] = acc2[r][q];
      }
    }
  }
}

// Whole sample rows staged.
template <int T>
__global__ void __launch_bounds__(kThreads)
pair_partials_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     float* __restrict__ part1, float* __restrict__ part2,
                     int d, int row0, int rows, SlabPlan plan, int stage_n,
                     int groups) {
  pair_partials<T, false>(x, c, part1, part2, d, row0, rows, plan, stage_n,
                          groups);
}

// Each block's span staged (more than kThreads pair blocks a row block);
// three blocks an SM, as the whole-row 4 x 4 instance gets at 168
// registers.
template <int T>
__global__ void __launch_bounds__(kThreads, 3)
pair_partials_span_kernel(const float* __restrict__ x,
                          const float* __restrict__ c,
                          float* __restrict__ part1,
                          float* __restrict__ part2, int d, int row0,
                          int rows, SlabPlan plan, int stage_n, int groups) {
  pair_partials<T, true>(x, c, part1, part2, d, row0, rows, plan, stage_n,
                         groups);
}

// out = scale * (slab sums added in slab order), each slab sum its splits
// added in order from 0: the per-slab launches' results added in order.
// blockIdx.y is the batch element.
__global__ void reduce_slabs_kernel(const float* __restrict__ part1,
                                    const float* __restrict__ part2,
                                    float* __restrict__ out1,
                                    float* __restrict__ out2, long long n,
                                    int n_full, int full_splits,
                                    int tail_splits, float scale) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int n_slabs = n_full + (tail_splits > 0 ? 1 : 0);
  const long long elem = blockIdx.y;
  const long long n_z = (long long)n_full * full_splits + tail_splits;
  part1 += elem * n_z * n;
  part2 += elem * n_z * n;
  out1 += elem * n;
  out2 += elem * n;
  float t1 = 0.0f;
  float t2 = 0.0f;
  long long z = 0;
  for (int slab = 0; slab < n_slabs; ++slab) {
    const int splits = slab < n_full ? full_splits : tail_splits;
    float a1 = 0.0f;
    float a2 = 0.0f;
    for (int k = 0; k < splits; ++k, ++z) {  // fixed order: deterministic
      a1 = __fadd_rn(a1, part1[z * n + idx]);
      a2 = __fadd_rn(a2, part2[z * n + idx]);
    }
    t1 = slab == 0 ? a1 : __fadd_rn(t1, a1);
    t2 = slab == 0 ? a2 : __fadd_rn(t2, a2);
  }
  out1[idx] = __fmul_rn(t1, scale);
  out2[idx] = __fmul_rn(t2, scale);
}

template <int T, bool kSpan>
cudaError_t launch_partials(const float* x, const float* c, float* part1,
                            float* part2, int d, int row0, int rows,
                            const SlabPlan& plan, int stage_n, int batch,
                            cudaStream_t stream) {
  const long long pair_blocks =
      (long long)((rows + T - 1) / T) * ((d + T - 1) / T);
  const long long groups = (pair_blocks + kThreads - 1) / kThreads;
  const long long n_z =
      (long long)plan.n_full * plan.full_splits + plan.tail_splits;
  if (groups * n_z > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // A span covers at most two row blocks only past kThreads pair blocks a
  // row block.
  if (kSpan && (d + T - 1) / T <= kThreads) return cudaErrorInvalidValue;
  const auto kernel =
      kSpan ? &pair_partials_span_kernel<T> : &pair_partials_kernel<T>;
  const int ld = kSpan ? span_ld<T>() : (d + 3) & ~3;
  const size_t smem = 2ull * stage_n * ld * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)(groups * n_z), (unsigned)batch);
  kernel<<<grid, kThreads, smem, stream>>>(x, c, part1, part2, d, row0, rows,
                                           plan, stage_n, (int)groups);
  return cudaGetLastError();
}

template <int T>
cudaError_t launch_staged(int span, const float* x, const float* c,
                          float* part1, float* part2, int d, int row0,
                          int rows, const SlabPlan& plan, int stage_n,
                          int batch, cudaStream_t stream) {
  return span ? launch_partials<T, true>(x, c, part1, part2, d, row0, rows,
                                         plan, stage_n, batch, stream)
              : launch_partials<T, false>(x, c, part1, part2, d, row0, rows,
                                          plan, stage_n, batch, stream);
}

}  // namespace

// Partial moment sums of rows [row0, row0 + rows) against all d columns over
// the slabs of the plan, for each of `batch` datasets: x is (batch, m, d) and
// c (batch, d, d), m = n_full * slab + tail; part1/part2 are (batch,
// n_full * full_splits + tail_splits, rows, d), one (rows, d) slice per
// split, slab by slab. `tile` is T (4, 2 or 1); `span` (0 or 1) stages each
// block's span rather than whole rows, only where ceil(d / T) > 128
// (pairwise_stats.staged_columns); `stage_n` samples per shared-memory
// stage divides 128.
extern "C" int pairwise_moment_partials(
    const float* x, const float* c, float* part1, float* part2, int d,
    int row0, int rows, long long slab, int n_full, int full_splits,
    int full_per, long long tail, int tail_splits, int tail_per, int tile,
    int span, int stage_n, int batch, cudaStream_t stream) {
  if (stage_n < 1 || stage_n > kChunk || kChunk % stage_n != 0 || d < 1 ||
      rows < 1 || n_full < 1 || full_splits < 1 || full_per < 1 ||
      (tail > 0) != (tail_splits > 0) || batch < 1 || batch > 65535 ||
      (span != 0 && span != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const SlabPlan plan{slab, tail, n_full, full_splits, full_per, tail_splits,
                      tail_per};
  switch (tile) {
    case 4:
      return (int)launch_staged<4>(span, x, c, part1, part2, d, row0, rows,
                                   plan, stage_n, batch, stream);
    case 2:
      return (int)launch_staged<2>(span, x, c, part1, part2, d, row0, rows,
                                   plan, stage_n, batch, stream);
    case 1:
      return (int)launch_staged<1>(span, x, c, part1, part2, d, row0, rows,
                                   plan, stage_n, batch, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out = scale * sum over slabs (in order) of sum over the slab's splits (in
// order) of part, for each of `batch` datasets; part is (batch,
// n_full * full_splits + tail_splits, n), out (batch, n).
extern "C" int pairwise_moment_reduce(const float* part1, const float* part2,
                                      float* out1, float* out2, long long n,
                                      int n_full, int full_splits,
                                      int tail_splits, float scale, int batch,
                                      cudaStream_t stream) {
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 blocks((unsigned)((n + threads - 1) / threads), (unsigned)batch);
  reduce_slabs_kernel<<<blocks, threads, 0, stream>>>(
      part1, part2, out1, out2, n, n_full, full_splits, tail_splits, scale);
  return (int)cudaGetLastError();
}
