// Pairwise residual-entropy moment sums for DirectLiNGAM, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pairwise_stats.py::_kernel
// under both of its launches, through two wrappers in
// repro_torch/kernels/pairwise_stats.py over the same launchers:
//   * pairwise_moments_pallas (B1): wrapper pairwise_moments, all d rows,
//     reduce scale 1/m;
//   * pairwise_moment_sums_rows (B2): wrapper pairwise_moment_sums_rows, a
//     row tile, reduce scale 1 (sums), launched once per sample slab by the
//     chunked streaming path.
// For every pair (i, j) of a row tile [row0, row0 + rows) against all d
// columns:
//
//   u_ij(s) = (x_i(s) - C_ij x_j(s)) / sqrt(max(1 - C_ij^2, 1e-12))
//   S1_ij   = sum_s log cosh u_ij(s)      = |u| + log1p(exp(-2|u|)) - log 2
//   S2_ij   = sum_s u_ij(s) exp(-u_ij(s)^2 / 2)
//
// X is sample-major (m, d), row-major fp32, exactly as the ordering step holds
// it: no padded or transposed copy is made. Samples at index >= m are masked
// by index.
//
// What bounds it on this card: each (pair, sample) term costs two exp and one
// log1p, so the kernel is bound by transcendental (special-function-unit and
// the FP32 polynomial work around it) throughput, not by bytes (X is read
// from L2 once per tile pair) and not by matrix products, so the tensor cores
// do not apply. Integrands use full-precision expf/log1pf (no fast math).
//
// Work split and summation order:
//   * one thread owns one (i, j) pair; a 16x16 block owns a pair tile;
//   * the block walks its sample range in 128-sample chunks, staging
//     x_i[128 x 16] and x_j[128 x 16] in shared memory (16 KB);
//   * each thread adds the chunk's 128 terms in sequence into a sub-sum, then
//     adds the sub-sum into its running total: the reference's fixed
//     ACCUM_CHUNK = 128 grouping (src/repro/kernels/pairwise_stats.py
//     _accumulate);
//   * split-m: at d = 100 there are only 7 x 7 = 49 pair tiles, under half of
//     the 132 SMs, and Hopper blocks cannot carry a sum across sequential grid
//     steps as the TPU grid did. So the grid is (tiles_j, tiles_i, n_split):
//     split k covers chunks [k * chunks_per_split, (k + 1) * chunks_per_split)
//     and writes its partial sums to scratch[k]. A second kernel adds the
//     splits in fixed order k = 0, 1, ... and scales. No atomics, so the result
//     is bit-identical from run to run. n_split is a function of m alone,
//     computed by the Python wrapper (split_plan): 32 splits give 1568 blocks
//     at d = 100 (over 11 per SM). Because it does not depend on d, a pair's
//     sums are bit-identical at every buffer width, so the staged-compaction
//     ordering sees the same moments as the masked scan.
//
// Both launchers return cudaGetLastError() so that the caller can raise when a
// launch was refused.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;    // pair tile edge: 16 x 16 threads
constexpr int kChunk = 128;  // samples per sub-sum (ACCUM_CHUNK)
constexpr float kLog2 = 0.6931471805599453f;
constexpr float kEps = 1e-12f;

__global__ void __launch_bounds__(kTile * kTile)
pair_partials_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     float* __restrict__ part1, float* __restrict__ part2,
                     long long m, int d, int row0, int rows,
                     int chunks_per_split) {
  // [sample][variable]: threads with neighbouring tj read neighbouring banks.
  __shared__ float xi_s[kChunk][kTile];
  __shared__ float xj_s[kChunk][kTile];

  const int tj = threadIdx.x;
  const int ti = threadIdx.y;
  const int t = ti * kTile + tj;
  const int i_base = blockIdx.y * kTile;  // row index within the tile rows
  const int j_base = blockIdx.x * kTile;
  const int i = i_base + ti;
  const int j = j_base + tj;
  const int split = blockIdx.z;

  float cij = 0.0f;
  if (i < rows && j < d) cij = c[(long long)(row0 + i) * d + j];
  const float inv = 1.0f / sqrtf(fmaxf(1.0f - cij * cij, kEps));

  const long long s_begin = (long long)split * chunks_per_split * kChunk;
  const long long s_stop = s_begin + (long long)chunks_per_split * kChunk;
  const long long s_end = s_stop < m ? s_stop : m;

  float acc1 = 0.0f;
  float acc2 = 0.0f;
  for (long long s0 = s_begin; s0 < s_end; s0 += kChunk) {
    // Stage the chunk: each sample row of a tile is 16 consecutive floats.
    for (int k = t; k < kChunk * kTile; k += kTile * kTile) {
      const int v = k % kTile;
      const int s = k / kTile;
      const long long gs = s0 + s;
      const bool in_m = gs < s_end;
      const int iv = i_base + v;
      const int jv = j_base + v;
      xi_s[s][v] = (in_m && iv < rows) ? x[gs * d + row0 + iv] : 0.0f;
      xj_s[s][v] = (in_m && jv < d) ? x[gs * d + jv] : 0.0f;
    }
    __syncthreads();

    const long long left = s_end - s0;
    const int n = left < kChunk ? (int)left : kChunk;
    float sub1 = 0.0f;
    float sub2 = 0.0f;
    for (int s = 0; s < n; ++s) {
      const float u = (xi_s[s][ti] - cij * xj_s[s][tj]) * inv;
      const float au = fabsf(u);
      sub1 += au + log1pf(expf(-2.0f * au)) - kLog2;
      sub2 += u * expf(-0.5f * u * u);
    }
    acc1 += sub1;
    acc2 += sub2;
    __syncthreads();
  }

  if (i < rows && j < d) {
    const long long o = ((long long)split * rows + i) * d + j;
    part1[o] = acc1;
    part2[o] = acc2;
  }
}

__global__ void reduce_splits_kernel(const float* __restrict__ part1,
                                     const float* __restrict__ part2,
                                     float* __restrict__ out1,
                                     float* __restrict__ out2, int n_split,
                                     long long n, float scale) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float a1 = 0.0f;
  float a2 = 0.0f;
  for (int k = 0; k < n_split; ++k) {  // fixed order: deterministic
    a1 += part1[(long long)k * n + idx];
    a2 += part2[(long long)k * n + idx];
  }
  out1[idx] = a1 * scale;
  out2[idx] = a2 * scale;
}

}  // namespace

// Partial moment sums of rows [row0, row0 + rows) against all d columns:
// part1/part2 are (n_split, rows, d).
extern "C" int pairwise_moment_partials(const float* x, const float* c,
                                        float* part1, float* part2,
                                        long long m, int d, int row0,
                                        int rows, int chunks_per_split,
                                        int n_split, cudaStream_t stream) {
  const dim3 block(kTile, kTile);
  const dim3 grid((d + kTile - 1) / kTile, (rows + kTile - 1) / kTile,
                  n_split);
  pair_partials_kernel<<<grid, block, 0, stream>>>(
      x, c, part1, part2, m, d, row0, rows, chunks_per_split);
  return (int)cudaGetLastError();
}

// out = scale * sum_k part[k], k in order; part is (n_split, n), out is (n,).
extern "C" int pairwise_moment_reduce(const float* part1, const float* part2,
                                      float* out1, float* out2, int n_split,
                                      long long n, float scale,
                                      cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  reduce_splits_kernel<<<blocks, threads, 0, stream>>>(
      part1, part2, out1, out2, n_split, n, scale);
  return (int)cudaGetLastError();
}
