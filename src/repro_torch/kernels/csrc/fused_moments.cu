// Fused standardize + pairwise residual-entropy moment sums, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_stats.py::
// _fused_kernel as launched by fused_moment_sums (kernel B3); its wrapper is
// repro_torch/kernels/fused_stats.py::fused_moment_sums, reached through
// ops.fused_moment_rows. It computes the sums of pairwise_moments.cu (B1/B2)
// from *raw* data: each staged value is standardized in registers as
//
//   z_v(s) = (x_v(s) - mu[v]) * rstd[v]          (fp32, no fused multiply-add)
//
// and then, for every pair (i, j) of the row tile [row0, row0 + rows) against
// all d columns,
//
//   u_ij(s) = (z_i(s) - C_ij z_j(s)) / sqrt(max(1 - C_ij^2, 1e-12))
//   S1_ij   = sum_s log cosh u_ij(s)
//   S2_ij   = sum_s u_ij(s) exp(-u_ij(s)^2 / 2)
//
// with the integrands of moment_terms.cuh, the header B1/B2 include too.
//
// X is the raw sample-major (m, d) matrix, row-major, float32 or bfloat16
// (a template over the input type, converted with __bfloat162float): the
// standardized copy is never written to device memory, and a bfloat16 X
// halves the bytes read. Samples at index >= m are masked by index, so the
// reference's zero-padded tail is never formed.
//
// What bounds it on this card: the same special-function work as B1 (three
// MUFU ops per (pair, sample) term), so bfloat16 input halves the bytes but
// not the special-function work; the bytes are far below the bound either way.
//
// Work split: one thread per pair, 16x16 pair tiles, the chunk staged in
// shared memory with plain loads. Summation order is B1's (see
// pairwise_moments.cu): 128-sample sub-sums added into a running total, the
// sample axis split over n_split blocks (a function of m alone, chosen by the
// Python wrapper) whose partials a second kernel adds in fixed order. The
// integrands and pair factors are moment_terms.cuh's, with every float
// operation pinned, so on the same standardized values B3 gives B1's sums bit
// for bit whatever the two kernels' tilings. Both launchers return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "moment_terms.cuh"

namespace {

constexpr int kTile = 16;    // pair tile edge: 16 x 16 threads
constexpr int kChunk = 128;  // samples per sub-sum (ACCUM_CHUNK)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kTile * kTile)
fused_partials_kernel(const T* __restrict__ x, const float* __restrict__ mu,
                      const float* __restrict__ rstd,
                      const float* __restrict__ c, float* __restrict__ part1,
                      float* __restrict__ part2, long long m, int d, int row0,
                      int rows, int chunks_per_split) {
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
  const moment_terms::PairCoef coef = moment_terms::pair_coef(cij);

  // The staging loop steps k by kTile * kTile, a multiple of kTile, so thread
  // t always stages variable v = t % kTile: its constants are loaded once.
  const int v = t % kTile;
  const int iv = i_base + v;
  const int jv = j_base + v;
  const bool i_ok = iv < rows;
  const bool j_ok = jv < d;
  const float mu_i = i_ok ? mu[row0 + iv] : 0.0f;
  const float rs_i = i_ok ? rstd[row0 + iv] : 0.0f;
  const float mu_j = j_ok ? mu[jv] : 0.0f;
  const float rs_j = j_ok ? rstd[jv] : 0.0f;

  const long long s_begin = (long long)split * chunks_per_split * kChunk;
  const long long s_stop = s_begin + (long long)chunks_per_split * kChunk;
  const long long s_end = s_stop < m ? s_stop : m;

  float acc1 = 0.0f;
  float acc2 = 0.0f;
  for (long long s0 = s_begin; s0 < s_end; s0 += kChunk) {
    // Stage and standardize the chunk: round after the subtraction and after
    // the product, as the plain version does (no contraction into an fma).
    for (int k = t; k < kChunk * kTile; k += kTile * kTile) {
      const int s = k / kTile;
      const long long gs = s0 + s;
      const bool in_m = gs < s_end;
      xi_s[s][v] = (in_m && i_ok)
          ? __fmul_rn(__fsub_rn(to_float(x[gs * d + row0 + iv]), mu_i), rs_i)
          : 0.0f;
      xj_s[s][v] = (in_m && j_ok)
          ? __fmul_rn(__fsub_rn(to_float(x[gs * d + jv]), mu_j), rs_j)
          : 0.0f;
    }
    __syncthreads();

    const long long left = s_end - s0;
    const int n = left < kChunk ? (int)left : kChunk;
    float sub1 = 0.0f;
    float sub2 = 0.0f;
    for (int s = 0; s < n; ++s) {
      moment_terms::add_term(xi_s[s][ti], xj_s[s][tj], coef, sub1, sub2);
    }
    acc1 = __fadd_rn(acc1, sub1);
    acc2 = __fadd_rn(acc2, sub2);
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
                                     long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float a1 = 0.0f;
  float a2 = 0.0f;
  for (int k = 0; k < n_split; ++k) {  // fixed order: deterministic
    a1 = __fadd_rn(a1, part1[(long long)k * n + idx]);
    a2 = __fadd_rn(a2, part2[(long long)k * n + idx]);
  }
  out1[idx] = a1;
  out2[idx] = a2;
}

template <typename T>
int launch_partials(const void* x, const float* mu, const float* rstd,
                    const float* c, float* part1, float* part2, long long m,
                    int d, int row0, int rows, int chunks_per_split,
                    int n_split, cudaStream_t stream) {
  const dim3 block(kTile, kTile);
  const dim3 grid((d + kTile - 1) / kTile, (rows + kTile - 1) / kTile,
                  n_split);
  fused_partials_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), mu, rstd, c, part1, part2, m, d, row0, rows,
      chunks_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Partial moment sums of rows [row0, row0 + rows) against all d columns, from
// raw X (float32, or bfloat16 when bf16 != 0): part1/part2 are
// (n_split, rows, d).
extern "C" int fused_moment_partials(const void* x, int bf16, const float* mu,
                                     const float* rstd, const float* c,
                                     float* part1, float* part2, long long m,
                                     int d, int row0, int rows,
                                     int chunks_per_split, int n_split,
                                     cudaStream_t stream) {
  if (bf16) {
    return launch_partials<__nv_bfloat16>(x, mu, rstd, c, part1, part2, m, d,
                                          row0, rows, chunks_per_split,
                                          n_split, stream);
  }
  return launch_partials<float>(x, mu, rstd, c, part1, part2, m, d, row0,
                                rows, chunks_per_split, n_split, stream);
}

// out = sum_k part[k], k in order; part is (n_split, n), out is (n,).
extern "C" int fused_moment_reduce(const float* part1, const float* part2,
                                   float* out1, float* out2, int n_split,
                                   long long n, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  reduce_splits_kernel<<<blocks, threads, 0, stream>>>(part1, part2, out1,
                                                       out2, n_split, n);
  return (int)cudaGetLastError();
}
