// The pairwise residual-entropy integrands, shared by pairwise_moments.cu
// (kernels B1, B2) and fused_moments.cu (kernel B3).
//
// For a pair (i, j) with correlation C_ij and one sample s:
//
//   u       = (x_i - C_ij x_j) / sqrt(max(1 - C_ij^2, 1e-12))
//   term 1  = log cosh u        = |u| + log(1 + exp(-2|u|)) - log 2
//   term 2  = u exp(-u^2 / 2)
//
// written for the special-function unit (MUFU) in exp2/log2 form, with
// exactly three MUFU ops a term:
//
//   t       = 2^(-2 log2(e) |u|)                      ex2.approx.ftz
//   term 1  = |u| + ln 2 * log2((1 + t) / 2)          lg2.approx.ftz
//   term 2  = u * 2^(-log2(e) / 2 * u^2)              ex2.approx.ftz
//
// (1 + t) / 2 is formed by one fused multiply-add, 0.5 t + 0.5, which is
// exact scaling of the rounded 1 + t; log2 of it folds the "- log 2". The
// per-pair factors are folded once, u = a x_i - b x_j with a = inv and
// b = C_ij inv, so a term costs one multiply and one fma for u. Every
// float operation is pinned with a rounding intrinsic (__fmul_rn, __fmaf_rn,
// __fadd_rn, ...), which the compiler never contracts or reorders, so any
// kernel that calls these functions for a pair in the same sample order
// produces the same bits, whatever its tiling. ex2/lg2 with .ftz flush
// denormal results to 0 (exp(-2|u|) underflows only where log1p of it is 0
// in float32 anyway). Samples past a range's end are never passed in, so
// nothing relies on the terms being 0 at u = 0.
//
// The MUFU ops are the bound of every kernel that includes this header: 16
// per clock per SM on Hopper, so 3/16 of a clock per (pair, sample) term.
// The other nine float ops a term run on the FMA pipe, 128 per clock per SM.

#pragma once

#include <cuda_runtime.h>

namespace moment_terms {

constexpr float kEps = 1e-12f;
constexpr float kLn2 = 0.693147180559945309f;
constexpr float kNeg2Log2e = -2.88539008177792681f;     // -2 log2(e)
constexpr float kNegHalfLog2e = -0.721347520444481703f;  // -log2(e) / 2

// u = a x_i - b x_j for one pair.
struct PairCoef {
  float a;
  float b;
};

__device__ __forceinline__ PairCoef pair_coef(float c) {
  const float v = fmaxf(__fsub_rn(1.0f, __fmul_rn(c, c)), kEps);
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(v));
  return {inv, __fmul_rn(c, inv)};
}

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float lg2_approx(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Adds the two integrands of one (pair, sample) term to the sub-sums s1, s2.
__device__ __forceinline__ void add_term(float xi, float xj, PairCoef k,
                                         float& s1, float& s2) {
  const float u = __fmaf_rn(-k.b, xj, __fmul_rn(k.a, xi));
  const float au = fabsf(u);
  const float t = ex2_approx(__fmul_rn(kNeg2Log2e, au));
  const float l = lg2_approx(__fmaf_rn(0.5f, t, 0.5f));
  s1 = __fadd_rn(s1, __fmaf_rn(kLn2, l, au));
  const float g = ex2_approx(__fmul_rn(kNegHalfLog2e, __fmul_rn(u, u)));
  s2 = __fmaf_rn(u, g, s2);
}

}  // namespace moment_terms
