// The closed-form costs of the card's kernels general_train.cu (B3) and
// fused_update.cu (B5): cost and dc of one element of F for each cost kind,
// in fp32 with the precise expf, log1pf and erff (no fast math), so that both
// kernels can be held to their plain version, ops/cuda/cost_forms.py. B3
// takes the cost and dc of every kind; B5 instantiates the kinds that
// fused_update.KINDS lists and drops the cost. Which cost and link take which
// kind is closed_forms.py's rule.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace plst {
namespace costs {

constexpr int GH_NODES = 16;

// the order of COST_KINDS in ops/cuda/cost_forms.py
enum CostKind {
  GAUSSIAN = 0,
  BERNOULLI_SIGMOID = 1,
  BERNOULLI_SIGMOID_SMOOTHED = 2,
  BERNOULLI_PROBIT = 3,
  POISSON_SQUARE = 4,
  STUDENT_T = 5,
  MULTIMODAL_IDENTITY = 6,
};

struct CostParams {
  float p0, p1, p2;  // the cost kind's scalars (ops/cuda/cost_forms.py)
  float m0;          // prior mean constant: F = m0 + P U
  float node[GH_NODES];    // sqrt(2) x hermgauss(16) nodes
  float weight[GH_NODES];  // hermgauss(16) weights / sqrt(pi)
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// logaddexp(x, 0), the JAX softplus
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Cost and dc of one element, as _tile_cost_and_dc (general_train.py:71-160);
// masked elements give 0 and 0.
template <int KIND>
__device__ __forceinline__ void cost_and_dc(float f, float y, float aux, bool valid, float jitter,
                                            const CostParams& cp, float& cost, float& dc) {
  // the Bernoulli kinds' clip: the link's jitter, floored dtype-aware (1 - 1e-10
  // rounds to 1 in fp32)
  const float jit = fmaxf(jitter, FLT_EPSILON);
  if (KIND == GAUSSIAN) {
    const float err = f - y;
    cost = (0.5f / cp.p0) * (err * err);
    dc = err / cp.p0;
  } else if (KIND == BERNOULLI_SIGMOID) {
    const float p = fminf(fmaxf(sigmoid(f), jit), 1.0f - jit);
    cost = -(y * logf(p) + (1.0f - y) * logf(1.0f - p));
    dc = p - y;
  } else if (KIND == BERNOULLI_SIGMOID_SMOOTHED) {
    // E_z[softplus(f + s z)] - y f and E_z[sigmoid(f + s z)] - y, node by node
    cost = -y * f;
    dc = -y;
#pragma unroll
    for (int q = 0; q < GH_NODES; ++q) {
      const float zq = f + cp.node[q] * aux;
      cost = cost + cp.weight[q] * softplus(zq);
      dc = dc + cp.weight[q] * sigmoid(zq);
    }
  } else if (KIND == BERNOULLI_PROBIT) {
    // d/df of the clipped cross-entropy: 0 where the clip saturates
    const float cdf = 0.5f * (1.0f + erff(f * 0.70710678118654752f));
    const bool in_range = cdf > jit && cdf < 1.0f - jit;
    const float p = fminf(fmaxf(cdf, jit), 1.0f - jit);
    const float pdf = expf(-0.5f * (f * f)) * 0.39894228040143268f;  // 1 / sqrt(2 pi)
    cost = -(y * logf(p) + (1.0f - y) * logf(1.0f - p));
    dc = in_range ? pdf * (p - y) / (p * (1.0f - p)) : 0.0f;
  } else if (KIND == POISSON_SQUARE) {
    // guard the masked elements before the log and the divide
    const float f_safe = valid ? f : 1.0f;
    cost = -2.0f * y * logf(fabsf(f_safe)) + f_safe * f_safe;
    dc = -2.0f * y / f_safe + 2.0f * f_safe;
  } else if (KIND == STUDENT_T) {
    const float err = f - y;
    const float denom = cp.p0 * (cp.p1 * cp.p1);
    cost = 0.5f * (cp.p0 + 1.0f) * log1pf((err * err) / denom);
    dc = (cp.p0 + 1.0f) * err / (denom + err * err);
  } else {  // MULTIMODAL_IDENTITY: two-mode mixture, responsibility-weighted pull
    const float sigma2 = cp.p0 * cp.p0;
    const float err = y - f;
    const float b = logf(cp.p2) - log1pf(-cp.p2);
    const float delta = -(cp.p1 * err + 0.5f * cp.p1 * cp.p1) / sigma2;
    const float log_norm = 0.5f * logf(6.28318530717958648f * sigma2);
    cost = 0.5f * (err * err) / sigma2 + log_norm - log1pf(-cp.p2) - softplus(b + delta);
    dc = -(err + sigmoid(b + delta) * cp.p1) / sigma2;
  }
  if (!valid) {
    cost = 0.0f;
    dc = 0.0f;
  }
}

}  // namespace costs
}  // namespace plst
