// crms_grid: Eq. (8) utility of a (B, M) grid of candidate allocations.
//
// Replaces the Pallas TPU kernel repro/kernels/crms_grid.py::crms_grid_eval
// (body _crms_kernel). Per (candidate b, app i) lane it evaluates Eq. (1)
// latency d = k1/(1-e^{-k2 c}) + e^{k3/m}, the service rate mu = 1000/(x̄ d),
// the Erlang-C response time Ws (P0 head as a streaming logsumexp over
// k < MAX_N = 128, log n! by Stirling, ws = 1e9 when rho >= 1) and the
// utility term alpha*Ws + beta*span*n*c/R_cpu/lam. per_app != 0 writes the
// (B, M) terms; per_app == 0 writes the (B,) row sums.
//
// Design: one warp per candidate row; the 32 lanes stride over the apps,
// each lane runs the k-loop for its app in registers, and the row sum is a
// warp-shuffle reduction (no atomics, fixed summation order). The ragged app
// edge is masked by the loop bound, so no app padding is needed.
//
// Bound: at the grid-seeding shape (<= 72 rows x 64 apps, ~74 KB moved) the
// launch dominates. At a search-sized batch, e.g. (20000, 64) in sum mode
// (~15 MB moved), the 3 transcendental operations per k step (a log and two
// exps, 127 steps per lane, ~5e8 in all) bound it, not the bytes.
//
// float32 throughout, as the TPU kernel. Build without --use_fast_math (the
// tolerances assume the accurate expf/logf) and with --fmad=false, so the
// arithmetic rounds operation by operation as the plain torch version
// (repro_torch/kernels/ref.py::crms_grid_plain) does.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kWarpsPerBlock = 8;
constexpr float kHalfLog2Pi = 0.91893853320467274178f;
constexpr float kWsUnstable = 1e9f;

// NaN-propagating max/min, as torch.maximum / torch.clamp.
__device__ __forceinline__ float max_nan(float x, float y) {
  return (isnan(x) || isnan(y)) ? NAN : fmaxf(x, y);
}

__device__ __forceinline__ float min_nan(float x, float y) {
  return (isnan(x) || isnan(y)) ? NAN : fminf(x, y);
}

__device__ __forceinline__ float logaddexp(float x, float y) {
  float delta = x - y;
  if (isnan(delta)) return x + y;
  return max_nan(x, y) + log1pf(expf(-fabsf(delta)));
}

__device__ float utility_term(float k1, float k2, float k3, float lam, float xbar,
                              float n, float c, float m, float caps_cpu,
                              float power_span, float alpha, float beta) {
  float d_ms = k1 / (1.0f - expf(-k2 * c)) + expf(k3 / m);
  float mu = 1000.0f / (xbar * d_ms);
  float a = lam / mu;
  float rho = lam / (n * mu);
  float rho_s = min_nan(rho, 1.0f - 1e-6f);
  float log_a = logf(a);

  // log sum_{k=0}^{n-1} a^k/k!: running max, rescaled running sum, log k!
  float run_max = 0.0f;
  float run_sum = 1.0f;
  float log_fact = 0.0f;
  for (int kk = 1; kk < kMaxN; ++kk) {
    float kf = static_cast<float>(kk);
    log_fact = log_fact + logf(kf);
    float term = kf * log_a - log_fact;
    bool valid = n > kf;
    float new_max = valid ? max_nan(run_max, term) : run_max;
    run_sum = run_sum * expf(run_max - new_max) + (valid ? expf(term - new_max) : 0.0f);
    run_max = new_max;
  }
  float log_head = run_max + logf(run_sum);

  // lgamma(n+1) by Stirling (n >= 1 here)
  float nn = fmaxf(n, 1.0f);
  float log_nfact = (nn + 0.5f) * logf(nn) - nn + kHalfLog2Pi + 1.0f / (12.0f * nn);
  float log_tail = n * log_a - log_nfact - log1pf(-rho_s);
  float log_pi0 = -logaddexp(log_head, log_tail);
  float log_lq = n * log_a - log_nfact + logf(rho_s) - 2.0f * log1pf(-rho_s) + log_pi0;
  float ls = expf(log_lq) + a;
  float ws = ls / lam;
  ws = (rho < 1.0f) ? ws : kWsUnstable;

  float dp = power_span * n * c / caps_cpu;
  return alpha * ws + beta * dp / lam;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
crms_grid_kernel(const float* __restrict__ kappa,  // (M, 3)
                 const float* __restrict__ lam,    // (M,)
                 const float* __restrict__ xbar,   // (M,)
                 const float* __restrict__ n,      // (B, M)
                 const float* __restrict__ c,      // (B, M)
                 const float* __restrict__ m,      // (B, M)
                 float* __restrict__ out,          // (B, M) per_app, else (B,)
                 int B, int M, float caps_cpu, float power_span, float alpha,
                 float beta, int per_app) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // uniform across the warp: the shuffles stay full-mask
  const long long base = row * M;
  float acc = 0.0f;
  for (int i = lane; i < M; i += 32) {
    float u = utility_term(kappa[3 * i], kappa[3 * i + 1], kappa[3 * i + 2], lam[i],
                           xbar[i], n[base + i], c[base + i], m[base + i], caps_cpu,
                           power_span, alpha, beta);
    if (per_app) {
      out[base + i] = u;
    } else {
      acc = acc + u;
    }
  }
  if (!per_app) {
    for (int offset = 16; offset > 0; offset >>= 1) {
      acc = acc + __shfl_down_sync(0xffffffffu, acc, offset);
    }
    if (lane == 0) out[row] = acc;
  }
}

}  // namespace

extern "C" int crms_grid_launch(const void* kappa, const void* lam, const void* xbar,
                                const void* n, const void* c, const void* m, void* out,
                                int B, int M, float caps_cpu, float power_span,
                                float alpha, float beta, int per_app, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  crms_grid_kernel<<<blocks, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kappa), static_cast<const float*>(lam),
      static_cast<const float*>(xbar), static_cast<const float*>(n),
      static_cast<const float*>(c), static_cast<const float*>(m),
      static_cast<float*>(out), B, M, caps_cpu, power_span, alpha, beta, per_app);
  return static_cast<int>(cudaGetLastError());
}
