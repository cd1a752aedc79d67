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
// Design: the Erlang head sum ends at the largest count its warp needs.
// Lane k-steps with k >= n change nothing (run_max stays, run_sum is scaled
// by expf(0) = 1 and gains 0; a NaN run_max has already made run_sum NaN),
// so the loop runs to min(ceil(n), MAX_N) - 1 over the warp's lanes
// (__reduce_max_sync, so the lanes stay converged) and the result is bit for
// bit the 127-step loop's. A NaN count needs no step, an infinite one 127.
// The counts on the allocator path are below 12, so a lane runs ~10 steps,
// not 127.
//   - per-app mode: one thread per (row, app) lane, blocks of 2 warps, so
//     the grid-seeding shape (72, 64) is 4608 lanes in 72 blocks (it was 9
//     blocks of 8 warps, each lane evaluating two apps in turn). The ragged
//     edge is masked; nothing is sorted or padded.
//   - sum mode: one warp per candidate row; the 32 lanes stride over the
//     apps, each lane runs the k-loop for its app in registers, and the row
//     sum is a warp-shuffle reduction (no atomics, a fixed summation order
//     per row).
//
// Bound: at the grid-seeding shape (<= 72 rows x 64 apps, ~74 KB moved) the
// launch dominates. At a search-sized batch, e.g. (20000, 64) in sum mode
// (~15 MB moved, counts 8..19), the 3 transcendental operations per k step
// (a log and two exps, up to 18 steps per lane) bound it, not the bytes.
//
// float32 throughout, as the TPU kernel. Build without --use_fast_math (the
// tolerances assume the accurate expf/logf) and with --fmad=false, so the
// arithmetic rounds operation by operation as the plain torch version
// (repro_torch/kernels/ref.py::crms_grid_plain) does.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kWarpsPerBlock = 8;     // sum mode: one row a warp
constexpr int kPerAppThreads = 64;    // per-app mode: one (row, app) lane a thread
constexpr unsigned kFull = 0xffffffffu;
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

// The k-steps a count needs, plus one: min(ceil(n), kMaxN), 0 for NaN.
__device__ __forceinline__ int steps_end(float n) {
  if (!(n > 0.0f)) return 0;  // NaN, or no k with n > k
  return n >= static_cast<float>(kMaxN) ? kMaxN : static_cast<int>(ceilf(n));
}

// Called by all 32 lanes of a warp together (the loop bound is the warp's
// largest); a lane with nothing to evaluate passes n = NaN and ignores the
// result.
__device__ float utility_term(float k1, float k2, float k3, float lam, float xbar,
                              float n, float c, float m, float caps_cpu,
                              float power_span, float alpha, float beta) {
  float d_ms = k1 / (1.0f - expf(-k2 * c)) + expf(k3 / m);
  float mu = 1000.0f / (xbar * d_ms);
  float a = lam / mu;
  float rho = lam / (n * mu);
  float rho_s = min_nan(rho, 1.0f - 1e-6f);
  float log_a = logf(a);

  // log sum_{k=0}^{n-1} a^k/k!: running max, rescaled running sum, log k!;
  // steps past this lane's count leave both as they are
  const int end = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(steps_end(n))));
  float run_max = 0.0f;
  float run_sum = 1.0f;
  float log_fact = 0.0f;
  for (int kk = 1; kk < end; ++kk) {
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

struct Args {
  const float* __restrict__ kappa;  // (M, 3)
  const float* __restrict__ lam;    // (M,)
  const float* __restrict__ xbar;   // (M,)
  const float* __restrict__ n;      // (B, M)
  const float* __restrict__ c;      // (B, M)
  const float* __restrict__ m;      // (B, M)
  float* __restrict__ out;          // (B, M) per-app, else (B,)
  int B, M;
  float caps_cpu, power_span, alpha, beta;
};

// The term of app i in the lane at flat index j = row * M + i; a lane past
// the grid (live false) evaluates a NaN count and its result is not used.
__device__ __forceinline__ float lane_term(const Args& p, long long j, int i, bool live) {
  const int a = live ? i : 0;
  return utility_term(p.kappa[3 * a], p.kappa[3 * a + 1], p.kappa[3 * a + 2], p.lam[a],
                      p.xbar[a], live ? p.n[j] : NAN, live ? p.c[j] : 1.0f,
                      live ? p.m[j] : 1.0f, p.caps_cpu, p.power_span, p.alpha, p.beta);
}

// per-app: thread j evaluates lane j of the (B, M) grid.
__global__ void __launch_bounds__(kPerAppThreads)
crms_grid_per_app(const Args p) {
  const long long j = static_cast<long long>(blockIdx.x) * kPerAppThreads + threadIdx.x;
  const bool live = j < static_cast<long long>(p.B) * p.M;
  const float u = lane_term(p, j, live ? static_cast<int>(j % p.M) : 0, live);
  if (live) p.out[j] = u;
}

// sum: warp w sums row w's terms, its lanes striding over the apps.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
crms_grid_sum(const Args p) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= p.B) return;  // uniform across the warp: the warp ops stay full-mask
  const long long base = row * p.M;
  float acc = 0.0f;
  for (int i0 = 0; i0 < p.M; i0 += 32) {
    const int i = i0 + lane;
    const float u = lane_term(p, base + i, i, i < p.M);
    if (i < p.M) acc = acc + u;
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc = acc + __shfl_down_sync(kFull, acc, offset);
  }
  if (lane == 0) p.out[row] = acc;
}

}  // namespace

extern "C" int crms_grid_launch(const void* kappa, const void* lam, const void* xbar,
                                const void* n, const void* c, const void* m, void* out,
                                int B, int M, float caps_cpu, float power_span,
                                float alpha, float beta, int per_app, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  const Args args{static_cast<const float*>(kappa), static_cast<const float*>(lam),
                  static_cast<const float*>(xbar), static_cast<const float*>(n),
                  static_cast<const float*>(c), static_cast<const float*>(m),
                  static_cast<float*>(out), B, M, caps_cpu, power_span, alpha, beta};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (per_app) {
    const long long lanes = static_cast<long long>(B) * M;
    const unsigned blocks = static_cast<unsigned>((lanes + kPerAppThreads - 1) / kPerAppThreads);
    crms_grid_per_app<<<blocks, kPerAppThreads, 0, st>>>(args);
  } else {
    const unsigned blocks = static_cast<unsigned>((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
    crms_grid_sum<<<blocks, 32 * kWarpsPerBlock, 0, st>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
