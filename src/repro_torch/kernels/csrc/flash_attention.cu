// Flash-attention forward (GQA), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_fwd (body _flash_fwd_kernel): softmax(q k^T * hd^-0.5) v
// per (batch, query head) with an online softmax, the kv head read as h / G,
// keys past Skv and queries past Sq masked, causal (top-left aligned,
// q_pos >= k_pos) tiles above the diagonal skipped, and the output
// acc / max(l, 1e-30) in q's dtype.
//
// Layouts are those of the port's model code, so no transpose is needed:
// q and out (B, Sq, KV, G, hd), k and v (B, Skv, KV, hd), all contiguous.
//
// What bounds it on this card: at the serving path's shape (B 4, S 512,
// 8 heads, hd 256, causal, bf16) the work is ~4.3e9 operations on ~19 MB:
// 5.6 us at the memory rate, 4.3 us at the bf16 tensor-core peak. This
// first version does the products on the float32 pipes (CUDA cores; 64 us
// at their peak) from shared memory, so operations and shared-memory
// traffic bound it; wgmma, TMA and pipelining come in a later change. What
// the design does:
//   - one block per (q tile of BQ = 32 rows, query head, batch); 8 warps of
//     4 query rows each, one key of the 32-key tile per lane;
//   - the Q tile and each K/V tile are staged once in shared memory as
//     float32 (inputs converted on load), K rows padded by 4 floats so the
//     lanes' 16-byte loads hit distinct banks; the kv head is read as h / G
//     with no copy of K/V per query head;
//   - online softmax in float32 registers (m, l per row; acc: hd / 32
//     columns per lane and row); fully masked rows keep m = -inf and give 0
//     through the same isfinite guards as the Pallas kernel, never NaN.
// Built without fast math (accurate expf, IEEE division) by kernels/build.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int ROWS = 4;                 // query rows per warp
constexpr int BQ = WARPS * ROWS;        // query rows per block
constexpr int BK = 32;                  // keys per tile: one per lane
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * HD + size_t(BK) * (HD + 4) + size_t(BK) * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Sq, int Skv, int KV, int G, float scale, int causal) {
  constexpr int KSTRIDE = HD + 4;
  constexpr int CPL = HD / 32;  // output columns per lane: lane + 32 * c
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // (BQ, HD)
  float* ks = qs + BQ * HD;         // (BK, KSTRIDE)
  float* vs = ks + BK * KSTRIDE;    // (BK, HD)

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t q_row = size_t(KV) * G * HD;  // stride of one position in q / out
  const size_t k_row = size_t(KV) * HD;      // stride of one position in k / v
  const T* qb = q + size_t(b) * Sq * q_row + size_t(h) * HD;
  T* ob = o + size_t(b) * Sq * q_row + size_t(h) * HD;
  const size_t kv_off = size_t(b) * Skv * k_row + size_t(h / G) * HD;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  for (int i = threadIdx.x; i < BQ * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    const int s = q_start + r;
    qs[i] = s < Sq ? to_f32(qb[size_t(s) * q_row + c]) : 0.f;
  }

  float acc[ROWS][CPL];
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;
  }

  int n_kb = (Skv + BK - 1) / BK;
  if (causal) n_kb = min(n_kb, (q_start + BQ - 1) / BK + 1);  // skip tiles above the diagonal
  const float* qw = qs + warp * ROWS * HD;
  const float* krow = ks + lane * KSTRIDE;

  for (int kt = 0; kt < n_kb; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * HD; i += THREADS) {
      const int r = i / HD, c = i % HD;
      const int t = k_start + r;
      const bool ok = t < Skv;
      ks[r * KSTRIDE + c] = ok ? to_f32(kb[size_t(t) * k_row + c]) : 0.f;
      vs[r * HD + c] = ok ? to_f32(vb[size_t(t) * k_row + c]) : 0.f;
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + r * HD + c);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int k_pos = k_start + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int q_pos = q_start + warp * ROWS + r;
      const bool live = k_pos < Skv && q_pos < Sq && (!causal || q_pos >= k_pos);
      const float sc = live ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float p = isfinite(sc) ? expf(sc - m_safe) : 0.f;
      const float corr = isfinite(m[r]) ? expf(m[r] - m_safe) : 0.f;
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      s[r] = p;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[r][c] *= corr;
    }

    // acc += p v: key j's probabilities come from lane j
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pj[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pj[r] = __shfl_sync(FULL, s[r], j);
      const float* vrow = vs + j * HD + lane;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float vv = vrow[32 * c];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][c] = fmaf(pj[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int q_pos = q_start + warp * ROWS + r;
    if (q_pos >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = ob + size_t(q_pos) * q_row + lane;
#pragma unroll
    for (int c = 0; c < CPL; ++c) store(orow + 32 * c, acc[r][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int KV, int G, float scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((Sq + BQ - 1) / BQ, KV * G, B);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), Sq,
                                           Skv, KV, G, scale, causal);
  return int(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
              int KV, int G, int hd, float scale, int causal, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, KV, G, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, KV, G, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, KV, G, scale, causal, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Skv, KV, G, scale, causal, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns the CUDA status of the launch (0 on
// success); the wrapper raises on anything else.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int KV, int G, int hd,
                                      float scale, int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || G <= 0) return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, B, Sq, Skv, KV, G, hd, scale, causal, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, KV, G, hd, scale, causal, st);
  return int(cudaErrorInvalidValue);
}
