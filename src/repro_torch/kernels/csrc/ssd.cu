// Mamba2 SSD intra-chunk step, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd.py::ssd_chunk_fwd (line
// 51; body _ssd_chunk_kernel, line 21). Per (batch b, chunk c, head h) of Q
// positions, in float32:
//   cum          = cumsum(da)
//   L[i, j]      = exp(cum[i] - cum[j]) if i >= j else 0
//   y_diag       = (C B^T ⊙ L) x                        (Q, P)
//   states[c, h] = x^T (B ⊙ exp(cum[Q-1] - cum))         (P, N)
// The inter-chunk recurrence and the off-diagonal term stay in the wrapper
// (kernels/ops.py::ssd_chunks), as in the reference; the kernel also writes
// cum, which the wrapper uses for them (the reference's wrapper recomputes
// the same cumsum).
//
// Layouts are the model's, with no transposes: x and y (B, S, H, P), B and C
// (B, S, N) shared by all heads, da and cum (B, S, H); states (B, nc, H, P,
// N). All contiguous float32.
//
// What bounds it on this card: at the serving shape (B 4, S 512, H 24, P 64,
// N 128, Q 256) the causal half of the score and y products plus the
// states is ~3.2e9 float32 operations (48 us at 67 TFLOP/s) on ~34 MB read
// and written once (10 us at 3.35 TB/s): operations. The TPU kernel holds a
// whole (Q, Q) score tile and the (Q, N) B and C tiles in VMEM; at Q = 256
// and N = 128 that is ~580 KB, more than a block's 227 KB of shared memory.
// What the design does:
//   - one block per (64-row tile of the chunk, head, batch * chunk) computes
//     its y rows, walking the 64-column tiles j <= i; tiles above the
//     diagonal are exact zeros under L and are skipped. One further block per
//     (head, batch * chunk) in the same launch (blockIdx.x == number of row
//     tiles) computes the chunk state;
//   - each block computes the chunk's cumsum(da) itself, in the order of the
//     reference's jnp.cumsum on the CPU (sequential within blocks of 16
//     positions, the block totals scanned sequentially and added): the
//     cumsum reaches ~200 in size and L takes differences of it, so another
//     order of the same float32 sums moves y by up to ~3e-4 at the serving
//     shape, more than the reference's bar;
//   - staged in shared memory as float32: the C row tile (64 x N), the B
//     and x column tiles (64 x N, 64 x P) and the masked score tile (64 x 64),
//     rows of the tiles read along N padded by one float so the lanes hit
//     distinct banks: ~100 KB at N 128, P 64, above the 48 KB default, so the
//     launcher opts in to dynamic shared memory before every launch;
//   - 256 threads as 16 x 16, each holding a 4 x 4 register tile of the
//     scores and a 4 x (P / 16) tile of y (the state block: (P / 16) x
//     (N / 16)); products on the CUDA cores (fmaf). wgmma (with
//     error-compensated TF32: plain TF32 keeps ~3 digits, short of the
//     reference's 2e-5 bar), TMA and pipelining are work for a later change;
//   - a chunk shorter than a tile (Q = 8 in the reduced model's prompts)
//     is masked: rows and columns at or past Q are zero and never stored.
// Built without fast math (accurate expf) and with --fmad=false by
// kernels/build.py.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;    // rows of a y tile and columns of a score tile
constexpr int TX = 16;      // threads along a tile's columns
constexpr int TY = 16;      // threads along a tile's rows
constexpr int THREADS = TX * TY;
constexpr int RPT = TILE / TY;  // rows per thread (4)
constexpr int CPT = TILE / TX;  // score columns per thread (4)
constexpr int SCAN_BLOCK = 16;  // block length of the reference's cumsum
constexpr int MAX_Q = SCAN_BLOCK * SCAN_BLOCK;  // two levels of blocks

template <int P, int N>
constexpr size_t smem_floats() {
  // cum (MAX_Q) + C tile (TILE x (N+1)) + B tile (TILE x (N+1)) + x tile
  // (TILE x P) + score tile (TILE x (TILE+1)); the state block uses a prefix.
  return size_t(MAX_Q) + 2 * size_t(TILE) * (N + 1) + size_t(TILE) * P +
         size_t(TILE) * (TILE + 1);
}

// cs[0:Q] <- cumsum of da[b, c*Q + t, h] over t, in the reference's order:
// sequential within each block of 16 positions (one thread a block), then
// the block totals' inclusive scan (one thread) added to every later block.
__device__ void chunk_cumsum(float* cs, const float* __restrict__ da, size_t pos0, int H,
                             int h, int Q) {
  __shared__ float totals[SCAN_BLOCK];
  for (int t = threadIdx.x; t < Q; t += THREADS) cs[t] = da[(pos0 + t) * H + h];
  __syncthreads();
  const int n_blocks = (Q + SCAN_BLOCK - 1) / SCAN_BLOCK;
  if (threadIdx.x < n_blocks) {
    const int lo = threadIdx.x * SCAN_BLOCK, hi = min(lo + SCAN_BLOCK, Q);
    float run = 0.f;
    for (int t = lo; t < hi; ++t) {
      run += cs[t];
      cs[t] = run;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int k = 0; k < n_blocks; ++k) {
      run += cs[min(k * SCAN_BLOCK + SCAN_BLOCK - 1, Q - 1)];
      totals[k] = run;
    }
  }
  __syncthreads();
  for (int t = SCAN_BLOCK + threadIdx.x; t < Q; t += THREADS)
    cs[t] += totals[t / SCAN_BLOCK - 1];
  __syncthreads();
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                 const float* __restrict__ cm, const float* __restrict__ da,
                 float* __restrict__ y, float* __restrict__ st, float* __restrict__ cum,
                 int S, int H, int Q, int nc) {
  constexpr int NS = N + 1;         // padded row stride of the B and C tiles
  constexpr int SS = TILE + 1;      // padded row stride of the score tile
  constexpr int PPT = P / TX;       // y columns per thread; state rows per thread (TY == TX)
  constexpr int NPT = N / TX;       // state columns per thread
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                 // (MAX_Q)
  float* c_t = cs + MAX_Q;          // (TILE, NS)
  float* b_t = c_t + TILE * NS;     // (TILE, NS)
  float* x_t = b_t + TILE * NS;     // (TILE, P)
  float* s_t = x_t + TILE * P;      // (TILE, SS)

  const int n_row_tiles = (Q + TILE - 1) / TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z / nc;
  const int c = blockIdx.z % nc;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const size_t pos0 = size_t(b) * S + size_t(c) * Q;  // (b, first position of the chunk)
  const float* xb = x + pos0 * H * P + size_t(h) * P;  // x[b, pos0 + t, h, p] = xb[t*H*P + p]
  const float* bb = bm + pos0 * N;
  const float* cb = cm + pos0 * N;
  const size_t x_row = size_t(H) * P;

  chunk_cumsum(cs, da, pos0, H, h, Q);

  if (blockIdx.x == n_row_tiles) {
    // the chunk's cumsum, and its state:
    // st[b, c, h, p, n] = sum_t x[t, p] * B[t, n] * exp(cum[Q-1] - cum[t])
    for (int t = threadIdx.x; t < Q; t += THREADS) cum[(pos0 + t) * H + h] = cs[t];
    const float cum_end = cs[Q - 1];
    float acc[PPT][NPT];
#pragma unroll
    for (int a = 0; a < PPT; ++a)
#pragma unroll
      for (int k = 0; k < NPT; ++k) acc[a][k] = 0.f;
    for (int t0 = 0; t0 < Q; t0 += TILE) {
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < TILE * P; i += THREADS) {
        const int r = i / P, p = i % P;
        x_t[i] = t0 + r < Q ? xb[size_t(t0 + r) * x_row + p] : 0.f;
      }
      for (int i = threadIdx.x; i < TILE * N; i += THREADS) {
        const int r = i / N, n = i % N;
        const int t = t0 + r;
        b_t[r * N + n] = t < Q ? bb[size_t(t) * N + n] * expf(cum_end - cs[t]) : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < TILE; ++r) {
        float xv[PPT], bv[NPT];
#pragma unroll
        for (int a = 0; a < PPT; ++a) xv[a] = x_t[r * P + ty + TY * a];
#pragma unroll
        for (int k = 0; k < NPT; ++k) bv[k] = b_t[r * N + tx + TX * k];
#pragma unroll
        for (int a = 0; a < PPT; ++a)
#pragma unroll
          for (int k = 0; k < NPT; ++k) acc[a][k] = fmaf(xv[a], bv[k], acc[a][k]);
      }
    }
    float* sb = st + ((size_t(b) * nc + c) * H + h) * size_t(P) * N;
#pragma unroll
    for (int a = 0; a < PPT; ++a)
#pragma unroll
      for (int k = 0; k < NPT; ++k) sb[size_t(ty + TY * a) * N + tx + TX * k] = acc[a][k];
    return;
  }

  // y rows [row0, row0 + TILE) of the chunk
  const int row0 = blockIdx.x * TILE;
  for (int i = threadIdx.x; i < TILE * N; i += THREADS) {
    const int r = i / N, n = i % N;
    c_t[r * NS + n] = row0 + r < Q ? cb[size_t(row0 + r) * N + n] : 0.f;
  }
  float acc[RPT][PPT];
#pragma unroll
  for (int a = 0; a < RPT; ++a)
#pragma unroll
    for (int k = 0; k < PPT; ++k) acc[a][k] = 0.f;

  for (int kt = 0; kt <= blockIdx.x; ++kt) {  // column tiles on or below the diagonal
    const int col0 = kt * TILE;
    __syncthreads();  // the previous tiles are consumed (and c_t is written)
    for (int i = threadIdx.x; i < TILE * N; i += THREADS) {
      const int r = i / N, n = i % N;
      b_t[r * NS + n] = col0 + r < Q ? bb[size_t(col0 + r) * N + n] : 0.f;
    }
    for (int i = threadIdx.x; i < TILE * P; i += THREADS) {
      const int r = i / P, p = i % P;
      x_t[i] = col0 + r < Q ? xb[size_t(col0 + r) * x_row + p] : 0.f;
    }
    __syncthreads();

    // scores = C B^T on this thread's rows ty + 16a and columns tx + 16k
    float sc[RPT][CPT];
#pragma unroll
    for (int a = 0; a < RPT; ++a)
#pragma unroll
      for (int k = 0; k < CPT; ++k) sc[a][k] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[RPT], bv[CPT];
#pragma unroll
      for (int a = 0; a < RPT; ++a) cv[a] = c_t[(ty + TY * a) * NS + n];
#pragma unroll
      for (int k = 0; k < CPT; ++k) bv[k] = b_t[(tx + TX * k) * NS + n];
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int k = 0; k < CPT; ++k) sc[a][k] = fmaf(cv[a], bv[k], sc[a][k]);
    }
    // mask and decay: L[i, j] = exp(cum[i] - cum[j]) for j <= i < Q
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
      const int r = ty + TY * a;
      const int i = row0 + r;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int j = col0 + tx + TX * k;
        float v = 0.f;
        if (i < Q && j <= i) v = sc[a][k] * expf(cs[i] - cs[j]);
        s_t[r * SS + tx + TX * k] = v;
      }
    }
    __syncthreads();

    // y += (scores ⊙ L) x
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float sv[RPT], xv[PPT];
#pragma unroll
      for (int a = 0; a < RPT; ++a) sv[a] = s_t[(ty + TY * a) * SS + j];
#pragma unroll
      for (int k = 0; k < PPT; ++k) xv[k] = x_t[j * P + tx + TX * k];
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int k = 0; k < PPT; ++k) acc[a][k] = fmaf(sv[a], xv[k], acc[a][k]);
    }
  }

  float* yb = y + pos0 * H * P + size_t(h) * P;
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    const int i = row0 + ty + TY * a;
    if (i >= Q) continue;
#pragma unroll
    for (int k = 0; k < PPT; ++k) yb[size_t(i) * x_row + tx + TX * k] = acc[a][k];
  }
}

template <int P, int N>
int launch(const float* x, const float* bm, const float* cm, const float* da, float* y,
           float* st, float* cum, int B, int S, int H, int Q, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<P, N>();
  auto kernel = ssd_chunk_kernel<P, N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  const int nc = S / Q;
  const dim3 grid((Q + TILE - 1) / TILE + 1, H, B * nc);
  kernel<<<grid, THREADS, bytes, stream>>>(x, bm, cm, da, y, st, cum, S, H, Q, nc);
  return int(cudaGetLastError());
}

template <int P>
int launch_n(const float* x, const float* bm, const float* cm, const float* da, float* y,
             float* st, float* cum, int B, int S, int H, int N, int Q, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<P, 16>(x, bm, cm, da, y, st, cum, B, S, H, Q, stream);
    case 32: return launch<P, 32>(x, bm, cm, da, y, st, cum, B, S, H, Q, stream);
    case 64: return launch<P, 64>(x, bm, cm, da, y, st, cum, B, S, H, Q, stream);
    case 128: return launch<P, 128>(x, bm, cm, da, y, st, cum, B, S, H, Q, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y (B, S, H, P); bm, cm (B, S, N); da, cum (B, S, H); st (B, S / Q, H, P,
// N); all contiguous float32 on the device. P in {16, 32, 64}, N in {16, 32, 64,
// 128}, 1 <= Q <= 256 dividing S. Returns the CUDA status of the launch (0 on
// success); the wrapper raises on anything else.
extern "C" int ssd_chunk_launch(const void* x, const void* bm, const void* cm, const void* da,
                                void* y, void* st, void* cum, int B, int S, int H, int P,
                                int N, int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q > MAX_Q || S % Q != 0)
    return int(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(bm);
  const float* cf = static_cast<const float*>(cm);
  const float* df = static_cast<const float*>(da);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(st);
  float* uf = static_cast<float*>(cum);
  switch (P) {
    case 16: return launch_n<16>(xf, bf, cf, df, yf, sf, uf, B, S, H, N, Q, s);
    case 32: return launch_n<32>(xf, bf, cf, df, yf, sf, uf, B, S, H, N, Q, s);
    case 64: return launch_n<64>(xf, bf, cf, df, yf, sf, uf, B, S, H, N, Q, s);
    default: return int(cudaErrorInvalidValue);
  }
}
