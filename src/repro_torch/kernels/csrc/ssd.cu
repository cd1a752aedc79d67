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
// N). All contiguous float32, 16-byte aligned.
//
// What bounds it on this card: at the serving shape (B 4, S 512, H 24, P 64,
// N 128, Q 256) the least work is 1.68e9 product operations (the scores
// C B^T once per (b, c) over the causal pairs, (scores ⊙ L) x and the states
// per head) and 2.2e7 elementwise ones, on 34 MB read and written once:
// 10.5 us of products at the tensor cores' TF32 rate over three (below)
// against 10.1 us of memory traffic. The Pallas kernel recomputes C B^T for
// every head (grid (B, H, nc)); here the scores are half of the products, so
// that repeat would double them. On this card the products run through
// mma.sync, whose TF32 rate is below wgmma's, and each operand has to be
// split on the CUDA cores first; that, not the bound, sets the kernel's time.
// What the design does:
//   - one block (4 warps) per (b, c, group of G = 2 heads, pair of
//     64-row tiles (t, last - t)): warp w owns the 16-row strip w of the
//     current row tile and walks its causal column tiles of KT = 32
//     positions. It forms its strip of the score tile S = C B^T once and
//     applies it to every head of the group: the decay L_h, then y_h +=
//     (S ⊙ L_h) x_h, with S ⊙ L_h kept in registers. Pairing the row tiles
//     gives every such block the same number of causal tiles; strips wholly
//     above the diagonal are skipped, and only strips that cross the diagonal
//     or the chunk's end are masked;
//   - further blocks of the same launch compute the chunk states of a group,
//     (x_h ⊙ exp(cum_end - cum_h))^T B, with the B tile staged once for the
//     group's heads (split along N where the group's accumulators would not
//     fit in registers). The grid lists the row blocks first, so the heavier
//     blocks start first and the state blocks fill the SMs as they free up;
//   - each block computes the chunk's cumsum(da) for its heads itself, in the
//     order of the reference's jnp.cumsum on the CPU (sequential within
//     blocks of 16 positions, the block totals scanned sequentially and
//     added): the cumsum reaches ~200 in size and L takes differences of it,
//     so another order of the same float32 sums moves y by up to ~3e-4 at
//     the serving shape, more than the reference's bar. The cumsum the
//     kernel returns is bit for bit the plain version's;
//   - the next column tile's B and x rows are copied with 16-byte cp.async
//     into a second buffer while the current tile's products run; rows past
//     the chunk and heads past H are zero-filled by the copy. A row tile's C
//     rows are staged once for all its column tiles;
//   - the three products run on the tensor cores (mma.sync m16n8k8 TF32,
//     float32 accumulators) in error-compensated TF32: each operand a is
//     split as hi = tf32(a), lo = tf32(a - hi), rounded to nearest with ties
//     away (cvt.rna's rounding), and lo·hi, hi·lo, hi·hi go, in that order, into one
//     accumulator. One TF32 product keeps ~3 digits, 20-343x outside the
//     reference's 2e-5 / 2e-4 bar; three stay within it
//     (tests/test_torch_ssd.py emulates this arithmetic on the CPU).
//     mma.sync takes its operands from registers, so the row-major tiles need
//     no K-major copy (wgmma in TF32 would). The decay, the mask and the
//     split run on the CUDA cores. The same design with register-tiled fmaf
//     products was 1.49x slower on the card (PERF.md §6);
//   - shared-memory row strides are padded (4 floats past N and
//     G·P where rows are read along them, 8 where a fragment reads
//     down a column) so every fragment load hits 32 distinct banks.
// Built without fast math (accurate expf) and with --fmad=false by
// kernels/build.py. Two heads a score tile, 32-column tiles and paired row
// tiles were the fastest of the choices measured on the card (PERF.md §6);
// four heads do not fit, as a warp holds G x 16 x P accumulators.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int G = 2;          // heads that share one score tile
constexpr int KT = 32;        // columns of a score tile (positions per staged tile)
constexpr int RT = 64;        // rows of a y tile: one 16-row strip a warp
constexpr int WARPS = RT / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 2;      // blocks an SM holds (registers and shared memory)
constexpr int SCAN_BLOCK = 16;     // block length of the reference's cumsum
constexpr int MAX_Q = SCAN_BLOCK * SCAN_BLOCK;  // two levels of blocks
constexpr int STATE_ACC = 8192;    // a state block's accumulators (64 a thread)

template <int P, int N>
struct Shape {
  static constexpr int GP = G * P;
  static constexpr int CS = N + 4;    // row stride of the C and B tiles (scores)
  static constexpr int XS = GP + 4;   // row stride of the x tile in a row block
  static constexpr int NS = GP * N > STATE_ACC ? STATE_ACC / GP : N;  // state columns a block
  static constexpr int NSPLIT = N / NS;
  static constexpr int SBS = NS + 8;  // row stride of the B tile in a state block
  static constexpr int SXS = GP + 8;  // row stride of the x tile in a state block
  static constexpr size_t row_floats =
      size_t(G) * MAX_Q + size_t(RT) * CS + 2 * size_t(KT) * (CS + XS);
  static constexpr size_t state_floats = 2 * size_t(G) * MAX_Q + 2 * size_t(KT) * (SBS + SXS);
  static constexpr size_t bytes =
      sizeof(float) * (row_floats > state_floats ? row_floats : state_floats);
  static_assert(bytes <= 232448, "shared memory of one block");
};

// Row blocks of one (chunk, head group): pairs of row tiles (t, last - t).
__host__ __device__ inline int row_blocks_per_chunk(int Q) { return ((Q + RT - 1) / RT + 1) / 2; }

// A WM x NT grid of 16 x 8 output tiles shared out over the block's warps:
// warp w owns tile rows row(w, i), i < RPW, and tile columns col(w, j), j <
// CPW (a column >= NT is not the warp's).
template <int WM, int NT>
struct WarpTiles {
  static constexpr int WPR = WM >= WARPS ? 1 : WARPS / WM;  // warps sharing a tile row
  static constexpr int RPW = WM >= WARPS ? WM / WARPS : 1;
  static constexpr int CPW = (NT + WPR - 1) / WPR;
  __device__ static int row(int w, int i) { return w / WPR + (WARPS / WPR) * i; }
  __device__ static int col(int w, int j) { return (w % WPR) * CPW + j; }
};

// acc[j] += a b[j] for the columns j with ok[j], in error-compensated TF32:
// the small terms lo·hi and hi·lo first, then hi·hi, each pass over all
// columns so that the tensor cores get independent products back to back.
template <int CPW>
__device__ __forceinline__ void mma3_row(float (&acc)[CPW][4], const FragA& a,
                                         const FragB (&b)[CPW], const bool (&ok)[CPW]) {
#pragma unroll
  for (int j = 0; j < CPW; ++j)
    if (ok[j]) mma_tf32(acc[j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < CPW; ++j)
    if (ok[j]) mma_tf32(acc[j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < CPW; ++j)
    if (ok[j]) mma_tf32(acc[j], a.hi, b[j].hi);
}

// cs[hh * MAX_Q + t] <- cumsum of da[b, c*Q + t, h0 + hh] over t < Q, in the
// reference's order: sequential within each block of 16 positions (one
// thread a block), then the block totals' inclusive scan (one thread a
// head) added to every later block. Heads past H get zeros.
__device__ void chunk_cumsum(float* cs, const float* __restrict__ da, size_t pos0, int H,
                             int h0, int Q) {
  __shared__ float totals[G][SCAN_BLOCK];
  for (int i = threadIdx.x; i < G * Q; i += THREADS) {
    const int hh = i / Q, t = i % Q;
    cs[hh * MAX_Q + t] = h0 + hh < H ? da[(pos0 + t) * H + h0 + hh] : 0.f;
  }
  __syncthreads();
  const int n_blocks = (Q + SCAN_BLOCK - 1) / SCAN_BLOCK;
  if (threadIdx.x < G * n_blocks) {
    float* c = cs + (threadIdx.x / n_blocks) * MAX_Q;
    const int lo = (threadIdx.x % n_blocks) * SCAN_BLOCK, hi = min(lo + SCAN_BLOCK, Q);
    float run = 0.f;
    for (int t = lo; t < hi; ++t) {
      run += c[t];
      c[t] = run;
    }
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const float* c = cs + threadIdx.x * MAX_Q;
    float run = 0.f;
    for (int k = 0; k < n_blocks; ++k) {
      run += c[min(k * SCAN_BLOCK + SCAN_BLOCK - 1, Q - 1)];
      totals[threadIdx.x][k] = run;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * Q; i += THREADS) {
    const int hh = i / Q, t = i % Q;
    if (t >= SCAN_BLOCK) cs[hh * MAX_Q + t] += totals[hh][t / SCAN_BLOCK - 1];
  }
  __syncthreads();
}

// Rows [t0, t0 + KT) of the group's x (KT x G·P, row stride XS) into
// shared memory; rows at or past Q and heads at or past H are zero-filled.
template <int P, int XS>
__device__ void stage_x(float* dst, const float* xg, size_t x_row, int t0, int Q, int n_heads) {
  constexpr int CHUNKS = G * P / 4;
  for (int i = threadIdx.x; i < KT * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, q = i % CHUNKS;
    const bool valid = t0 + r < Q && 4 * q < n_heads * P;
    const float* src = valid ? xg + size_t(t0 + r) * x_row + 4 * q : xg;
    cp_async16(dst + r * XS + 4 * q, src, valid);
  }
}

// Rows [t0, t0 + ROWS) and columns [n0, n0 + NC) of a (Q, N) matrix (B or C)
// into shared memory with row stride STRIDE; rows at or past Q are zero.
template <int ROWS, int NC, int N, int STRIDE>
__device__ void stage_rows(float* dst, const float* src0, int t0, int n0, int Q) {
  constexpr int CHUNKS = NC / 4;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, q = i % CHUNKS;
    const bool valid = t0 + r < Q;
    const float* src = valid ? src0 + size_t(t0 + r) * N + n0 + 4 * q : src0;
    cp_async16(dst + r * STRIDE + 4 * q, src, valid);
  }
}

// y rows of the row tiles (pair, last - pair) of one chunk for the group's
// heads (the middle row tile alone when their number is odd). Warp w owns the 16-row strip
// w of the current row tile and walks its causal column tiles: S = C B^T for
// its strip, then per head y_h += (S ⊙ L_h) x_h with S ⊙ L_h kept in
// registers. The accumulator of an m16n8 product holds columns 2t and 2t + 1
// of the thread's rows, where an A operand wants columns t and t + 4; so the
// product with x runs over a permuted k, logical t -> column 2t and t + 4 ->
// column 2t + 1, with the x rows read in the same order.
template <int P, int N>
__device__ void row_block(const float* __restrict__ xg, const float* __restrict__ bb,
                          const float* __restrict__ cb, float* __restrict__ yg, float* smem,
                          size_t x_row, int Q, int n_heads, int pair) {
  using Sh = Shape<P, N>;
  constexpr int CS = Sh::CS, XS = Sh::XS;
  constexpr int NJ = KT / 8;  // n-tiles of a score strip, k-steps of the product with x
  constexpr int NP = P / 8;   // n-tiles of a head's y strip
  float* cs = smem;                // (G, MAX_Q)
  float* c_t = cs + G * MAX_Q;     // (RT, CS): the row tile's C rows
  float* b_t = c_t + RT * CS;      // 2 x (KT, CS)
  float* x_t = b_t + 2 * KT * CS;  // 2 x (KT, XS)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;  // mma fragment row and column in the quad

  // the pair of row tiles (pair, last - pair), and their causal column tiles
  const int n_rows = (Q + RT - 1) / RT;
  const int row_a = pair, row_b = n_rows - 1 - pair;
  const int cols_a = (min(row_a * RT + RT, Q) + KT - 1) / KT;
  const int cols_b = (min(row_b * RT + RT, Q) + KT - 1) / KT;
  const int n_steps = cols_a + (row_b != row_a ? cols_b : 0);
  auto col_of = [&](int s) { return (s < cols_a ? s : s - cols_a) * KT; };
  auto stage = [&](int s) {
    stage_rows<KT, N, N, CS>(b_t + (s & 1) * KT * CS, bb, col_of(s), 0, Q);
    stage_x<P, XS>(x_t + (s & 1) * KT * XS, xg, x_row, col_of(s), Q, n_heads);
    cp_async_commit();
  };
  stage_rows<RT, N, N, CS>(c_t, cb, row_a * RT, 0, Q);
  stage(0);

  bool all_j[NJ], all_p[NP];
#pragma unroll
  for (int j = 0; j < NJ; ++j) all_j[j] = true;
#pragma unroll
  for (int j = 0; j < NP; ++j) all_p[j] = true;
  float acc[G][NP][4];
  for (int s = 0; s < n_steps; ++s) {
    const int row0 = (s < cols_a ? row_a : row_b) * RT;
    const int col0 = col_of(s);
    const int r0 = row0 + 16 * warp;  // this warp's strip
    if (s == 0 || s == cols_a) {
#pragma unroll
      for (int hh = 0; hh < G; ++hh)
#pragma unroll
        for (int j = 0; j < NP; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[hh][j][e] = 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();  // tile s is in shared memory; tile s - 1 is consumed
    if (s == cols_a) {  // the second row tile: its C rows replace the first's
      stage_rows<RT, N, N, CS>(c_t, cb, row_b * RT, 0, Q);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (s + 1 < n_steps) stage(s + 1);
    const float* bt = b_t + (s & 1) * KT * CS;
    const float* xt = x_t + (s & 1) * KT * XS;

    if (col0 <= r0 + 15 && r0 < Q) {  // the strip has pairs j <= i in this tile
      // scores S = C B^T, 16 rows x KT columns
      float sc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      const float* cr = c_t + (16 * warp + gq) * CS + tq;
#pragma unroll 4
      for (int k = 0; k < N; k += 8) {
        FragA a;
        a.set(cr[k], cr[8 * CS + k], cr[k + 4], cr[8 * CS + k + 4]);
        FragB b[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float* br = bt + (8 * j + gq) * CS + k + tq;
          b[j].set(br[0], br[4]);
        }
        mma3_row(sc, a, b, all_j);
      }

      // per head: P_h = S ⊙ L_h, L_h = exp(cum_i - cum_j), masked to j <= i
      // < Q only on tiles that cross the diagonal or the chunk's end; then
      // y_h += P_h x_h
      const bool masked = col0 + KT - 1 > r0 || r0 + 16 > Q || col0 + KT > Q;
      const int i0 = r0 + gq, i1 = i0 + 8;
#pragma unroll
      for (int hh = 0; hh < G; ++hh) {
        if (hh >= n_heads) break;
        const float* c = cs + hh * MAX_Q;
        const float ci0 = c[min(i0, Q - 1)], ci1 = c[min(i1, Q - 1)];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? i0 : i1;
            const int jj = col0 + 8 * j + 2 * tq + (e & 1);
            v[e] = sc[j][e] * expf((e < 2 ? ci0 : ci1) - c[min(jj, Q - 1)]);
            if (masked && !(i < Q && jj <= i)) v[e] = 0.f;
          }
          FragA a;
          a.set(v[0], v[2], v[1], v[3]);  // k = t: column 2t; k = t + 4: column 2t + 1
          FragB b[NP];
#pragma unroll
          for (int n = 0; n < NP; ++n) {
            const float* xr = xt + (8 * j + 2 * tq) * XS + hh * P + 8 * n + gq;
            b[n].set(xr[0], xr[XS]);
          }
          mma3_row(acc[hh], a, b, all_p);
        }
      }
    }

    if (s == cols_a - 1 || s == n_steps - 1) {  // the row tile is done: store its y rows
#pragma unroll
      for (int hh = 0; hh < G; ++hh) {
        if (hh >= n_heads) break;
#pragma unroll
        for (int n = 0; n < NP; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = r0 + gq + 8 * half;
            if (row >= Q) continue;
            *reinterpret_cast<float2*>(yg + size_t(row) * x_row + hh * P + 8 * n + 2 * tq) =
                make_float2(acc[hh][n][2 * half], acc[hh][n][2 * half + 1]);
          }
      }
    }
  }
}

template <int P, int N>
__device__ void state_block(const float* __restrict__ xg, const float* __restrict__ bb,
                            float* __restrict__ stg, float* __restrict__ cumg, float* smem,
                            size_t x_row, int H, int Q, int n_heads, int part) {
  using Sh = Shape<P, N>;
  constexpr int XS = Sh::SXS, NS = Sh::NS, SBS = Sh::SBS;
  using Tiles = WarpTiles<G * P / 16, NS / 8>;
  float* cs = smem;                  // (G, MAX_Q)
  float* dec = cs + G * MAX_Q;       // (G, MAX_Q): exp(cum_end - cum), 0 past Q
  float* b_t = dec + G * MAX_Q;      // 2 x (KT, SBS)
  float* x_t = b_t + 2 * KT * SBS;   // 2 x (KT, XS)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int n0 = part * NS;
  const int n_tiles = (Q + KT - 1) / KT;

  auto stage = [&](int s) {
    stage_rows<KT, NS, N, SBS>(b_t + (s & 1) * KT * SBS, bb, s * KT, n0, Q);
    stage_x<P, XS>(x_t + (s & 1) * KT * XS, xg, x_row, s * KT, Q, n_heads);
    cp_async_commit();
  };
  stage(0);

  if (part == 0) {
    for (int i = threadIdx.x; i < n_heads * Q; i += THREADS) {
      const int hh = i / Q, t = i % Q;
      cumg[size_t(t) * H + hh] = cs[hh * MAX_Q + t];
    }
  }
  for (int i = threadIdx.x; i < G * n_tiles * KT; i += THREADS) {
    const int hh = i / (n_tiles * KT), t = i % (n_tiles * KT);
    dec[hh * MAX_Q + t] = t < Q ? expf(cs[hh * MAX_Q + Q - 1] - cs[hh * MAX_Q + t]) : 0.f;
  }

  float acc[Tiles::RPW][Tiles::CPW][4];
  bool ok[Tiles::CPW];
#pragma unroll
  for (int j = 0; j < Tiles::CPW; ++j) ok[j] = Tiles::col(warp, j) < NS / 8;
#pragma unroll
  for (int i = 0; i < Tiles::RPW; ++i)
#pragma unroll
    for (int j = 0; j < Tiles::CPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // tile s (and dec) are in shared memory; tile s - 1 is consumed
    if (s + 1 < n_tiles) stage(s + 1);
    const float* bt = b_t + (s & 1) * KT * SBS;
    const float* xt = x_t + (s & 1) * KT * XS;
    // st_h[p, n] += sum_t x_h[t, p] dec_h[t] B[t, n]: A = (x_h ⊙ dec_h)^T
#pragma unroll 2
    for (int k = 0; k < KT; k += 8) {
      FragB b[Tiles::CPW];
#pragma unroll
      for (int j = 0; j < Tiles::CPW; ++j) {
        const float* br = bt + (k + tq) * SBS + (ok[j] ? Tiles::col(warp, j) : 0) * 8 + gq;
        b[j].set(br[0], br[4 * SBS]);
      }
#pragma unroll
      for (int i = 0; i < Tiles::RPW; ++i) {
        const int m = Tiles::row(warp, i);
        const int hh = m / (P / 16), pm = m % (P / 16);
        const float* xr = xt + (k + tq) * XS + hh * P + pm * 16 + gq;
        const float d0 = dec[hh * MAX_Q + s * KT + k + tq];
        const float d1 = dec[hh * MAX_Q + s * KT + k + tq + 4];
        FragA a;
        a.set(xr[0] * d0, xr[8] * d0, xr[4 * XS] * d1, xr[4 * XS + 8] * d1);
        mma3_row(acc[i], a, b, ok);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < Tiles::RPW; ++i) {
    const int m = Tiles::row(warp, i);
    const int hh = m / (P / 16), pm = m % (P / 16);
    if (hh >= n_heads) continue;
#pragma unroll
    for (int j = 0; j < Tiles::CPW; ++j) {
      const int col = Tiles::col(warp, j);
      if (!ok[j]) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = pm * 16 + gq + 8 * half;
        *reinterpret_cast<float2*>(stg + (size_t(hh) * P + p) * N + n0 + col * 8 + 2 * tq) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                 const float* __restrict__ cm, const float* __restrict__ da,
                 float* __restrict__ y, float* __restrict__ st, float* __restrict__ cum,
                 int S, int H, int Q, int nc) {
  extern __shared__ __align__(16) float smem[];
  // blockIdx.x: the row blocks (pair fastest, then head group, then batch x
  // chunk), then the state blocks (part fastest); the heavier row blocks are
  // dispatched first and the state blocks fill the SMs as they free up
  const int row_blocks = row_blocks_per_chunk(Q);
  const int n_groups = (H + G - 1) / G;
  const int n_chunks = gridDim.x / ((row_blocks + Shape<P, N>::NSPLIT) * n_groups);
  const int n_row_blocks = row_blocks * n_groups * n_chunks;
  const bool is_row = blockIdx.x < n_row_blocks;
  const int item = is_row ? blockIdx.x : blockIdx.x - n_row_blocks;
  const int split = is_row ? row_blocks : Shape<P, N>::NSPLIT;
  const int part = item % split;
  const int group = item / split % n_groups;
  const int chunk = item / split / n_groups;
  const int h0 = group * G;
  const int n_heads = min(G, H - h0);
  const int b = chunk / nc;
  const int c = chunk % nc;
  const size_t pos0 = size_t(b) * S + size_t(c) * Q;  // (b, first position of the chunk)
  const size_t x_row = size_t(H) * P;
  const float* xg = x + pos0 * x_row + size_t(h0) * P;  // x[b, pos0 + t, h0 + hh, p]
  const float* bb = bm + pos0 * N;
  const float* cb = cm + pos0 * N;

  chunk_cumsum(smem, da, pos0, H, h0, Q);
  if (is_row) {
    row_block<P, N>(xg, bb, cb, y + pos0 * x_row + size_t(h0) * P, smem, x_row, Q, n_heads,
                    part);
  } else {
    float* stg = st + ((size_t(b) * nc + c) * H + h0) * size_t(P) * N;
    state_block<P, N>(xg, bb, stg, cum + pos0 * H + h0, smem, x_row, H, Q, n_heads, part);
  }
}

template <int P, int N>
int launch(const float* x, const float* bm, const float* cm, const float* da, float* y,
           float* st, float* cum, int B, int S, int H, int Q, cudaStream_t stream) {
  using Sh = Shape<P, N>;
  auto kernel = ssd_chunk_kernel<P, N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(Sh::bytes));
  if (err != cudaSuccess) return int(err);
  const int nc = S / Q;
  const int row_blocks = row_blocks_per_chunk(Q);
  const dim3 grid((row_blocks + Sh::NSPLIT) * ((H + G - 1) / G) * B * nc);
  kernel<<<grid, THREADS, Sh::bytes, stream>>>(x, bm, cm, da, y, st, cum, S, H, Q, nc);
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
// N); all contiguous float32 on the device, 16-byte aligned. P in {16, 32,
// 64}, N in {16, 32, 64, 128}, 1 <= Q <= 256 dividing S. Returns the CUDA
// status of the launch (0 on success); the wrapper raises on anything else.
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

// The heads that share one score tile.
extern "C" int ssd_chunk_head_group() { return G; }
