// Flash attention for Hopper (sm_90a): forward, and the backward as two
// kernels (dQ; dK with dV), for the training path. Every kernel is a
// template over `Causal`, as every TPU body takes its static `causal`:
// the causal bodies serve dense attention and ring attention's diagonal
// pair, the full ones (Causal = false: no element mask, no diagonal skip,
// dK/dV visiting every query tile) the ring's off-diagonal pairs
// (midgpt_tpu/parallel/ring_attention.py:231-249). The extern "C" launchers
// take the flag as `int causal`.
//
// Replaces: midgpt_tpu/kernels/flash_attention.py, every body reached from
// its pl.pallas_call sites, with causal=True and causal=False:
//   flash_fwd      <- _fwd_kernel_single (:126) and _fwd_kernel (:160)
//   flash_bwd_dq   <- _bwd_fused_single (:265, its dQ), _bwd_dq_kernel_single
//                     (:301) and _bwd_dq_kernel (:329)
//   flash_bwd_dkv  <- _bwd_fused_single (:265, its dK and dV) and
//                     _bwd_dkv_kernel (:376)
// Layout is the JAX wrapper's: q, k, v, out, dout (N = B*H, T, C) contiguous
// in one dtype (float32 or bfloat16), lse (N, T) float32 (the port's layout:
// one value per row, not the TPU's 8 lanes). head_dim C is 64 or 128.
//
// Rounding points kept from the TPU kernels:
//   * scores are f32 dot products (bf16 products are exact in f32), scaled
//     by 1/sqrt(C) AFTER the dot; masked entries (col > row) get the finite
//     MASK (-1e30) and the running max starts at M_INIT (-0.5e30), so
//     exp(MASK - m) is exactly 0;
//   * forward: l sums the f32 p; p is rounded to V's dtype before the PV
//     product, accumulated in f32. The TPU's single-visit body rounds
//     exp(s - m_final); an online kernel would round exp(s - m_running).
//     The forward SWEEPS TWICE over each KV chunk of `chunk` columns (the
//     dispatcher's block_k): first for the chunk's row max, then for p, l
//     and PV with that max. With one chunk (block_k == T, the main path)
//     that is exactly body 1's rounding; with several it is body 2's online
//     recurrence at block_k granularity. The price is a second Q.K^T;
//   * backward: p = exp(s - lse); p rounded to dO's dtype before dV += p^T dO;
//     dp = dO V^T in f32; delta = rowsum(O * dO) in f32 from O and dO as
//     stored (in-kernel, as bodies 5 and 6 do); ds = (p * (dp - delta)) *
//     scale rounded to q's dtype before dQ = ds K and dK = ds^T Q, both
//     accumulated in f32 and rounded once at the end.
// The TPU's fused body 3 keeps the whole (T, T) f32 score tile in VMEM (4 MB
// at T = 1024); a Hopper block has 227 KB, so the fused backward is computed
// by the two tiled kernels, each recomputing Q.K^T from (q, k, lse): the same
// function. No atomics: dQ and dK/dV are each owned by one block, so results
// are the same from run to run. With Causal = false every (query, key) pair
// is visible: the last visible column of every tile is T - 1, only columns
// and rows at or past T are masked (ragged T), and the forward's rounding
// points are body 1's and body 2's with causal=False.
//
// What bounds it on the card. Per head the causal half of T^2 score pairs
// costs 2C flops per product: the forward's 2 products, dQ's 3 and dK/dV's
// 4 (chip_smoke.flash_bounds). At the training main path's shape (B 16,
// H 12, T 1024, C 64, bf16) that is 25.8, 38.7 and 51.6 GFLOP, 0.026-0.052
// ms at the tensor cores' 989 TFLOP/s, against 0.030-0.053 ms to move each
// tensor once at 3.35 TB/s: the two bounds are within 20% of each other,
// and the kernels do more products than that count (the forward's second
// Q.K^T, the backward's recomputed Q.K^T in both kernels), so what limits
// them is tensor-core work and the exp, shuffle and shared-memory traffic
// around it.
//
// Design of the bfloat16 kernels (the `*_mma` kernels below):
//   * products on the tensor cores: mma.sync.m16n8k16, bf16 operands, f32
//     accumulators. The rounding points above are exactly the operand
//     conversions the tensor cores need: p (or ds) is rounded to bf16 when
//     the f32 score fragment is repacked, in registers, into the A fragment
//     of the next product;
//   * one block of 4 warps per (head, 64-row tile); each warp owns 16 rows
//     (queries; keys in dK/dV), so row max and row sum are shuffles within
//     a quad of lanes. The block loops over the tiles of the other sequence,
//     skipping tiles above the diagonal (per warp, for its own 16 rows), and
//     keeps its running state in registers; the longest rows go first;
//   * tiles are staged in shared memory as bf16, never widened, with a row
//     stride of C + 8 elements (16 bytes of padding: the 8 row addresses of
//     an ldmatrix fall in 8 distinct bank groups). Operands are read with
//     ldmatrix; the operands read along the other axis (V and K as B of
//     P.V and dS.K, Q and dO as B of P^T.dO and dS^T.Q) with ldmatrix.trans.
//     dK/dV computes S^T = K.Q^T and dP^T = V.dO^T directly, so P^T and dS^T
//     come out of the accumulators in A-fragment order: no transpose;
//   * K/V tiles (forward, dQ) and Q/dO/O/lse tiles (dK/dV) arrive by
//     cp.async in a ring of two stages: the next tile's copies are in flight
//     while the current tile's products run. Rows at or past T are
//     zero-filled by cp.async (source size 0) and masked to MASK;
//   * dK/dV at C = 128 takes query tiles of 32 rows: its two 16 x 128 f32
//     accumulators take 128 registers a thread, and a 64-row tile's S^T and
//     dP^T fragments would take 64 more. At C = 64 it is held to 168
//     registers, so that 3 blocks fit an SM, not 2;
//   * the forward tests each tile once per warp: a tile wholly at or below
//     the warp's diagonal and inside its chunk is only scaled; the others
//     compare each column with min(row, chunk end - 1). No bf16 kernel
//     spills registers.
// float32 inputs keep the SIMT kernels (the templates without `_mma`): the
// tensor cores take f32 only as TF32, which keeps about three decimal
// digits, and the f32 path is held to 1e-5 (kernel vs plain; the f32 flash
// train step vs dense attention). Those kernels stage f32 tiles with row
// stride C + 1 and do every product with scalar FMAs: thread (ty, tx) of 256
// owns rows ty + 16a and columns tx + 16b of a 64 x 64 tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kMask = -1.0e30f;
constexpr float kMInit = -0.5e30f;
constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows per block, columns per inner tile
constexpr int kSLd = kTile + 1;    // row stride of a 64 x 64 f32 tile
constexpr size_t kSmemMax = 227 * 1024;

// The SIMT kernels below are templates over the element type as the TPU
// bodies are, instantiated for float only (bf16 takes the tensor cores).
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// x rounded to T and widened back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Stage rows [row0, row0 + 64) of a (T, C) matrix into shared memory as f32
// with row stride C + 1; rows >= T are zero.
template <typename T, int C>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int T_len) {
  constexpr int ld = C + 1;
  for (int e = threadIdx.x; e < kTile * C; e += kThreads) {
    const int r = e / C, c = e - (e / C) * C;
    const int row = row0 + r;
    dst[r * ld + c] = row < T_len ? to_f32(src[static_cast<size_t>(row) * C + c]) : 0.f;
  }
}

// acc[a][b] += sum_c A[ty + 16a][c] * B[tx + 16b][c] over two f32 tiles of
// stride C + 1 (a 64 x 64 block of A . B^T).
template <int C>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int ld = C + 1;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * ld + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * ld + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[a][b] += sum_j P[ty + 16a][j] * V[j][tx + 16b] for a 64 x 64 tile P
// (stride 65) and a 64 x C tile V (stride C + 1).
template <int C>
__device__ __forceinline__ void pv_tile(float (&acc)[4][C / 16], const float* P,
                                        const float* V, int ty, int tx) {
  constexpr int ld = C + 1;
  constexpr int nc = C / 16;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float p[4], v[nc];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * kSLd + j];
#pragma unroll
    for (int b = 0; b < nc; ++b) v[b] = V[j * ld + tx + 16 * b];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < nc; ++b) acc[i][b] = fmaf(p[i], v[b], acc[i][b]);
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// delta[r] = sum_c O[row0 + r][c] * dO[r][c] for the 64 rows of a tile: one
// warp per 8 rows; dO is the staged f32 tile, O is read from device memory.
template <typename T, int C>
__device__ __forceinline__ void tile_delta(float* delta_s, const T* __restrict__ o,
                                           const float* dO_s, int row0, int T_len) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp * (kTile / 8); r < (warp + 1) * (kTile / 8); ++r) {
    const int row = row0 + r;
    float d = 0.f;
    if (row < T_len) {
      for (int c = lane; c < C; c += 32)
        d = fmaf(to_f32(o[static_cast<size_t>(row) * C + c]), dO_s[r * (C + 1) + c], d);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (lane == 0) delta_s[r] = d;
  }
}

// ---------------------------------------------------------------- f32: SIMT forward

template <typename T, int C, bool Causal>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int T_len, int chunk, float scale) {
  constexpr int ld = C + 1;
  constexpr int nc = C / 16;
  const int n = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;  // longest rows first
  const int r0 = tile * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t base = static_cast<size_t>(n) * T_len * C;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [64][C + 1]
  float* k_s = q_s + kTile * ld;     // [64][C + 1]
  float* v_s = k_s + kTile * ld;     // [64][C + 1]
  float* p_s = v_s + kTile * ld;     // [64][65] p rounded to V's dtype

  load_tile<T, C>(q_s, q + base, r0, T_len);

  float m[4], l[4], acc[4][nc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMInit;
    l[i] = 0.f;
#pragma unroll
    for (int b = 0; b < nc; ++b) acc[i][b] = 0.f;
  }
  // the tile's last visible column: its causal limit, or the sequence's end
  const int last_col = Causal ? min(r0 + kTile - 1, T_len - 1) : T_len - 1;

  for (int c0 = 0; c0 <= last_col; c0 += chunk) {
    const int c_end = min(c0 + chunk, T_len);
    // Sweep A: the chunk's row max.
    float cm[4] = {kMask, kMask, kMask, kMask};
    for (int kt = c0; kt < c_end && kt <= last_col; kt += kTile) {
      __syncthreads();  // k_s is free (previous readers done)
      load_tile<T, C>(k_s, k + base, kt, T_len);
      __syncthreads();
      float s[4][4] = {};
      dot_tile<C>(s, q_s, k_s, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = r0 + ty + 16 * i, col = kt + tx + 16 * j;
          const float sv = ((!Causal || col <= row) && col < c_end) ? s[i][j] * scale : kMask;
          cm[i] = fmaxf(cm[i], sv);
        }
    }
    float alpha[4], m_new[4], lsum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m_new[i] = fmaxf(m[i], row_max16(cm[i]));
      alpha[i] = expf(m[i] - m_new[i]);  // 0 on the first chunk (M_INIT)
      lsum[i] = 0.f;
#pragma unroll
      for (int b = 0; b < nc; ++b) acc[i][b] *= alpha[i];
    }
    // Sweep B: p with the chunk's max, its sum, and PV.
    for (int kt = c0; kt < c_end && kt <= last_col; kt += kTile) {
      __syncthreads();
      load_tile<T, C>(k_s, k + base, kt, T_len);
      load_tile<T, C>(v_s, v + base, kt, T_len);
      __syncthreads();
      float s[4][4] = {};
      dot_tile<C>(s, q_s, k_s, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = r0 + ty + 16 * i, col = kt + tx + 16 * j;
          const float sv = ((!Causal || col <= row) && col < c_end) ? s[i][j] * scale : kMask;
          const float p = expf(sv - m_new[i]);  // masked: exactly 0
          lsum[i] += p;
          p_s[(ty + 16 * i) * kSLd + tx + 16 * j] = round_to<T>(p);
        }
      __syncthreads();
      pv_tile<C>(acc, p_s, v_s, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = l[i] * alpha[i] + row_sum16(lsum[i]);
      m[i] = m_new[i];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= T_len) continue;
    const float safe_l = fmaxf(l[i], 1e-30f);
    T* o_row = out + base + static_cast<size_t>(row) * C;
#pragma unroll
    for (int b = 0; b < nc; ++b) o_row[tx + 16 * b] = from_f32<T>(acc[i][b] / safe_l);
    if (tx == 0) lse[static_cast<size_t>(n) * T_len + row] = l[i] > 0.f ? m[i] + logf(safe_l) : kMask;
  }
}

// ---------------------------------------------------------------- f32: SIMT backward

template <typename T, int C, bool Causal>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    T* __restrict__ dq, int T_len, float scale) {
  constexpr int ld = C + 1;
  constexpr int nc = C / 16;
  const int n = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;  // longest rows first
  const int r0 = tile * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t base = static_cast<size_t>(n) * T_len * C;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [64][C + 1]
  float* do_s = q_s + kTile * ld;     // [64][C + 1]
  float* k_s = do_s + kTile * ld;     // [64][C + 1]
  float* v_s = k_s + kTile * ld;      // [64][C + 1]
  float* ds_s = v_s + kTile * ld;     // [64][65] ds rounded to q's dtype
  float* lse_s = ds_s + kTile * kSLd; // [64]
  float* delta_s = lse_s + kTile;     // [64]

  load_tile<T, C>(q_s, q + base, r0, T_len);
  load_tile<T, C>(do_s, dout + base, r0, T_len);
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    lse_s[r] = r0 + r < T_len ? lse[static_cast<size_t>(n) * T_len + r0 + r] : 0.f;
  __syncthreads();
  tile_delta<T, C>(delta_s, o + base, do_s, r0, T_len);

  float acc[4][nc];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < nc; ++b) acc[i][b] = 0.f;
  const int last_col = Causal ? min(r0 + kTile - 1, T_len - 1) : T_len - 1;

  for (int kt = 0; kt <= last_col; kt += kTile) {
    __syncthreads();  // k_s / v_s / ds_s free; delta_s written (first pass)
    load_tile<T, C>(k_s, k + base, kt, T_len);
    load_tile<T, C>(v_s, v + base, kt, T_len);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_tile<C>(s, q_s, k_s, ty, tx);
    dot_tile<C>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, row = r0 + r, col = kt + tx + 16 * j;
        const float sv = ((!Causal || col <= row) && col < T_len) ? s[i][j] * scale : kMask;
        const float p = expf(sv - lse_s[r]);
        ds_s[r * kSLd + tx + 16 * j] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
      }
    __syncthreads();
    pv_tile<C>(acc, ds_s, k_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= T_len) continue;
    T* d_row = dq + base + static_cast<size_t>(row) * C;
#pragma unroll
    for (int b = 0; b < nc; ++b) d_row[tx + 16 * b] = from_f32<T>(acc[i][b]);
  }
}

template <typename T, int C, bool Causal>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    T* __restrict__ dk, T* __restrict__ dv, int T_len, float scale) {
  constexpr int ld = C + 1;
  constexpr int nc = C / 16;
  const int n = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // low key tiles see the most queries: first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t base = static_cast<size_t>(n) * T_len * C;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                   // [64][C + 1]
  float* v_s = k_s + kTile * ld;       // [64][C + 1]
  float* q_s = v_s + kTile * ld;       // [64][C + 1]
  float* do_s = q_s + kTile * ld;      // [64][C + 1]
  float* pt_s = do_s + kTile * ld;     // [64 keys][65] p^T rounded to dO's dtype
  float* dst_s = pt_s + kTile * kSLd;  // [64 keys][65] ds^T rounded to q's dtype
  float* lse_s = dst_s + kTile * kSLd; // [64]
  float* delta_s = lse_s + kTile;      // [64]

  load_tile<T, C>(k_s, k + base, k0, T_len);
  load_tile<T, C>(v_s, v + base, k0, T_len);

  float dk_acc[4][nc], dv_acc[4][nc];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < nc; ++b) dk_acc[i][b] = dv_acc[i][b] = 0.f;

  // Causal: the query tiles at or below the diagonal, rows >= k0 (tiles
  // are aligned); otherwise every query tile.
  for (int i0 = Causal ? k0 : 0; i0 < T_len; i0 += kTile) {
    __syncthreads();  // q_s / do_s / pt_s / dst_s free
    load_tile<T, C>(q_s, q + base, i0, T_len);
    load_tile<T, C>(do_s, dout + base, i0, T_len);
    for (int r = threadIdx.x; r < kTile; r += kThreads)
      lse_s[r] = i0 + r < T_len ? lse[static_cast<size_t>(n) * T_len + i0 + r] : 0.f;
    __syncthreads();
    tile_delta<T, C>(delta_s, o + base, do_s, i0, T_len);
    __syncthreads();
    // Transposed tiles: thread rows are keys j, thread columns are queries i.
    float st[4][4] = {}, dpt[4][4] = {};
    dot_tile<C>(st, k_s, q_s, ty, tx);
    dot_tile<C>(dpt, v_s, do_s, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int jr = ty + 16 * a, ir = tx + 16 * b;
        const int key = k0 + jr, row = i0 + ir;
        const float sv = ((!Causal || key <= row) && row < T_len && key < T_len) ? st[a][b] * scale : kMask;
        const float p = expf(sv - lse_s[ir]);
        pt_s[jr * kSLd + ir] = round_to<T>(p);
        dst_s[jr * kSLd + ir] = round_to<T>(p * (dpt[a][b] - delta_s[ir]) * scale);
      }
    __syncthreads();
    pv_tile<C>(dv_acc, pt_s, do_s, ty, tx);
    pv_tile<C>(dk_acc, dst_s, q_s, ty, tx);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= T_len) continue;
    T* dk_row = dk + base + static_cast<size_t>(key) * C;
    T* dv_row = dv + base + static_cast<size_t>(key) * C;
#pragma unroll
    for (int b = 0; b < nc; ++b) {
      dk_row[tx + 16 * b] = from_f32<T>(dk_acc[a][b]);
      dv_row[tx + 16 * b] = from_f32<T>(dv_acc[a][b]);
    }
  }
}

// ---------------------------------------------------------------- bf16: tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a block owns: 16 per warp
constexpr int kKvTile = 64;         // K/V rows per tile (forward, dQ)

template <int C> __host__ __device__ constexpr int ld() { return C + 8; }  // padded row stride, elements
// query rows per tile in dK/dV: 32 at C = 128 keeps the accumulators in registers
template <int C> __host__ __device__ constexpr int dkv_q_tile() { return C == 64 ? 64 : 32; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most one committed group (the newest) is still in flight
__device__ __forceinline__ void cp_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even, as torch's .to(torch.bfloat16)),
// `lo` in the low half: the element of the smaller column in a fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts of m16n8k16 (lane = 4 g + t): an accumulator tile j of
// 8 columns holds (row g, cols 8j + 2t, 8j + 2t + 1) in [0], [1] and (row
// g + 8, same cols) in [2], [3]; an A fragment over 16 columns k0.. holds
// (g, k0 + 2t..), (g + 8, k0 + 2t..), (g, k0 + 8 + 2t..), (g + 8, k0 + 8 + 2t..).

// acc[j] += A . B^T for one warp: A the 16 x K rows at `a`, B the N x K rows
// at `b` (both row-major in shared memory, row strides LA and LB).
template <int K, int N, int LA, int LB>
__device__ __forceinline__ void gemm_abt(float (&acc)[N / 8][4], const bf16* a, const bf16* b, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * LA + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LB + k0 + ((lane >> 3) & 1) * 8);
      mma16816(acc[n0 / 8], af, bf[0], bf[1]);
      mma16816(acc[n0 / 8 + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[j] += P . B for one warp: P (16 x K) as A fragments in registers, B
// the K x N rows at `b` (row-major in shared memory, row stride LB), read
// with ldmatrix.trans.
template <int K, int N, int LB>
__device__ __forceinline__ void gemm_pb(float (&acc)[N / 8][4], const uint32_t (&pf)[K / 16][4],
                                        const bf16* b, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LB + n0 + (lane >> 4) * 8);
      mma16816(acc[n0 / 8], pf[k0 / 16], bf[0], bf[1]);
      mma16816(acc[n0 / 8 + 1], pf[k0 / 16], bf[2], bf[3]);
    }
  }
}

// The A fragment of columns 16 kk.. of a 16 x N f32 accumulator, rounded.
template <int N>
__device__ __forceinline__ void to_a_frag(uint32_t (&f)[4], const float (&acc)[N / 8][4], int kk) {
  f[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
  f[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
  f[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  f[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + R) of a (T, C) bf16 matrix into shared memory (row
// stride C + 8) by cp.async, 16 bytes a copy; rows >= T are zero-filled.
template <int R, int C>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int row0, int T_len) {
  constexpr int chunks = C / 8;
#pragma unroll
  for (int e = threadIdx.x; e < R * chunks; e += kThreads) {
    const int r = e / chunks, c = (e % chunks) * 8;
    const int row = row0 + r;
    const bool ok = row < T_len;
    cp_async16(dst + r * ld<C>() + c, src + static_cast<size_t>(ok ? row : 0) * C + c, ok);
  }
}

// f32 accumulator rows (g and g + 8 of the warp's 16, starting at `row`)
// divided by `div` and rounded, as bf16 pairs; rows >= T are not written.
template <int C>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[C / 8][4], int row,
                                           int T_len, int t, float div_a, float div_b) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= T_len) continue;
    const float div = h ? div_b : div_a;
    bf16* d = dst + static_cast<size_t>(r) * C + 2 * t;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const uint32_t v = pack_bf16(acc[j][2 * h] / div, acc[j][2 * h + 1] / div);
      *reinterpret_cast<uint32_t*>(d + 8 * j) = v;
    }
  }
}

// The forward's schedule: chunk by chunk, each chunk's tiles swept twice
// (phase 0: the row max; phase 1: p, l and PV), tiles of kKvTile columns
// from the chunk's start, stopping at the block's causal limit.
struct FwdStep {
  int c0, kt, phase;
};

__device__ __forceinline__ bool next_step(FwdStep& s, int chunk, int last_col) {
  s.kt += kKvTile;
  if (s.kt < min(s.c0 + chunk, last_col + 1)) return true;
  if (s.phase == 0) {
    s.phase = 1;
    s.kt = s.c0;
    return true;
  }
  s.c0 += chunk;
  s.phase = 0;
  s.kt = s.c0;
  return s.c0 <= last_col;
}

template <int C, bool Causal>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, int T_len, int chunk, float scale) {
  constexpr int L = ld<C>();
  constexpr int NT = kKvTile / 8;  // accumulator tiles of a score row block
  const int n = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(n) * T_len * C;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [64][L]
  bf16* k_s = q_s + kRows * L;                     // [2 stages][64][L]
  bf16* v_s = k_s + 2 * kKvTile * L;               // [2 stages][64][L]

  // the block's last visible column: its causal limit, or the sequence's end
  const int last_col = Causal ? min(r0 + kRows - 1, T_len - 1) : T_len - 1;
  const int w_last = r0 + 16 * warp + 15;  // the warp's last row
  const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
  const bf16* q_w = q_s + 16 * warp * L;

  float m_a = kMInit, m_b = kMInit, l_a = 0.f, l_b = 0.f;
  float mn_a = kMInit, mn_b = kMInit, cm_a = kMask, cm_b = kMask, ls_a = 0.f, ls_b = 0.f;
  float acc[C / 8][4];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  FwdStep cur{0, 0, 0};
  stage_rows<kRows, C>(q_s, q + base, r0, T_len);
  stage_rows<kKvTile, C>(k_s, kb, 0, T_len);
  cp_commit();
  int stage = 0;
  for (bool more = true; more;) {
    FwdStep nxt = cur;
    more = next_step(nxt, chunk, last_col);
    if (more) {  // the next tile's copies fly while this tile's products run
      stage_rows<kKvTile, C>(k_s + (stage ^ 1) * kKvTile * L, kb, nxt.kt, T_len);
      if (nxt.phase) stage_rows<kKvTile, C>(v_s + (stage ^ 1) * kKvTile * L, vb, nxt.kt, T_len);
    }
    cp_commit();
    cp_wait_all_but_newest();
    __syncthreads();

    if (!Causal || cur.kt <= w_last) {  // else every column of the tile is above the warp's rows
      const int c_end = min(cur.c0 + chunk, T_len);
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      gemm_abt<C, kKvTile, L, L>(s, q_w, k_s + stage * kKvTile * L, lane);
      if ((!Causal || cur.kt + kKvTile - 1 <= r0 + 16 * warp) && cur.kt + kKvTile <= c_end) {
        // the tile lies wholly at or below the warp's diagonal (or there is
        // none) and inside the chunk
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
      } else {  // column col of a row is visible iff col <= min(row, c_end - 1) (causal), c_end - 1
        const int lim_a = (Causal ? min(row_a, c_end - 1) : c_end - 1) - cur.kt - 2 * t;  // as 8 j + (e & 1)
        const int lim_b = (Causal ? min(row_b, c_end - 1) : c_end - 1) - cur.kt - 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = 8 * j + (e & 1) <= (e < 2 ? lim_a : lim_b) ? __fmul_rn(s[j][e], scale) : kMask;
      }
      if (cur.phase == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          cm_a = fmaxf(cm_a, fmaxf(s[j][0], s[j][1]));
          cm_b = fmaxf(cm_b, fmaxf(s[j][2], s[j][3]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          s[j][0] = expf(s[j][0] - mn_a);  // masked: exactly 0
          s[j][1] = expf(s[j][1] - mn_a);
          s[j][2] = expf(s[j][2] - mn_b);
          s[j][3] = expf(s[j][3] - mn_b);
          ls_a += s[j][0] + s[j][1];
          ls_b += s[j][2] + s[j][3];
        }
        uint32_t pf[kKvTile / 16][4];  // p rounded to bf16: the rounding point
#pragma unroll
        for (int kk = 0; kk < kKvTile / 16; ++kk) to_a_frag<kKvTile>(pf[kk], s, kk);
        gemm_pb<kKvTile, C, L>(acc, pf, v_s + stage * kKvTile * L, lane);
      }
    }

    if (cur.phase == 0 && (!more || nxt.phase == 1)) {  // the chunk's max is known
      mn_a = fmaxf(m_a, quad_max(cm_a));
      mn_b = fmaxf(m_b, quad_max(cm_b));
      const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);  // 0 on the first chunk
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        acc[j][0] *= al_a;
        acc[j][1] *= al_a;
        acc[j][2] *= al_b;
        acc[j][3] *= al_b;
      }
      l_a *= al_a;
      l_b *= al_b;
      cm_a = cm_b = kMask;
      ls_a = ls_b = 0.f;
    } else if (cur.phase == 1 && (!more || nxt.phase == 0)) {  // the chunk is done
      l_a += quad_sum(ls_a);
      l_b += quad_sum(ls_b);
      m_a = mn_a;
      m_b = mn_b;
    }
    __syncthreads();  // this stage is free for the copies of the step after next
    cur = nxt;
    stage ^= 1;
  }

  const float sl_a = fmaxf(l_a, 1e-30f), sl_b = fmaxf(l_b, 1e-30f);
  store_rows<C>(out + base, acc, row_a, T_len, t, sl_a, sl_b);
  if (t == 0) {
    float* lse_n = lse + static_cast<size_t>(n) * T_len;
    if (row_a < T_len) lse_n[row_a] = l_a > 0.f ? m_a + logf(sl_a) : kMask;
    if (row_b < T_len) lse_n[row_b] = l_b > 0.f ? m_b + logf(sl_b) : kMask;
  }
}

// sum over W channels of a[c] * b[c] in f32, two bf16 rows read 16 bytes at
// a time (global or shared memory)
template <int W>
__device__ __forceinline__ float dot_bf16(const bf16* a, const bf16* b) {
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < W; c += 8) {
    const uint4 ua = *reinterpret_cast<const uint4*>(a + c);
    const uint4 ub = *reinterpret_cast<const uint4*>(b + c);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&ua);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&ub);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(pa[i]), fb = __bfloat1622float2(pb[i]);
      d = fmaf(fa.x, fb.x, d);
      d = fmaf(fa.y, fb.y, d);
    }
  }
  return d;
}

template <int C, bool Causal>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    bf16* __restrict__ dq, int T_len, float scale) {
  constexpr int L = ld<C>();
  constexpr int NT = kKvTile / 8;
  const int n = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(n) * T_len * C;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);               // [64][L]
  bf16* do_s = q_s + kRows * L;                                 // [64][L]
  bf16* k_s = do_s + kRows * L;                                 // [2 stages][64][L]
  bf16* v_s = k_s + 2 * kKvTile * L;                            // [2 stages][64][L]
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * kKvTile * L);  // [64]
  float* delta_s = lse_s + kRows;                               // [64]

  stage_rows<kRows, C>(q_s, q + base, r0, T_len);
  stage_rows<kRows, C>(do_s, dout + base, r0, T_len);
  stage_rows<kKvTile, C>(k_s, kb, 0, T_len);
  stage_rows<kKvTile, C>(v_s, vb, 0, T_len);
  cp_commit();
  {  // lse and delta = rowsum(O * dO) of the block's rows, two threads a row
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = r0 + r;
    float d = 0.f;
    if (row < T_len) {
      const size_t off = base + static_cast<size_t>(row) * C + half * (C / 2);
      d = dot_bf16<C / 2>(o + off, dout + off);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      delta_s[r] = d;
      lse_s[r] = row < T_len ? lse[static_cast<size_t>(n) * T_len + row] : 0.f;
    }
  }

  const int last_col = Causal ? min(r0 + kRows - 1, T_len - 1) : T_len - 1;
  const int w_last = r0 + 16 * warp + 15;
  const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
  const bf16* q_w = q_s + 16 * warp * L;
  const bf16* do_w = do_s + 16 * warp * L;
  float acc[C / 8][4];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int stage = 0;
  for (int kt = 0; kt <= last_col; kt += kKvTile) {
    const bool more = kt + kKvTile <= last_col;
    if (more) {
      stage_rows<kKvTile, C>(k_s + (stage ^ 1) * kKvTile * L, kb, kt + kKvTile, T_len);
      stage_rows<kKvTile, C>(v_s + (stage ^ 1) * kKvTile * L, vb, kt + kKvTile, T_len);
    }
    cp_commit();
    cp_wait_all_but_newest();
    __syncthreads();  // also: lse_s and delta_s written (first pass)

    if (!Causal || kt <= w_last) {
      const bf16* k_t = k_s + stage * kKvTile * L;
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      gemm_abt<C, kKvTile, L, L>(s, q_w, k_t, lane);                            // S = Q K^T
      gemm_abt<C, kKvTile, L, L>(dp, do_w, v_s + stage * kKvTile * L, lane);  // dP = dO V^T
      const float ls_a = lse_s[row_a - r0], ls_b = lse_s[row_b - r0];
      const float dl_a = delta_s[row_a - r0], dl_b = delta_s[row_b - r0];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kt + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          const float sv = ((!Causal || col <= row) && col < T_len) ? __fmul_rn(s[j][e], scale) : kMask;
          const float p = expf(sv - (e < 2 ? ls_a : ls_b));
          s[j][e] = __fmul_rn(p * (dp[j][e] - (e < 2 ? dl_a : dl_b)), scale);
        }
      uint32_t dsf[kKvTile / 16][4];  // ds rounded to bf16: the rounding point
#pragma unroll
      for (int kk = 0; kk < kKvTile / 16; ++kk) to_a_frag<kKvTile>(dsf[kk], s, kk);
      gemm_pb<kKvTile, C, L>(acc, dsf, k_t, lane);  // dQ += dS K
    }
    __syncthreads();
    stage ^= 1;
  }
  store_rows<C>(dq + base, acc, row_a, T_len, t, 1.f, 1.f);
}

// At C = 64, 3 blocks an SM (at most 170 registers a thread) rather than 2.
template <int C, bool Causal>
__global__ void __launch_bounds__(kThreads, C == 64 ? 3 : 1) flash_bwd_dkv_kernel_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int T_len, float scale) {
  constexpr int L = ld<C>();
  constexpr int QT = dkv_q_tile<C>();  // query rows per tile
  constexpr int NT = QT / 8;
  constexpr int TPR = kThreads / QT;   // threads per row of the delta pass
  const int n = blockIdx.x;
  const int k0 = blockIdx.y * kRows;  // low key tiles see the most queries: first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(n) * T_len * C;
  const float* lse_n = lse + static_cast<size_t>(n) * T_len;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [64][L]
  bf16* v_s = k_s + kRows * L;                     // [64][L]
  bf16* q_s = v_s + kRows * L;                     // [2 stages][QT][L]
  bf16* do_s = q_s + 2 * QT * L;                   // [2 stages][QT][L]
  bf16* o_s = do_s + 2 * QT * L;                   // [2 stages][QT][L]
  float* lse_s = reinterpret_cast<float*>(o_s + 2 * QT * L);  // [2 stages][QT]
  float* delta_s = lse_s + 2 * QT;                             // [QT]

  // the Q-side rows of one query tile: q, dO, O and lse, by cp.async
  auto stage_queries = [&](int st, int i0) {
    stage_rows<QT, C>(q_s + st * QT * L, q + base, i0, T_len);
    stage_rows<QT, C>(do_s + st * QT * L, dout + base, i0, T_len);
    stage_rows<QT, C>(o_s + st * QT * L, o + base, i0, T_len);
    if (threadIdx.x < QT) {
      const int row = i0 + threadIdx.x;
      cp_async4(lse_s + st * QT + threadIdx.x, lse_n + (row < T_len ? row : 0), row < T_len);
    }
  };

  // Causal: the query tiles at or below the diagonal, rows >= k0 (k0 is a
  // multiple of QT); otherwise every query tile.
  const int i_first = Causal ? k0 : 0;
  stage_rows<kRows, C>(k_s, k + base, k0, T_len);
  stage_rows<kRows, C>(v_s, v + base, k0, T_len);
  stage_queries(0, i_first);
  cp_commit();

  const int kw0 = k0 + 16 * warp;  // the warp's first key
  const int key_a = kw0 + g, key_b = key_a + 8;
  const bf16* k_w = k_s + 16 * warp * L;
  const bf16* v_w = v_s + 16 * warp * L;
  float dk_acc[C / 8][4], dv_acc[C / 8][4];
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  int stage = 0;
  for (int i0 = i_first; i0 < T_len; i0 += QT) {
    const bool more = i0 + QT < T_len;
    if (more) stage_queries(stage ^ 1, i0 + QT);
    cp_commit();
    cp_wait_all_but_newest();
    __syncthreads();
    const bf16* q_t = q_s + stage * QT * L;
    const bf16* do_t = do_s + stage * QT * L;
    {  // delta = rowsum(O * dO) of the tile's rows, from O and dO as stored
      const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
      const int off = r * L + part * (C / TPR);
      float d = dot_bf16<C / TPR>(o_s + stage * QT * L + off, do_t + off);
#pragma unroll
      for (int w = 1; w < TPR; w <<= 1) d += __shfl_xor_sync(0xffffffffu, d, w);
      if (part == 0) delta_s[r] = d;
    }
    __syncthreads();

    if (!Causal || i0 + QT - 1 >= kw0) {  // else every row of the tile is above the warp's keys
      // transposed tiles: rows are the warp's 16 keys, columns the tile's queries
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      gemm_abt<C, QT, L, L>(st, k_w, q_t, lane);    // S^T = K Q^T
      gemm_abt<C, QT, L, L>(dpt, v_w, do_t, lane);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = 8 * j + 2 * t + (e & 1), row = i0 + ri;
          const int key = e < 2 ? key_a : key_b;
          const bool ok = (!Causal || key <= row) && row < T_len && key < T_len;
          const float sv = ok ? __fmul_rn(st[j][e], scale) : kMask;
          const float p = expf(sv - lse_s[stage * QT + ri]);
          st[j][e] = p;
          dpt[j][e] = __fmul_rn(p * (dpt[j][e] - delta_s[ri]), scale);
        }
      uint32_t ptf[QT / 16][4], dsf[QT / 16][4];  // p^T and ds^T rounded to bf16
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        to_a_frag<QT>(ptf[kk], st, kk);
        to_a_frag<QT>(dsf[kk], dpt, kk);
      }
      gemm_pb<QT, C, L>(dv_acc, ptf, do_t, lane);  // dV += P^T dO
      gemm_pb<QT, C, L>(dk_acc, dsf, q_t, lane);   // dK += dS^T Q
    }
    __syncthreads();
    stage ^= 1;
  }
  store_rows<C>(dk + base, dk_acc, key_a, T_len, t, 1.f, 1.f);
  store_rows<C>(dv + base, dv_acc, key_a, T_len, t, 1.f, 1.f);
}

}  // namespace tc

// ---------------------------------------------------------------- launch

static_assert(tc::kRows == kTile, "both paths tile the rows of a block by 64");

template <int C> constexpr size_t fwd_smem() {
  return (3 * kTile * (C + 1) + kTile * kSLd) * sizeof(float);
}
template <int C> constexpr size_t dq_smem() {
  return (4 * kTile * (C + 1) + kTile * kSLd + 2 * kTile) * sizeof(float);
}
template <int C> constexpr size_t dkv_smem() {
  return (4 * kTile * (C + 1) + 2 * kTile * kSLd + 2 * kTile) * sizeof(float);
}
// bf16: Q + a 2-stage K/V ring
template <int C> constexpr size_t fwd_smem_mma() {
  return (tc::kRows + 4 * tc::kKvTile) * tc::ld<C>() * sizeof(__nv_bfloat16);
}
// bf16: Q, dO + a 2-stage K/V ring, lse and delta
template <int C> constexpr size_t dq_smem_mma() {
  return (2 * tc::kRows + 4 * tc::kKvTile) * tc::ld<C>() * sizeof(__nv_bfloat16) +
         2 * tc::kRows * sizeof(float);
}
// bf16: K, V + a 2-stage ring of Q, dO, O and lse tiles, delta
template <int C> constexpr size_t dkv_smem_mma() {
  return (2 * tc::kRows + 6 * tc::dkv_q_tile<C>()) * tc::ld<C>() * sizeof(__nv_bfloat16) +
         3 * tc::dkv_q_tile<C>() * sizeof(float);
}

// Opt in to more than 48 KB of dynamic shared memory, once per kernel
// instantiation (no stream operation: launches stay capturable in graphs).
template <typename K>
int allow_smem(K kernel, size_t smem, bool& done) {
  if (done || smem <= 48 * 1024) return 0;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

template <typename T, int C, bool Causal>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int N,
               int T_len, int chunk, float scale, cudaStream_t stream) {
  static bool ready = false;
  const dim3 grid(N, (T_len + kTile - 1) / kTile);
  if constexpr (kTensorCores<T>) {
    const size_t smem = fwd_smem_mma<C>();
    if (int e = allow_smem(tc::flash_fwd_kernel_mma<C, Causal>, smem, ready)) return e;
    tc::flash_fwd_kernel_mma<C, Causal><<<grid, tc::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), lse, T_len, chunk, scale);
  } else {
    const size_t smem = fwd_smem<C>();
    if (int e = allow_smem(flash_fwd_kernel<T, C, Causal>, smem, ready)) return e;
    flash_fwd_kernel<T, C, Causal><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), lse, T_len, chunk, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C, bool Causal>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, int N, int T_len, float scale, cudaStream_t stream) {
  static bool ready = false;
  const dim3 grid(N, (T_len + kTile - 1) / kTile);
  if constexpr (kTensorCores<T>) {
    const size_t smem = dq_smem_mma<C>();
    if (int e = allow_smem(tc::flash_bwd_dq_kernel_mma<C, Causal>, smem, ready)) return e;
    tc::flash_bwd_dq_kernel_mma<C, Causal><<<grid, tc::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq), T_len,
        scale);
  } else {
    const size_t smem = dq_smem<C>();
    if (int e = allow_smem(flash_bwd_dq_kernel<T, C, Causal>, smem, ready)) return e;
    flash_bwd_dq_kernel<T, C, Causal><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq), T_len,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C, bool Causal>
int launch_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dk, void* dv, int N, int T_len, float scale,
               cudaStream_t stream) {
  static bool ready = false;
  const dim3 grid(N, (T_len + kTile - 1) / kTile);
  if constexpr (kTensorCores<T>) {
    const size_t smem = dkv_smem_mma<C>();
    if (int e = allow_smem(tc::flash_bwd_dkv_kernel_mma<C, Causal>, smem, ready)) return e;
    tc::flash_bwd_dkv_kernel_mma<C, Causal><<<grid, tc::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dk),
        static_cast<T*>(dv), T_len, scale);
  } else {
    const size_t smem = dkv_smem<C>();
    if (int e = allow_smem(flash_bwd_dkv_kernel<T, C, Causal>, smem, ready)) return e;
    flash_bwd_dkv_kernel<T, C, Causal><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dk),
        static_cast<T*>(dv), T_len, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int N, int T_len, int C, int dtype) {
  return N >= 1 && T_len >= 1 && (T_len + kTile - 1) / kTile <= 65535 &&
         (C == 64 || C == 128) && (dtype == 0 || dtype == 1);
}

}  // namespace

// Dispatch on (causal, dtype, C): causal 1 = the causal bodies, 0 = the
// full ones; dtype 0 = float32, 1 = bfloat16; C in {64, 128}.
#define FLASH_DISPATCH_C(FN, CAUSAL, ...)                                         \
  do {                                                                            \
    if (dtype == 0 && C == 64) return FN<float, 64, CAUSAL>(__VA_ARGS__);         \
    if (dtype == 0 && C == 128) return FN<float, 128, CAUSAL>(__VA_ARGS__);       \
    if (dtype == 1 && C == 64) return FN<__nv_bfloat16, 64, CAUSAL>(__VA_ARGS__); \
    return FN<__nv_bfloat16, 128, CAUSAL>(__VA_ARGS__);                           \
  } while (0)
#define FLASH_DISPATCH(FN, ...)                                                   \
  do {                                                                            \
    if (causal) FLASH_DISPATCH_C(FN, true, __VA_ARGS__);                          \
    FLASH_DISPATCH_C(FN, false, __VA_ARGS__);                                     \
  } while (0)

extern "C" {

// Every launch function returns the cudaError_t of its launch (0 on success).
// The caller guarantees contiguous tensors of the shapes in the header note,
// all on the current device, and 1 <= chunk with chunk dividing T (fwd).

int flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int N,
              int T_len, int C, int chunk, float scale, int dtype, int causal, void* stream) {
  if (!shape_ok(N, T_len, C, dtype) || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, out, lse, N, T_len, chunk, scale, s);
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, void* dq, int N, int T_len, int C, float scale, int dtype,
                 int causal, void* stream) {
  if (!shape_ok(N, T_len, C, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, o, dout, lse, dq, N, T_len, scale, s);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, void* dk, void* dv, int N, int T_len, int C, float scale,
                  int dtype, int causal, void* stream) {
  if (!shape_ok(N, T_len, C, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, o, dout, lse, dk, dv, N, T_len, scale, s);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
