// Causal flash attention for Hopper (sm_90a): forward, and the backward as
// two kernels (dQ; dK with dV), for the training path.
//
// Replaces: midgpt_tpu/kernels/flash_attention.py, every body reached from
// its pl.pallas_call sites:
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
//   * forward: p is rounded to V's dtype before the PV product, accumulated
//     in f32. The TPU's single-visit body rounds exp(s - m_final); an online
//     kernel would round exp(s - m_running). This kernel SWEEPS TWICE over
//     each KV chunk of `chunk` columns (the dispatcher's block_k): first for
//     the chunk's row max, then for p, l and PV with that max. With one
//     chunk (block_k == T, the main path) that is exactly body 1's rounding;
//     with several it is body 2's online recurrence at block_k granularity.
//     The price is a second Q.K^T per tile;
//   * backward: p = exp(s - lse); p rounded to dO's dtype before dV += p^T dO;
//     dp = dO V^T in f32; delta = rowsum(O * dO) in f32 from O and dO as
//     stored (in-kernel, as bodies 5 and 6 do); ds = (p * (dp - delta)) *
//     scale rounded to q's dtype before dQ = ds K and dK = ds^T Q, both
//     accumulated in f32 and rounded once at the end.
// The TPU's fused body 3 keeps the whole (T, T) f32 score tile in VMEM (4 MB
// at T = 1024); a Hopper block has 227 KB, so the fused backward is computed
// by the two tiled kernels, each recomputing Q.K^T: the same function.
//
// What bounds it on the card: the work is 2*T^2*C/2 multiply-adds per head
// and product (causal half), against the tensor cores' 989 TFLOP/s in bf16
// it would be operation-bound. This first version does its products with
// f32 FMAs on the SIMT cores (67 TFLOP/s peak), so it is bound by those and
// by shared-memory reads (8 scalar loads per 16 FMAs); mma.sync / wgmma and
// TMA staging are later work (PERF.md has its time beside its bound).
//
// Design (the TPU grid ran in order with state carried across the KV or Q
// sweep in VMEM scratch; here blocks run in parallel with no carried state):
//   * one block of 256 threads per (head, 64-row tile); the block loops over
//     the 64-wide tiles of the other sequence itself, skipping tiles wholly
//     above the diagonal, and keeps its running state in registers;
//   * every tile is staged through shared memory as f32 with a row stride of
//     C + 1 (conflict-free column reads); thread (ty, tx) owns rows
//     ty + 16a and columns tx + 16b (a, b < 4) of a 64 x 64 score tile, and
//     rows ty + 16a, channels tx + 16b (b < C/16) of a 64 x C accumulator;
//     row reductions are shuffles across the 16 lanes that share a row;
//   * the kernel masks the ragged edge itself: rows and columns >= T and
//     columns past the current chunk;
//   * no atomics: dQ and dK/dV are each owned by one block, so results are
//     the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kMask = -1.0e30f;
constexpr float kMInit = -0.5e30f;
constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows per block, columns per inner tile
constexpr int kSLd = kTile + 1;    // row stride of a 64 x 64 f32 tile
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
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

// ---------------------------------------------------------------- forward

template <typename T, int C>
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
  const int last_col = min(r0 + kTile - 1, T_len - 1);  // causal limit of this tile

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
          const float sv = (col <= row && col < c_end) ? s[i][j] * scale : kMask;
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
          const float sv = (col <= row && col < c_end) ? s[i][j] * scale : kMask;
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

// ---------------------------------------------------------------- backward

template <typename T, int C>
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
  const int last_col = min(r0 + kTile - 1, T_len - 1);

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
        const float sv = (col <= row && col < T_len) ? s[i][j] * scale : kMask;
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

template <typename T, int C>
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

  // Query tiles at or below the diagonal: rows >= k0 (tiles are aligned).
  for (int i0 = k0; i0 < T_len; i0 += kTile) {
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
        const float sv = (key <= row && row < T_len && key < T_len) ? st[a][b] * scale : kMask;
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

// ---------------------------------------------------------------- launch

template <int C> constexpr size_t fwd_smem() {
  return (3 * kTile * (C + 1) + kTile * kSLd) * sizeof(float);
}
template <int C> constexpr size_t dq_smem() {
  return (4 * kTile * (C + 1) + kTile * kSLd + 2 * kTile) * sizeof(float);
}
template <int C> constexpr size_t dkv_smem() {
  return (4 * kTile * (C + 1) + 2 * kTile * kSLd + 2 * kTile) * sizeof(float);
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

template <typename T, int C>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int N,
               int T_len, int chunk, float scale, cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = fwd_smem<C>();
  if (int e = allow_smem(flash_fwd_kernel<T, C>, smem, ready)) return e;
  const dim3 grid(N, (T_len + kTile - 1) / kTile);
  flash_fwd_kernel<T, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, T_len, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, int N, int T_len, float scale, cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = dq_smem<C>();
  if (int e = allow_smem(flash_bwd_dq_kernel<T, C>, smem, ready)) return e;
  const dim3 grid(N, (T_len + kTile - 1) / kTile);
  flash_bwd_dq_kernel<T, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq), T_len,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dk, void* dv, int N, int T_len, float scale,
               cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = dkv_smem<C>();
  if (int e = allow_smem(flash_bwd_dkv_kernel<T, C>, smem, ready)) return e;
  const dim3 grid(N, (T_len + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<T, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dk),
      static_cast<T*>(dv), T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int N, int T_len, int C, int dtype) {
  return N >= 1 && T_len >= 1 && (T_len + kTile - 1) / kTile <= 65535 &&
         (C == 64 || C == 128) && (dtype == 0 || dtype == 1);
}

}  // namespace

// Dispatch on (dtype, C): dtype 0 = float32, 1 = bfloat16; C in {64, 128}.
#define FLASH_DISPATCH(FN, ...)                                                   \
  do {                                                                            \
    if (dtype == 0 && C == 64) return FN<float, 64>(__VA_ARGS__);                 \
    if (dtype == 0 && C == 128) return FN<float, 128>(__VA_ARGS__);               \
    if (dtype == 1 && C == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__);         \
    return FN<__nv_bfloat16, 128>(__VA_ARGS__);                                   \
  } while (0)

extern "C" {

// Every launch function returns the cudaError_t of its launch (0 on success).
// The caller guarantees contiguous tensors of the shapes in the header note,
// all on the current device, and 1 <= chunk with chunk dividing T (fwd).

int flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int N,
              int T_len, int C, int chunk, float scale, int dtype, void* stream) {
  if (!shape_ok(N, T_len, C, dtype) || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, out, lse, N, T_len, chunk, scale, s);
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, void* dq, int N, int T_len, int C, float scale, int dtype,
                 void* stream) {
  if (!shape_ok(N, T_len, C, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, o, dout, lse, dq, N, T_len, scale, s);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, void* dk, void* dv, int N, int T_len, int C, float scale,
                  int dtype, void* stream) {
  if (!shape_ok(N, T_len, C, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, o, dout, lse, dk, dv, N, T_len, scale, s);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
