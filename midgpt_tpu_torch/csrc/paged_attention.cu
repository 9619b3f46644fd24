// Paged decode attention for Hopper (sm_90a): the decode spec (one query
// row per slot) of the paged-attention template.
//
// Replaces: midgpt_tpu/kernels/attention_template.py `_tpl_kernel` (reached
// through `paged_attention_template`, its pl.pallas_call), decode spec as
// called by midgpt_tpu/kernels/decode_attention.py `paged_attention_kernel`:
// R = 1 query row per slot, bf16 or f32 pool, MHA, split_k in {1, 2, 4, 8}.
// The query (and output) dtype may differ from the pool's, as in JAX, whose
// dots promote: an f32 query over a bf16 pool is served in f32.
//
// What it computes, per (slot b, head h): attention of q[b, h] over the
// first counts[b] keys of the slot's logical sequence, whose page j lives at
// physical page page_table[b, j] of the pool (H, num_pages, page_size, C).
// The rounding points are the template's:
//   * scores are f32 dot products, scaled by 1/sqrt(C) after the dot;
//   * columns >= count get the finite MASK (-1e30), the running max starts
//     at M_INIT (-0.5e30), so exp(MASK - m) is exactly 0;
//   * the running (m, l) and the C-wide accumulator are f32, updated ONE
//     PAGE AT A TIME (online softmax per page, like the TPU grid step);
//   * p is rounded to V's (the pool's) dtype before the PV product;
//   * split_k == 1 finalizes here (acc / max(l, 1e-30), cast to q's dtype);
//     split_k > 1 writes raw f32 (m, l, acc) partials that the wrapper
//     merges with ops/online_softmax.merge_partials + finalize.
//
// What bounds it on the card: the bytes of K and V it must read — count
// keys x C x 2 tensors per (slot, head) — against 3.35 TB/s; the arithmetic
// is 4 flops per key per channel, far below the card's compute rate.
//
// Design (the TPU ran the grid in order with every head in one block; here
// blocks run in parallel with no carried state):
//   * grid (H, split_k, B): one block per (head, partition, slot), so heads
//     and partitions spread over the SMs; each block reads its own page-table
//     row and count, and loops over the pages_per_split pages of its
//     partition, skipping every page with page0 >= count;
//   * pages are staged through shared memory a TILE at a time (up to 64 keys,
//     i.e. 8 pages of 8 tokens) with cp.async into a ring of kStages tiles, so
//     the next tile's loads are in flight while this one is reduced;
//   * each tile is reduced in phases spread over all 256 threads: scores (8
//     lanes per key), page maxima, p per key, then per-page PV partials and
//     weight sums per (page, channel); only the page-ordered online-softmax
//     recurrence acc = acc * alpha_u + pv_u, l = l * alpha_u + sum_u runs
//     serially, one FMA per page per channel — the template's per-page
//     rounding, at six block barriers per tile instead of work per page.
// Simple and right first: TMA, wgmma and a persistent schedule are later work
// (PERF.md has its time beside its bound).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr float kMask = -1.0e30f;
constexpr float kMInit = -0.5e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerKey = 8;                       // score dot: 8 lanes per key
constexpr int kKeysPerPass = kWarps * (32 / kLanesPerKey);
constexpr int kStages = 2;         // tiles in flight
constexpr int kTileKeys = 64;      // keys staged per tile (whole pages)
constexpr int kMaxTilePages = 8;   // bounds the per-page partial buffers
constexpr int kMaxChan = 2;        // channels per thread: C <= 512
constexpr size_t kSmemBudget = 160 * 1024;  // tiles shrink to fit this ...
constexpr size_t kSmemMax = 227 * 1024;     // ... and a block may not exceed this

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename TQ, typename T>  // query/output dtype, pool dtype
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q,           // (B, H, C)
    const T* __restrict__ k_pages,      // (H, num_pages, ps, C)
    const T* __restrict__ v_pages,      // (H, num_pages, ps, C)
    const int* __restrict__ page_table, // (B, max_pages)
    const int* __restrict__ counts,     // (B,) visible keys per slot
    TQ* __restrict__ out,               // (B, H, C)           split_k == 1
    float* __restrict__ part_acc,       // (B, split_k, H, C)  split_k > 1
    float* __restrict__ part_m,         // (B, split_k, H)
    float* __restrict__ part_l,         // (B, split_k, H)
    int H, int num_pages, int ps, int C, int max_pages, int split_k,
    int pps, int tile_pages, float scale) {
  const int h = blockIdx.x, si = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int page_elems = ps * C;
  const int tile_elems = tile_pages * page_elems;
  const int tile_keys = tile_pages * ps;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                                 // [kStages][tile_elems]
  T* v_s = k_s + kStages * tile_elems;                                 // [kStages][tile_elems]
  float* q_s = reinterpret_cast<float*>(v_s + kStages * tile_elems);   // [C]
  float* s_s = q_s + C;                 // [tile_keys] scaled, masked scores
  float* p_s = s_s + tile_keys;         // [tile_keys] exp(s - m) in f32
  float* pr_s = p_s + tile_keys;        // [tile_keys] p rounded to V's dtype
  float* pv_s = pr_s + tile_keys;       // [tile_pages][C] per-page PV partials
  float* pmax_s = pv_s + tile_pages * C;  // [tile_pages] max score of each page
  float* psum_s = pmax_s + tile_pages;    // [tile_pages] sum of p of each page

  const int count = counts[b];
  const int first = si * pps;  // first logical page of this partition
  // live pages of this partition: logical page j is live iff j * ps < count
  int n_live = (count + ps - 1) / ps - first;
  n_live = n_live < 0 ? 0 : (n_live > pps ? pps : n_live);
  const int n_tiles = (n_live + tile_pages - 1) / tile_pages;

  const TQ* q_bh = q + (static_cast<size_t>(b) * H + h) * C;
  for (int c = tid; c < C; c += kThreads) q_s[c] = to_f32(q_bh[c]);

  const int* pt_row = page_table + static_cast<size_t>(b) * max_pages + first;
  const size_t head_base = static_cast<size_t>(h) * num_pages;
  const int vecs_per_page = page_elems * static_cast<int>(sizeof(T)) / 16;
  const int4* k_vec = reinterpret_cast<const int4*>(k_pages);
  const int4* v_vec = reinterpret_cast<const int4*>(v_pages);

  // Stage tile t (its live pages only) into ring slot t % kStages.
  auto load_tile = [&](int t) {
    int4* kdst = reinterpret_cast<int4*>(k_s + (t % kStages) * tile_elems);
    int4* vdst = reinterpret_cast<int4*>(v_s + (t % kStages) * tile_elems);
    const int pages = min(tile_pages, n_live - t * tile_pages);
    const int total = pages * vecs_per_page;
    for (int e = tid; e < total; e += kThreads) {
      const int u = e / vecs_per_page;
      const int r = e - u * vecs_per_page;
      const size_t src =
          (head_base + pt_row[t * tile_pages + u]) * vecs_per_page + r;
      __pipeline_memcpy_async(kdst + e, k_vec + src, 16);
      __pipeline_memcpy_async(vdst + e, v_vec + src, 16);
    }
  };

  // Prologue: kStages - 1 tiles in flight (one commit group per tile, empty
  // groups included, so group g always holds tile g).
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    __pipeline_commit();
  }

  float m = kMInit, l = 0.f;
  float acc[kMaxChan];
#pragma unroll
  for (int j = 0; j < kMaxChan; ++j) acc[j] = 0.f;

  const int group = lane / kLanesPerKey, sub = lane % kLanesPerKey;
  for (int t = 0; t < n_tiles; ++t) {
    // Refill the slot consumed in iteration t - 1 (freed by its last barrier).
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 1);  // this thread's copies of tile t landed
    __syncthreads();                     // ... and every thread's

    const T* kt = k_s + (t % kStages) * tile_elems;
    const T* vt = v_s + (t % kStages) * tile_elems;
    const int pages = min(tile_pages, n_live - t * tile_pages);
    const int keys = pages * ps;
    const int key0 = (first + t * tile_pages) * ps;  // column of the tile's first key

    // 1. Scores: f32 dot over C by 8 lanes per key, then * scale, then MASK
    //    past the count. The pass loop bound is warp-uniform (shuffles).
    for (int kk0 = warp * (32 / kLanesPerKey); kk0 < keys; kk0 += kKeysPerPass) {
      const int kk = kk0 + group;
      float dot = 0.f;
      if (kk < keys) {
        const T* krow = kt + kk * C;
        for (int c = sub; c < C; c += kLanesPerKey) dot += q_s[c] * to_f32(krow[c]);
      }
#pragma unroll
      for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (kk < keys && sub == 0) s_s[kk] = (key0 + kk < count) ? dot * scale : kMask;
    }
    __syncthreads();

    // 2. Page maxima (every score is >= MASK).
    for (int u = tid; u < pages; u += kThreads) {
      float pmax = kMask;
      for (int j = 0; j < ps; ++j) pmax = fmaxf(pmax, s_s[u * ps + j]);
      pmax_s[u] = pmax;
    }
    __syncthreads();

    // 3. p = exp(s - m_u), m_u the running max through the key's page (the
    //    m_new of that page's online step), and p rounded to V's dtype.
    for (int kk = tid; kk < keys; kk += kThreads) {
      const int u = kk / ps;
      float mu = m;
      for (int w = 0; w <= u; ++w) mu = fmaxf(mu, pmax_s[w]);
      const float p = expf(s_s[kk] - mu);
      p_s[kk] = p;
      pr_s[kk] = to_f32(from_f32<T>(p));
    }
    __syncthreads();

    // 4. Per-page partials: the weight sum of each page, and its PV product
    //    (rounded p times V, summed over the page's keys in order) per channel.
    for (int u = tid; u < pages; u += kThreads) {
      float psum = 0.f;
      for (int j = 0; j < ps; ++j) psum += p_s[u * ps + j];
      psum_s[u] = psum;
    }
    for (int idx = tid; idx < pages * C; idx += kThreads) {
      const int u = idx / C, c = idx - u * C;
      float pv = 0.f;
      for (int j = 0; j < ps; ++j)
        pv += pr_s[u * ps + j] * to_f32(vt[(u * ps + j) * C + c]);
      pv_s[idx] = pv;
    }
    __syncthreads();

    // 5. The per-page online-softmax updates, in page order.
    for (int u = 0; u < pages; ++u) {
      const float m_new = fmaxf(m, pmax_s[u]);
      const float alpha = expf(m - m_new);
      l = l * alpha + psum_s[u];
#pragma unroll
      for (int jj = 0; jj < kMaxChan; ++jj) {
        const int c = tid + jj * kThreads;
        if (c < C) acc[jj] = acc[jj] * alpha + pv_s[u * C + c];
      }
      m = m_new;
    }
    __syncthreads();  // ring slot t % kStages and the tile buffers are reused
  }

  if (split_k == 1) {
    TQ* o = out + (static_cast<size_t>(b) * H + h) * C;
    const float safe_l = fmaxf(l, 1e-30f);
#pragma unroll
    for (int jj = 0; jj < kMaxChan; ++jj) {
      const int c = tid + jj * kThreads;
      if (c < C) o[c] = from_f32<TQ>(acc[jj] / safe_l);
    }
  } else {
    const size_t part = (static_cast<size_t>(b) * split_k + si) * H + h;
#pragma unroll
    for (int jj = 0; jj < kMaxChan; ++jj) {
      const int c = tid + jj * kThreads;
      if (c < C) part_acc[part * C + c] = acc[jj];
    }
    if (tid == 0) {
      part_m[part] = m;
      part_l[part] = l;
    }
  }
}

template <typename TQ, typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* page_table, const int* counts, void* out,
           float* part_acc, float* part_m, float* part_l, int B, int H,
           int num_pages, int ps, int C, int max_pages, int split_k,
           float scale, cudaStream_t stream) {
  const int pps = max_pages / split_k;
  int tile_pages = ps >= kTileKeys ? 1 : kTileKeys / ps;
  if (tile_pages > kMaxTilePages) tile_pages = kMaxTilePages;
  if (tile_pages > pps) tile_pages = pps;
  auto smem_for = [&](int tp) {
    return 2 * kStages * static_cast<size_t>(tp) * ps * C * sizeof(T) +
           (C + 3 * tp * ps + tp * C + 2 * tp) * sizeof(float);
  };
  while (tile_pages > 1 && smem_for(tile_pages) > kSmemBudget) --tile_pages;
  const size_t smem = smem_for(tile_pages);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB of dynamic shared memory the kernel must opt in; raise the
  // limit once per size (not per launch: it is no stream operation, and a
  // launch being captured into a CUDA graph should not call it).
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<TQ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  const dim3 grid(H, split_k, B);
  paged_decode_kernel<TQ, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), page_table, counts,
      static_cast<TQ*>(out), part_acc, part_m, part_l, H, num_pages, ps, C,
      max_pages, split_k, pps, tile_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q_dtype (query and output) and kv_dtype (pools): 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launch (0 on success). The
// caller guarantees: contiguous tensors, page-table entries in
// [0, num_pages), ps * C * sizeof(pool dtype) a multiple of 16 bytes,
// max_pages % split_k == 0, C <= 512, B <= 65535.
int paged_attention_decode(const void* q, const void* k_pages,
                           const void* v_pages, const int* page_table,
                           const int* counts, void* out, float* part_acc,
                           float* part_m, float* part_l, int B, int H,
                           int num_pages, int ps, int C, int max_pages,
                           int split_k, float scale, int q_dtype, int kv_dtype,
                           void* stream) {
  if (C > kThreads * kMaxChan || split_k < 1 || max_pages % split_k != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_LAUNCH(TQ, T)                                                     \
  return launch<TQ, T>(q, k_pages, v_pages, page_table, counts, out, part_acc, \
                       part_m, part_l, B, H, num_pages, ps, C, max_pages,      \
                       split_k, scale, s)
  if (q_dtype == 0 && kv_dtype == 0) PAGED_LAUNCH(float, float);
  if (q_dtype == 1 && kv_dtype == 1) PAGED_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && kv_dtype == 1) PAGED_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 0) PAGED_LAUNCH(__nv_bfloat16, float);
#undef PAGED_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
