// Paged attention for Hopper (sm_90a): every spec of the paged-attention
// template — decode, verify, int8, the GQA fold and the sliding window.
//
// Replaces: midgpt_tpu/kernels/attention_template.py `_tpl_kernel` (reached
// through `paged_attention_template`, its pl.pallas_call) as called by
// midgpt_tpu/kernels/decode_attention.py `paged_attention_kernel` (decode:
// R = 1 query row per slot) and `paged_verify_attention_kernel` (verify:
// R = k+1 rows per slot, each with its own count), with bf16, f32 or int8
// pools, split_k in {1, 2, 4, 8}, GQA (`:226-234`: the wrapper folds the G
// query heads of a K/V head into the row axis, so this kernel sees H_kv
// heads of G*R rows with tiled counts) and a sliding window with sinks
// (`:141-146` the page-sweep predicate, `:166-171` the column mask). The
// query (and output) dtype may differ from the pool's, as in JAX, whose
// dots promote: an f32 query over a bf16 pool is served in f32. Int8 pools
// carry one f32 scale per (page, head, position)
// (midgpt_tpu_torch/ops/quant.py) and are dequantized here.
//
// What it computes, per (slot b, K/V head h, row r): attention of q[b, h, r]
// over the keys visible to row r — the first counts[b, r] keys of the
// slot's logical sequence and, under a window W, only those in
// [count - W, count) or in the sink prefix [0, sinks) — whose page j lives
// at physical page page_table[b, j] of the pool (H, num_pages, page_size,
// C). Row 0 of a slot has its smallest count and row R-1 its largest (a
// verify's rows are nondecreasing; the GQA fold tiles them G times). The
// rounding points are the template's:
//   * scores are f32 dot products, scaled by 1/sqrt(C) after the dot;
//   * invisible columns get the finite MASK (-1e30), the running max starts
//     at M_INIT (-0.5e30), so exp(MASK - m) is exactly 0 and a page wholly
//     invisible to a row leaves that row's (m, l, acc) unchanged;
//   * the running (m, l) and the C-wide accumulator are f32, updated ONE
//     PAGE AT A TIME (online softmax per page, like the TPU grid step);
//   * bf16/f32 pools: p is rounded to the pool's dtype before the PV product;
//     int8 pools: K and V are dequantized to f32 (int8 x f32 scale) and p
//     stays f32;
//   * split_k == 1 finalizes here (acc / max(l, 1e-30), cast to q's dtype);
//     split_k > 1 writes raw f32 (m, l, acc) partials that the wrapper
//     merges with ops/online_softmax.merge_partials + finalize.
// A row's arithmetic does not depend on R: every (row, key) dot, every
// per-page step and the finalize run the same instructions for R = 1 and
// R = 9, so a verify row equals the decode result for that row bit for bit
// (and a folded GQA row the MHA result of its query head).
//
// What bounds it on the card: the bytes of K and V it must read — the live
// pages' keys (under a window only the window's and the sinks') x C x 2
// tensors per (slot, K/V head), at 1 byte per value plus 4 bytes of scale
// per key and tensor for int8 pools — against 3.35 TB/s; the arithmetic is
// 4 R flops per key per channel per folded row, far below the card's
// compute rate.
//
// Design (the TPU ran the grid in order with every head in one block; here
// blocks run in parallel with no carried state):
//   * grid (H_kv, split_k, B): one block per (K/V head, partition, slot), so
//     heads and partitions spread over the SMs and each K/V page is read
//     once for all G query heads of its group (the point of GQA); each block
//     reads its own page-table row and counts, and sweeps the LIVE pages of
//     its partition in ascending logical order: at most two ranges, the
//     sink pages [0, ceil(sinks/ps)) and [floor((counts[b,0] - W)/ps),
//     ceil(last/ps)) (just [0, ceil(last/ps)) without a window), so the
//     page-ordered online recurrence — and its bits — match the plain
//     version, and a skipped page costs nothing (pl.when in the template);
//   * pages are staged through shared memory a TILE at a time (up to 64 keys,
//     i.e. 8 pages of 8 tokens) with cp.async into a ring of kStages tiles, so
//     the next tile's loads are in flight while this one is reduced; int8
//     tiles bring their pages' scale rows through the same ring. Each tile
//     is read from device memory ONCE and serves all R rows — the reason a
//     verify forward exists;
//   * each tile is reduced in phases spread over all 256 threads: scores (8
//     lanes per (row, key)), page maxima, p per (row, key), then per-page PV
//     partials and weight sums per (row, page, channel); only the
//     page-ordered online-softmax recurrence runs serially, each thread on
//     its (row, channel) accumulators with that row's (m, l) in registers:
//     acc = acc * alpha_u + pv_u, l = l * alpha_u + sum_u, one FMA per page;
//   * the accumulators per thread are a template parameter, from rows x
//     channels: the MHA decode spec (one row, 2 accumulators, no row
//     divisions) keeps its own instantiation and time; folded decode and
//     small verify (R*C <= 512: 2) and every other shape (R*C <= 8192: 32,
//     e.g. 36 folded rows x 128 channels = 18 used) get theirs, so decode
//     pays nothing for rows it does not have. The shared buffers grow with
//     R; the launcher shrinks the tile (pages per tile) until they fit.
// Simple and right first: TMA, wgmma and a persistent schedule are later work
// (PERF.md has its time beside its bound).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kMask = -1.0e30f;
constexpr float kMInit = -0.5e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerKey = 8;                       // score dot: 8 lanes per (row, key)
constexpr int kPairsPerPass = kWarps * (32 / kLanesPerKey);
constexpr int kStages = 2;         // tiles in flight
constexpr int kTileKeys = 64;      // keys staged per tile (whole pages)
constexpr int kMaxTilePages = 8;
constexpr int kMaxRowChan = 8192;  // (folded) rows x head_dim per block: 32 accumulators a thread
constexpr int kSmallRowChan = 512; // ... of the small instantiation: 2 a thread
constexpr int kMaxChan = 512;      // head_dim
constexpr size_t kSmemBudget = 160 * 1024;  // tiles shrink to fit this ...
constexpr size_t kSmemMax = 227 * 1024;     // ... and a block may not exceed this

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// query/output dtype, pool dtype, (row, channel) accumulators per thread,
// one row per block (the MHA decode spec: no row divisions)
template <typename TQ, typename T, int kAccSlots, bool kOneRow>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q,           // (B, H, R, C)  H = K/V heads, R = folded rows
    const T* __restrict__ k_pages,      // (H, num_pages, ps, C)
    const T* __restrict__ v_pages,      // (H, num_pages, ps, C)
    const float* __restrict__ k_scale,  // (num_pages, H, ps)   int8 pools only
    const float* __restrict__ v_scale,  // (num_pages, H, ps)
    const int* __restrict__ page_table, // (B, max_pages)
    const int* __restrict__ counts,     // (B, R) visible keys per row, least in row 0, most in row R-1
    TQ* __restrict__ out,               // (B, H, R, C)           split_k == 1
    float* __restrict__ part_acc,       // (B, split_k, H, R, C)  split_k > 1
    float* __restrict__ part_m,         // (B, split_k, H, R)
    float* __restrict__ part_l,         // (B, split_k, H, R)
    int H, int R, int num_pages, int ps, int C, int max_pages, int split_k,
    int pps, int tile_pages, int window, int sinks, float scale) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  const int h = blockIdx.x, si = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int page_elems = ps * C;
  const int tile_elems = tile_pages * page_elems;
  const int tile_keys = tile_pages * ps;
  const int RC = R * C;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                           // [kStages][tile_elems]
  T* v_s = k_s + kStages * tile_elems;                           // [kStages][tile_elems]
  float* ks_s = reinterpret_cast<float*>(v_s + kStages * tile_elems);  // [kStages][tile_keys] int8 only
  float* vs_s = ks_s + (kQuant ? kStages * tile_keys : 0);
  float* q_s = vs_s + (kQuant ? kStages * tile_keys : 0);  // [R][C]
  float* s_s = q_s + RC;                    // [R][tile_keys] scaled, masked scores
  float* p_s = s_s + R * tile_keys;         // [R][tile_keys] exp(s - m) in f32
  float* pr_s = p_s + R * tile_keys;        // [R][tile_keys] p rounded to V's dtype
  float* pv_s = pr_s + R * tile_keys;       // [R][tile_pages][C] per-page PV partials
  float* pmax_s = pv_s + R * tile_pages * C;  // [R][tile_pages] max score of each page
  float* psum_s = pmax_s + R * tile_pages;    // [R][tile_pages] sum of p of each page
  float* m_s = psum_s + R * tile_pages;       // [R] running max at the tile's start

  // Row of a row-major (row, n) index; the one-row instantiation divides
  // nothing.
  auto row_of = [](int x, int n) { return kOneRow ? 0 : x / n; };
  const int* cnt_row = counts + static_cast<size_t>(b) * R;
  const int last = cnt_row[R - 1];
  const int first = si * pps;  // first logical page of this partition
  // Live logical pages: j * ps < last and, under a window, j not wholly
  // behind row 0's window (row 0's starts first) or j holding a sink token.
  // As ranges: A = the sink pages before the window's first page, B = the
  // window's pages [lo, hi); both cut to this partition [first, first+pps).
  const int hi = (last + ps - 1) / ps;
  int lo = 0, sink_end = 0;
  if (window > 0) {
    const int start0 = cnt_row[0] - window;
    lo = start0 > 0 ? start0 / ps : 0;
    sink_end = (sinks + ps - 1) / ps;
  }
  const int end = first + pps;
  const int a0 = first;
  const int nA = max(0, min(min(sink_end, lo), min(hi, end)) - a0);
  const int b0 = max(lo, first);
  const int nB = max(0, min(hi, end) - b0);
  const int n_live = nA + nB;
  // live index i -> logical page (ascending)
  auto logical = [&](int i) { return i < nA ? a0 + i : b0 + (i - nA); };
  const int n_tiles = (n_live + tile_pages - 1) / tile_pages;

  const TQ* q_bh = q + (static_cast<size_t>(b) * H + h) * RC;
  for (int i = tid; i < RC; i += kThreads) q_s[i] = to_f32(q_bh[i]);
  for (int r = tid; r < R; r += kThreads) m_s[r] = kMInit;

  const int* pt_row = page_table + static_cast<size_t>(b) * max_pages;
  const size_t head_base = static_cast<size_t>(h) * num_pages;
  const int vecs_per_page = page_elems * static_cast<int>(sizeof(T)) / 16;
  const int4* k_vec = reinterpret_cast<const int4*>(k_pages);
  const int4* v_vec = reinterpret_cast<const int4*>(v_pages);

  // Stage tile t (its live pages only, with their scale rows for int8
  // pools) into ring slot t % kStages.
  auto load_tile = [&](int t) {
    int4* kdst = reinterpret_cast<int4*>(k_s + (t % kStages) * tile_elems);
    int4* vdst = reinterpret_cast<int4*>(v_s + (t % kStages) * tile_elems);
    const int pages = min(tile_pages, n_live - t * tile_pages);
    const int total = pages * vecs_per_page;
    for (int e = tid; e < total; e += kThreads) {
      const int u = e / vecs_per_page;
      const int r = e - u * vecs_per_page;
      const size_t src =
          (head_base + pt_row[logical(t * tile_pages + u)]) * vecs_per_page + r;
      __pipeline_memcpy_async(kdst + e, k_vec + src, 16);
      __pipeline_memcpy_async(vdst + e, v_vec + src, 16);
    }
    if constexpr (std::is_same<T, int8_t>::value) {
      float* ksd = ks_s + (t % kStages) * tile_keys;
      float* vsd = vs_s + (t % kStages) * tile_keys;
      for (int e = tid; e < pages * ps; e += kThreads) {
        const int u = e / ps;
        const size_t src =
            (static_cast<size_t>(pt_row[logical(t * tile_pages + u)]) * H + h) * ps + (e - u * ps);
        __pipeline_memcpy_async(ksd + e, k_scale + src, 4);
        __pipeline_memcpy_async(vsd + e, v_scale + src, 4);
      }
    }
  };

  // Prologue: kStages - 1 tiles in flight (one commit group per tile, empty
  // groups included, so group g always holds tile g).
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    __pipeline_commit();
  }

  // This thread's (row, channel) accumulators: slot i holds idx = tid + i *
  // kThreads of the row-major (R, C) output, with its row's running (m, l)
  // (every thread of a row carries the same values).
  float acc[kAccSlots], m[kAccSlots], l[kAccSlots];
#pragma unroll
  for (int i = 0; i < kAccSlots; ++i) {
    acc[i] = 0.f;
    m[i] = kMInit;
    l[i] = 0.f;
  }

  const int group = lane / kLanesPerKey, sub = lane % kLanesPerKey;
  for (int t = 0; t < n_tiles; ++t) {
    // Refill the slot consumed in iteration t - 1 (freed by its last barrier).
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 1);  // this thread's copies of tile t landed
    __syncthreads();                     // ... and every thread's

    const T* kt = k_s + (t % kStages) * tile_elems;
    const T* vt = v_s + (t % kStages) * tile_elems;
    const float* kst = ks_s + (t % kStages) * tile_keys;
    const float* vst = vs_s + (t % kStages) * tile_keys;
    const int pages = min(tile_pages, n_live - t * tile_pages);
    const int keys = pages * ps;
    // Column of tile key kk: the tile's keys run in range A up to key
    // split_a, then in range B (one jump at most).
    const int i0 = t * tile_pages;
    const int split_a = (nA - i0) * ps;
    const int col_a = (a0 + i0) * ps, col_b = (b0 - nA + i0) * ps;
    const int pairs = R * keys;

    // 1. Scores: f32 dot over C by 8 lanes per (row, key), then * scale,
    //    then MASK where the row does not see the column (past its count,
    //    or outside its window and the sinks). The pass loop bound is
    //    warp-uniform (shuffles).
    for (int p0 = warp * (32 / kLanesPerKey); p0 < pairs; p0 += kPairsPerPass) {
      const int pair = p0 + group;
      const int r = row_of(pair, keys), kk = pair - r * keys;
      float dot = 0.f;
      if (pair < pairs) {
        const T* krow = kt + kk * C;
        const float* qrow = q_s + r * C;
        if constexpr (kQuant) {
          const float ks = kst[kk];
          for (int c = sub; c < C; c += kLanesPerKey) dot += qrow[c] * (to_f32(krow[c]) * ks);
        } else {
          for (int c = sub; c < C; c += kLanesPerKey) dot += qrow[c] * to_f32(krow[c]);
        }
      }
#pragma unroll
      for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (pair < pairs && sub == 0) {
        const int col = kk + (kk < split_a ? col_a : col_b);
        const int n = kOneRow ? last : cnt_row[r];
        const bool keep = col < n && (window == 0 || col >= n - window || col < sinks);
        s_s[r * tile_keys + kk] = keep ? dot * scale : kMask;
      }
    }
    __syncthreads();

    // 2. Page maxima per row (every score is >= MASK).
    for (int e = tid; e < R * pages; e += kThreads) {
      const int r = row_of(e, pages), u = e - r * pages;
      const float* sr = s_s + r * tile_keys + u * ps;
      float pmax = kMask;
      for (int j = 0; j < ps; ++j) pmax = fmaxf(pmax, sr[j]);
      pmax_s[r * tile_pages + u] = pmax;
    }
    __syncthreads();

    // 3. p = exp(s - m_u), m_u the row's running max through the key's page
    //    (the m_new of that page's online step); rounded to V's dtype for
    //    bf16/f32 pools, kept f32 for int8 pools.
    for (int e = tid; e < pairs; e += kThreads) {
      const int r = row_of(e, keys), kk = e - r * keys;
      const int u = kk / ps;
      float mu = m_s[r];
      for (int w = 0; w <= u; ++w) mu = fmaxf(mu, pmax_s[r * tile_pages + w]);
      const float p = expf(s_s[r * tile_keys + kk] - mu);
      p_s[r * tile_keys + kk] = p;
      if constexpr (kQuant) {
        pr_s[r * tile_keys + kk] = p;
      } else {
        pr_s[r * tile_keys + kk] = to_f32(from_f32<T>(p));
      }
    }
    __syncthreads();

    // 4. Per-page partials: the weight sum of each (row, page), and its PV
    //    product (p times V, summed over the page's keys in order) per channel.
    for (int e = tid; e < R * pages; e += kThreads) {
      const int r = row_of(e, pages), u = e - r * pages;
      const float* pr = p_s + r * tile_keys + u * ps;
      float psum = 0.f;
      for (int j = 0; j < ps; ++j) psum += pr[j];
      psum_s[r * tile_pages + u] = psum;
    }
    for (int idx = tid; idx < R * pages * C; idx += kThreads) {
      const int ru = idx / C, c = idx - ru * C;
      const int r = row_of(ru, pages), u = ru - r * pages;
      const float* pr = pr_s + r * tile_keys + u * ps;
      const T* vcol = vt + u * ps * C + c;
      float pv = 0.f;
      if constexpr (kQuant) {
        const float* vs = vst + u * ps;
        for (int j = 0; j < ps; ++j) pv += pr[j] * (to_f32(vcol[j * C]) * vs[j]);
      } else {
        for (int j = 0; j < ps; ++j) pv += pr[j] * to_f32(vcol[j * C]);
      }
      pv_s[(r * tile_pages + u) * C + c] = pv;
    }
    __syncthreads();

    // 5. The per-page online-softmax updates, in page order, on this
    //    thread's (row, channel) accumulators. The thread holding channel 0
    //    of a row publishes its running max for the next tile's phase 3
    //    (read only after this tile's last barrier).
#pragma unroll
    for (int i = 0; i < kAccSlots; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < RC) {
        const int r = row_of(idx, C), c = idx - r * C;
        for (int u = 0; u < pages; ++u) {
          const float m_new = fmaxf(m[i], pmax_s[r * tile_pages + u]);
          const float alpha = expf(m[i] - m_new);
          l[i] = l[i] * alpha + psum_s[r * tile_pages + u];
          acc[i] = acc[i] * alpha + pv_s[(r * tile_pages + u) * C + c];
          m[i] = m_new;
        }
        if (c == 0) m_s[r] = m[i];
      }
    }
    __syncthreads();  // ring slot t % kStages and the tile buffers are reused
  }

  if (split_k == 1) {
    TQ* o = out + (static_cast<size_t>(b) * H + h) * RC;
#pragma unroll
    for (int i = 0; i < kAccSlots; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < RC) o[idx] = from_f32<TQ>(acc[i] / fmaxf(l[i], 1e-30f));
    }
  } else {
    const size_t part = (static_cast<size_t>(b) * split_k + si) * H + h;
#pragma unroll
    for (int i = 0; i < kAccSlots; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < RC) {
        part_acc[part * RC + idx] = acc[i];
        if (idx % C == 0) {
          part_m[part * R + idx / C] = m[i];
          part_l[part * R + idx / C] = l[i];
        }
      }
    }
  }
}

template <typename TQ, typename T, int kAccSlots, bool kOneRow>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const float* k_scale, const float* v_scale, const int* page_table,
           const int* counts, void* out, float* part_acc, float* part_m,
           float* part_l, int B, int H, int R, int num_pages, int ps, int C,
           int max_pages, int split_k, int window, int sinks, float scale,
           cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  const int pps = max_pages / split_k;
  int tile_pages = ps >= kTileKeys ? 1 : kTileKeys / ps;
  if (tile_pages > kMaxTilePages) tile_pages = kMaxTilePages;
  if (tile_pages > pps) tile_pages = pps;
  auto smem_for = [&](int tp) {
    const size_t keys = static_cast<size_t>(tp) * ps;
    return 2 * kStages * keys * C * sizeof(T) +
           (kQuant ? 2 * kStages * keys * sizeof(float) : 0) +
           (static_cast<size_t>(R) * C + 3 * R * keys + static_cast<size_t>(R) * tp * C +
            2 * R * tp + R) * sizeof(float);
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
        paged_attention_kernel<TQ, T, kAccSlots, kOneRow>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  const dim3 grid(H, split_k, B);
  paged_attention_kernel<TQ, T, kAccSlots, kOneRow><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), k_scale, v_scale, page_table, counts,
      static_cast<TQ*>(out), part_acc, part_m, part_l, H, R, num_pages, ps, C,
      max_pages, split_k, pps, tile_pages, window, sinks, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, H, R, C) is the query FOLDED to the pool's H (K/V) heads, R rows
// per slot and head, with counts (B, R) tiled to match. window: 0 = full
// causal attention; sinks counts only under a window. q_dtype (query and
// output): 0 = float32, 1 = bfloat16; kv_dtype (pools): 0 = float32,
// 1 = bfloat16, 2 = int8 (k_scale and v_scale then point at the layer's
// (num_pages, H, ps) f32 scales; otherwise they are ignored). Returns the
// cudaError_t of the launch (0 on success). The caller guarantees:
// contiguous tensors, page-table entries in [0, num_pages), each slot's
// smallest count in row 0 and largest in row R-1, ps * C * sizeof(pool
// dtype) a multiple of 16 bytes, max_pages % split_k == 0, R >= 1, R * C <= 8192, C <= 512,
// B <= 65535.
int paged_attention(const void* q, const void* k_pages, const void* v_pages,
                    const float* k_scale, const float* v_scale,
                    const int* page_table, const int* counts, void* out,
                    float* part_acc, float* part_m, float* part_l, int B,
                    int H, int R, int num_pages, int ps, int C, int max_pages,
                    int split_k, int window, int sinks, float scale,
                    int q_dtype, int kv_dtype, void* stream) {
  if (C > kMaxChan || R < 1 || R * C > kMaxRowChan || split_k < 1 ||
      max_pages % split_k != 0 || window < 0 || sinks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_ARGS                                                            \
  q, k_pages, v_pages, k_scale, v_scale, page_table, counts, out, part_acc,    \
      part_m, part_l, B, H, R, num_pages, ps, C, max_pages, split_k, window,   \
      sinks, scale, s
#define PAGED_LAUNCH(TQ, T)                                                   \
  return R == 1 ? launch<TQ, T, kMaxChan / kThreads, true>(PAGED_ARGS)        \
       : R * C <= kSmallRowChan                                               \
           ? launch<TQ, T, kSmallRowChan / kThreads, false>(PAGED_ARGS)       \
           : launch<TQ, T, kMaxRowChan / kThreads, false>(PAGED_ARGS)
  if (q_dtype == 0 && kv_dtype == 0) PAGED_LAUNCH(float, float);
  if (q_dtype == 1 && kv_dtype == 1) PAGED_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && kv_dtype == 1) PAGED_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 0) PAGED_LAUNCH(__nv_bfloat16, float);
  if (q_dtype == 0 && kv_dtype == 2) PAGED_LAUNCH(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 2) PAGED_LAUNCH(__nv_bfloat16, int8_t);
#undef PAGED_LAUNCH
#undef PAGED_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
