// Paged attention for Hopper (sm_90a): every spec of the paged-attention
// template — decode, verify, int8, the GQA fold and the sliding window —
// and the merge of its partitions.
//
// Replaces: midgpt_tpu/kernels/attention_template.py `_tpl_kernel` (reached
// through `paged_attention_template`, its pl.pallas_call) as called by
// midgpt_tpu/kernels/decode_attention.py `paged_attention_kernel` (decode:
// R = 1 query row per slot) and `paged_verify_attention_kernel` (verify:
// R = k+1 rows per slot, each with its own count), with bf16, f32 or int8
// pools, GQA (`:226-234`: the wrapper folds the G query heads of a K/V head
// into the row axis, so these kernels see H_kv heads of G*R rows with tiled
// counts) and a sliding window with sinks (`:141-146` the page-sweep
// predicate, `:166-171` the column mask). The query (and output) dtype may
// differ from the pool's, as in JAX, whose dots promote: an f32 query over
// a bf16 pool is served in f32. Int8 pools carry one f32 scale per (page,
// head, position) (midgpt_tpu_torch/ops/quant.py) and are dequantized here.
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
//     int8 pools: K and V are dequantized (int8 x f32 scale) and p stays f32;
//   * every launch writes raw f32 (m, l, acc) partials, one per PARTITION
//     of the page table, and `paged_attention_merge` reduces them in
//     ascending partition order and finalizes (acc / max(l, 1e-30), cast to
//     q's dtype) — ops/online_softmax.merge_partials + finalize.
//
// Partitions. Each slot's page table is cut into fixed runs of P pages,
// anchored at absolute page 0. P comes from the shapes and dtypes alone
// (the wrapper's `partition_pages`: the largest divisor of max_pages /
// split_k that is at most max(ceil(32 / ps), ceil(max_pages / 32)) pages
// and at most 16384 / (ps * C) pages, so it refines the caller's split and
// a partition's keys fit shared memory). An f32 query over bf16 pools
// keeps the caller's split: its p is rounded to bf16 relative to its
// partition's running max, and it is held to the plain version at
// float32's tolerance. Never the counts: reading them on the host would be
// a device sync and break CUDA-graph capture. Never R or G: a row's bits
// would then depend on them. Both kernels below run grid (H_kv,
// max_pages / P, B), so a 128-page bucket gives 32 partitions per (slot,
// K/V head) and the GQA serving shape (3 K/V heads, counts [1024, 700,
// 300, 1]) ~195 live blocks for the card's 132 SMs. A block whose
// partition holds no live page writes the neutral partial (M_INIT, 0, 0),
// which adds exact zeros in the merge.
//
// A row's arithmetic depends on neither R, nor G, nor row 0's first live
// page: the kernel (tensor cores or SIMT) is chosen by dtype, C and ps
// alone; every score, per-page step and merge runs the same instructions
// for R = 1 and R = 36; pages that other rows need but this row does not
// see are exact no-ops for it (alpha = 1, p = 0). So a verify row equals
// the decode result for that row bit for bit (and a folded GQA row the
// MHA result of its query head), and split 1 equals split 2.
//
// What bounds it on the card: the bytes of K and V it must read — the live
// pages' keys (under a window only the window's and the sinks') x C x 2
// tensors per (slot, K/V head), at 1 byte per value plus 4 bytes of scale
// per key and tensor for int8 pools — against 3.35 TB/s; the arithmetic is
// 4 R flops per key per channel per folded row, far below the card's
// compute rate. The merge moves the partials: (C + 2) f32 per (slot,
// partition, head, row).
//
// Two partition kernels:
//   * tc::paged_attention_tc — bf16 queries over bf16 or int8 pools with
//     ps in {8, 16, 32} and C a multiple of 32 (the serving path). A block
//     has one warp per (16-row tile, channel chunk) item, at most 4 (chunks
//     of 64 channels, the last 32 wide where C % 64 == 32): decode's one
//     item at C 64 takes a one-warp block, so the MHA grid (1,536
//     blocks at the serving shape) fits the card at once. The block reads
//     its live pages' physical numbers once, stages the pages (cp.async,
//     rows padded so ldmatrix is conflict-free; int8 pages are converted to
//     bf16 in shared memory, exactly) and the query rows, padded to 16-row
//     tiles, once. Each warp sweeps the pages in batches of 32 keys: the
//     batch's scores on mma.sync m16n8k16 (one n8 tile is 8 keys) and page
//     maxima first, as independent products, then each page's online step
//     in page order — the row sums over the 4 lanes of a row by shuffles,
//     p rounded to bf16 as A fragments straight from the score
//     accumulators, and P.V on mma.sync m16n8k8 (one k8 step is 8 keys)
//     into acc * alpha. Int8: the per-key K scale multiplies the score
//     after the dot; the per-key V scale folds into p, carried as a bf16
//     hi + lo pair (two products) because the template keeps int8 p in f32.
//   * paged_attention_simt — every other dtype pairing (f32 queries or f32
//     pools: f32 FMA products). Its partition's live pages are staged a
//     tile (up to 64 keys) at a time through a cp.async ring and reduced by
//     all 256 threads in phases: scores (8 lanes per (row, key)), page
//     maxima, p, per-page PV partials, then the per-page online updates on
//     each thread's (row, channel) accumulators.
// Simple and right first: TMA, wgmma and a persistent schedule are later
// work (PERF.md has the times beside the bounds).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kMask = -1.0e30f;
constexpr float kMInit = -0.5e30f;
constexpr int kMaxRowChan = 8192;  // (folded) rows x head_dim per block
constexpr int kMaxChan = 512;      // head_dim
constexpr size_t kSmemMax = 227 * 1024;  // a block may not exceed this

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The live logical pages of one partition [first, first + P) of slot b:
// j * ps < last and, under a window, j not wholly behind row 0's window
// (row 0's starts first) or j holding a sink token. As ranges: A = the sink
// pages before the window's first page, B = the window's pages [lo, hi);
// both cut to the partition. Pages are visited in ascending order.
struct LivePages {
  int a0, nA, b0, n;
  __device__ LivePages(const int* cnt_row, int R, int ps, int first, int P, int window, int sinks) {
    const int last = cnt_row[R - 1];
    const int hi = (last + ps - 1) / ps;
    int lo = 0, sink_end = 0;
    if (window > 0) {
      const int start0 = cnt_row[0] - window;
      lo = start0 > 0 ? start0 / ps : 0;
      sink_end = (sinks + ps - 1) / ps;
    }
    const int end = first + P;
    a0 = first;
    nA = max(0, min(min(sink_end, lo), min(hi, end)) - a0);
    b0 = max(lo, first);
    n = nA + max(0, min(hi, end) - b0);
  }
  // live index i -> logical page
  __device__ __forceinline__ int operator()(int i) const { return i < nA ? a0 + i : b0 + (i - nA); }
};

__device__ __forceinline__ bool visible(int col, int n, int window, int sinks) {
  return col < n && (window == 0 || col >= n - window || col < sinks);
}

// ---------------------------------------------------------------- SIMT (f32 products)

namespace simt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerKey = 8;  // score dot: 8 lanes per (row, key)
constexpr int kPairsPerPass = kWarps * (32 / kLanesPerKey);
constexpr int kStages = 2;       // tiles in flight
constexpr int kTileKeys = 64;    // keys staged per tile (whole pages)
constexpr int kMaxTilePages = 8;
constexpr int kSmallRowChan = 512;  // rows x head_dim of the 2-accumulator instantiation
constexpr size_t kSmemBudget = 160 * 1024;  // tiles shrink to fit this

// query/output dtype, pool dtype, (row, channel) accumulators per thread,
// one row per block (the MHA decode spec: no row divisions)
template <typename TQ, typename T, int kAccSlots, bool kOneRow>
__global__ void __launch_bounds__(kThreads) paged_attention_simt(
    const TQ* __restrict__ q,           // (B, H, R, C)  H = K/V heads, R = folded rows
    const T* __restrict__ k_pages,      // (H, num_pages, ps, C)
    const T* __restrict__ v_pages,      // (H, num_pages, ps, C)
    const float* __restrict__ k_scale,  // (num_pages, H, ps)   int8 pools only
    const float* __restrict__ v_scale,  // (num_pages, H, ps)
    const int* __restrict__ page_table, // (B, max_pages)
    const int* __restrict__ counts,     // (B, R) visible keys per row, least in row 0, most in row R-1
    float* __restrict__ part_acc,       // (B, n_parts, H, R, C)
    float* __restrict__ part_m,         // (B, n_parts, H, R)
    float* __restrict__ part_l,         // (B, n_parts, H, R)
    int H, int R, int num_pages, int ps, int C, int max_pages, int P, int tile_pages,
    int window, int sinks, float scale) {
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
  asm volatile("griddepcontrol.launch_dependents;");  // the merge may launch; it waits for us
  const LivePages logical(cnt_row, R, ps, si * P, P, window, sinks);
  const int n_live = logical.n, nA = logical.nA;
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
    if constexpr (kQuant) {
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
    const int col_a = (logical.a0 + i0) * ps, col_b = (logical.b0 - nA + i0) * ps;
    const int pairs = R * keys;

    // 1. Scores: f32 dot over C by 8 lanes per (row, key), then * scale,
    //    then MASK where the row does not see the column. The pass loop
    //    bound is warp-uniform (shuffles).
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
        s_s[r * tile_keys + kk] = visible(col, n, window, sinks) ? dot * scale : kMask;
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

  const size_t part = (static_cast<size_t>(b) * gridDim.y + si) * H + h;
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

// Shared memory of one block at `tp` pages per tile.
template <typename T>
size_t smem_for(int tp, int R, int ps, int C) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  const size_t keys = static_cast<size_t>(tp) * ps;
  return 2 * kStages * keys * C * sizeof(T) + (kQuant ? 2 * kStages * keys * sizeof(float) : 0) +
         (static_cast<size_t>(R) * C + 3 * R * keys + static_cast<size_t>(R) * tp * C + 2 * R * tp + R) *
             sizeof(float);
}

}  // namespace simt

// ---------------------------------------------------------------- bf16 queries: tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;  // output channels per warp item (32 for the last where C % 64 == 32)
constexpr int kPad = 8;     // bf16 elements of padding per shared row: ldmatrix conflict-free

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
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

// d (16 x 8 f32) += a (16 x 8 bf16, row) . b (8 x 8 bf16, col)
__device__ __forceinline__ void mma1688(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// two f32 rounded to bf16 (nearest even, as torch's .to(torch.bfloat16)),
// `lo` in the low half: the element of the smaller column in a fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the f32 values of a pack_bf16 pair
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// Fragment layouts (lane = 4 g + t): an m16n8 accumulator holds (row g,
// cols 2t, 2t + 1) in [0], [1] and (row g + 8, same cols) in [2], [3]; the
// A fragment of m16n8k8 holds (row g, k 2t, 2t + 1) and (row g + 8, ...) —
// the accumulator's layout, so a score tile of 8 keys becomes the P operand
// of those 8 keys in registers.

// Shared memory of one block: the query rows padded to 16-row tiles, the
// partition's K and V pages (bf16, padded rows), the rows' counts, the
// partition's physical pages, and for int8 pools the raw pages and the
// per-key scales.
__host__ __device__ inline size_t smem_bytes(int R, int ps, int C, int P, bool quant) {
  const size_t rows = (R + 15) / 16 * 16, keys = static_cast<size_t>(P) * ps, ld = C + kPad;
  return (rows + 2 * keys) * ld * sizeof(bf16) + (rows + (P + 3) / 4 * 4) * sizeof(int) +
         (quant ? 2 * keys * C + 2 * keys * sizeof(float) : 0);
}

// kPT: n8 key tiles per page (ps = 8 kPT); kQuant: int8 pools.
template <bool kQuant, int kPT>
__global__ void __launch_bounds__(kThreads, 1) paged_attention_tc(
    const bf16* __restrict__ q,         // (B, H, R, C)
    const void* __restrict__ k_pages,   // (H, num_pages, ps, C) bf16 or int8
    const void* __restrict__ v_pages,
    const float* __restrict__ k_scale,  // (num_pages, H, ps)   int8 pools only
    const float* __restrict__ v_scale,
    const int* __restrict__ page_table, // (B, max_pages)
    const int* __restrict__ counts,     // (B, R)
    float* __restrict__ part_acc,       // (B, n_parts, H, R, C)
    float* __restrict__ part_m,         // (B, n_parts, H, R)
    float* __restrict__ part_l,         // (B, n_parts, H, R)
    int H, int R, int num_pages, int C, int max_pages, int P, int window, int sinks, float scale) {
  constexpr int ps = 8 * kPT;
  constexpr int kPB = kPT >= 4 ? 1 : 4 / kPT;  // pages per batch: 32 keys
  const int h = blockIdx.x, si = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int RC = R * C;
  const int ld = C + kPad;
  const int rows = (R + 15) / 16 * 16;
  const int* cnt_row = counts + static_cast<size_t>(b) * R;
  const size_t part = (static_cast<size_t>(b) * gridDim.y + si) * H + h;
  asm volatile("griddepcontrol.launch_dependents;");  // the merge may launch; it waits for us
  const LivePages logical(cnt_row, R, ps, si * P, P, window, sinks);
  const int n_live = logical.n;

  if (n_live == 0) {  // nothing of this partition is visible to any row
    for (int i = tid; i < RC; i += nthreads) part_acc[part * RC + i] = 0.f;
    for (int r = tid; r < R; r += nthreads) {
      part_m[part * R + r] = kMInit;
      part_l[part * R + r] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [rows][ld]
  bf16* k_s = q_s + rows * ld;                // [P * ps][ld]
  bf16* v_s = k_s + P * ps * ld;              // [P * ps][ld]
  int* cnt_s = reinterpret_cast<int*>(v_s + P * ps * ld);  // [rows]
  int* phys_s = cnt_s + rows;                                // [P] physical pages (16-byte padded)
  int8_t* k8_s = reinterpret_cast<int8_t*>(phys_s + (P + 3) / 4 * 4);  // [P * ps][C] int8 only
  int8_t* v8_s = k8_s + (kQuant ? P * ps * C : 0);
  float* ks_s = reinterpret_cast<float*>(v8_s + (kQuant ? P * ps * C : 0));  // [P * ps]
  float* vs_s = ks_s + (kQuant ? P * ps : 0);

  // Stage the live pages (and, for int8, their scale rows), asynchronously,
  // their physical pages read once.
  const int* pt_row = page_table + static_cast<size_t>(b) * max_pages;
  const size_t head_base = static_cast<size_t>(h) * num_pages;
  for (int u = tid; u < n_live; u += nthreads) phys_s[u] = pt_row[logical(u)];
  __syncthreads();
  if constexpr (kQuant) {
    const int chunks = ps * C / 16;  // 16-byte chunks of a page (unpadded in shared memory)
    const int8_t* kp = static_cast<const int8_t*>(k_pages);
    const int8_t* vp = static_cast<const int8_t*>(v_pages);
    for (int u = 0; u < n_live; ++u) {
      const size_t page = (head_base + phys_s[u]) * ps * C;
      for (int e = tid; e < chunks; e += nthreads) {
        cp_async16(k8_s + u * ps * C + e * 16, kp + page + e * 16);
        cp_async16(v8_s + u * ps * C + e * 16, vp + page + e * 16);
      }
    }
    for (int e = tid; e < n_live * (ps / 4); e += nthreads) {
      const int u = e / (ps / 4), j4 = e - u * (ps / 4);
      const size_t src = (static_cast<size_t>(phys_s[u]) * H + h) * ps + j4 * 4;
      cp_async16(ks_s + u * ps + j4 * 4, k_scale + src);
      cp_async16(vs_s + u * ps + j4 * 4, v_scale + src);
    }
  } else {
    const int vecs = C / 8;  // 16-byte vectors per key row
    const int chunks = ps * vecs;
    const bf16* kp = static_cast<const bf16*>(k_pages);
    const bf16* vp = static_cast<const bf16*>(v_pages);
    for (int u = 0; u < n_live; ++u) {
      const size_t page = (head_base + phys_s[u]) * ps * C;
      for (int e = tid; e < chunks; e += nthreads) {
        const int key = e / vecs, c8 = e - key * vecs;
        cp_async16(k_s + (u * ps + key) * ld + c8 * 8, kp + page + e * 8);
        cp_async16(v_s + (u * ps + key) * ld + c8 * 8, vp + page + e * 8);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // The query rows (zero past R) and their counts (0 past R: every column
  // masked) while the pages are in flight.
  const bf16* q_bh = q + (static_cast<size_t>(b) * H + h) * RC;
  if ((reinterpret_cast<uintptr_t>(q_bh) & 15) == 0) {  // 16 bytes at a time
    const int vecs = C / 8;
    for (int i = tid; i < rows * vecs; i += nthreads) {
      const int r = i / vecs, c8 = i - r * vecs;
      const uint4 x = r < R ? *reinterpret_cast<const uint4*>(q_bh + r * C + c8 * 8) : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(q_s + r * ld + c8 * 8) = x;
    }
  } else {
    for (int i = tid; i < rows * C; i += nthreads) {
      const int r = i / C, c = i - r * C;
      q_s[r * ld + c] = r < R ? q_bh[i] : __float2bfloat16_rn(0.f);
    }
  }
  for (int r = tid; r < rows; r += nthreads) cnt_s[r] = r < R ? cnt_row[r] : 0;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if constexpr (kQuant) {  // int8 codes are exact in bf16
    const int quads = C / 4;
    for (int e = tid; e < n_live * ps * quads; e += nthreads) {
      const int key = e / quads, c4 = (e - key * quads) * 4;
      const char4 kc = *reinterpret_cast<const char4*>(k8_s + key * C + c4);
      const char4 vc = *reinterpret_cast<const char4*>(v8_s + key * C + c4);
      uint2 kb, vb;
      kb.x = pack_bf16(kc.x, kc.y);
      kb.y = pack_bf16(kc.z, kc.w);
      vb.x = pack_bf16(vc.x, vc.y);
      vb.y = pack_bf16(vc.z, vc.w);
      *reinterpret_cast<uint2*>(k_s + key * ld + c4) = kb;
      *reinterpret_cast<uint2*>(v_s + key * ld + c4) = vb;
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
  // Channel chunks of 64; where C % 64 == 32 the last chunk is 32 wide.
  const int n_chunks = (C + kChunk - 1) / kChunk;
  const int n_items = rows / 16 * n_chunks;
  for (int item = warp; item < n_items; item += nwarps) {
    const int rt = item / n_chunks, c0 = (item - rt * n_chunks) * kChunk;
    const int width = min(kChunk, C - c0);
    const int r0 = rt * 16 + g, r1 = r0 + 8;
    const int n0 = cnt_s[r0], n1 = cnt_s[r1];
    const bf16* qa = q_s + (rt * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
    float acc[kChunk / 8][4];
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float m0 = kMInit, m1 = kMInit, l0 = 0.f, l1 = 0.f;

    // The pages in batches of kPB (32 keys): the batch's scores and page
    // maxima first (independent products), then each page's online step in
    // page order — the same per-page arithmetic as one page at a time.
    for (int i0 = 0; i0 < n_live; i0 += kPB) {
      const int nb = min(kPB, n_live - i0);
      // Scores: s[u][j] holds keys 8 j + 2 t, 8 j + 2 t + 1 of page i0 + u,
      // rows g and g + 8.
      float s[kPB][kPT][4];
#pragma unroll
      for (int u = 0; u < kPB; ++u)
#pragma unroll
        for (int j = 0; j < kPT; ++j) s[u][j][0] = s[u][j][1] = s[u][j][2] = s[u][j][3] = 0.f;
      for (int k0 = 0; k0 < C; k0 += 32) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, qa + k0);
        ldsm_x4(a1, qa + k0 + 16);
#pragma unroll
        for (int u = 0; u < kPB; ++u) {
          if (u < nb) {
            const bf16* kp = k_s + (i0 + u) * ps * ld;
#pragma unroll
            for (int j = 0; j < kPT; ++j) {
              uint32_t bk[4];
              ldsm_x4(bk, kp + (j * 8 + (lane & 7)) * ld + k0 + (lane >> 3) * 8);
              mma16816(s[u][j], a0, bk[0], bk[1]);
              mma16816(s[u][j], a1, bk[2], bk[3]);
            }
          }
        }
      }
      // Scale after the dot (int8: the key's scale first), mask, page maxima.
      float pm0[kPB], pm1[kPB];
#pragma unroll
      for (int u = 0; u < kPB; ++u) {
        const int col0 = logical(i0 + u) * ps;
        pm0[u] = pm1[u] = kMask;
        if (u >= nb) continue;
#pragma unroll
        for (int j = 0; j < kPT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kk = j * 8 + 2 * t + e;
            float x0 = s[u][j][e], x1 = s[u][j][2 + e];
            if constexpr (kQuant) {
              const float ks = ks_s[(i0 + u) * ps + kk];
              x0 *= ks;
              x1 *= ks;
            }
            s[u][j][e] = visible(col0 + kk, n0, window, sinks) ? x0 * scale : kMask;
            s[u][j][2 + e] = visible(col0 + kk, n1, window, sinks) ? x1 * scale : kMask;
            pm0[u] = fmaxf(pm0[u], s[u][j][e]);
            pm1[u] = fmaxf(pm1[u], s[u][j][2 + e]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kPB; ++u) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          pm0[u] = fmaxf(pm0[u], __shfl_xor_sync(0xffffffffu, pm0[u], off));
          pm1[u] = fmaxf(pm1[u], __shfl_xor_sync(0xffffffffu, pm1[u], off));
        }
      }
      // Each page's online step: m_new = max(m, page max), alpha =
      // exp(m - m_new), p = exp(s - m_new) in f32, l = l * alpha + sum p.
      float mn0[kPB], mn1[kPB], al0[kPB], al1[kPB], sum0[kPB], sum1[kPB];
#pragma unroll
      for (int u = 0; u < kPB; ++u) {
        if (u < nb) {
          mn0[u] = fmaxf(m0, pm0[u]);
          mn1[u] = fmaxf(m1, pm1[u]);
          al0[u] = expf(m0 - mn0[u]);
          al1[u] = expf(m1 - mn1[u]);
          m0 = mn0[u];
          m1 = mn1[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kPB; ++u) {
        sum0[u] = sum1[u] = 0.f;
        if (u < nb) {
#pragma unroll
          for (int j = 0; j < kPT; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              s[u][j][e] = expf(s[u][j][e] - mn0[u]);
              s[u][j][2 + e] = expf(s[u][j][2 + e] - mn1[u]);
              sum0[u] += s[u][j][e];
              sum1[u] += s[u][j][2 + e];
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kPB; ++u) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          sum0[u] += __shfl_xor_sync(0xffffffffu, sum0[u], off);
          sum1[u] += __shfl_xor_sync(0xffffffffu, sum1[u], off);
        }
      }
      // acc = acc * alpha + P . V per page, 8 keys per k8 step. bf16 pools:
      // p rounded to bf16. int8: w = p * s_v as hi + lo bf16 parts.
#pragma unroll
      for (int u = 0; u < kPB; ++u) {
        if (u < nb) {
          l0 = l0 * al0[u] + sum0[u];
          l1 = l1 * al1[u] + sum1[u];
#pragma unroll
          for (int j = 0; j < kChunk / 8; ++j) {
            acc[j][0] *= al0[u];
            acc[j][1] *= al0[u];
            acc[j][2] *= al1[u];
            acc[j][3] *= al1[u];
          }
          const bf16* vp = v_s + (i0 + u) * ps * ld;
#pragma unroll
          for (int j = 0; j < kPT; ++j) {
            uint32_t pa0, pa1, pb0 = 0, pb1 = 0;
            if constexpr (kQuant) {
              const float* vs = vs_s + (i0 + u) * ps + j * 8 + 2 * t;
              const float w00 = s[u][j][0] * vs[0], w01 = s[u][j][1] * vs[1];
              const float w10 = s[u][j][2] * vs[0], w11 = s[u][j][3] * vs[1];
              pa0 = pack_bf16(w00, w01);
              pa1 = pack_bf16(w10, w11);
              const float2 h0 = unpack_bf16(pa0), h1 = unpack_bf16(pa1);
              pb0 = pack_bf16(w00 - h0.x, w01 - h0.y);
              pb1 = pack_bf16(w10 - h1.x, w11 - h1.y);
            } else {
              pa0 = pack_bf16(s[u][j][0], s[u][j][1]);
              pa1 = pack_bf16(s[u][j][2], s[u][j][3]);
            }
            const bf16* vrow = vp + (j * 8 + (lane & 7)) * ld + c0 + (lane >> 3) * 8;
#pragma unroll
            for (int n = 0; n < kChunk / 32; ++n) {
              if (n * 32 < width) {
                uint32_t bv[4];
                ldsm_x4_trans(bv, vrow + n * 32);
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                  mma1688(acc[n * 4 + x], pa0, pa1, bv[x]);
                  if constexpr (kQuant) mma1688(acc[n * 4 + x], pb0, pb1, bv[x]);
                }
              }
            }
          }
        }
      }
    }

    // This item's partials: rows past R are padding and are not written.
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      if (j * 8 < width) {
        const int c = c0 + j * 8 + 2 * t;
        if (r0 < R)
          *reinterpret_cast<float2*>(part_acc + (part * R + r0) * C + c) = make_float2(acc[j][0], acc[j][1]);
        if (r1 < R)
          *reinterpret_cast<float2*>(part_acc + (part * R + r1) * C + c) = make_float2(acc[j][2], acc[j][3]);
      }
    }
    if (c0 == 0 && t == 0) {
      if (r0 < R) {
        part_m[part * R + r0] = m0;
        part_l[part * R + r0] = l0;
      }
      if (r1 < R) {
        part_m[part * R + r1] = m1;
        part_l[part * R + r1] = l1;
      }
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------- merge

// One thread per (slot, head, row, channel): m = the max over partitions,
// then l = sum_i l_i w_i and acc = sum_i acc_i w_i with w_i = exp(m_i - m),
// added in ascending partition order; out = acc / max(l, 1e-30) in q's
// dtype. A neutral partition (M_INIT, 0, 0) adds exact zeros; one
// partition gives its own acc / l. It is launched as a programmatic
// dependent of the partition kernel (Hopper's griddepcontrol): the
// partition blocks allow it to launch as they start, and it waits for
// their results before its first read, so its launch overlaps their work.
constexpr int kMergeThreads = 128;

template <typename TO>
__global__ void __launch_bounds__(kMergeThreads) paged_attention_merge_kernel(
    const float* __restrict__ part_acc,  // (B, n_parts, H, R, C)
    const float* __restrict__ part_m,    // (B, n_parts, H, R)
    const float* __restrict__ part_l,
    TO* __restrict__ out,                // (B, H, R, C)
    int n_parts, int H, int R, int C) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the partition kernel's partials are complete
  const int idx = blockIdx.x * kMergeThreads + threadIdx.x;  // (row, channel) of (b, h)
  const int h = blockIdx.y, b = blockIdx.z;
  const int RC = R * C;
  if (idx >= RC) return;
  const int r = idx / C;
  const size_t HRC = static_cast<size_t>(H) * RC, HR = static_cast<size_t>(H) * R;
  const float* mp = part_m + static_cast<size_t>(b) * n_parts * HR + static_cast<size_t>(h) * R + r;
  const float* lp = part_l + static_cast<size_t>(b) * n_parts * HR + static_cast<size_t>(h) * R + r;
  const float* ap = part_acc + static_cast<size_t>(b) * n_parts * HRC + static_cast<size_t>(h) * RC + idx;
  float m = kMInit;
  for (int i = 0; i < n_parts; ++i) m = fmaxf(m, mp[i * HR]);
  float l = 0.f, acc = 0.f;
  for (int i = 0; i < n_parts; ++i) {
    const float w = expf(mp[i * HR] - m);
    l += lp[i * HR] * w;
    acc += ap[i * HRC] * w;
  }
  out[(static_cast<size_t>(b) * H + h) * RC + idx] = from_f32<TO>(acc / fmaxf(l, 1e-30f));
}

// Opt in to the most dynamic shared memory a block may have, once per
// kernel instantiation and before its first launch (no stream operation:
// later launches stay capturable in CUDA graphs).
template <typename K>
int allow_smem(K kernel, bool& done) {
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kSmemMax));
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

#define PAGED_PARAMS                                                                             \
  const void *q, const void *k_pages, const void *v_pages, const float *k_scale,                  \
      const float *v_scale, const int *page_table, const int *counts, float *part_acc,            \
      float *part_m, float *part_l, int B, int H, int R, int num_pages, int ps, int C,             \
      int max_pages, int P, int window, int sinks, float scale, cudaStream_t stream

template <typename TQ, typename T, int kAccSlots, bool kOneRow>
int launch_simt(PAGED_PARAMS) {
  using namespace simt;
  int tile_pages = ps >= kTileKeys ? 1 : kTileKeys / ps;
  if (tile_pages > kMaxTilePages) tile_pages = kMaxTilePages;
  if (tile_pages > P) tile_pages = P;
  while (tile_pages > 1 && smem_for<T>(tile_pages, R, ps, C) > kSmemBudget) --tile_pages;
  const size_t smem = smem_for<T>(tile_pages, R, ps, C);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;
  if (int e = allow_smem(paged_attention_simt<TQ, T, kAccSlots, kOneRow>, ready)) return e;
  const dim3 grid(H, max_pages / P, B);
  paged_attention_simt<TQ, T, kAccSlots, kOneRow><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      k_scale, v_scale, page_table, counts, part_acc, part_m, part_l, H, R, num_pages, ps, C,
      max_pages, P, tile_pages, window, sinks, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kQuant, int kPT>
int launch_tc(PAGED_PARAMS) {
  const size_t smem = tc::smem_bytes(R, ps, C, P, kQuant);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;
  if (int e = allow_smem(tc::paged_attention_tc<kQuant, kPT>, ready)) return e;
  const dim3 grid(H, max_pages / P, B);
  // a warp per (16-row tile, channel chunk) item, at most tc::kWarps
  const int items = (R + 15) / 16 * ((C + tc::kChunk - 1) / tc::kChunk);
  const int threads = 32 * (items < tc::kWarps ? items : tc::kWarps);
  tc::paged_attention_tc<kQuant, kPT><<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k_pages, v_pages, k_scale, v_scale, page_table, counts,
      part_acc, part_m, part_l, H, R, num_pages, C, max_pages, P, window, sinks, scale);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel's domain: chosen by dtype, C and ps alone.
bool tensor_cores(int q_dtype, int kv_dtype, int ps, int C) {
  return q_dtype == 1 && kv_dtype != 0 && (ps == 8 || ps == 16 || ps == 32) && C % 32 == 0;
}

}  // namespace

extern "C" {

// Writes the raw f32 partials of every partition of P pages: part_acc
// (B, max_pages / P, H, R, C), part_m and part_l (B, max_pages / P, H, R).
// q (B, H, R, C) is the query FOLDED to the pool's H (K/V) heads, R rows
// per slot and head, with counts (B, R) tiled to match. window: 0 = full
// causal attention; sinks counts only under a window. q_dtype: 0 =
// float32, 1 = bfloat16; kv_dtype (pools): 0 = float32, 1 = bfloat16,
// 2 = int8 (k_scale and v_scale then point at the layer's (num_pages, H,
// ps) f32 scales; otherwise they are ignored). Returns the cudaError_t of
// the launch (0 on success). The caller guarantees: contiguous tensors
// with 16-byte aligned pools and scales, page-table entries in [0,
// num_pages), each slot's smallest count in row 0 and largest in row
// R-1, ps * C * sizeof(pool dtype) a multiple of 16 bytes, max_pages % P
// == 0, R >= 1, R * C <= 8192, C <= 512, B <= 65535.
int paged_attention(const void* q, const void* k_pages, const void* v_pages,
                    const float* k_scale, const float* v_scale,
                    const int* page_table, const int* counts, float* part_acc,
                    float* part_m, float* part_l, int B, int H, int R,
                    int num_pages, int ps, int C, int max_pages, int P,
                    int window, int sinks, float scale, int q_dtype,
                    int kv_dtype, void* stream) {
  if (C > kMaxChan || R < 1 || R * C > kMaxRowChan || P < 1 || max_pages % P != 0 ||
      window < 0 || sinks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_ARGS                                                                      \
  q, k_pages, v_pages, k_scale, v_scale, page_table, counts, part_acc, part_m, part_l,   \
      B, H, R, num_pages, ps, C, max_pages, P, window, sinks, scale, s
  if (tensor_cores(q_dtype, kv_dtype, ps, C)) {
    const bool quant = kv_dtype == 2;
    if (ps == 8) return quant ? launch_tc<true, 1>(PAGED_ARGS) : launch_tc<false, 1>(PAGED_ARGS);
    if (ps == 16) return quant ? launch_tc<true, 2>(PAGED_ARGS) : launch_tc<false, 2>(PAGED_ARGS);
    return quant ? launch_tc<true, 4>(PAGED_ARGS) : launch_tc<false, 4>(PAGED_ARGS);
  }
  // Three SIMT instantiations per pairing, chosen by R: they differ only in
  // the accumulators a thread holds (registers, so blocks per SM), not in a
  // row's arithmetic, so a row's bits do not depend on which one ran. One
  // 32-accumulator instantiation for every R (165–168 registers: one block an
  // SM) took f32 decode from 0.0174 to 0.0815 ms on an H100 (PERF.md).
#define PAGED_LAUNCH(TQ, T)                                                                   \
  return R == 1 ? launch_simt<TQ, T, kMaxChan / simt::kThreads, true>(PAGED_ARGS)             \
       : R * C <= simt::kSmallRowChan                                                         \
           ? launch_simt<TQ, T, simt::kSmallRowChan / simt::kThreads, false>(PAGED_ARGS)      \
           : launch_simt<TQ, T, kMaxRowChan / simt::kThreads, false>(PAGED_ARGS)
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

// out (B, H, R, C) in out_dtype (0 = float32, 1 = bfloat16) from the raw
// partials of n_parts partitions, laid out as `paged_attention` writes
// them. Returns the cudaError_t of the launch.
int paged_attention_merge(const float* part_acc, const float* part_m, const float* part_l,
                          void* out, int B, int n_parts, int H, int R, int C, int out_dtype,
                          void* stream) {
  if (n_parts < 1 || R < 1 || C < 1 || C > kMaxChan || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((R * C + kMergeThreads - 1) / kMergeThreads, H, B);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaErrorInvalidValue;
  if (out_dtype == 0)
    e = cudaLaunchKernelEx(&cfg, paged_attention_merge_kernel<float>, part_acc, part_m, part_l,
                           static_cast<float*>(out), n_parts, H, R, C);
  else if (out_dtype == 1)
    e = cudaLaunchKernelEx(&cfg, paged_attention_merge_kernel<__nv_bfloat16>, part_acc, part_m, part_l,
                           static_cast<__nv_bfloat16*>(out), n_parts, H, R, C);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// 1 where `paged_attention` takes the tensor-core kernel for these dtypes
// (codes as there), page size and head_dim, else 0 (the SIMT kernel).
int paged_attention_tensor_cores(int q_dtype, int kv_dtype, int ps, int C) {
  return tensor_cores(q_dtype, kv_dtype, ps, C) ? 1 : 0;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
