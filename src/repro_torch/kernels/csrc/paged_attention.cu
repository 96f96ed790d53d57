// Paged-decode attention, its K/V row scatter, and the two fused, for
// Hopper (sm_90a).
//
// Replaces the three TPU kernels of src/repro/kernels/paged_attention.py:
//   * `paged_attention_scatter_pallas`, the fused decode step the reference's
//     serving engine reaches through repro.serve.kvcache.paged_attention_decode
//     with kernel="pallas";
//   * `paged_attention_pallas`, the same walk without the write;
//   * `paged_scatter_pallas`, the write alone (2 or 4 pools in place).
// The reference reaches the last two through repro.kernels.ops, and holds
// the fused step bit-equal to scatter followed by attention.  Here the
// three kernels share their code, so that holds by construction: the row
// write is one device function (`write_row`), the walk is one kernel
// template whose `kScatter` flag runs the write first, then __syncthreads().
//
// One decode step, for every slot b and kv head h:
//   1. (scatter) land slot b's new K/V row (and its int8 scales) at
//      pages[page_idx[b], off[b], h];
//   2. (attention) walk table[b] with an fp32 online softmax (m, l, acc) for
//      the G query heads of the GQA group, masking keys by position:
//      k_pos <= pos[b], and k_pos > pos[b] - window when a window is set.
//      The same mask gives causality and isolation between requests.
//   3. write acc / max(l, 1e-20) in the query's dtype.
//
// What bounds it on an H100: the bytes of the live K/V pages it reads, at
// 3.35 TB/s.  Per key it does 4*G*D flops (Q.K and P.V) against 2*D page
// elements read: at G = 4 that is 8 flops per bf16 byte, under the ~20
// flops per byte at which the fp32 CUDA cores (67 TFLOP/s) would balance
// the memory, so the kernel is memory bound.  At decode sizes (a few MB of
// pages) it is bound in practice by latency: how many page loads are in
// flight at once, and how many dependent rounds the longest slot needs.
// The scatter alone moves a few KB: its launch is its cost.
//
// What the design does about it:
//   * Split-K over a slot's live pages (flash-decoding).  The grid is
//     (S, Hkv, B): block s of (b, h) walks its own run of C pages of the
//     live range, which runs from the first page inside the window to the
//     page holding pos[b] (computed here from pos, so pages the mask would
//     zero are never read).  S and C are chosen on the host from the shapes
//     alone (B, Hkv, table width, page, window, the SM count), never from
//     pos, for about two blocks per SM.  With S > 1 each block writes a
//     partial (m, l, acc) per query head to an fp32 workspace the wrapper
//     allocates, and a second kernel on the same stream merges the S
//     partials of each (b, h, g) in the fixed order s = 0 .. S-1 with the
//     log-sum-exp rescale; no atomics, so the result does not depend on the
//     order in which blocks finish.  The merge is launched as a
//     programmatic dependent launch: its blocks start while the walk runs
//     and wait (griddepcontrol.wait) for the walk's partials.  With S = 1
//     the block writes the output.
//   * Page loads are 16-byte cp.async copies into shared memory.  A block
//     takes its whole run as one tile of C * page keys when that fits in
//     112 KB (two blocks an SM), else tiles of fewer pages, double buffered
//     (tile i+1 in flight while tile i is scored).  The tiles hold the page
//     dtype as stored; bf16 and int8 are widened (and int8 dequantised) in
//     registers as they are read.  A head dim whose row is not a whole
//     number of 16-byte chunks falls back to plain loads into the same
//     layout.
//   * Every lane scores: a warp takes two query heads and scores 4 keys at
//     a time, each split over 8 lanes (lane = part * 4 + key) that hold
//     their eighth of both heads' q in fp32 registers, read 16-byte chunks
//     of K once for both heads, and add the parts with shuffles.  K rows
//     are padded so that the 8 lanes of a quarter-warp hit 8 bank groups.
//     The probabilities take one lane per key.  P.V gives each lane 16-byte
//     chunks of V for both heads and, where a row has fewer chunks than a
//     warp has lanes, a share of the keys; the shares are added once, after
//     the walk.
//   * q and the probabilities stay fp32, as the Pallas walk keeps them.  No
//     tensor cores: they would round q to bf16.  The walk is bound by the
//     latency of its page loads and of its fp32 FMA chains, not by bytes.
// Not done yet: TMA (cp.async.bulk) page loads with mbarriers; tensor-core
// products with q and the probabilities split into three bf16 terms (exact
// to fp32); the merge folded into the last block of each (b, h).
//
// Races: in the fused kernel every split block of (b, h) writes slot b's
// row at head h (identical bytes to one address), runs __syncthreads(), and
// then reads only slot b's pages at head h, so whichever block holds the
// destination page reads the new row.  Idle slots all write the scratch
// page 0 and only idle slots read it; their outputs are discarded.  The
// standalone scatter runs its blocks in no order, where the TPU's grid is
// sequential and the last of two rows with one destination wins: so a row
// is written only if no later slot has the same destination, which makes
// the result the sequential grid's, bit for bit.
//
// The data-split step's scatter (`paged_scatter_step_kernel`, the redesign of
// `paged_scatter_pallas` for the step whose slots are split over data ranks):
// once a step every rank all-gathers every attention layer's new rows as
// one (N, W) byte buffer, N the whole batch's slots, a row holding each
// layer's K, V (and int8 scale) rows in turn.  One launch writes all of them
// into every layer's pools, straight from the buffer.  A table of one entry
// per (layer, leaf) (the pool, the leaf's byte offset in a buffer row, its
// row width in bytes; 16 bytes an entry) goes to the kernel by value, in
// its parameters: at most kMaxStepLeaves entries, which keeps the
// parameters under the 4 KB every CUDA version takes and holds every
// configuration's layers (mixtral-8x22b in int8: 56 layers of 4 leaves), so
// nothing is uploaded or cached.  The kernel moves N * W bytes in and at most as many out, a few hundred KB at
// full width: it is bound by its launch, so the design cuts launches (one a
// step where the per-layer write took L scatters and 2-4 L copies of the
// buffer's slices) and then keeps every byte in flight at once: the grid is
// (row chunks, table entries), each thread one 16-byte vector (where the
// addresses, offsets and widths allow; else 8, 4, 2 or 1 bytes) of one row
// of one leaf.
// The last of several rows with one destination wins, by a pre-pass: each
// block first marks, for every row, whether a later row has its (page,
// offset), and copies only the unmarked rows.  That is the per-call
// scatter's rule, so both leave the sequential grid's bits, and it keeps
// every row independent; the other way, one thread walking all rows of a
// lane chunk in slot order, would put the B rows' stores of a lane one after
// another.  The pre-pass reads page_idx and off (B ints each) and does B^2/2
// compares, nothing beside the copy at decode batch sizes.
//
// The page ids and positions live on the device, where the wrapper cannot
// check them without a synchronisation: a block that finds one out of range
// traps (a device-side assert, as PyTorch's own indexing kernels raise)
// before it touches memory outside the pools.
//
// The file includes no PyTorch header: it exposes a plain C interface
// that the Python wrapper calls through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarp = 32;
constexpr int kChunk = 16;                // bytes a cp.async moves
constexpr int kScatterThreads = 128;
constexpr int kCombineBatch = 64;         // partials a combine thread has in flight
constexpr int kHeads = 2;                 // query heads a warp takes
constexpr int kMaxTile = 8;               // pages a block scores at once, at most
constexpr size_t kTileBudget = 112 * 1024;  // shared memory a block aims at (two an SM)
constexpr int kKeys = 4;                  // keys a warp scores at once ...
constexpr int kParts = kWarp / kKeys;     // ... each split over 8 lanes
constexpr size_t kDefaultShared = 48 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }
template <>
__device__ __forceinline__ int8_t zero<int8_t>() { return 0; }

// 16 bytes of page elements in shared memory, widened to fp32 (exactly).
template <typename T>
__device__ __forceinline__ void widen(const unsigned char* src, float* f);
template <>
__device__ __forceinline__ void widen<float>(const unsigned char* src, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const unsigned char* src, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {          // the element at the lower address is the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void widen<int8_t>(const unsigned char* src, float* f) {
  const int4 v = *reinterpret_cast<const int4*>(src);
  const unsigned w[4] = {static_cast<unsigned>(v.x), static_cast<unsigned>(v.y),
                         static_cast<unsigned>(v.z), static_cast<unsigned>(v.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)  // byte k, sign-extended
      f[4 * i + k] = static_cast<float>(static_cast<int>(w[i] << (24 - 8 * k)) >> 24);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch (sm_90): let the next kernel on the stream
// start its blocks early / wait until the previous grid is done and visible.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ __forceinline__ int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

struct Args {
  const void* q;             // (B, Hkv, G, D) fp32 or bf16; attention only
  const void* k_new;         // (B, Hkv, D) in the page dtype; scatter only
  const void* v_new;
  const float* k_scale_new;  // (B, Hkv), int8 pages only
  const float* v_scale_new;
  void* k_pages;             // (P, page, Hkv, D), updated in place by a scatter
  void* v_pages;
  float* k_scale_pages;      // (P, page, Hkv), int8 pages only
  float* v_scale_pages;
  const int* table;          // (B, M); attention only
  const int* pos;            // (B,); attention only
  const int* page_idx;       // (B,); scatter only
  const int* off;            // (B,); scatter only
  void* out;                 // (B, Hkv, G, D) in q's dtype; attention only
  float* work;               // S > 1: acc (B, Hkv, S, G, D), then m and l (B, Hkv, S, G)
  int bsz, n_pages, hkv, g, d, page, m, window;
  int splits, run;           // S blocks per (b, h), each over a run of C live pages
  int tile, stages;          // set by the launch (BlockPlan): pages scored at once, stages
  bool vec;                  // page rows are whole 16-byte chunks at 16-byte addresses
  float scale;
};

// A block's shape and shared memory, in bytes.  Warp w takes query heads
// kHeads*w ...; a tile is `tile` pages (tile * page keys).  Shared memory:
//   page ids (2, kMaxTile) | probabilities (warps, kHeads, tile * page) fp32 |
//   `stages` stages of [K (tile * page, krow chunks) | V (tile * page, nch
//   chunks) | K scales, V scales (tile * page) if int8]
// where a row is nch 16-byte chunks of `elem`-byte elements (zero past D).
// K rows are padded to krow = 2 (mod 8) chunks: a quarter-warp's 8 lanes
// read keys t = 0..3 at chunks p and p + 1, 16-byte bank groups 2t + p.
struct Plan {
  int warps, nch, krow, keys;
  size_t p_off, stage_off, stage_bytes, v_off, sc_off, total;
  __host__ __device__ Plan(int elem, int g, int d, int page, int tile, int stages) {
    warps = (g + kHeads - 1) / kHeads;
    nch = (d * elem + kChunk - 1) / kChunk;
    krow = nch + (10 - nch % 8) % 8;
    keys = tile * page;
    p_off = 2 * kMaxTile * sizeof(int);
    stage_off = p_off + (sizeof(float) * static_cast<size_t>(warps) * kHeads * keys + 15) / 16 * 16;
    v_off = static_cast<size_t>(keys) * krow * kChunk;
    sc_off = v_off + static_cast<size_t>(keys) * nch * kChunk;
    stage_bytes = sc_off + (elem == 1 ? (2 * sizeof(float) * keys + 15) / 16 * 16 : 0);
    total = stage_off + stages * stage_bytes;
  }
};

// The launch's tile, from the shapes and the run C alone: the whole run
// when one tile of it keeps the block within kTileBudget bytes (two blocks
// an SM), else the most pages whose two stages do (tile i+1 in flight while
// tile i is scored).
struct BlockPlan {
  int tile = 1, stages = 1;
  BlockPlan(int elem, int g, int d, int page, int run) {
    stages = run > 1 ? 2 : 1;
    for (int tp = run < kMaxTile ? run : kMaxTile; tp > 1; --tp) {
      const int st = run > tp ? 2 : 1;
      if (Plan(elem, g, d, page, tp, st).total <= kTileBudget) {
        tile = tp;
        stages = st;
        return;
      }
    }
  }
  size_t shared_bytes(int elem, int g, int d, int page) const {
    return Plan(elem, g, d, page, tile, stages).total;
  }
};

// Slot b's new row at head h (and its scales) to pages[pw, ow, h]; the rows
// are read before the destination is checked, so that their loads overlap
// the ones of pw and ow.
template <typename PageT, bool kQuant>
__device__ __forceinline__ void write_row(const Args& a, int b, int h, int pw, int ow, int tid,
                                          int nthreads) {
  PageT* k_pages = static_cast<PageT*>(a.k_pages);
  PageT* v_pages = static_cast<PageT*>(a.v_pages);
  const PageT* k_new = static_cast<const PageT*>(a.k_new);
  const PageT* v_new = static_cast<const PageT*>(a.v_new);
  const size_t row_n = static_cast<size_t>(b) * a.hkv + h;
  const size_t row_w = (static_cast<size_t>(pw) * a.page + ow) * a.hkv + h;
  const bool bad = pw < 0 || pw >= a.n_pages || ow < 0 || ow >= a.page;
  for (int i = tid; i < a.d; i += nthreads) {
    const PageT kv = k_new[row_n * a.d + i];
    const PageT vv = v_new[row_n * a.d + i];
    if (bad) __trap();
    k_pages[row_w * a.d + i] = kv;
    v_pages[row_w * a.d + i] = vv;
  }
  if (bad) __trap();
  if (kQuant && tid == 0) {
    a.k_scale_pages[row_w] = a.k_scale_new[row_n];
    a.v_scale_pages[row_w] = a.v_scale_new[row_n];
  }
}

// grid (B, Hkv); block kScatterThreads.  The last of several slots with one
// destination writes it, as on the TPU's sequential grid.
template <typename PageT, bool kQuant>
__global__ void paged_scatter_kernel(Args a) {
  const int b = blockIdx.x;
  for (int later = b + 1; later < a.bsz; ++later)
    if (a.page_idx[later] == a.page_idx[b] && a.off[later] == a.off[b]) return;
  write_row<PageT, kQuant>(a, b, blockIdx.y, a.page_idx[b], a.off[b], threadIdx.x, blockDim.x);
}

// One entry of the step scatter's table: one pool leaf of one attention layer.
struct StepLeaf {
  unsigned long long pool;  // the (P, page, ...) pool's address; a row of `bytes` a (page, offset)
  unsigned col;             // the leaf's byte offset in a row of the gathered buffer
  unsigned bytes;           // the bytes of one row
};

constexpr int kMaxStepLeaves = 240;  // 3840 bytes of table: the parameters stay under 4 KB

struct StepTable {
  StepLeaf leaf[kMaxStepLeaves];
};

// The bytes a thread moves at once for a leaf: the widest of 16, 8, 4, 2, 1
// that divides the pool's and the buffer's addresses, the buffer's row, the
// leaf's offset in it and its width.
__host__ __device__ __forceinline__ int step_vec(const StepLeaf& lf, const void* whole,
                                                 long long width) {
  const unsigned long long x = lf.pool | reinterpret_cast<unsigned long long>(whole) |
                               static_cast<unsigned long long>(width) | lf.col | lf.bytes | 16;
  return static_cast<int>(x & (~x + 1));
}

template <typename V>
__device__ __forceinline__ void copy_vec(unsigned char* dst, const unsigned char* src) {
  *reinterpret_cast<V*>(dst) = *reinterpret_cast<const V*>(src);
}

// grid (row chunks, table entries); block kScatterThreads; dynamic shared
// memory one long long a row.  Item i of entry e is vector i % per_row of
// row i / per_row (the launch keeps rows * per_row within an int); a row
// whose (page, offset) a later row also has is skipped, so the last wins.
__global__ void paged_scatter_step_kernel(const unsigned char* __restrict__ whole,
                                          const __grid_constant__ StepTable table,
                                          const int* __restrict__ page_idx,
                                          const int* __restrict__ off, int rows, long long width,
                                          int n_pages, int page) {
  extern __shared__ long long dest[];  // a row's place in the pools' rows, or -1: a later row wins
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int pw = page_idx[r], ow = off[r];
    if (pw < 0 || pw >= n_pages || ow < 0 || ow >= page) __trap();
    long long d = static_cast<long long>(pw) * page + ow;
    for (int later = r + 1; later < rows; ++later)
      if (page_idx[later] == pw && off[later] == ow) {
        d = -1;
        break;
      }
    dest[r] = d;
  }
  __syncthreads();
  const StepLeaf& lf = table.leaf[blockIdx.y];
  const int vec = step_vec(lf, whole, width);
  const int per_row = static_cast<int>(lf.bytes) / vec;
  const int items = rows * per_row;
  unsigned char* pool = reinterpret_cast<unsigned char*>(lf.pool);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items; i += gridDim.x * blockDim.x) {
    const int r = i / per_row;
    const long long at = static_cast<long long>(i - r * per_row) * vec;
    const long long d = dest[r];
    if (d < 0) continue;
    const unsigned char* src = whole + static_cast<long long>(r) * width + lf.col + at;
    unsigned char* dst = pool + d * lf.bytes + at;
    switch (vec) {
      case 16: copy_vec<uint4>(dst, src); break;
      case 8: copy_vec<uint2>(dst, src); break;
      case 4: copy_vec<unsigned>(dst, src); break;
      case 2: copy_vec<unsigned short>(dst, src); break;
      default: *dst = *src;
    }
  }
}

__device__ __forceinline__ int table_entry(const Args& a, int b, int j) {
  const int tab = a.table[static_cast<size_t>(b) * a.m + j];
  if (tab < 0 || tab >= a.n_pages) __trap();
  return tab;
}

// A thread's first (row, chunk) of a tile and its step, so that the copy
// loop divides nothing.
struct TileStep {
  int t0, c0, dt, dc;
  __device__ TileStep(int tid, int nthreads, int nch)
      : t0(tid / nch), c0(tid % nch), dt(nthreads / nch), dc(nthreads % nch) {}
};

// Start the copy of the rows at head h (and their scales) of `np` pages,
// whose ids are in `ids`, into a stage: page p's row r is tile row p*page + r.
template <typename PageT, bool kQuant>
__device__ __forceinline__ void load_tile(const Args& a, const Plan& pl, const TileStep& st,
                                          const int* ids, int np, int h, unsigned char* stage,
                                          int tid, int nthreads) {
  constexpr int kVec = kChunk / sizeof(PageT);
  const int PAGE = a.page, D = a.d;
  const PageT* kg = static_cast<const PageT*>(a.k_pages);
  const PageT* vg = static_cast<const PageT*>(a.v_pages);
  const int row_stride = a.hkv * D;
  const size_t page_stride = static_cast<size_t>(PAGE) * row_stride;
  int pp = 0, r = st.t0;  // tile row t = pp * PAGE + r
  while (r >= PAGE) {
    r -= PAGE;
    ++pp;
  }
  for (int c = st.c0; pp < np;) {
    const int t = pp * PAGE + r;
    unsigned char* kd = stage + (t * pl.krow + c) * kChunk;
    unsigned char* vd = stage + pl.v_off + (t * pl.nch + c) * kChunk;
    const size_t off = ids[pp] * page_stride + h * D + r * row_stride + c * kVec;
    if (a.vec) {
      cp_async16(kd, kg + off);
      cp_async16(vd, vg + off);
    } else {  // plain loads, zeros past D
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const bool in = c * kVec + e < D;
        reinterpret_cast<PageT*>(kd)[e] = in ? kg[off + e] : zero<PageT>();
        reinterpret_cast<PageT*>(vd)[e] = in ? vg[off + e] : zero<PageT>();
      }
    }
    r += st.dt;
    c += st.dc;
    if (c >= pl.nch) {
      c -= pl.nch;
      ++r;
    }
    while (r >= PAGE) {
      r -= PAGE;
      ++pp;
    }
  }
  if (kQuant) {
    float* sc = reinterpret_cast<float*>(stage + pl.sc_off);  // K scales, then V scales
    const int keys = np * PAGE;
    for (int i = tid; i < 2 * keys; i += nthreads) {
      const int t = i < keys ? i : i - keys;
      const size_t row = (static_cast<size_t>(ids[t / PAGE]) * PAGE + t % PAGE) * a.hkv + h;
      cp_async4(sc + (i < keys ? t : pl.keys + t),
                (i < keys ? a.k_scale_pages : a.v_scale_pages) + row);
    }
  }
}

// Slot b's page ids for run pages [first, first + np) into `ids`, by the
// first np threads.
__device__ __forceinline__ void fetch_ids(const Args& a, int b, int first, int np, int* ids,
                                          int tid) {
  if (tid < np) ids[tid] = table_entry(a, b, first + tid);
}

// grid (S, Hkv, B); block 32 * ceil(G / kHeads) threads.  Warp w takes query
// heads kHeads*w ... (a head past G, for odd G, runs on zeros and stores
// nothing).  Block s walks pages [j_lo + s*C, min(j_lo + (s+1)*C, j_hi + 1))
// of slot b's live range, in tiles of a.tile pages.  With kScatter, slot b's
// new row lands first (the fused step).
template <typename PageT, typename QT, bool kQuant, bool kScatter>
__global__ void paged_attention_kernel(Args a) {
  constexpr int kVec = kChunk / sizeof(PageT);
  constexpr int kQChunks = 2 * sizeof(PageT);  // K chunks a scoring lane takes at D <= 256
  constexpr int kLaneChunks = sizeof(PageT) == 4 ? 2 : 1;  // V chunks a P.V lane takes
  constexpr int kAcc = kLaneChunks * kVec;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int w = tid / kWarp;
  const int G = a.g, D = a.d, PAGE = a.page, HKV = a.hkv;
  const Plan pl(sizeof(PageT), G, D, PAGE, a.tile, a.stages);
  const TileStep st(tid, blockDim.x, pl.nch);
  // scoring: lane = part * kKeys + key; part p takes chunks p, p + kParts, ...
  const int key_lane = lane % kKeys;
  const int part = lane / kKeys;
  // P.V: lane = kp * cl + chunk; the kpv key shares kp split the keys
  const int cl = min(kWarp, pow2_at_least(pl.nch));
  const int chunk_lane = lane % cl;
  const int kp = lane / cl;
  const int kpv = kWarp / cl;
  const int TK = pl.keys;  // keys in a full tile

  extern __shared__ __align__(16) unsigned char smem[];
  int* ids_s = reinterpret_cast<int*>(smem);  // (2, kMaxTile): the next two tiles' page ids
  float* pr = reinterpret_cast<float*>(smem + pl.p_off) + w * kHeads * TK;  // (kHeads, TK)
  unsigned char* stages = smem + pl.stage_off;

  // the loads that need nothing else first: the position, the row's
  // destination, and this lane's share of the warp's query heads in fp32
  // registers (zero past D)
  const int p0 = a.pos[b];
  const int pw = kScatter ? a.page_idx[b] : 0;
  const int ow = kScatter ? a.off[b] : 0;
  const size_t row_n = static_cast<size_t>(b) * HKV + h;
  float qreg[kHeads][kQChunks * kVec];
#pragma unroll
  for (int k = 0; k < kHeads; ++k) {
    const int g = kHeads * w + k;
    const QT* q_g = static_cast<const QT*>(a.q) + (row_n * G + min(g, G - 1)) * D;
#pragma unroll
    for (int i = 0; i < kQChunks; ++i)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int dd = (part + kParts * i) * kVec + e;
        qreg[k][i * kVec + e] = g < G && dd < D ? to_float(q_g[dd]) : 0.f;
      }
  }
  // 1. the fused step's scatter: every split block writes slot b's row at head h
  if (kScatter) write_row<PageT, kQuant>(a, b, h, pw, ow, tid, blockDim.x);
  if (p0 < 0) __trap();
  // the combine (when S > 1) may start its blocks now: it waits for this grid
  griddep_launch_dependents();

  // 2. this block's run of the live range, from the first page inside the
  //    window to the one holding pos, in tiles of a.tile pages; tile i's
  //    page ids sit in slot i & 1
  const int j_hi = min(a.m - 1, p0 / PAGE);
  const int j_lo = a.window ? max(0, p0 - a.window + 1) / PAGE : 0;
  const int js = j_lo + split * a.run;
  const int n = max(0, min(js + a.run - 1, j_hi) - js + 1);
  const int nt = (n + a.tile - 1) / a.tile;
  if (nt > 0) fetch_ids(a, b, js, min(a.tile, n), ids_s, tid);
  if (nt > 1) fetch_ids(a, b, js + a.tile, min(a.tile, n - a.tile), ids_s + kMaxTile, tid);
  float m_run[kHeads], l_run[kHeads], acc[kHeads][kAcc];
#pragma unroll
  for (int k = 0; k < kHeads; ++k) {
    m_run[k] = kNegInf;
    l_run[k] = 0.f;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[k][e] = 0.f;
  }
  __syncthreads();  // the new row is visible to the copies below; so are the ids
  if (nt > 0) load_tile<PageT, kQuant>(a, pl, st, ids_s, min(a.tile, n), h, stages, tid,
                                       blockDim.x);
  cp_async_commit();

  for (int i = 0; i < nt; ++i) {
    const int j0 = js + i * a.tile;                      // the tile's first page
    const int nk = min(a.tile, n - i * a.tile) * PAGE;   // its keys
    if (i + 1 < nt)  // tile i+1 in flight while tile i is scored
      load_tile<PageT, kQuant>(a, pl, st, ids_s + ((i + 1) & 1) * kMaxTile,
                               min(a.tile, n - (i + 1) * a.tile), h,
                               stages + ((i + 1) & 1) * pl.stage_bytes, tid, blockDim.x);
    cp_async_commit();
    if (i + 2 < nt)  // tile i's slot is free: its copies were started
      fetch_ids(a, b, j0 + 2 * a.tile, min(a.tile, n - (i + 2) * a.tile),
                ids_s + (i & 1) * kMaxTile, tid);
    cp_async_wait<1>();
    __syncthreads();  // tile i has landed for every thread
    const unsigned char* kt = stages + (i & 1) * pl.stage_bytes;
    const unsigned char* vt = kt + pl.v_off;
    const float* sc = reinterpret_cast<const float*>(kt + pl.sc_off);

    // scores of the tile's keys for the warp's heads, kKeys keys a pass.
    // Chunks and keys past the row or the tile read the last one (no
    // branch; its q is zero, or its score is masked).
    float mx[kHeads];
#pragma unroll
    for (int k = 0; k < kHeads; ++k) mx[k] = kNegInf;
#pragma unroll 2
    for (int t0 = 0; t0 < nk; t0 += kKeys) {
      const int t = t0 + key_lane;
      const int tr = min(t, nk - 1);
      const unsigned char* krow_s = kt + tr * pl.krow * kChunk;
      const float ksc = kQuant ? sc[tr] : 1.f;
      float dots[kHeads][kQChunks];
#pragma unroll
      for (int c = 0; c < kQChunks; ++c) {
        float kf[kVec];
        widen<PageT>(krow_s + min(part + kParts * c, pl.nch - 1) * kChunk, kf);
#pragma unroll
        for (int k = 0; k < kHeads; ++k) {
          dots[k][c] = 0.f;
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            dots[k][c] += qreg[k][c * kVec + e] * (kQuant ? kf[e] * ksc : kf[e]);
        }
      }
      const int kpos = j0 * PAGE + t;
      const bool valid = t < nk && kpos <= p0 && (a.window == 0 || kpos > p0 - a.window);
#pragma unroll
      for (int k = 0; k < kHeads; ++k) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < kQChunks; ++c) dot += dots[k][c];
        for (int o = kKeys; o < kWarp; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const float s = valid ? dot * a.scale : kNegInf;
        if (part == 0 && t < nk) pr[k * TK + t] = s;
        mx[k] = fmaxf(mx[k], s);
      }
    }
    // every part holds the same scores: the max over keys is over lane bits
    // 0-1; then lane t takes keys t, t + 32, ... for the probabilities
    float corr[kHeads], m_new[kHeads], psum[kHeads];
#pragma unroll
    for (int k = 0; k < kHeads; ++k) {
      for (int o = 1; o < kKeys; o <<= 1)
        mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], o));
      m_new[k] = fmaxf(m_run[k], mx[k]);
      corr[k] = expf(m_run[k] - m_new[k]);
      psum[k] = 0.f;
    }
    __syncwarp();
    for (int t = lane; t < nk; t += kWarp)
#pragma unroll
      for (int k = 0; k < kHeads; ++k) {  // a masked key gives exactly 0
        const float sk = pr[k * TK + t];
        const float p = sk > kNegInf ? expf(sk - m_new[k]) : 0.f;
        pr[k * TK + t] = p;
        psum[k] += p;
      }
#pragma unroll
    for (int k = 0; k < kHeads; ++k) {
      psum[k] = warp_sum(psum[k]);
      l_run[k] = l_run[k] * corr[k] + psum[k];
      m_run[k] = m_new[k];
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[k][e] *= corr[k];
    }
    __syncwarp();

    // P.V: this lane's chunks over its share of the keys, both heads from
    // one read of V (a chunk past the row reads the last one into an
    // accumulator that is never stored)
#pragma unroll 4
    for (int t = kp; t < nk; t += kpv) {
      const float vsc = kQuant ? sc[TK + t] : 1.f;
      float p[kHeads];
#pragma unroll
      for (int k = 0; k < kHeads; ++k) p[k] = pr[k * TK + t];
      const unsigned char* vrow = vt + t * pl.nch * kChunk;
#pragma unroll
      for (int lc = 0; lc < kLaneChunks; ++lc) {
        float vf[kVec];
        widen<PageT>(vrow + min(chunk_lane + lc * cl, pl.nch - 1) * kChunk, vf);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float v = kQuant ? vf[e] * vsc : vf[e];
#pragma unroll
          for (int k = 0; k < kHeads; ++k) acc[k][lc * kVec + e] += p[k] * v;
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // 3. add the key shares; store the output (S = 1) or this split's partial
#pragma unroll
  for (int k = 0; k < kHeads; ++k)
#pragma unroll
    for (int e = 0; e < kAcc; ++e)
      for (int o = kWarp / 2; o >= cl; o >>= 1)
        acc[k][e] += __shfl_xor_sync(0xffffffffu, acc[k][e], o);
#pragma unroll
  for (int k = 0; k < kHeads; ++k) {
    const int g = kHeads * w + k;
    if (g >= G) continue;
    const size_t head = row_n * G + g;  // (b, h, g) in (B, Hkv, G)
    if (a.splits == 1) {
      const float denom = fmaxf(l_run[k], 1e-20f);
      QT* o = static_cast<QT*>(a.out) + head * D;
      if (kp == 0)
#pragma unroll
        for (int lc = 0; lc < kLaneChunks; ++lc)
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const int dd = (chunk_lane + lc * cl) * kVec + e;
            if (dd < D) o[dd] = from_float<QT>(acc[k][lc * kVec + e] / denom);
          }
      continue;
    }
    const size_t part_row = (row_n * a.splits + split) * G + g;  // (b, h, s, g)
    const size_t n_rows = static_cast<size_t>(a.bsz) * HKV * a.splits * G;
    if (lane == 0) {
      a.work[n_rows * D + part_row] = m_run[k];
      a.work[n_rows * D + n_rows + part_row] = l_run[k];
    }
    if (l_run[k] > 0.f && kp == 0) {  // an empty split leaves its acc unwritten
      float* wa = a.work + part_row * D;
#pragma unroll
      for (int lc = 0; lc < kLaneChunks; ++lc)
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int dd = (chunk_lane + lc * cl) * kVec + e;
          if (dd < D) wa[dd] = acc[k][lc * kVec + e];
        }
    }
  }
}

// grid (B * Hkv * G); block D rounded up to 32 threads, thread d owns output
// dim d.  Merges the S partials of one (b, h, g) in the order s = 0 .. S-1:
// m = the largest m_s of a nonempty split, l = sum l_s e^(m_s - m), acc =
// sum acc_s e^(m_s - m), out = acc / max(l, 1e-20).  One nonempty split
// gives its partial's acc / max(l, 1e-20) exactly, as with S = 1.  The first
// kCombineBatch partials are loaded before their weights are known (an empty
// split's unwritten acc is read and discarded).
template <typename QT>
__global__ void paged_attention_combine_kernel(Args a) {
  extern __shared__ float msh[];  // m_s, then the weights e^(m_s - m) (S); l_s (S)
  const int S = a.splits, D = a.d, G = a.g;
  float* lsh = msh + S;
  const size_t head = blockIdx.x;  // (b, h, g) in (B, Hkv, G)
  const size_t bh = head / G;
  const int g = static_cast<int>(head - bh * G);
  const size_t n_rows = static_cast<size_t>(a.bsz) * a.hkv * S * G;
  const float* acc_p = a.work;
  const float* m_p = a.work + n_rows * D;
  const float* l_p = m_p + n_rows;
  const int tid = threadIdx.x;
  const int dd = min(tid, D - 1);
  griddep_wait();  // the walk's partials are complete and visible
  float x[kCombineBatch];
#pragma unroll
  for (int k = 0; k < kCombineBatch; ++k)
    x[k] = acc_p[((bh * S + min(k, S - 1)) * G + g) * D + dd];
  for (int s = tid; s < S; s += blockDim.x) {
    const size_t r = (bh * S + s) * G + g;
    msh[s] = m_p[r];
    lsh[s] = l_p[r];
  }
  __syncthreads();
  if (tid < kWarp) {
    float mx = kNegInf;
    for (int s = tid; s < S; s += kWarp)
      if (lsh[s] > 0.f) mx = fmaxf(mx, msh[s]);
    mx = warp_max(mx);
    for (int s = tid; s < S; s += kWarp) msh[s] = lsh[s] > 0.f ? expf(msh[s] - mx) : 0.f;
  }
  __syncthreads();
  float l = 0.f, acc = 0.f;
  for (int s0 = 0; s0 < S; s0 += kCombineBatch) {
    if (s0 > 0)
#pragma unroll
      for (int k = 0; k < kCombineBatch; ++k) {  // loads in flight together; empty splits skipped
        const int s = s0 + k;
        x[k] = s < S && msh[s] != 0.f ? acc_p[((bh * S + s) * G + g) * D + dd] : 0.f;
      }
#pragma unroll
    for (int k = 0; k < kCombineBatch; ++k) {
      const int s = s0 + k;
      if (s < S) {
        const float wgt = msh[s];
        l += lsh[s] * wgt;
        acc += wgt != 0.f ? wgt * x[k] : 0.f;
      }
    }
  }
  if (tid < D) static_cast<QT*>(a.out)[head * D + tid] = from_float<QT>(acc / fmaxf(l, 1e-20f));
}

template <typename PageT, typename QT, bool kQuant, bool kScatter>
cudaError_t launch_attention(Args a, cudaStream_t stream) {
  const BlockPlan bp(sizeof(PageT), a.g, a.d, a.page, a.run);
  a.tile = bp.tile;
  a.stages = bp.stages;
  const size_t smem = bp.shared_bytes(sizeof(PageT), a.g, a.d, a.page);
  auto kernel = paged_attention_kernel<PageT, QT, kQuant, kScatter>;
  if (smem > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const uintptr_t kp = reinterpret_cast<uintptr_t>(a.k_pages);
  const uintptr_t vp = reinterpret_cast<uintptr_t>(a.v_pages);
  a.vec = (a.d * sizeof(PageT)) % kChunk == 0 && kp % kChunk == 0 && vp % kChunk == 0;
  const int threads = kWarp * ((a.g + kHeads - 1) / kHeads);
  kernel<<<dim3(a.splits, a.hkv, a.bsz), threads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  // the combine launches while the walk runs (programmatic dependent launch)
  // and waits in griddepcontrol.wait for the walk's partials
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.bsz * a.hkv * a.g);
  cfg.blockDim = dim3((a.d + kWarp - 1) / kWarp * kWarp);
  cfg.dynamicSmemBytes = 2 * sizeof(float) * a.splits;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_attention_combine_kernel<QT>, a);
}

template <bool kScatter>
int dispatch_attention(int page_kind, int q_kind, const Args& a, cudaStream_t s) {
  if (a.splits < 1 || a.run < 1 || (a.splits > 1 && a.work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (page_kind == 0 && q_kind == 0) return launch_attention<float, float, false, kScatter>(a, s);
  if (page_kind == 0 && q_kind == 1)
    return launch_attention<float, __nv_bfloat16, false, kScatter>(a, s);
  if (page_kind == 1 && q_kind == 0)
    return launch_attention<__nv_bfloat16, float, false, kScatter>(a, s);
  if (page_kind == 1 && q_kind == 1)
    return launch_attention<__nv_bfloat16, __nv_bfloat16, false, kScatter>(a, s);
  if (page_kind == 2 && q_kind == 0) return launch_attention<int8_t, float, true, kScatter>(a, s);
  if (page_kind == 2 && q_kind == 1)
    return launch_attention<int8_t, __nv_bfloat16, true, kScatter>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename PageT, bool kQuant>
cudaError_t launch_scatter(const Args& a, cudaStream_t stream) {
  paged_scatter_kernel<PageT, kQuant><<<dim3(a.bsz, a.hkv), kScatterThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

const int kElemBytes[3] = {4, 2, 1};

}  // namespace

// page_kind: 0 fp32, 1 bf16, 2 int8 (with scale pages); q_kind: 0 fp32, 1 bf16.
// `splits` (S) and `run` (C) are the wrapper's split plan; with S > 1,
// `work` is an fp32 workspace of B * Hkv * S * G * (D + 2) floats.  Each
// function launches on `stream` and returns the launch's cudaError_t (0 on
// success).

// The fused decode step: scatter, then attend.
extern "C" int repro_paged_attention_scatter(
    int page_kind, int q_kind, const void* q, const void* k_new, const void* v_new,
    const float* k_scale_new, const float* v_scale_new, void* k_pages, void* v_pages,
    float* k_scale_pages, float* v_scale_pages, const int* table, const int* pos,
    const int* page_idx, const int* off, void* out, float* work, int b, int n_pages, int hkv,
    int g, int d, int page, int m, int window, int splits, int run, float scale,
    void* stream) {
  Args a{};
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.k_scale_new = k_scale_new;
  a.v_scale_new = v_scale_new;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale_pages = k_scale_pages;
  a.v_scale_pages = v_scale_pages;
  a.table = table;
  a.pos = pos;
  a.page_idx = page_idx;
  a.off = off;
  a.out = out;
  a.work = work;
  a.bsz = b;
  a.n_pages = n_pages;
  a.hkv = hkv;
  a.g = g;
  a.d = d;
  a.page = page;
  a.m = m;
  a.window = window;
  a.splits = splits;
  a.run = run;
  a.scale = scale;
  return dispatch_attention<true>(page_kind, q_kind, a, static_cast<cudaStream_t>(stream));
}

// Attention over the pages as they are (the pools are only read).
extern "C" int repro_paged_attention(
    int page_kind, int q_kind, const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale_pages, const float* v_scale_pages, const int* table, const int* pos,
    void* out, float* work, int b, int n_pages, int hkv, int g, int d, int page, int m,
    int window, int splits, int run, float scale, void* stream) {
  Args a{};
  a.q = q;
  a.k_pages = const_cast<void*>(k_pages);
  a.v_pages = const_cast<void*>(v_pages);
  a.k_scale_pages = const_cast<float*>(k_scale_pages);
  a.v_scale_pages = const_cast<float*>(v_scale_pages);
  a.table = table;
  a.pos = pos;
  a.out = out;
  a.work = work;
  a.bsz = b;
  a.n_pages = n_pages;
  a.hkv = hkv;
  a.g = g;
  a.d = d;
  a.page = page;
  a.m = m;
  a.window = window;
  a.splits = splits;
  a.run = run;
  a.scale = scale;
  return dispatch_attention<false>(page_kind, q_kind, a, static_cast<cudaStream_t>(stream));
}

// Each slot's new K/V row (and scales) into its page, in place; the last of
// several slots with one destination wins.
extern "C" int repro_paged_scatter(int page_kind, const void* k_new, const void* v_new,
                                   const float* k_scale_new, const float* v_scale_new,
                                   void* k_pages, void* v_pages, float* k_scale_pages,
                                   float* v_scale_pages, const int* page_idx, const int* off,
                                   int b, int n_pages, int hkv, int d, int page, void* stream) {
  Args a{};
  a.k_new = k_new;
  a.v_new = v_new;
  a.k_scale_new = k_scale_new;
  a.v_scale_new = v_scale_new;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale_pages = k_scale_pages;
  a.v_scale_pages = v_scale_pages;
  a.page_idx = page_idx;
  a.off = off;
  a.bsz = b;
  a.n_pages = n_pages;
  a.hkv = hkv;
  a.d = d;
  a.page = page;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page_kind == 0) return launch_scatter<float, false>(a, s);
  if (page_kind == 1) return launch_scatter<__nv_bfloat16, false>(a, s);
  if (page_kind == 2) return launch_scatter<int8_t, true>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The data-split step's scatter: the (rows, width) byte buffer `whole` into
// the pools of the `n_leaves` StepLeafs at host address `leaves`, each row
// to (page_idx[r], off[r]); of several rows with one destination the last
// wins.  The table is copied into the launch's parameters.
extern "C" int repro_paged_scatter_step(const void* whole, const void* leaves, int n_leaves,
                                        const int* page_idx, const int* off, int rows,
                                        long long width, int n_pages, int page, void* stream) {
  if (rows < 1 || n_leaves < 1 || n_leaves > kMaxStepLeaves ||
      static_cast<size_t>(rows) * sizeof(long long) > kDefaultShared)
    return static_cast<int>(cudaErrorInvalidValue);
  StepTable table;
  long long max_per_row = 1;
  for (int e = 0; e < n_leaves; ++e) {
    table.leaf[e] = static_cast<const StepLeaf*>(leaves)[e];
    const long long per_row = table.leaf[e].bytes / step_vec(table.leaf[e], whole, width);
    if (per_row > max_per_row) max_per_row = per_row;
  }
  if (rows * max_per_row >= (1LL << 31) - kScatterThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((rows * max_per_row + kScatterThreads - 1) / kScatterThreads);
  paged_scatter_step_kernel<<<dim3(blocks, n_leaves), kScatterThreads,
                              rows * sizeof(long long), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(whole), table, page_idx, off, rows, width, n_pages, page);
  return static_cast<int>(cudaGetLastError());
}

// The attention block's dynamic shared memory, in bytes, for runs of `run`
// pages (the launch opts in above 48 KB; a block may have 232,448).
extern "C" size_t repro_paged_attention_shared_bytes(int page_kind, int g, int d, int page,
                                                     int run) {
  if (page_kind < 0 || page_kind > 2 || run < 1) return 0;
  const int elem = kElemBytes[page_kind];
  return BlockPlan(elem, g, d, page, run).shared_bytes(elem, g, d, page);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
