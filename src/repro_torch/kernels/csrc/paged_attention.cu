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
// the memory, so the kernel is memory bound.  The scatter alone moves a
// few KB: its launch is its cost.
//
// What the design does about it: one thread block per (slot, kv head)
// reads each element of that pair's live pages from device memory once,
// and the G query heads of the group share that read from shared memory
// (one warp per query head).  int8 pages are dequantised as they are
// loaded, so a quantised pool moves half the bytes of a bf16 one.  The
// walk covers only the pages that hold an unmasked key (from the first
// page inside the window to the page holding pos[b]); pages the mask would
// zero are never read, and skipping them changes no bit of the result.
// Not done yet: cp.async/TMA double buffering of the page tiles, and more
// than one block per (slot, kv head) for long contexts.
//
// Races: in the fused kernel block (b, h) writes only slot b's row at head
// h and reads only slot b's pages at head h.  Idle slots all write the
// scratch page 0 and only idle slots read it; their outputs are discarded.
// The standalone scatter runs its blocks in no order, where the TPU's grid
// is sequential and the last of two rows with one destination wins: so a
// row is written only if no later slot has the same destination, which
// makes the result the sequential grid's, bit for bit.
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
constexpr int kMaxDimsPerLane = 8;  // head_dim <= 256
constexpr int kScatterThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
  int bsz, n_pages, hkv, g, d, page, m, window;
  float scale;
};

size_t shared_bytes(int g, int d, int page) {
  // q (G, D) + K tile (page, D + 1) + V tile (page, D) + probabilities (G, page)
  return sizeof(float) * (static_cast<size_t>(g) * d + static_cast<size_t>(page) * (d + 1) +
                          static_cast<size_t>(page) * d + static_cast<size_t>(g) * page);
}

// Slot b's new row at head h (and its scales) to pages[page_idx[b], off[b], h].
template <typename PageT, bool kQuant>
__device__ __forceinline__ void write_row(const Args& a, int b, int h, int tid, int nthreads) {
  const int pw = a.page_idx[b];
  const int ow = a.off[b];
  if (pw < 0 || pw >= a.n_pages || ow < 0 || ow >= a.page) __trap();
  PageT* k_pages = static_cast<PageT*>(a.k_pages);
  PageT* v_pages = static_cast<PageT*>(a.v_pages);
  const PageT* k_new = static_cast<const PageT*>(a.k_new);
  const PageT* v_new = static_cast<const PageT*>(a.v_new);
  const size_t row_n = static_cast<size_t>(b) * a.hkv + h;
  const size_t row_w = (static_cast<size_t>(pw) * a.page + ow) * a.hkv + h;
  for (int i = tid; i < a.d; i += nthreads) {
    k_pages[row_w * a.d + i] = k_new[row_n * a.d + i];
    v_pages[row_w * a.d + i] = v_new[row_n * a.d + i];
  }
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
  write_row<PageT, kQuant>(a, b, blockIdx.y, threadIdx.x, blockDim.x);
}

// grid (B, Hkv); block 32 * G threads, warp w owns query head w.  With
// kScatter, slot b's new row lands first (the fused decode step).
template <typename PageT, typename QT, bool kQuant, bool kScatter>
__global__ void paged_attention_kernel(Args a) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int w = tid / kWarp;
  const int G = a.g, D = a.d, PAGE = a.page, HKV = a.hkv;
  const int kstride = D + 1;  // padded K rows: lane t reads row t free of bank conflicts

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + G * D;
  float* v_s = k_s + PAGE * kstride;
  float* p_s = v_s + PAGE * D;

  const PageT* k_pages = static_cast<PageT*>(a.k_pages);  // plain loads: the walk
  const PageT* v_pages = static_cast<PageT*>(a.v_pages);  // reads the row just written
  const QT* q = static_cast<const QT*>(a.q);
  QT* out = static_cast<QT*>(a.out);

  const int p0 = a.pos[b];
  if (p0 < 0) __trap();

  // 1. the fused step's scatter: slot b's new row at head h
  if (kScatter) write_row<PageT, kQuant>(a, b, h, tid, blockDim.x);
  const size_t row_n = static_cast<size_t>(b) * HKV + h;
  const QT* q_bh = q + row_n * G * D;
  for (int i = tid; i < G * D; i += blockDim.x) q_s[i] = to_float(q_bh[i]);
  __syncthreads();  // the new row is visible to the walk below

  // 2. the walk: pages from the first one inside the window to the one holding pos
  const int j_hi = min(a.m - 1, p0 / PAGE);
  const int j_lo = a.window ? max(0, p0 - a.window + 1) / PAGE : 0;
  const float* qr = q_s + w * D;
  float* pr = p_s + w * PAGE;
  float m_run = kNegInf;
  float l_run = 0.f;
  float acc[kMaxDimsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDimsPerLane; ++i) acc[i] = 0.f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int tab = a.table[static_cast<size_t>(b) * a.m + j];
    if (tab < 0 || tab >= a.n_pages) __trap();
    const size_t pid = static_cast<size_t>(tab);
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < PAGE * D; i += blockDim.x) {
      const int t = i / D;
      const int dd = i - t * D;
      const size_t srow = (pid * PAGE + t) * HKV + h;
      float kv = to_float(k_pages[srow * D + dd]);
      float vv = to_float(v_pages[srow * D + dd]);
      if (kQuant) {
        kv *= a.k_scale_pages[srow];
        vv *= a.v_scale_pages[srow];
      }
      k_s[t * kstride + dd] = kv;
      v_s[t * D + dd] = vv;
    }
    __syncthreads();

    // scores of this page for query head w: lane t takes key t
    float mx = kNegInf;
    for (int t = lane; t < PAGE; t += kWarp) {
      const int kpos = j * PAGE + t;
      const bool valid = kpos <= p0 && (a.window == 0 || kpos > p0 - a.window);
      float s = kNegInf;
      if (valid) {
        const float* kr = k_s + t * kstride;
        float dot = 0.f;
        for (int dd = 0; dd < D; ++dd) dot += qr[dd] * kr[dd];
        s = dot * a.scale;
      }
      pr[t] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    float psum = 0.f;
    for (int t = lane; t < PAGE; t += kWarp) {
      const float p = expf(pr[t] - m_new);  // a masked key gives exactly 0
      pr[t] = p;
      psum += p;
    }
    psum = warp_sum(psum);
    l_run = l_run * corr + psum;
    __syncwarp();
    // P.V: lane owns dims lane, lane + 32, ...
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int dd = lane + i * kWarp;
      if (dd < D) {
        float pv = 0.f;
        for (int t = 0; t < PAGE; ++t) pv += pr[t] * v_s[t * D + dd];
        acc[i] = acc[i] * corr + pv;
      }
    }
    m_run = m_new;
  }

  // 3. normalise and store in q's dtype
  const float denom = fmaxf(l_run, 1e-20f);
  QT* o = out + (row_n * G + w) * D;
#pragma unroll
  for (int i = 0; i < kMaxDimsPerLane; ++i) {
    const int dd = lane + i * kWarp;
    if (dd < D) o[dd] = from_float<QT>(acc[i] / denom);
  }
}

template <typename PageT, typename QT, bool kQuant, bool kScatter>
cudaError_t launch_attention(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.bsz, a.hkv);
  const dim3 block(kWarp * a.g);
  paged_attention_kernel<PageT, QT, kQuant, kScatter>
      <<<grid, block, shared_bytes(a.g, a.d, a.page), stream>>>(a);
  return cudaGetLastError();
}

template <bool kScatter>
int dispatch_attention(int page_kind, int q_kind, const Args& a, cudaStream_t s) {
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

}  // namespace

// page_kind: 0 fp32, 1 bf16, 2 int8 (with scale pages); q_kind: 0 fp32, 1 bf16.
// Each function launches on `stream` and returns the launch's cudaError_t
// (0 on success).

// The fused decode step: scatter, then attend.
extern "C" int repro_paged_attention_scatter(
    int page_kind, int q_kind, const void* q, const void* k_new, const void* v_new,
    const float* k_scale_new, const float* v_scale_new, void* k_pages, void* v_pages,
    float* k_scale_pages, float* v_scale_pages, const int* table, const int* pos,
    const int* page_idx, const int* off, void* out, int b, int n_pages, int hkv, int g, int d,
    int page, int m, int window, float scale, void* stream) {
  Args a{q, k_new, v_new, k_scale_new, v_scale_new, k_pages, v_pages, k_scale_pages,
         v_scale_pages, table, pos, page_idx, off, out, b, n_pages, hkv, g, d, page, m,
         window, scale};
  return dispatch_attention<true>(page_kind, q_kind, a, static_cast<cudaStream_t>(stream));
}

// Attention over the pages as they are (the pools are only read).
extern "C" int repro_paged_attention(
    int page_kind, int q_kind, const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale_pages, const float* v_scale_pages, const int* table, const int* pos,
    void* out, int b, int n_pages, int hkv, int g, int d, int page, int m, int window,
    float scale, void* stream) {
  Args a{q, nullptr, nullptr, nullptr, nullptr, const_cast<void*>(k_pages),
         const_cast<void*>(v_pages), const_cast<float*>(k_scale_pages),
         const_cast<float*>(v_scale_pages), table, pos, nullptr, nullptr, out, b, n_pages,
         hkv, g, d, page, m, window, scale};
  return dispatch_attention<false>(page_kind, q_kind, a, static_cast<cudaStream_t>(stream));
}

// Each slot's new K/V row (and scales) into its page, in place; the last of
// several slots with one destination wins.
extern "C" int repro_paged_scatter(int page_kind, const void* k_new, const void* v_new,
                                   const float* k_scale_new, const float* v_scale_new,
                                   void* k_pages, void* v_pages, float* k_scale_pages,
                                   float* v_scale_pages, const int* page_idx, const int* off,
                                   int b, int n_pages, int hkv, int d, int page, void* stream) {
  Args a{nullptr, k_new, v_new, k_scale_new, v_scale_new, k_pages, v_pages, k_scale_pages,
         v_scale_pages, nullptr, nullptr, page_idx, off, nullptr, b, n_pages, hkv, 1, d, page,
         0, 0, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page_kind == 0) return launch_scatter<float, false>(a, s);
  if (page_kind == 1) return launch_scatter<__nv_bfloat16, false>(a, s);
  if (page_kind == 2) return launch_scatter<int8_t, true>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" size_t repro_paged_attention_shared_bytes(int g, int d, int page) {
  return shared_bytes(g, d, page);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
