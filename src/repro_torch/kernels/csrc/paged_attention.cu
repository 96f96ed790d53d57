// Paged-decode attention with the fused K/V scatter, for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_attention_scatter_pallas`
// (src/repro/kernels/paged_attention.py), which the reference's serving
// engine reaches through repro.serve.kvcache.paged_attention_decode with
// kernel="pallas".  One decode step, for every slot b and kv head h:
//   1. land slot b's new K/V row (and its int8 scales) at
//      pages[page_idx[b], off[b], h];
//   2. walk table[b] with an fp32 online softmax (m, l, acc) for the G
//      query heads of the GQA group, masking keys by position:
//      k_pos <= pos[b], and k_pos > pos[b] - window when a window is set.
//      The same mask gives causality and isolation between requests.
//   3. write acc / max(l, 1e-20) in the query's dtype.
//
// What bounds it on an H100: the bytes of the live K/V pages it reads, at
// 3.35 TB/s.  Per key it does 4*G*D flops (Q.K and P.V) against 2*D page
// elements read: at G = 4 that is 8 flops per bf16 byte, under the ~20
// flops per byte at which the fp32 CUDA cores (67 TFLOP/s) would balance
// the memory, so the kernel is memory bound.
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
// No race: block (b, h) writes only slot b's row at head h and reads only
// slot b's pages at head h.  Idle slots all write the scratch page 0 and
// only idle slots read it; their outputs are discarded.
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
  const void* q;             // (B, Hkv, G, D) fp32 or bf16
  const void* k_new;         // (B, Hkv, D) in the page dtype
  const void* v_new;
  const float* k_scale_new;  // (B, Hkv), int8 pages only
  const float* v_scale_new;
  void* k_pages;             // (P, page, Hkv, D), updated in place
  void* v_pages;
  float* k_scale_pages;      // (P, page, Hkv), int8 pages only
  float* v_scale_pages;
  const int* table;          // (B, M)
  const int* pos;            // (B,)
  const int* page_idx;       // (B,)
  const int* off;            // (B,)
  void* out;                 // (B, Hkv, G, D) in q's dtype
  int n_pages, hkv, g, d, page, m, window;
  float scale;
};

size_t shared_bytes(int g, int d, int page) {
  // q (G, D) + K tile (page, D + 1) + V tile (page, D) + probabilities (G, page)
  return sizeof(float) * (static_cast<size_t>(g) * d + static_cast<size_t>(page) * (d + 1) +
                          static_cast<size_t>(page) * d + static_cast<size_t>(g) * page);
}

// grid (B, Hkv); block 32 * G threads, warp w owns query head w.
template <typename PageT, typename QT, bool kQuant>
__global__ void paged_attention_scatter_kernel(Args a) {
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

  PageT* k_pages = static_cast<PageT*>(a.k_pages);
  PageT* v_pages = static_cast<PageT*>(a.v_pages);
  const PageT* k_new = static_cast<const PageT*>(a.k_new);
  const PageT* v_new = static_cast<const PageT*>(a.v_new);
  const QT* q = static_cast<const QT*>(a.q);
  QT* out = static_cast<QT*>(a.out);

  const int p0 = a.pos[b];
  if (p0 < 0 || a.page_idx[b] < 0 || a.page_idx[b] >= a.n_pages || a.off[b] < 0 ||
      a.off[b] >= PAGE)
    __trap();

  // 1. scatter: slot b's new row at head h
  const size_t row_n = static_cast<size_t>(b) * HKV + h;
  const size_t row_w = (static_cast<size_t>(a.page_idx[b]) * PAGE + a.off[b]) * HKV + h;
  for (int i = tid; i < D; i += blockDim.x) {
    k_pages[row_w * D + i] = k_new[row_n * D + i];
    v_pages[row_w * D + i] = v_new[row_n * D + i];
  }
  if (kQuant && tid == 0) {
    a.k_scale_pages[row_w] = a.k_scale_new[row_n];
    a.v_scale_pages[row_w] = a.v_scale_new[row_n];
  }
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

template <typename PageT, typename QT, bool kQuant>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const dim3 grid(b, a.hkv);
  const dim3 block(kWarp * a.g);
  paged_attention_scatter_kernel<PageT, QT, kQuant>
      <<<grid, block, shared_bytes(a.g, a.d, a.page), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// page_kind: 0 fp32, 1 bf16, 2 int8 (with scale pages); q_kind: 0 fp32, 1 bf16.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int repro_paged_attention_scatter(
    int page_kind, int q_kind, const void* q, const void* k_new, const void* v_new,
    const float* k_scale_new, const float* v_scale_new, void* k_pages, void* v_pages,
    float* k_scale_pages, float* v_scale_pages, const int* table, const int* pos,
    const int* page_idx, const int* off, void* out, int b, int n_pages, int hkv, int g, int d,
    int page, int m, int window, float scale, void* stream) {
  Args a{q, k_new, v_new, k_scale_new, v_scale_new, k_pages, v_pages, k_scale_pages,
         v_scale_pages, table, pos, page_idx, off, out, n_pages, hkv, g, d, page, m,
         window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page_kind == 0 && q_kind == 0) return launch<float, float, false>(a, b, s);
  if (page_kind == 0 && q_kind == 1) return launch<float, __nv_bfloat16, false>(a, b, s);
  if (page_kind == 1 && q_kind == 0) return launch<__nv_bfloat16, float, false>(a, b, s);
  if (page_kind == 1 && q_kind == 1) return launch<__nv_bfloat16, __nv_bfloat16, false>(a, b, s);
  if (page_kind == 2 && q_kind == 0) return launch<int8_t, float, true>(a, b, s);
  if (page_kind == 2 && q_kind == 1) return launch<int8_t, __nv_bfloat16, true>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" size_t repro_paged_attention_shared_bytes(int g, int d, int page) {
  return shared_bytes(g, d, page);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
