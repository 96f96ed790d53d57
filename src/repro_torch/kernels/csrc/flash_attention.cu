// Causal / sliding-window flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py), which the reference holds to
// `layers.chunked_causal_attention` / `attention_forward`.  q: (B, Hq, S, D),
// k and v: (B, Hkv, S, D), all fp32 or all bf16, Hq a multiple of Hkv
// (query head h reads kv head h / (Hq / Hkv)).  Keys are masked by index,
// as the TPU kernel masks them (its causal mode, the only one a caller
// uses): key j is seen by query i when j <= i and j > i - window
// (window > 0).  The output is
// acc / max(l, 1e-20) in q's dtype, with the scores, the softmax and the
// sums in fp32.
//
// What bounds it on an H100: the fp32 operations.  Every unmasked
// (query, key) pair costs 4 * D flops (Q.K and P.V); at recurrentgemma-2b's
// prefill (10 query heads, D 256, a 2032-token prompt) that is 21 GFLOP
// against 46 MB of q, k, v and output, about 460 flops a byte: at the
// 67 TFLOP/s of the fp32 cores the arithmetic takes 23 times longer than
// the bytes.  The kernel keeps fp32 for the products to hold the reference's
// fp32 tolerance (TF32 tensor cores would keep 10 bits of mantissa).
//
// What the design does about it: one block per (q tile of 32 rows, query
// head, batch row), 8 warps, 4 query rows a warp.  The block's Q tile and
// one K and one V tile of 32 keys at a time sit in shared memory (fp32, K
// rows padded by 4 floats so that the lanes' 16-byte loads of 32 different
// key rows fall in different banks); the walk covers only the key tiles
// that hold an unmasked key for some row of the block (from the window's
// first key to the causal diagonal), so the masked triangle costs nothing.
// Lane t scores key t against the warp's 4 rows (float4 loads, 16 FMAs per
// 5 shared loads); the online softmax (m, l) runs across the warp with
// shuffles; P.V broadcasts each probability from its lane and every lane
// accumulates 4 rows x 8 of the D dims in registers.  At D = 256 the tiles
// take 97 KB of shared memory, over the 48 KB default, so the launch opts
// in with cudaFuncSetAttribute (a block may use up to 227 KB).  Not done
// yet: tensor-core (wgmma) products, TMA/cp.async double buffering of the
// K/V tiles, and splitting long key ranges over several blocks.
//
// The file includes no PyTorch header: it exposes a plain C interface that
// the Python wrapper calls through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows a block
constexpr int kBK = kWarp;                  // keys a tile: lane t scores key t
constexpr int kMaxD = 256;
constexpr int kDimsPerLane = kMaxD / kWarp;
constexpr int kKPad = 4;                    // floats of padding per K row

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t shared_bytes(int d) {
  // Q tile (kBQ, D) + K tile (kBK, D + kKPad) + V tile (kBK, D)
  return sizeof(float) * (static_cast<size_t>(kBQ) * d + static_cast<size_t>(kBK) * (d + kKPad) +
                          static_cast<size_t>(kBK) * d);
}

struct Args {
  const void* q;  // (B, Hq, S, D)
  const void* k;  // (B, Hkv, S, D)
  const void* v;
  void* out;      // (B, Hq, S, D) in q's dtype
  int hq, hkv, s, d, window;
  float scale;
};

// grid (ceil(S / kBQ), Hq, B); block kThreads threads; warp w owns query
// rows q0 + 4w .. q0 + 4w + 3 of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) flash_attention_kernel(Args a) {
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int w = tid / kWarp;
  const int S = a.s, D = a.d;
  const int kstride = D + kKPad;

  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBQ * D;
  float* v_s = k_s + kBK * kstride;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  const size_t q_rows = (static_cast<size_t>(bi) * a.hq + h) * S;  // first row of (b, h)
  const size_t k_rows = (static_cast<size_t>(bi) * a.hkv + hk) * S;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int row = q0 + r;
    q_s[i] = row < S ? to_float(q[(q_rows + row) * D + (i - r * D)]) : 0.f;
  }

  // the key tiles that hold an unmasked key for some row of this block
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_lo = a.window ? max(0, q0 - a.window + 1) : 0;

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int kt = k_lo / kBK; kt <= q_last / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tiles are consumed (and the Q tile is in place)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int t = i / D;
      const int dd = i - t * D;
      const int key = k0 + t;
      float kv = 0.f, vv = 0.f;
      if (key < S) {
        kv = to_float(k[(k_rows + key) * D + dd]);
        vv = to_float(v[(k_rows + key) * D + dd]);
      }
      k_s[t * kstride + dd] = kv;
      v_s[t * D + dd] = vv;
    }
    __syncthreads();

    // scores: lane t takes key k0 + t against the warp's 4 rows
    float sc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = 0.f;
    const float* kr = k_s + lane * kstride;
    const float* qr = q_s + w * kRowsPerWarp * D;
    for (int dd = 0; dd < D; dd += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + dd);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qr + r * D + dd);
        sc[r] = fmaf(qq.x, kk.x, sc[r]);
        sc[r] = fmaf(qq.y, kk.y, sc[r]);
        sc[r] = fmaf(qq.z, kk.z, sc[r]);
        sc[r] = fmaf(qq.w, kk.w, sc[r]);
      }
    }

    // online softmax over this tile, row by row across the warp
    const int key = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + w * kRowsPerWarp + r;
      const bool valid = key <= row && (a.window == 0 || key > row - a.window);
      const float s = valid ? sc[r] * a.scale : kNegInf;
      const float m_new = fmaxf(m_run[r], warp_max(s));
      const float corr = expf(m_run[r] - m_new);
      p[r] = expf(s - m_new);  // a masked key gives 0 once a row has seen a real one
      l_run[r] = l_run[r] * corr + warp_sum(p[r]);
      m_run[r] = m_new;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] *= corr;
    }

    // P.V: lane owns dims lane, lane + 32, ... of the warp's 4 rows
    for (int t = 0; t < kBK; ++t) {
      float pt[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pt[r] = __shfl_sync(0xffffffffu, p[r], t);
      const float* vr = v_s + t * D;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int dd = lane + i * kWarp;
        if (dd < D) {
          const float vv = vr[dd];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][i] = fmaf(pt[r], vv, acc[r][i]);
        }
      }
    }
  }

  // normalise and store in q's dtype
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + w * kRowsPerWarp + r;
    if (row >= S) continue;
    const float denom = fmaxf(l_run[r], 1e-20f);
    T* o = out + (q_rows + row) * D;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int dd = lane + i * kWarp;
      if (dd < D) o[dd] = from_float<T>(acc[r][i] / denom);
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const size_t smem = shared_bytes(a.d);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.hq, b);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 fp32, 1 bf16 (q, k, v and out alike).  Needs d % 4 == 0, d <= 256.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention(int kind, const void* q, const void* k, const void* v,
                                     void* out, int b, int hq, int hkv, int s, int d, int window,
                                     float scale, void* stream) {
  if (d % 4 != 0 || d > kMaxD || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out, hq, hkv, s, d, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) return launch<float>(a, b, st);
  if (kind == 1) return launch<__nv_bfloat16>(a, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" size_t repro_flash_attention_shared_bytes(int d) { return shared_bytes(d); }

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
