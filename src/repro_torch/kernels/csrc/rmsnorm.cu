// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `rmsnorm_pallas` (src/repro/kernels/rmsnorm.py),
// which the reference holds to `layers.apply_norm` (rmsnorm branch).  For
// each row of x (rows, D):
//   ms  = mean(x^2) in fp32
//   out = (x * rsqrt(ms + eps) * scale) cast back to x's dtype
// with x fp32 or bf16 and scale fp32 or bf16 (the parameter dtype).
//
// What bounds it on an H100: the bytes, at 3.35 TB/s: each element is read
// and written once and gets three flops.  At the serving path's shapes
// (8 decode rows, or one prompt's 2032 rows, of 2560 fp32) a call moves
// 0.16 MB to 42 MB, so the small calls are bound by the launch, not by the card.
//
// What the design does about it: one block per row, so a row's statistic
// never leaves the block: every thread folds a strided slice of the row
// into an fp32 sum of squares (neighbouring threads on neighbouring
// addresses), a warp shuffle and one pass through shared memory reduce it,
// and the same threads then write the scaled row.  The second read of the
// row hits the cache, not device memory.  Not done yet: vector loads, and
// several rows a block for the short decode calls.
//
// The file includes no PyTorch header: it exposes a plain C interface that
// the Python wrapper calls through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (rows); block kThreads threads.
template <typename XT, typename ST>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const XT* __restrict__ x, const ST* __restrict__ scale,
                   XT* __restrict__ out, int d, float eps) {
  __shared__ float partial[kThreads / kWarp];
  const size_t row = blockIdx.x;
  const XT* xr = x + row * d;
  XT* orow = out + row * d;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;

  float ss = 0.f;
  for (int i = tid; i < d; i += kThreads) {
    const float v = to_float(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / kWarp ? partial[lane] : 0.f;
    ss = warp_sum(ss);
    if (lane == 0) partial[0] = ss;
  }
  __syncthreads();
  const float r = 1.0f / sqrtf(partial[0] / static_cast<float>(d) + eps);
  for (int i = tid; i < d; i += kThreads)
    orow[i] = from_float<XT>(to_float(xr[i]) * r * to_float(scale[i]));
}

template <typename XT, typename ST>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
                   cudaStream_t stream) {
  rmsnorm_kernel<XT, ST><<<rows, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const ST*>(scale), static_cast<XT*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace

// x_kind / scale_kind: 0 fp32, 1 bf16.  x and out (rows, d), scale (d,).
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int repro_rmsnorm(int x_kind, int scale_kind, const void* x, const void* scale,
                             void* out, int rows, int d, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 0 && scale_kind == 0) return launch<float, float>(x, scale, out, rows, d, eps, s);
  if (x_kind == 0 && scale_kind == 1)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  if (x_kind == 1 && scale_kind == 0)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, s);
  if (x_kind == 1 && scale_kind == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
