// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t.
//
// Replaces the TPU kernel `rglru_scan_pallas` (src/repro/kernels/rglru_scan.py),
// which the reference holds to `rglru.linear_scan`.  a, b: (B, S, W) fp32;
// h0: (B, W) fp32 or absent (zeros); out h: (B, S, W) fp32.  The serving
// prefill takes the final state as h[:, S-1].
//
// What bounds it on an H100: the bytes, at 3.35 TB/s: a and b are read and
// h is written once, 12 bytes per element against two flops.  At one
// prompt of 2032 positions over the 2560 lanes of recurrentgemma-2b that is
// 62 MB, about 19 us.
//
// What the design does about it: the recurrence is elementwise over the
// width lanes and sequential in time, so one thread owns one (batch, lane)
// pair and steps time with the carry in a register; neighbouring threads
// take neighbouring lanes, so every load and store of a warp is one
// coalesced 128-byte row.  The loads of a and b do not depend on the carry:
// each thread issues a batch of kUnroll time steps' loads before it folds
// them, so kUnroll rows are in flight per thread instead of one.  The
// TPU kernel's chunked time grid with its VMEM carry becomes this in-thread
// loop.  Not done yet: B * W threads are few (2560 at one prompt, 80 warps
// on 132 SMs), so the kernel waits on memory latency; a two-pass scan over
// time chunks would give the card more parallel work.
//
// The file includes no PyTorch header: it exposes a plain C interface that
// the Python wrapper calls through ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kUnroll = 16;

// grid (ceil(W / kThreads), B); thread = one width lane of one batch row.
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h, int s, int w) {
  const int lane_w = blockIdx.x * kThreads + threadIdx.x;
  if (lane_w >= w) return;
  const size_t bi = blockIdx.y;
  const size_t base = bi * static_cast<size_t>(s) * w + lane_w;
  const size_t step = static_cast<size_t>(w);
  float carry = h0 ? h0[bi * w + lane_w] : 0.f;

  int t = 0;
  for (; t + kUnroll <= s; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
    const size_t row = base + static_cast<size_t>(t) * step;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = a[row + u * step];
      bv[u] = b[row + u * step];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = fmaf(av[u], carry, bv[u]);
      h[row + u * step] = carry;
    }
  }
  for (; t < s; ++t) {
    const size_t row = base + static_cast<size_t>(t) * step;
    carry = fmaf(a[row], carry, b[row]);
    h[row] = carry;
  }
}

}  // namespace

// a, b, h: (batch, s, w) fp32; h0: (batch, w) fp32 or null for a zero state.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int repro_rglru_scan(const float* a, const float* b, const float* h0, float* h,
                                int batch, int s, int w, void* stream) {
  const dim3 grid((w + kThreads - 1) / kThreads, batch);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, h0, h, s, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
