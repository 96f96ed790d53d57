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
// and written once and gets three flops.  At the serving paths' shapes a
// join of 2000-2032 rows moves 12-42 MB (bound 4-12 us); a decode call of 8
// rows moves 50-160 KB, far below what one launch and one trip to device
// memory take, so a decode call is bound by latency: the launch, then the
// row's loads, the reduction, the stores.
//
// What the design does about it:
// * Each row is read once.  A thread loads its share of the row in 16-byte
//   vectors (4 fp32 or 8 bf16; scalars only where D is not a multiple of the
//   vector width or a pointer is not 16-byte aligned) into registers, with
//   its share of the scale, all loads issued before the first use, so a row
//   costs one memory round trip; the same registers are scaled and stored.
//   A thread holds at most 32 elements (8 fp32 or 4 bf16 vectors), so x and
//   an fp32 scale fit in registers without spills.
// * A row is one CTA of the fewest warps that hold it (1-3 at the paths'
//   widths), reduced by a shuffle in each warp and one shared-memory step
//   across warps, the warps added in order.  Packing 2-8 rows into a CTA,
//   as a draft of this kernel did, was measured on an H100 no faster at any
//   path shape and slower at some.
// * A row too wide for one CTA (more than 512 threads x 32 elements) is cut
//   over a thread block cluster of 2-8 CTAs.  Each CTA reduces its slice;
//   the partial sums of squares are exchanged through distributed shared
//   memory (`map_shared_rank`) and every CTA adds them in rank order, so
//   all CTAs, and every launch, get the same bits.  Splitting the decode
//   step's short rows this way was measured slower on an H100 (the two
//   cluster barriers cost more than the extra SMs' loads save; chip_smoke.py
//   logs the comparison), so the paths' rows never take it.
// The plan (vector width, vectors a thread, threads a CTA, cluster size) is
// a function of the shapes alone, chosen by the Python wrapper
// (`repro_torch.kernels.rmsnorm.plan`) and checked here.
//
// `repro_empty` launches an empty kernel: the launch floor under the
// launch-bound rows, timed by chip_smoke.py with the same harness.
//
// The file includes no PyTorch header: it exposes a plain C interface that
// the Python wrapper calls through ctypes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 512;  // threads a CTA
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kMaxElems = 32;     // elements a thread holds (x and an fp32 scale, no spills)

template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Vec {
  T v[N];
};

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

// xor butterfly: every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (rows * cluster); block T threads.  Row r's vectors are cut into
// `cluster` contiguous slices, one a CTA of the cluster; thread t of CTA c
// holds vectors c * span + t + k * T, k < VPT.
template <typename XT, typename ST, int VEC, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const XT* __restrict__ x, const ST* __restrict__ scale,
                   XT* __restrict__ out, int d, int cluster, float eps) {
  using XV = Vec<XT, VEC>;
  using SV = Vec<ST, VEC>;
  __shared__ float warp_part[kMaxThreads / kWarp];
  __shared__ float cta_part;  // this CTA's share of its row's sum, read by the cluster

  const int nvec = d / VEC;
  const int rank = blockIdx.x % cluster;  // the block's rank in its 1-D cluster
  const size_t row = blockIdx.x / cluster;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int span = (nvec + cluster - 1) / cluster;
  const int lo = rank * span;
  const int hi = min(lo + span, nvec);
  const XV* xr = reinterpret_cast<const XV*>(x + row * d);
  const SV* sr = reinterpret_cast<const SV*>(scale);

  XV held[VPT];
  SV sc[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {  // every load in flight before the first use
    const int v = lo + t + k * T;
    if (v < hi) {
      held[k] = xr[v];
      sc[k] = sr[v];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (lo + t + k * T < hi) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_float(held[k].v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  }

  ss = warp_sum(ss);
  const int warps = T / kWarp;
  if (warps > 1) {
    if (t % kWarp == 0) warp_part[t / kWarp] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < warps; ++w) ss += warp_part[w];
  }
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    if (t == 0) cta_part = ss;
    cl.sync();
    float total = 0.f;
    for (int r = 0; r < cluster; ++r) total += *cl.map_shared_rank(&cta_part, r);
    cl.sync();  // no CTA leaves while another still reads its part
    ss = total;
  }

  const float inv = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
  XV* orow = reinterpret_cast<XV*>(out + row * d);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = lo + t + k * T;
    if (v < hi) {
      XV o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = from_float<XT>(to_float(held[k].v[e]) * inv * to_float(sc[k].v[e]));
      orow[v] = o;
    }
  }
}

template <typename XT, typename ST, int VEC, int VPT>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
                   int threads, int cluster, cudaStream_t stream) {
  if constexpr (VEC * VPT > kMaxElems) {
    return cudaErrorInvalidValue;  // not built: more than a thread holds
  } else {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(rows) * cluster);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = 0;
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = cluster > 1 ? 1 : 0;  // no cluster attribute for a one-CTA row
    const cudaError_t e = cudaLaunchKernelEx(
        &config, rmsnorm_kernel<XT, ST, VEC, VPT>, static_cast<const XT*>(x),
        static_cast<const ST*>(scale), static_cast<XT*>(out), d, cluster, eps);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
}

template <typename XT, typename ST, int VEC>
cudaError_t by_vpt(int vpt, const void* x, const void* scale, void* out, int rows, int d,
                   float eps, int threads, int cluster, cudaStream_t s) {
  switch (vpt) {
    case 1: return launch<XT, ST, VEC, 1>(x, scale, out, rows, d, eps, threads, cluster, s);
    case 2: return launch<XT, ST, VEC, 2>(x, scale, out, rows, d, eps, threads, cluster, s);
    case 4: return launch<XT, ST, VEC, 4>(x, scale, out, rows, d, eps, threads, cluster, s);
    case 8: return launch<XT, ST, VEC, 8>(x, scale, out, rows, d, eps, threads, cluster, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename XT, typename ST>
cudaError_t by_vec(int vec, int vpt, const void* x, const void* scale, void* out, int rows,
                   int d, float eps, int threads, int cluster, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(XT);  // one 16-byte load of x
  if (vec == kVec)
    return by_vpt<XT, ST, kVec>(vpt, x, scale, out, rows, d, eps, threads, cluster, s);
  if (vec == 1) return by_vpt<XT, ST, 1>(vpt, x, scale, out, rows, d, eps, threads, cluster, s);
  return cudaErrorInvalidValue;
}

__global__ void empty_kernel() {}

}  // namespace

// x_kind / scale_kind: 0 fp32, 1 bf16.  x and out (rows, d), scale (d,).
// The plan: vec elements a load (16 bytes of x, or 1), vpt loads a thread
// (1, 2, 4 or 8; vec * vpt at most 32), threads a CTA (a multiple of 32),
// cluster CTAs a row (1, 2, 4 or 8).  Launches on `stream` and returns the
// launch's cudaError_t (0 on success).
extern "C" int repro_rmsnorm(int x_kind, int scale_kind, const void* x, const void* scale,
                             void* out, int rows, int d, float eps, int vec, int vpt,
                             int threads, int cluster, void* stream) {
  const bool shape_ok = rows > 0 && d > 0 && vec > 0 && d % vec == 0 && threads > 0 &&
                        threads % kWarp == 0 && threads <= kMaxThreads && cluster > 0 &&
                        cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0 &&
                        static_cast<long long>(rows) * cluster < (1LL << 31) &&
                        static_cast<long long>(cluster) * threads * vpt * vec >= d;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_kind == 0 && scale_kind == 0)
    return by_vec<float, float>(vec, vpt, x, scale, out, rows, d, eps, threads, cluster, s);
  if (x_kind == 0 && scale_kind == 1)
    return by_vec<float, bf16>(vec, vpt, x, scale, out, rows, d, eps, threads, cluster, s);
  if (x_kind == 1 && scale_kind == 0)
    return by_vec<bf16, float>(vec, vpt, x, scale, out, rows, d, eps, threads, cluster, s);
  if (x_kind == 1 && scale_kind == 1)
    return by_vec<bf16, bf16>(vec, vpt, x, scale, out, rows, d, eps, threads, cluster, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// An empty kernel of one warp: the launch floor.
extern "C" int repro_empty(void* stream) {
  empty_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
