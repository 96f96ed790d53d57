// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) b_t ;  y_t = h_t c_t
//
// Replaces the TPU kernel `ssd_pallas` (src/repro/kernels/ssd.py), which the
// reference holds to `ssm.ssd_chunked`.  It computes `ssd_chunked` whole:
// y and the final state, from an initial state or zeros.  x: (B, S, H, P)
// fp32 or bf16; dt: (B, S, H) fp32 (post-softplus); a_log: (H,) fp32 (the
// negative A); b, c: (B, S, N) in x's dtype, one group shared by every head;
// init and the final state: (B, H, P, N) fp32; y: (B, S, H, P) in x's dtype.
//
// Per chunk of Q rows (positions past S count as dt = 0, x = b = c = 0, so
// they move neither y nor the state, and the final state is the one at S-1):
//   cs   = inclusive cumsum of dt * a over the chunk
//   y_i  = sum_{j<=i} (c_i . b_j) exp(cs_i - cs_j) dt_j x_j  +  exp(cs_i) c_i . S
//   S   <- exp(cs_{Q-1}) S + sum_j exp(cs_{Q-1} - cs_j) dt_j x_j (x) b_j
//
// What bounds it on an H100: the operations.  At mamba2-130m's prefill
// (H 24, P 64, N 128, Q 128) a chunk of one head takes about 3.7 M
// multiply-adds for 64 KB of x and y, some 110 flops a byte, above the ~20
// at which the fp32 CUDA cores (67 TFLOP/s) balance the memory.
//
// What the design does about it: the TPU kernel's grid (B*H, chunks), with
// the chunk axis sequential and the state in VMEM, becomes one block per
// (batch, head) that walks its chunks in a loop and keeps the (N, P) state
// in shared memory; blocks share nothing.  b and c are read by batch, never
// repeated per head as the TPU wrapper materialises them.  The (Q, Q)
// C.B^T tile does not fit beside the b, c, x.dt and state tiles at Q = N =
// 128 (264,192 bytes against the 232,448 a block may have), so it is never
// held: each warp takes 4 rows of the chunk at a time, lane t scores key row t
// against the 4 rows (float4 loads; b rows padded by 4 floats so that the
// 16-byte loads of 32 rows fall in different banks), keeps only the
// causal entries times their decay in a per-warp row buffer, then folds
// them into the rows' outputs with x.dt.  Masked (j > i) entries are never
// formed, so they contribute exactly 0, as the reference's exp(NEG_INF).
// Row groups go to warps in a snake order so that the causal triangle's
// work is even.  The state update gives each thread 32 (n, p) entries in
// registers.  Sums are fp32.  Not done yet: with one prompt only B*H blocks
// run (24 on 132 SMs); computing every chunk's local state in parallel and
// combining them in a short second pass, and tensor-core products, are the
// levers.
//
// The file includes no PyTorch header: it exposes a plain C interface that
// the Python wrapper calls through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;       // chunk rows a warp takes at once
constexpr int kMaxState = 32;  // state entries a thread owns: N * P <= 8192
constexpr int kMaxQ = 128;     // the cumsum gives each lane of one warp 4 rows

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

// Offsets, in floats, into the dynamic shared memory; all multiples of 4.
struct Layout {
  int qp;   // chunk rows rounded up to kRows
  int ns;   // row stride of the b tile: N + 4
  size_t b, c, xdt, st, cs, w, total;
};

__host__ __device__ inline Layout layout(int q, int n, int p) {
  Layout l;
  l.qp = (q + kRows - 1) / kRows * kRows;
  l.ns = n + 4;
  l.b = 0;                                             // (qp, N + 4)
  l.c = l.b + static_cast<size_t>(l.qp) * l.ns;        // (qp, N)
  l.xdt = l.c + static_cast<size_t>(l.qp) * n;         // (qp, P): x * dt
  l.st = l.xdt + static_cast<size_t>(l.qp) * p;        // (N, P): the carried state
  l.cs = l.st + static_cast<size_t>(n) * p;            // 4 x qp: cs, exp(cs), sdec, dt
  l.w = l.cs + 4 * static_cast<size_t>(l.qp);          // kWarps x kRows x qp
  l.total = l.w + static_cast<size_t>(kWarps) * kRows * l.qp;
  return l;
}

template <typename T>
struct Args {
  const T* x;
  const float* dt;
  const float* a_log;
  const T* b;
  const T* c;
  const float* init;  // may be null: zeros
  T* y;
  float* state;
  int bsz, s, h, p, n, q;
};

// grid (B * H); block kThreads.  PL = p-slots a lane holds: P <= 32 PL.
template <typename T, int PL>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args<T> a) {
  const int bh = blockIdx.x;
  const int bb = bh / a.h;
  const int h = bh % a.h;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int S = a.s, H = a.h, P = a.p, N = a.n, Q = a.q;
  const Layout L = layout(Q, N, P);

  extern __shared__ __align__(16) float smem[];
  float* b_s = smem + L.b;
  float* c_s = smem + L.c;
  float* xdt_s = smem + L.xdt;
  float* st_s = smem + L.st;
  float* cs_s = smem + L.cs;
  float* ecs_s = cs_s + L.qp;
  float* sdec_s = ecs_s + L.qp;
  float* dt_s = sdec_s + L.qp;
  float* w_s = smem + L.w + static_cast<size_t>(warp) * kRows * L.qp;

  const float a_h = a.a_log[h];
  const size_t st_base = static_cast<size_t>(bh) * P * N;

  // the initial state, (P, N) in device memory, (N, P) here
  for (int e = tid; e < N * P; e += kThreads) {
    const int p = e / N, n = e % N;
    st_s[n * P + p] = a.init ? a.init[st_base + e] : 0.f;
  }

  const int n_chunks = (S + Q - 1) / Q;
  const int n_groups = L.qp / kRows;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s0 = ci * Q;
    for (int j = tid; j < L.qp; j += kThreads) {
      const int s = s0 + j;
      dt_s[j] = (j < Q && s < S) ? a.dt[(static_cast<size_t>(bb) * S + s) * H + h] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < L.qp * N; e += kThreads) {
      const int j = e / N, n = e % N;
      const int s = s0 + j;
      const bool ok = j < Q && s < S;
      const size_t g = (static_cast<size_t>(bb) * S + s) * N + n;
      b_s[j * L.ns + n] = ok ? to_float(a.b[g]) : 0.f;
      c_s[j * N + n] = ok ? to_float(a.c[g]) : 0.f;
    }
    for (int e = tid; e < L.qp * P; e += kThreads) {
      const int j = e / P, p = e % P;
      const int s = s0 + j;
      const bool ok = j < Q && s < S;
      xdt_s[e] = ok ? to_float(a.x[((static_cast<size_t>(bb) * S + s) * H + h) * P + p]) *
                          dt_s[j]
                    : 0.f;
    }
    if (warp == 0) {
      // inclusive cumsum of dt * a: lane l sums its 4 consecutive rows, then
      // the warp scans the lanes' totals
      const int per = (L.qp + 31) / 32;
      float loc[kMaxQ / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxQ / 32; ++k) {
        const int j = lane * per + k;
        if (k < per && j < L.qp) run += dt_s[j] * a_h;
        loc[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < kMaxQ / 32; ++k) {
        const int j = lane * per + k;
        if (k < per && j < L.qp) cs_s[j] = excl + loc[k];
      }
    }
    __syncthreads();
    for (int j = tid; j < L.qp; j += kThreads) {
      ecs_s[j] = expf(cs_s[j]);
      sdec_s[j] = expf(cs_s[Q - 1] - cs_s[j]);
    }
    __syncthreads();

    // y, kRows rows at a time per warp, groups dealt in snake order
    for (int k = 0; k * kWarps < n_groups; ++k) {
      const int grp = k * kWarps + ((k & 1) ? kWarps - 1 - warp : warp);
      if (grp >= n_groups) continue;
      const int i0 = grp * kRows;
      const int jmax = min(i0 + kRows - 1, Q - 1);
      // w[r][j] = (c_i . b_j) exp(cs_i - cs_j) for j <= i = i0 + r, else 0
      for (int j = lane; j <= jmax; j += 32) {
        float dot[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) dot[r] = 0.f;
        const float4* bj = reinterpret_cast<const float4*>(b_s + j * L.ns);
        for (int n4 = 0; n4 < N / 4; ++n4) {
          const float4 bv = bj[n4];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 cv = reinterpret_cast<const float4*>(c_s + (i0 + r) * N)[n4];
            dot[r] += cv.x * bv.x + cv.y * bv.y + cv.z * bv.z + cv.w * bv.w;
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = i0 + r;
          w_s[r * L.qp + j] = (j <= i && i < Q) ? dot[r] * expf(cs_s[i] - cs_s[j]) : 0.f;
        }
      }
      __syncwarp();
      float intra[kRows][PL], inter[kRows][PL];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int kk = 0; kk < PL; ++kk) intra[r][kk] = inter[r][kk] = 0.f;
      const bool lane_ok = lane < P;  // P < 32: the upper lanes idle
      for (int j = 0; j <= jmax; ++j) {
        float xv[PL];
#pragma unroll
        for (int kk = 0; kk < PL; ++kk) xv[kk] = lane_ok ? xdt_s[j * P + lane + 32 * kk] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float wv = w_s[r * L.qp + j];
#pragma unroll
          for (int kk = 0; kk < PL; ++kk) intra[r][kk] += wv * xv[kk];
        }
      }
      for (int n = 0; n < N; ++n) {
        float sv[PL];
#pragma unroll
        for (int kk = 0; kk < PL; ++kk) sv[kk] = lane_ok ? st_s[n * P + lane + 32 * kk] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float cv = c_s[(i0 + r) * N + n];
#pragma unroll
          for (int kk = 0; kk < PL; ++kk) inter[r][kk] += cv * sv[kk];
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        const int s = s0 + i;
        if (lane_ok && i < Q && s < S) {
          T* yr = a.y + ((static_cast<size_t>(bb) * S + s) * H + h) * P;
#pragma unroll
          for (int kk = 0; kk < PL; ++kk)
            yr[lane + 32 * kk] = from_float<T>(intra[r][kk] + ecs_s[i] * inter[r][kk]);
        }
      }
      __syncwarp();  // the next group rewrites w
    }
    __syncthreads();  // every warp has read the state

    // S <- exp(cs_last) S + sum_j b_j sdec_j x_j dt_j; thread owns p = tid % P
    // and n = tid / P + k * (kThreads / P)
    {
      const int p = tid % P;
      const int n0 = tid / P;
      const int step = kThreads / P;
      const float decay = ecs_s[Q - 1];
      float acc[kMaxState];
#pragma unroll
      for (int k = 0; k < kMaxState; ++k) {
        const int n = n0 + k * step;
        acc[k] = n < N ? st_s[n * P + p] * decay : 0.f;
      }
      for (int j = 0; j < Q; ++j) {
        const float t = xdt_s[j * P + p] * sdec_s[j];
        const float* bj = b_s + j * L.ns;
#pragma unroll
        for (int k = 0; k < kMaxState; ++k) {
          const int n = n0 + k * step;
          if (n < N) acc[k] += bj[n] * t;
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxState; ++k) {
        const int n = n0 + k * step;
        if (n < N) st_s[n * P + p] = acc[k];
      }
    }
    __syncthreads();  // the next chunk rewrites the tiles
  }

  for (int e = tid; e < N * P; e += kThreads) {
    const int p = e / N, n = e % N;
    a.state[st_base + e] = st_s[n * P + p];
  }
}

template <typename T, int PL>
cudaError_t launch(const Args<T>& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, PL>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_kernel<T, PL><<<a.bsz * a.h, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = layout(a.q, a.n, a.p).total * sizeof(float);
  if (a.p <= 32) return launch<T, 1>(a, smem, stream);
  if (a.p <= 64) return launch<T, 2>(a, smem, stream);
  return launch<T, 4>(a, smem, stream);
}

}  // namespace

// kind: 0 fp32, 1 bf16 (x, b, c and y alike).  Needs P a power of two <= 128,
// N % 4 == 0, N * P <= 8192 and 1 <= q <= 128 (the wrapper checks).  init
// may be null.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int repro_ssd_scan(int kind, const void* x, const float* dt, const float* a_log,
                              const void* b, const void* c, const float* init, void* y,
                              float* state, int bsz, int s, int h, int p, int n, int q,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q < 1 || q > kMaxQ || p < 1 || p > 128 || n % 4 || n * p > kMaxState * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 0) {
    Args<float> a{static_cast<const float*>(x), dt, a_log, static_cast<const float*>(b),
                  static_cast<const float*>(c), init, static_cast<float*>(y), state,
                  bsz, s, h, p, n, q};
    return static_cast<int>(dispatch(a, st));
  }
  if (kind == 1) {
    Args<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(x), dt, a_log,
                          static_cast<const __nv_bfloat16*>(b),
                          static_cast<const __nv_bfloat16*>(c), init,
                          static_cast<__nv_bfloat16*>(y), state, bsz, s, h, p, n, q};
    return static_cast<int>(dispatch(a, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" size_t repro_ssd_shared_bytes(int q, int n, int p) {
  return layout(q, n, p).total * sizeof(float);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
