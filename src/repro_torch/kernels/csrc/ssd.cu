// Mamba-2 SSD chunked scan on Hopper tensor cores (sm_90a).
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
//   cs    = inclusive cumsum of dt * a over the chunk
//   L_c   = sum_j exp(cs_{Q-1} - cs_j) dt_j x_j (x) b_j       (chunk-local state)
//   S_c   = exp(cs_{Q-1}) S_{c-1} + L_c, from S_{-1} = init   (the carry)
//   y_i   = sum_{j<=i} (c_i . b_j) exp(cs_i - cs_j) dt_j x_j  +  exp(cs_i) c_i . S_{c-1}
//
// What bounds it on an H100: the operations.  At mamba2-130m's prefill
// (H 24, P 64, N 128, Q 128, S 2048) the function needs 2.05 GFLOP against
// 13 MB of inputs and outputs, some 160 flops a byte.
//
// What the design does about it: the decomposition that the plain
// `ssd_chunked` spells out, as up to four short kernels that the wrapper
// counts as one call, each parallel over chunks, heads and column tiles,
// with all products on the tensor cores.  fp32 operands take the 3xTF32
// split of mma.cuh (three TF32 `mma.sync` m16n8k8 per fp32 product, which
// holds the reference's fp32 SSD bar where one TF32 product does not);
// C.B^T of bf16 inputs takes one bf16 m16n8k16 mma.
//   (a0) ssd_cb_kernel, per (batch, chunk, 64 x 64 tile on or below the
//        diagonal): C.B^T once for every head, into a (B, nc, Q, Q) fp32
//        workspace; 8 warps of 16 x 32, those wholly above the diagonal idle.
//   (a)  ssd_state_kernel, per (batch, chunk, head, 32 of P, 64 of N): the
//        cumsum, then L_c = (x dt exp(cs_last - cs))^T . b, into a
//        (B, nc, H, P, N) fp32 workspace, and exp(cs_last) into (B, nc, H).
//        With one chunk it writes the final state, exp(cs_last) init + L.
//   (b)  ssd_carry_kernel, one thread per (batch, head, p, n) entry, only
//        with more than one chunk: walks the chunks in order and replaces
//        each L_c by S_{c-1}, the state that enters chunk c; writes the
//        final state.  Plain fp32 FMAs, in a fixed order (no atomics
//        anywhere, so a second launch gives the same bits).
//   (c)  ssd_output_kernel, per (batch, chunk, 64 rows, head, 32 of P): the
//        intra-chunk product (C.B^T o decay o dt) . x, with the causal
//        decay formed in registers as the A operand, plus exp(cs_i) c_i . S
//        (S the initial state, or zeros, with one chunk).
// At one 128-token prompt (H 24, P 64) kernel (c) runs 2 x 24 x 2 = 96
// blocks and kernel (a) 24 x 2 x 2 = 96; at S 2048, 16 times as many.
// Shared rows are padded so that a fragment load of 8 rows x 4 columns
// falls in 32 banks (strides of 4 mod 8 floats, or 8 mod 32 where the rows
// are the k index).  fp32 tiles arrive by `cp.async`, all of a block's
// copies in flight at once, since plain loads one at a time leave the
// blocks waiting on memory latency; bf16 tiles are widened to fp32 by plain
// loads, eight in flight a thread.
//
// The file includes no PyTorch header: it exposes a plain C interface that
// the Python wrapper calls through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kMaxQ = 128;     // the cumsum gives each lane of one warp 4 rows
constexpr int kRowTile = 64;   // chunk rows a block of (a0) and (c): 16 a warp
constexpr int kPTile = 32;     // P columns a block of (a) and (c)
constexpr int kNTile = 64;     // N columns a block of (a)
constexpr int kXS = kPTile + 8;  // shared row stride of the (j, p) tiles
constexpr int kBS = kNTile + 8;  // shared row stride of the (j, n) tile of (a)

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

// Programmatic dependent launch (sm_90): kernels (a), (b) and (c) are
// launched so that they may start while their predecessor on the stream
// still runs, and wait in griddepcontrol.wait where they need its output
// (and the predecessor's own prerequisites, which it waited for).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Shapes and the padded sizes every kernel derives from them.
struct Geo {
  int bsz, s, h, p, n, q;
  int nc;   // chunks
  int qp;   // chunk rows rounded up to 8 (the k step of a TF32 mma)
  int np;   // N rounded up to 16 (the k step of a bf16 mma)
  int rt;   // 64-row tiles of a chunk
  int pt;   // 32-column tiles of P
  int nt;   // 64-column tiles of N
};

inline Geo geo(int bsz, int s, int h, int p, int n, int q) {
  Geo g{bsz, s, h, p, n, q};
  g.nc = (s + q - 1) / q;
  g.qp = (q + 7) / 8 * 8;
  g.np = (n + 15) / 16 * 16;
  g.rt = (q + kRowTile - 1) / kRowTile;
  g.pt = (p + kPTile - 1) / kPTile;
  g.nt = (g.np + kNTile - 1) / kNTile;
  return g;
}

template <typename T>
__host__ __device__ constexpr int cb_stride(int np) {
  return np + (std::is_same<T, float>::value ? 4 : 8);
}

template <typename T>
size_t cb_smem(const Geo& g) { return 2 * kRowTile * cb_stride<T>(g.np) * sizeof(T); }
size_t state_smem(const Geo& g) {
  return sizeof(float) * (2 * g.qp + g.qp * kXS + g.qp * kBS);
}
size_t out_smem(const Geo& g) {
  return sizeof(float) * (2 * g.qp + kRowTile * (g.qp + 4) + g.qp * kXS + kRowTile * (g.np + 4) +
                          kPTile * (g.np + 4));
}

struct Ptrs {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  const float* init;  // may be null: zeros
  void* y;
  float* state;
  float* cb;   // workspace (B, nc, Q, Q)
  float* st;   // workspace (B, nc, H, P, N): L_c, then S_{c-1}
  float* dec;  // workspace (B, nc, H): exp(cs_last)
};

// Warp 0: cs[j] = inclusive cumsum over the chunk's rows of dt_j * a (rows
// past the chunk or past S count dt = 0), j < qp.  Lane l sums its `per`
// consecutive rows, then the warp scans the lanes' totals.  Kernels (a) and
// (c) call it on the same inputs and get the same bits.
__device__ void chunk_cumsum(float* cs, const float* dt, const Geo& g, int bb, int c, int h,
                             float a_h, int lane) {
  const int per = (g.qp + 31) / 32;
  const int s0 = c * g.q;
  float loc[kMaxQ / 32];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    const int j = lane * per + k;
    if (k < per && j < g.qp) {
      const int s = s0 + j;
      const float d = (j < g.q && s < g.s) ? dt[(static_cast<size_t>(bb) * g.s + s) * g.h + h]
                                           : 0.f;
      run += d * a_h;
    }
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
    if (k < per && j < g.qp) cs[j] = excl + loc[k];
  }
}

// rows x cols of a row-major source (row r at src + r * ld) into shared fp32
// dst (row stride ds, a multiple of 4), zeros past vr rows / vc columns.  fp32
// sources go by cp.async (16 bytes a copy where the rows allow it, else 4),
// bf16 ones by plain loads, eight in flight a thread, widened on the way, so
// a block's loads overlap instead of waiting one by one.  The caller
// commits, waits and syncs.
template <typename T>
__device__ void load_tile(float* dst, int ds, const T* src, size_t ld, int rows, int cols, int vr,
                          int vc) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
    if (cols % 4 == 0 && vc % 4 == 0 && ld % 4 == 0 &&
        (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int chunks = cols / 4;
      for (int i = tid; i < rows * chunks; i += kThreads) {
        const int r = i / chunks, c = (i - r * chunks) * 4;
        const bool ok = r < vr && c < vc;
        mma::cp_async<16>(dst + r * ds + c, ok ? src + r * ld + c : src, ok);
      }
    } else {
      for (int i = tid; i < rows * cols; i += kThreads) {
        const int r = i / cols, c = i - r * cols;
        const bool ok = r < vr && c < vc;
        mma::cp_async<4>(dst + r * ds + c, ok ? src + r * ld + c : src, ok);
      }
    }
  } else {
    constexpr int kAhead = 8;
    const int total = rows * cols;
    for (int base = tid; base < total; base += kThreads * kAhead) {
      float v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int i = base + u * kThreads, r = i / cols, c = i - r * cols;
        v[u] = (i < total && r < vr && c < vc) ? to_float(src[r * ld + c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int i = base + u * kThreads;
        if (i < total) dst[(i / cols) * ds + i % cols] = v[u];
      }
    }
  }
}

// (a0) grid (nc * rt * rt, B): C.B^T for one 64 x 64 tile of one chunk;
// tiles wholly above the diagonal are never read and not computed.  Warp
// w: rows 16 (w % 4) .., columns 32 (w / 4) ...
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_cb_kernel(Geo g, Ptrs a) {
  launch_dependents();  // (a) needs nothing from here
  const int tiles = g.rt * g.rt;
  const int c = blockIdx.x / tiles;
  const int ri = (blockIdx.x % tiles) / g.rt;
  const int cj = blockIdx.x % g.rt;
  if (cj > ri) return;
  const int bb = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int i0 = ri * kRowTile, j0 = cj * kRowTile;
  const int st = cb_stride<T>(g.np);

  extern __shared__ float4 smem4[];
  T* c_s = reinterpret_cast<T*>(smem4);
  T* b_s = c_s + kRowTile * st;
  // rows i0.. of C and j0.. of B, 4 elements a copy (N % 4 == 0)
  const T* cg = static_cast<const T*>(a.c) + (static_cast<size_t>(bb) * g.s + c * g.q) * g.n;
  const T* bg = static_cast<const T*>(a.b) + (static_cast<size_t>(bb) * g.s + c * g.q) * g.n;
  const int rows_left = min(g.q, g.s - c * g.q);  // rows of this chunk that exist
  const int chunks = g.np / 4;
  for (int e = tid; e < 2 * kRowTile * chunks; e += kThreads) {
    const int half = e / (kRowTile * chunks);
    const int r = (e / chunks) % kRowTile, n = (e % chunks) * 4;
    const int row = (half ? j0 : i0) + r;
    const bool ok = row < rows_left && n < g.n;
    const T* src = (half ? bg : cg) + (ok ? static_cast<size_t>(row) * g.n + n : 0);
    mma::cp_async<4 * sizeof(T)>((half ? b_s : c_s) + r * st + n, src, ok);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  const int wr = 16 * (w % 4), wc = 32 * (w / 4);
  if (i0 + wr >= g.q || j0 + wc > i0 + wr + 15) return;  // no row, or above the diagonal

  float acc[4][4] = {};
  if constexpr (std::is_same<T, float>::value)
    mma::mma3_strided<4>(acc, c_s + wr * st, st, 1, b_s + wc * st, 1, st, g.np / 8, lane);
  else
    mma::bf16_rows<4>(acc, c_s + wr * st, st, b_s + wc * st, st, g.np / 16, lane);

  const int gq = lane >> 2, tq = lane & 3;
  float* out = a.cb + (static_cast<size_t>(bb) * g.nc + c) * g.q * g.q;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + wr + gq + 8 * (e >> 1);
      const int j = j0 + wc + 8 * nt + 2 * tq + (e & 1);
      if (i < g.q && j < g.q) out[static_cast<size_t>(i) * g.q + j] = acc[nt][e];
    }
  }
}

// (a) grid (nc * H, pt * nt, B): the chunk-local state of one head, 32 of P
// by 64 of N.  Warp w: p rows 16 (w & 1) .., n columns 16 (w >> 1) ...
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(Geo g, Ptrs a) {
  launch_dependents();
  const int c = blockIdx.x / g.h, h = blockIdx.x % g.h;
  const int p0 = (blockIdx.y % g.pt) * kPTile, n0 = (blockIdx.y / g.pt) * kNTile;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int s0 = c * g.q;
  const int rows = min(g.q, g.s - s0);  // rows of this chunk that exist

  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  float* wj = cs + g.qp;        // (qp): dt_j exp(cs_last - cs_j)
  float* xt = wj + g.qp;        // (qp, kXS): x
  float* bt = xt + g.qp * kXS;  // (qp, kBS): b

  const size_t row0 = static_cast<size_t>(bb) * g.s + s0;
  load_tile(xt, kXS, static_cast<const T*>(a.x) + (row0 * g.h + h) * g.p + p0,
            static_cast<size_t>(g.h) * g.p, g.qp, kPTile, rows, min(kPTile, g.p - p0));
  load_tile(bt, kBS, static_cast<const T*>(a.b) + row0 * g.n + n0, g.n, g.qp, kNTile, rows,
            min(kNTile, g.n - n0));
  mma::cp_async_commit();
  if (w == 0) chunk_cumsum(cs, a.dt, g, bb, c, h, a.a_log[h], lane);
  __syncthreads();
  const float cs_last = cs[g.q - 1];
  for (int j = tid; j < g.qp; j += kThreads)
    wj[j] = j < rows ? a.dt[(row0 + j) * g.h + h] * expf(cs_last - cs[j]) : 0.f;
  mma::cp_async_wait<0>();
  __syncthreads();

  // L(p, n) = sum_j x[j][p] w_j b[j][n]
  const int pw = 16 * (w & 1), nw = 16 * (w >> 1);
  float acc[2][4] = {};
  mma::mma3_strided<2>(acc, xt + pw, 1, kXS, bt + nw, kBS, 1, g.qp / 8, lane, wj);
  // With one chunk the state leaves here, exp(cs_last) init + L in the
  // carry's order, and (b) is not launched; else L goes to the workspace.
  const int gq = lane >> 2, tq = lane & 3;
  const bool one = g.nc == 1;
  const float decay = expf(cs_last);
  const size_t slice = (static_cast<size_t>(bb) * g.h + h) * g.p * g.n;  // (b, h) of (B, H, P, N)
  float* out = one ? a.state + slice
                   : a.st + ((static_cast<size_t>(bb) * g.nc + c) * g.h + h) * g.p * g.n;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + pw + gq + 8 * (e >> 1);
      const int n = n0 + nw + 8 * nt + 2 * tq + (e & 1);
      if (p < g.p && n < g.n) {
        const size_t idx = static_cast<size_t>(p) * g.n + n;
        out[idx] = (one && a.init) ? a.init[slice + idx] * decay + acc[nt][e] : acc[nt][e];
      }
    }
  }
  if (blockIdx.y == 0 && tid == 0)
    a.dec[(static_cast<size_t>(bb) * g.nc + c) * g.h + h] = decay;
  wait_prerequisites();  // end after (a0), so that (c) waiting on this grid also waits on it
}

// (b) one thread per (b, h, p, n): the carry over the chunks, in order.
__global__ void __launch_bounds__(kThreads) ssd_carry_kernel(Geo g, Ptrs a) {
  const size_t pn = static_cast<size_t>(g.p) * g.n;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  launch_dependents();
  wait_prerequisites();  // the chunk-local states of (a)
  if (e >= static_cast<size_t>(g.bsz) * g.h * pn) return;
  const size_t bb = e / (g.h * pn);
  const size_t h = (e / pn) % g.h;
  const size_t off = e % pn;
  float carry = a.init ? a.init[e] : 0.f;
  constexpr int kAhead = 4;  // loads issued before the dependent updates
  int c = 0;
  for (; c + kAhead <= g.nc; c += kAhead) {
    float loc[kAhead], dec[kAhead];
    size_t idx[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const size_t ch = (bb * g.nc + c + k) * g.h + h;
      idx[k] = ch * pn + off;
      loc[k] = a.st[idx[k]];
      dec[k] = a.dec[ch];
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      a.st[idx[k]] = carry;  // the state entering chunk c + k
      carry = carry * dec[k] + loc[k];
    }
  }
  for (; c < g.nc; ++c) {
    const size_t ch = (bb * g.nc + c) * g.h + h;
    const float loc = a.st[ch * pn + off];
    a.st[ch * pn + off] = carry;
    carry = carry * a.dec[ch] + loc;
  }
  a.state[e] = carry;
}

// (c) grid (nc * rt, H * pt, B): y for 64 rows of one chunk, one head, 32
// of P.  Warp w: rows 16 (w % 4) .., P columns 16 (w / 4) ...
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_output_kernel(Geo g, Ptrs a) {
  const int c = blockIdx.x / g.rt, i0 = (blockIdx.x % g.rt) * kRowTile;
  const int h = blockIdx.y % g.h, p0 = (blockIdx.y / g.h) * kPTile;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int cbs_st = g.qp + 4, ns = g.np + 4;
  const int s0 = c * g.q;
  const int rows = min(g.q, g.s - s0);         // rows of this chunk that exist
  const int j_end = min(rows, i0 + kRowTile);  // keys any row of the tile sees

  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  float* dts = cs + g.qp;                  // (qp): dt
  float* cbs = dts + g.qp;                 // (64, qp + 4): rows i0.. of C.B^T
  float* xs = cbs + kRowTile * cbs_st;     // (qp, kXS): x
  float* cst = xs + g.qp * kXS;            // (64, np + 4): c rows i0..
  float* prv = cst + kRowTile * ns;        // (32, np + 4): S_{c-1} rows p0..

  const size_t row0 = static_cast<size_t>(bb) * g.s + s0;
  const size_t chunk = static_cast<size_t>(bb) * g.nc + c;
  // inputs first; C.B^T and the entering state once the kernels before
  // have finished
  load_tile(xs, kXS, static_cast<const T*>(a.x) + (row0 * g.h + h) * g.p + p0,
            static_cast<size_t>(g.h) * g.p, g.qp, kPTile, j_end, min(kPTile, g.p - p0));
  load_tile(cst, ns, static_cast<const T*>(a.c) + (row0 + i0) * g.n, g.n, kRowTile, g.np,
            rows - i0, g.n);
  mma::cp_async_commit();
  for (int j = tid; j < g.qp; j += kThreads) dts[j] = j < rows ? a.dt[(row0 + j) * g.h + h] : 0.f;
  if (w == 0) chunk_cumsum(cs, a.dt, g, bb, c, h, a.a_log[h], lane);
  wait_prerequisites();
  load_tile(cbs, cbs_st, a.cb + (chunk * g.q + i0) * g.q, g.q, kRowTile, g.qp, rows - i0,
            j_end);
  // S_{c-1}: the carry's output, or with one chunk the initial state (zeros
  // when there is none)
  const bool one = g.nc == 1;
  const size_t prev_row = ((one ? static_cast<size_t>(bb) : chunk) * g.h + h) * g.p + p0;
  const float* prev = (one && a.init ? a.init : a.st) + prev_row * g.n;
  load_tile(prv, ns, prev, g.n, kPTile, g.np, one && !a.init ? 0 : min(kPTile, g.p - p0), g.n);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  const int r0 = i0 + 16 * (w & 3);  // the warp's first row, in the chunk
  const int pw = 16 * (w >> 2);       // and its first column of the P tile
  if (r0 >= rows) return;
  const int gq = lane >> 2, tq = lane & 3;

  // intra: A(i, j) = C.B^T(i, j) exp(cs_i - cs_j) dt_j for j <= i, else 0
  constexpr int kNT = 2;  // 16 columns of P a warp
  float intra[kNT][4] = {};
  float small[kNT][4] = {};
  const int ksteps = (min(r0 + 16, rows) + 7) / 8;
  const float* cbw = cbs + (r0 - i0) * cbs_st;
  for (int ks = 0; ks < ksteps; ++ks) {
    float av[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = gq + 8 * (e & 1);        // a0 (g, t) a1 (g+8, t) a2 (g, t+4) a3 (g+8, t+4)
      const int j = 8 * ks + tq + 4 * (e >> 1);
      const int i = r0 + rr;
      av[e] = (j <= i && i < rows) ? cbw[rr * cbs_st + j] * expf(cs[i] - cs[j]) * dts[j] : 0.f;
    }
    uint32_t ah[4], al[4];
    mma::split(av, ah, al);
    const float* xr = xs + (8 * ks + tq) * kXS + pw + gq;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float bv[2] = {xr[8 * nt], xr[4 * kXS + 8 * nt]};
      uint32_t bh[2], bl[2];
      mma::split(bv, bh, bl);
      mma::tf32_mma(small[nt], al, bh);
      mma::tf32_mma(small[nt], ah, bl);
      mma::tf32_mma(intra[nt], ah, bh);
    }
  }
  // inter: c_i . S_{c-1}, A(i, n) = c[i][n], B(n, p) = S[p][n]
  float inter[kNT][4] = {};
  mma::mma3_strided<kNT>(inter, cst + (r0 - i0) * ns, ns, 1, prv + pw * ns, 1, ns, g.np / 8,
                         lane);

  T* yg = static_cast<T*>(a.y);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = r0 + gq + 8 * (e >> 1);
    if (i >= rows) continue;
    const float ecs = expf(cs[i]);
    T* yr = yg + ((row0 + i) * g.h + h) * g.p + p0;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int p = pw + 8 * nt + 2 * tq + (e & 1);
      if (p0 + p < g.p)
        yr[p] = from_float<T>((intra[nt][e] + small[nt][e]) + ecs * inter[nt][e]);
    }
  }
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// a launch that may start while the previous kernel on the stream runs
cudaError_t launch_after(void (*kernel)(Geo, Ptrs), dim3 grid, size_t smem, cudaStream_t st,
                         const Geo& g, const Ptrs& a) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, g, a);
}

template <typename T>
cudaError_t launch(const Geo& g, const Ptrs& a, cudaStream_t st) {
  cudaError_t err;
  const size_t s_cb = cb_smem<T>(g), s_state = state_smem(g), s_out = out_smem(g);
  if ((err = opt_in(ssd_cb_kernel<T>, s_cb)) != cudaSuccess) return err;
  if ((err = opt_in(ssd_state_kernel<T>, s_state)) != cudaSuccess) return err;
  if ((err = opt_in(ssd_output_kernel<T>, s_out)) != cudaSuccess) return err;
  ssd_cb_kernel<T><<<dim3(g.nc * g.rt * g.rt, g.bsz), kThreads, s_cb, st>>>(g, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_after(ssd_state_kernel<T>, dim3(g.nc * g.h, g.pt * g.nt, g.bsz), s_state, st, g, a);
  if (err != cudaSuccess) return err;
  if (g.nc > 1) {  // one chunk: (a) wrote the final state
    const size_t entries = static_cast<size_t>(g.bsz) * g.h * g.p * g.n;
    err = launch_after(ssd_carry_kernel, dim3(static_cast<unsigned>((entries + kThreads - 1) /
                                                                    kThreads)),
                       0, st, g, a);
    if (err != cudaSuccess) return err;
  }
  return launch_after(ssd_output_kernel<T>, dim3(g.nc * g.rt, g.h * g.pt, g.bsz), s_out, st, g,
                      a);
}

}  // namespace

// kind: 0 fp32, 1 bf16 (x, b, c and y alike).  Needs P a power of two <= 128,
// N % 4 == 0, 1 <= q <= 128, and the largest of the kernels' shared memory
// within what a block may have (the wrapper checks); cb, st and dec are the
// caller's workspaces of B*nc*q*q, B*nc*H*P*N and B*nc*H floats, with nc =
// ceil(s / q).  init may be null.  Launches on `stream` and returns the first
// launch error (0 on success).
extern "C" int repro_ssd_scan(int kind, const void* x, const float* dt, const float* a_log,
                              const void* b, const void* c, const float* init, void* y,
                              float* state, float* cb, float* st, float* dec, int bsz, int s,
                              int h, int p, int n, int q, void* stream) {
  if (q < 1 || q > kMaxQ || p < 1 || p > 128 || (p & (p - 1)) || n < 4 || n % 4 || s < 1 ||
      bsz < 1 || bsz > 65535 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g = geo(bsz, s, h, p, n, q);
  const Ptrs a{x, dt, a_log, b, c, init, y, state, cb, st, dec};
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (kind == 0) return static_cast<int>(launch<float>(g, a, strm));
  if (kind == 1) return static_cast<int>(launch<__nv_bfloat16>(g, a, strm));
  return static_cast<int>(cudaErrorInvalidValue);
}

// the most shared memory any of the kernels asks for, at chunk q
extern "C" size_t repro_ssd_shared_bytes(int q, int n, int p) {
  const Geo g = geo(1, q, 1, p, n, q);
  size_t m = cb_smem<float>(g);
  if (state_smem(g) > m) m = state_smem(g);
  if (out_smem(g) > m) m = out_smem(g);
  return m;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
