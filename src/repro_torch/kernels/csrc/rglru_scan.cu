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
// 62 MB, about 19 us; a 128-token join moves 3.9 MB, about 1.2 us, less
// than a launch and one trip to device memory take.
//
// What the design does about it: one launch reads a and b once and writes
// h once, with enough bytes in flight to keep device memory busy at one
// prompt (Little's law: about 3 MB at 3.35 TB/s and a microsecond of
// latency).  A thread per (batch, lane) pair stepping all S positions, as
// this kernel did before, has 2560 threads at one prompt and waits on
// latency; here the time axis is cut too.
// * A block owns 16 lanes (64-byte rows) of one batch row, so one prompt at
//   W 2560 gives 160 blocks on 132 SMs, and walks time in tiles of 128
//   steps (tiles of 256 were measured slower: the ring fills and drains
//   later).  Its 256 threads are 16 lanes x 16 segments of 8 steps; a warp
//   spans neighbouring lanes at two neighbouring segments.
// * Tiles of a and b arrive by 16-byte `cp.async` copies (4-byte ones where
//   W is not a multiple of 4 or a pointer is not 16-byte aligned) into a
//   ring of two stages in shared memory: tile k+2 is copied while tile k is
//   scanned, so two tiles a block are in flight (three stages were measured
//   no faster).  L2 fetches whole 128-byte lines, so one block's copy
//   brings its neighbour's half of each line too.  Segments are padded by
//   16 floats so that the two segments a warp reads fall on different banks.
// * A tile is scanned in three passes over registers: each thread forms its
//   segment's aggregate (A = the product of its a, B = its scan from 0);
//   after one barrier the thread of segment g folds the tile's carry-in
//   through the aggregates of segments 0 .. g-1 in that order
//   (c <- A_j * c + B_j), then rescans its 8 steps from c with the a and b
//   it still holds and stores h.  The last segment's end is the next
//   tile's carry.  No atomics and no flags between blocks: the order of
//   every floating-point operation is fixed by the plan, so two launches
//   give the same bits.  A segment's product of 8 factors rounds to about
//   8 ulp, within the port's fp32 bar.
// * The plan is one for every shape: its constants below are mirrored by
//   the Python wrapper (`repro_torch.kernels.rglru_scan.scan_plan`), which
//   also models this order in numpy (`scan_model`).  At S 128 the whole
//   sequence is one tile.  Ragged S and W are masked: rows past S are
//   never copied and never stored (they only reach later segments, which
//   lie past S too), lanes past W likewise.  A block's 38,976 bytes of
//   shared memory lie under the 48 KB a launch gets without asking.
// The TPU kernel's sequential time grid with its VMEM carry becomes the
// loop over tiles inside the block, with the carry in shared memory.
//
// The file includes no PyTorch header: it exposes a plain C interface that
// the Python wrapper calls through ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // threads a block: lanes x segments
constexpr int kLanes = 16;              // width lanes a block (64-byte rows)
constexpr int kSegs = kThreads / kLanes;  // segments a tile
constexpr int kSeg = 8;                 // steps a segment, held in registers
constexpr int kTile = kSegs * kSeg;     // steps a tile
constexpr int kStages = 2;              // tiles of a and b in shared memory
// floats between the starts of two segments of a tile: 8 rows of 16 lanes,
// padded so that a warp's two segments start 16 banks apart
constexpr int kStride = kSeg * kLanes + 16;
constexpr int kTileFloats = kSegs * kStride;  // one tile of one array

// the ring (two stages of a and b), the segments' aggregates and the carry
constexpr size_t kSharedBytes =
    sizeof(float) * (2 * kStages * static_cast<size_t>(kTileFloats) + 2 * kThreads + kLanes);
static_assert(kSharedBytes <= 48 * 1024, "a launch takes 48 KB of shared memory without asking");

// floats a copy: 4 (16 bytes, past L1) or 1; L2 fetches the whole 128-byte
// line, whose other half is the neighbouring block's
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(s), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 4;\n" ::"r"(s), "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// grid B * ceil(W / 16); block = (batch row, 16 lanes); thread = (lane l,
// segment g) with threadIdx.x = g * 16 + l.  V floats a copy.
template <int V>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h, int s, int w) {
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const agg_a = ring + 2 * kStages * kTileFloats;  // (G, L): A of each segment
  float* const agg_b = agg_a + kThreads;                  // (G, L): B of each segment
  float* const carry = agg_b + kThreads;                  // (L,): the next tile's carry-in

  const int l = threadIdx.x % kLanes, g = threadIdx.x / kLanes;
  const int col_blocks = (w + kLanes - 1) / kLanes;
  const int bi = blockIdx.x / col_blocks;
  const int lane0 = (blockIdx.x % col_blocks) * kLanes;
  const int width = min(kLanes, w - lane0);  // this block's lanes inside W
  const int n_tiles = (s + kTile - 1) / kTile;
  const size_t first = static_cast<size_t>(bi) * s * w + lane0;  // (bi, 0, lane0)

  // copy tile k of a and b into stage k % 2, neighbouring threads on
  // neighbouring chunks of a row; every thread commits one group a tile
  auto load = [&](int k) {
    float* const dst = ring + (k % kStages) * 2 * kTileFloats;
    constexpr int per_row = kLanes / V;
    const int t0 = k * kTile;
    const int chunks = min(kTile, s - t0) * per_row;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      const int r = c / per_row, col = (c % per_row) * V;
      if (col < width) {
        const int at = (r / kSeg) * kStride + (r % kSeg) * kLanes + col;
        const size_t src = first + static_cast<size_t>(t0 + r) * w + col;
        cp_async<V>(dst + at, a + src);
        cp_async<V>(dst + kTileFloats + at, b + src);
      }
    }
    cp_async_commit();
  };

  const bool live = l < width;
  float c0 = (h0 != nullptr && live) ? h0[static_cast<size_t>(bi) * w + lane0 + l] : 0.f;
  static_assert(kStages == 2, "the waits below leave one tile in flight");
  load(0);
  if (n_tiles > 1) load(1);
  for (int k = 0; k < n_tiles; ++k) {
    if (k + 1 < n_tiles) {
      cp_async_wait<1>();  // tile k + 1 may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile k has landed; the last tile's carry is written
    const float* const ta = ring + (k % kStages) * 2 * kTileFloats + g * kStride + l;
    float av[kSeg], bv[kSeg];
#pragma unroll
    for (int q = 0; q < kSeg; ++q) {
      av[q] = ta[q * kLanes];
      bv[q] = ta[kTileFloats + q * kLanes];
    }
    // the segment's aggregate: its end is A * (its carry-in) + B
    float A = av[0], B = bv[0];
#pragma unroll
    for (int q = 1; q < kSeg; ++q) {
      A *= av[q];
      B = fmaf(av[q], B, bv[q]);
    }
    agg_a[threadIdx.x] = A;
    agg_b[threadIdx.x] = B;
    float c = k == 0 ? c0 : carry[l];
    __syncthreads();  // the aggregates are written; stage k % 2 is read
    if (k + kStages < n_tiles) load(k + kStages);
    for (int j = 0; j < g; ++j) c = fmaf(agg_a[j * kLanes + l], c, agg_b[j * kLanes + l]);
    const int t0 = k * kTile + g * kSeg;
    float* const out = h + first + static_cast<size_t>(t0) * w + l;
#pragma unroll
    for (int q = 0; q < kSeg; ++q) {
      c = fmaf(av[q], c, bv[q]);
      if (live && t0 + q < s) out[static_cast<size_t>(q) * w] = c;
    }
    if (g == kSegs - 1) carry[l] = c;
  }
}

template <int V>
cudaError_t launch(const float* a, const float* b, const float* h0, float* h, int batch, int s,
                   int w, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(batch) * ((w + kLanes - 1) / kLanes);
  rglru_scan_kernel<V><<<blocks, kThreads, kSharedBytes, stream>>>(a, b, h0, h, s, w);
  return cudaGetLastError();
}

}  // namespace

// a, b, h: (batch, s, w) fp32; h0: (batch, w) fp32 or null for a zero state.
// `vec` floats a copy (4: w a multiple of 4 and a, b 16-byte aligned; else
// 1).  The caller keeps batch * ceil(w / 16) blocks within the grid's
// 2**31 - 1.  Launches on `stream` and returns the launch's cudaError_t (0
// on success).
extern "C" int repro_rglru_scan(const float* a, const float* b, const float* h0, float* h,
                                int batch, int s, int w, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4 && w % 4 == 0) return static_cast<int>(launch<4>(a, b, h0, h, batch, s, w, st));
  if (vec == 1) return static_cast<int>(launch<1>(a, b, h0, h, batch, s, w, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The shared memory a block takes, in bytes.
extern "C" size_t repro_rglru_scan_shared_bytes() { return kSharedBytes; }

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
