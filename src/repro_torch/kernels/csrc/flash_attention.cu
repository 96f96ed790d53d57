// Flash attention (online softmax) on Hopper tensor cores (sm_90a): causal
// or full, with an optional sliding window, GQA.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py), which the reference holds to
// `ref.attention_ref` and `layers.chunked_causal_attention`.  q: (B, Hq, S, D),
// k and v: (B, Hkv, S, D), all fp32 or all bf16, Hq a multiple of Hkv
// (query head h reads kv head h / (Hq / Hkv)).  Keys are masked by index:
// key j is seen by query i when j <= S - 1, j <= i (causal) and
// j > i - window (window > 0).  Keys past S - 1 are never seen, in either
// mode, so a ragged S gives `attention_ref`'s answer.  The output is
// acc / max(l, 1e-20) in q's dtype, with the scores, the softmax and the
// sums in fp32.
//
// What bounds it on an H100: the operations.  Every unmasked (query, key)
// pair costs 4 * D flops (Q.K and P.V); at recurrentgemma-2b's prefill (10
// query heads, D 256, a 2032-token prompt) that is 21 GFLOP against 46 MB
// of q, k, v and output, about 460 flops a byte.
//
// What the design does about it: both products run on the tensor cores,
// `mma.sync` m16n8k8 TF32 for fp32 inputs and m16n8k16 bf16 for bf16 ones,
// accumulating in fp32 registers.  One TF32 product misses the reference's
// fp32 bar (atol 2e-5 / rtol 2e-4), so fp32 operands take the 3xTF32 split of
// mma.cuh: three TF32 products per fp32 product, about 165 TFLOP/s of
// fp32-exact work against the 67 of the CUDA cores.  bf16 Q.K is exact in
// one bf16 mma; the fp32 probabilities P are split into two bf16 terms
// (hi + lo, 16 bits) for P.V over bf16 V.
//
// One block per (q tile of 64 rows, query head, batch row): 8 warps in two
// groups of 4, 16 rows a warp; each group takes one half of every key tile
// and keeps its own online softmax, and the two are merged at the end in a
// fixed order (no atomics: a second launch gives the same bits).  The two
// groups double the warps an SM runs within one block's shared memory.
// The Q tile and two stages of K and V tiles of kBK keys sit in shared
// memory in the input dtype, brought in by `cp.async` (16 bytes a copy for
// fp32, 8 for bf16); the next tile's copy runs while the warps work on the
// current one.  Rows are padded (4 floats, 8 bf16) so that the fragment
// loads of 8 rows x 4 columns fall in 32 different banks, and the head dim
// is padded with zeros to a bucket kD of 64, 128 or 256.  Shared memory per
// block, (64 + 4 kBK) rows of kD + pad elements:
//   fp32, kD 256, kBK 32: 192 x 260 x 4 = 199,680 bytes (of 232,448)
//   fp32, kD 128, kBK 64: 320 x 132 x 4 = 168,960
//   fp32, kD  64, kBK 64: 320 x  68 x 4 =  87,040
//   bf16 halves the element size, with 8 elements of pad.
// The scores S = Q.K^T stay in registers (16 rows x kBK / 2 keys a warp);
// the online softmax (m, l, rescale) runs on them with quad shuffles, and
// they become P.V's A operand without a trip through shared memory.  For
// TF32 the key order of P.V is permuted (A column t <-> key 2t, t + 4 <->
// 2t + 1, with V's rows read to match), which turns the C fragment into the
// A fragment in place.  The walk covers only the key tiles that hold an
// unmasked key for some row of the block, and a warp skips a half tile that
// is masked for all its rows.  Blocks are issued heaviest first: in causal
// mode the last q tiles of the triangle get the lowest block indices.
//
// What still bounds it: `mma.sync` TF32 issues at a fraction of the card's
// 494.7 TFLOP/s (the tensor-core rate is reached only by `wgmma`), and three
// products per fp32 product triple that work; copies of the kernel with
// either product removed run far faster.  `wgmma` needs B in shared memory
// K-major, so V transposed and both split halves of K and V there, which
// does not fit beside the Q tile at D 256 in fp32; that is the next lever.
//
// The file includes no PyTorch header: it exposes a plain C interface that
// the Python wrapper calls through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRowWarps = 4;                // warps of a group: 16 query rows each
constexpr int kGroups = 2;                  // warp groups: each takes half of a key tile
constexpr int kWarps = kRowWarps * kGroups;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kRowWarps;         // query rows a block
constexpr int kMaxD = 256;

template <typename T, int kD>
struct Tile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kBK = kD == 256 ? 32 : 64;           // keys a tile
  static constexpr int kKeys = kBK / kGroups;                // keys a warp takes of a tile
  static constexpr int kStride = kD + (kF32 ? 4 : 8);        // elements a shared row
  static constexpr size_t kSmem = sizeof(T) * static_cast<size_t>(kBQ + 4 * kBK) * kStride;
  // the second group's (m, l, acc) for the final merge, in the K/V stages
  static_assert(sizeof(float) * kBQ * (kD + 2) <= sizeof(T) * 4 * kBK * kStride,
                "the merge buffer must fit in the K/V stages");
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

struct Args {
  const void* q;  // (B, Hq, S, D)
  const void* k;  // (B, Hkv, S, D)
  const void* v;
  void* out;      // (B, Hq, S, D) in q's dtype
  int b, hq, hkv, s, d, window, causal;
  float scale;
};

// grid (ceil(S / kBQ) * Hq * B); block kThreads.  Warp w owns rows
// 16 (w % 4) .. + 15 of its q tile and, of every key tile, the half
// w / 4: each group keeps its own online softmax, and the two are merged
// at the end in a fixed order.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(Args a) {
  using C = Tile<T, kD>;
  constexpr int kBK = C::kBK, kKeys = C::kKeys, kS = C::kStride, kNT = kKeys / 8, kDT = kD / 8;
  const int S = a.s, D = a.d;
  const int heads = a.hq * a.b;
  const int rank = blockIdx.x / heads;
  const int rest = blockIdx.x - rank * heads;
  const int h = rest % a.hq;
  const int bi = rest / a.hq;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (a.causal ? n_qt - 1 - rank : rank) * kBQ;  // heaviest tiles first
  const int hk = h / (a.hq / a.hkv);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int wr = w % kRowWarps, grp = w / kRowWarps;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ float4 smem4[];  // 16-byte aligned
  T* q_s = reinterpret_cast<T*>(smem4);
  T* k_s = q_s + kBQ * kS;           // two stages
  T* v_s = k_s + 2 * kBK * kS;       // two stages

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const size_t q_rows = (static_cast<size_t>(bi) * a.hq + h) * S;  // first row of (b, h)
  const size_t k_rows = (static_cast<size_t>(bi) * a.hkv + hk) * S;

  // the head-dim pad D..kD of every row stays zero (no copy writes it)
  if (D < kD) {
    const int pad = kD - D;
    for (int i = tid; i < (kBQ + 4 * kBK) * pad; i += kThreads)
      q_s[(i / pad) * kS + D + i % pad] = from_float<T>(0.f);
  }

  // rows row0 .. row0 + n - 1 of one (b, head) into dst; rows past S - 1
  // are filled with zeros
  auto load_rows = [&](T* dst, const T* src, size_t base, int row0, int n) {
    const int chunks = D / 4;  // 4 elements a copy
    for (int i = tid; i < n * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 4;
      const int row = row0 + r;
      const bool ok = row < S;
      mma::cp_async<4 * sizeof(T)>(dst + r * kS + c, src + (base + (ok ? row : 0)) * D + c, ok);
    }
  };

  // the key tiles that hold an unmasked key for some row of this block
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_first = a.window ? max(0, q0 - a.window + 1) : 0;
  const int k_last = a.causal ? q_last : S - 1;
  const int kt0 = k_first / kBK, kt1 = k_last / kBK;

  load_rows(q_s, q, q_rows, q0, kBQ);
  load_rows(k_s, k, k_rows, kt0 * kBK, kBK);
  load_rows(v_s, v, k_rows, kt0 * kBK, kBK);
  mma::cp_async_commit();

  const int r0 = q0 + 16 * wr;             // the warp's first row
  const int rows[2] = {r0 + g, r0 + g + 8};  // this thread's two rows
  float o[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int kt = kt0; kt <= kt1; ++kt) {
    const int stage = (kt - kt0) & 1;
    if (kt < kt1) {  // the next tile into the other stage
      load_rows(k_s + (stage ^ 1) * kBK * kS, k, k_rows, (kt + 1) * kBK, kBK);
      load_rows(v_s + (stage ^ 1) * kBK * kS, v, k_rows, (kt + 1) * kBK, kBK);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // this tile (and the Q tile) have landed
    __syncthreads();
    const int k0 = kt * kBK + grp * kKeys;  // the warp's first key
    const bool skip = (a.causal && k0 > r0 + 15) ||
                      (a.window && k0 + kKeys - 1 <= r0 - a.window);
    if (!skip) {
      const T* kst = k_s + (stage * kBK + grp * kKeys) * kS;
      const T* vst = v_s + (stage * kBK + grp * kKeys) * kS;
      float sc[kNT][4];
#pragma unroll
      for (int i = 0; i < kNT; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
      // S = Q.K^T: A(r, d) = Q[r][d], B(d, key) = K[key][d]
      if constexpr (C::kF32)
        mma::mma3_strided<kNT>(sc, q_s + 16 * wr * kS, kS, 1, kst, 1, kS, kD / 8, lane);
      else
        mma::bf16_rows<kNT>(sc, q_s + 16 * wr * kS, kS, kst, kS, kD / 16, lane);

      // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
      float m_tile[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * nt + 2 * t + (e & 1);
          const int row = rows[e >> 1];
          const bool ok = key < S && (!a.causal || key <= row) &&
                          (a.window == 0 || key > row - a.window);
          sc[nt][e] = ok ? sc[nt][e] * a.scale : kNegInf;
          m_tile[e >> 1] = fmaxf(m_tile[e >> 1], sc[nt][e]);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
        m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
        const float m_new = fmaxf(m_run[r], m_tile[r]);
        corr[r] = expf(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= corr[r];  // this thread's share of l; the quad sums at the end
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked key gives 0 once a row has seen a real one
          sc[nt][e] = expf(sc[nt][e] - m_run[e >> 1]);
          l_run[e >> 1] += sc[nt][e];
        }
      }
#pragma unroll
      for (int i = 0; i < kDT; ++i) {
        o[i][0] *= corr[0];
        o[i][1] *= corr[0];
        o[i][2] *= corr[1];
        o[i][3] *= corr[1];
      }

      // O += P.V
      if constexpr (C::kF32) {
#pragma unroll
        for (int ks = 0; ks < kNT; ++ks) {
          // A column t is key 2t, column t + 4 key 2t + 1: the C fragment as is
          const float pv[4] = {sc[ks][0], sc[ks][2], sc[ks][1], sc[ks][3]};
          uint32_t ph[4], pl[4];
          mma::split(pv, ph, pl);
          const float* vr = vst + (8 * ks + 2 * t) * kS + g;  // keys 2t and 2t + 1
#pragma unroll
          for (int i = 0; i < kDT; ++i) {
            const float bv[2] = {vr[8 * i], vr[kS + 8 * i]};
            uint32_t bh[2], bl[2];
            mma::split(bv, bh, bl);
            mma::mma3(o[i], ph, pl, bh, bl);
          }
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < kNT / 2; ++ks) {
          const float pv[4][2] = {{sc[2 * ks][0], sc[2 * ks][1]},
                                  {sc[2 * ks][2], sc[2 * ks][3]},
                                  {sc[2 * ks + 1][0], sc[2 * ks + 1][1]},
                                  {sc[2 * ks + 1][2], sc[2 * ks + 1][3]}};
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const __nv_bfloat16 h0 = __float2bfloat16(pv[j][0]);
            const __nv_bfloat16 h1 = __float2bfloat16(pv[j][1]);
            ph[j] = mma::pack(h0, h1);
            pl[j] = mma::pack(__float2bfloat16(pv[j][0] - __bfloat162float(h0)),
                              __float2bfloat16(pv[j][1] - __bfloat162float(h1)));
          }
          const __nv_bfloat16* vr = vst + (16 * ks + 2 * t) * kS + g;
#pragma unroll
          for (int i = 0; i < kDT; ++i) {
            const __nv_bfloat16* vc = vr + 8 * i;
            const uint32_t bv[2] = {mma::pack(vc[0], vc[kS]), mma::pack(vc[8 * kS], vc[9 * kS])};
            mma::bf16_mma(o[i], pl, bv);
            mma::bf16_mma(o[i], ph, bv);
          }
        }
      }
    }
    __syncthreads();  // the tile is consumed before the next copy overwrites it
  }

  // merge the two groups' (m, l, acc) in a fixed order, then normalise and
  // store in q's dtype.  The K/V stages are free: the loop ended on a
  // __syncthreads() and no copy is in flight.
  float* xm = reinterpret_cast<float*>(k_s);  // (kBQ): group 1's m
  float* xl = xm + kBQ;                       // (kBQ): group 1's l
  float* xo = xl + kBQ;                       // (kBQ, kD): group 1's acc
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if (grp == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * wr + g + 8 * r;
      if (t == 0) {
        xm[row] = m_run[r];
        xl[row] = l_run[r];
      }
#pragma unroll
      for (int i = 0; i < kDT; ++i)
        *reinterpret_cast<float2*>(xo + row * kD + 8 * i + 2 * t) =
            make_float2(o[i][2 * r], o[i][2 * r + 1]);
    }
  }
  __syncthreads();
  if (grp == 1) return;
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * wr + g + 8 * r;
    const float m1 = xm[row];
    const float m = fmaxf(m_run[r], m1);
    const float c0 = expf(m_run[r] - m), c1 = expf(m1 - m);  // a group that saw no real key: 0
    const float denom = fmaxf(l_run[r] * c0 + xl[row] * c1, 1e-20f);
    if (rows[r] >= S) continue;
    T* orow = out + (q_rows + rows[r]) * D;
#pragma unroll
    for (int i = 0; i < kDT; ++i) {
      const int col = 8 * i + 2 * t;
      if (col < D) {
        const float2 o1 = *reinterpret_cast<const float2*>(xo + row * kD + col);
        const float x0 = (o[i][2 * r] * c0 + o1.x * c1) / denom;
        const float x1 = (o[i][2 * r + 1] * c0 + o1.y * c1) / denom;
        if constexpr (C::kF32)
          *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
        else
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

template <typename T, int kD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Tile<T, kD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((a.s + kBQ - 1) / kBQ) * a.hq * a.b;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_attention_kernel<T, kD><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 64>(a, stream);
  if (a.d <= 128) return launch<T, 128>(a, stream);
  return launch<T, 256>(a, stream);
}

template <typename T>
size_t shared_bytes(int d) {
  if (d <= 64) return Tile<T, 64>::kSmem;
  if (d <= 128) return Tile<T, 128>::kSmem;
  return Tile<T, 256>::kSmem;
}

}  // namespace

// kind: 0 fp32, 1 bf16 (q, k, v and out alike).  Needs d % 4 == 0, d <= 256
// and 16-byte aligned tensors (the wrapper checks).  causal: 0 or 1.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention(int kind, const void* q, const void* k, const void* v,
                                     void* out, int b, int hq, int hkv, int s, int d, int window,
                                     int causal, float scale, void* stream) {
  if (d % 4 != 0 || d < 4 || d > kMaxD || hkv < 1 || hq % hkv != 0 || s < 1 || b < 1 ||
      window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out, b, hq, hkv, s, d, window, causal ? 1 : 0, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) return static_cast<int>(dispatch<float>(a, st));
  if (kind == 1) return static_cast<int>(dispatch<__nv_bfloat16>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" size_t repro_flash_attention_shared_bytes(int kind, int d) {
  return kind == 0 ? shared_bytes<float>(d) : shared_bytes<__nv_bfloat16>(d);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
