// Split-K GQA flash-decode over a paged KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::_decode_kernel
// (called from flash_decode) and the jnp logsumexp merge that follows it
// there (flash_decode.py:147-153), as two kernels:
//
//   flash_decode_split_kernel   grid (B*Kv, splits), one CTA of kWarps
//                               warps per (request * kv head, K-split).
//                               It reads its pool block ids from the block
//                               table itself (the TPU fed them to the DMA
//                               engine as scalar-prefetch operands), scores
//                               the G query heads of its kv head against
//                               each K row and keeps online softmax states
//                               (m, l, acc) in f32; it writes the split's
//                               unnormalised partial.
//   flash_decode_combine_kernel grid (B*Kv), merges the splits' partials
//                               with one logsumexp rescale and writes the
//                               (B, 1, H, D) output in q's type.
//
// Numerics follow the TPU kernel: table entries < 0 are clamped to block 0
// and padded tail entries of the split plan read block 0; positions >= ctx
// score NEG_INF = -1e30 and their p is exactly 0; the combine divides by
// max(l, 1e-30).  Positions past ctx are a no-op of the online update
// (alpha = 1, p = 0), so a CTA stops at the request's last valid position
// instead of walking its whole range.
//
// Bound on the H100: bytes.  Decode reads every cached K/V element once for
// one query token per head: 2 * G operations per element, far below the
// ~20 f32 operations per byte the card could do, at any context length.
// The serving shape (B 8, H 16, Kv 8, D 128, block 16, ctx <= 320, 4
// splits) reads 8.1 MB: 2.5 us at 3.35 TB/s, less than one launch costs.
// The first design staged each block in shared memory behind four
// barriers, scored with one warp per (head, position), ran the softmax on
// G = 2 of 128 threads and walked a split's blocks one after another: 53.7
// us on an H100 80GB HBM3 at 700 W.  This design has no barrier in its
// loop.  Each warp owns chunks of kChunk positions (chunk c of the split
// to warp c % kWarps) and its own (m, l, acc) in registers; a lane holds
// DPL consecutive columns (16 bytes of f32 at D 128), so one K or V row is
// one coalesced warp load, and all 2 * kChunk rows of a chunk are loaded
// before any arithmetic on them.  The states meet once, at the end, in
// shared memory, merged in warp order: the same bits on every launch.
// Same card: 10.9 us of device time at the serving shape (15 us between
// CUDA events around the launch, whose floor there is 5 us); B 8 at ctx
// 4096 (268 MB) 101 us, 80 % of its 80 us bound; bf16 reads half the
// bytes and takes as long, so there the chunk loop's ~1,100 instructions
// per 8 positions, not bytes, set the pace.
// Loading a warp's first chunk before q is staged did not help (11.0 us).
// Registers bound the shapes: G <= kMaxG, D <= kMaxD; shared memory holds
// q and the warps' states, (G * D + kWarps * G * (D + 2)) * 4 bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps per split CTA
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 8;            // positions a warp takes per step
constexpr int kMaxG = 16;            // query heads per kv head, at most
constexpr int kMaxD = 256;           // head dim, at most (8 values a lane)
constexpr int kCombineThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Loads one lane's DPL consecutive values of a K or V row (DPL * sizeof(T)
// bytes, 16-byte aligned or less as the row allows) into f32.
template <typename T, int DPL>
__device__ __forceinline__ void load_lane(const T* p, float* o) {
  constexpr int kBytes = DPL * static_cast<int>(sizeof(T));
  uint32_t w[kBytes / 4];
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
    }
  } else if constexpr (kBytes == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < kBytes / 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      o[i] = __uint_as_float(w[i]);
    } else {            // two bf16, the lower address in the low half
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// grid (B*Kv, splits), kWarps warps.  The split's positions p0 .. p0 +
// bps*bs - 1 that are < ctx are cut into chunks of kChunk; warp w takes
// chunks w, w + kWarps, ... and keeps its own online softmax (m, l, acc)
// for each of the G query heads in registers (lane l holds columns
// l*DPL .. l*DPL + DPL - 1 of acc).  Per chunk: lane u < kChunk reads the
// block id of position u of the chunk from the table (one load for the
// warp), the warp loads the chunk's kChunk K rows and V rows (one
// coalesced row per load instruction) before any arithmetic on them, then
// per head scores them (lane-partial dots, xor butterflies: every lane
// gets the same bits), and updates m, l, acc once for the chunk.  At the
// end the warps' states go through shared memory once and are merged in
// warp order into the split's partial.  One barrier after q is staged,
// one before the merge.
template <typename T, int GM, int DPL>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q,       // (B*Kv, G, D)
                          const T* __restrict__ k_pool,  // (P, bs, Kv, D)
                          const T* __restrict__ v_pool,
                          const int* __restrict__ tbl,   // (B, nb)
                          const int* __restrict__ ctx,   // (B,)
                          float* __restrict__ acc_out,   // (B*Kv, S, G, D)
                          float* __restrict__ m_out,     // (B*Kv, S, G)
                          float* __restrict__ l_out,     // (B*Kv, S, G)
                          int Kv, int G, int D, int P, int bs, int nb,
                          int splits, int bps, float scale, int vec) {
  extern __shared__ float smem[];
  float* q_s = smem;                      // G*D          query heads
  float* acc_s = q_s + G * D;             // kWarps*G*D   warps' acc
  float* m_s = acc_s + kWarps * G * D;    // kWarps*G     warps' m
  float* l_s = m_s + kWarps * G;          // kWarps*G     warps' l

  const int bk = blockIdx.x;              // request * Kv + kv head
  const int s = blockIdx.y;               // K-split
  const int b = bk / Kv, h = bk - b * Kv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d0 = lane * DPL;              // this lane's first column

  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = to_float(q[static_cast<int64_t>(bk) * G * D + i]);
  __syncthreads();

  float acc[GM][DPL], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  // this split's positions that are < ctx: the CTA stops at the last one
  const int p0 = s * bps * bs;
  const int n_pos = max(min(p0 + bps * bs, ctx[b]) - p0, 0);
  const int n_chunks = (n_pos + kChunk - 1) / kChunk;
  for (int ci = warp; ci < n_chunks; ci += kWarps) {
    // lane u < kChunk: where position u of the chunk lives in the pool
    const int u_l = lane % kChunk;
    const int pos = p0 + ci * kChunk + u_l;
    const int j = pos / bs;
    int blk = j < nb ? tbl[static_cast<int64_t>(b) * nb + j] : 0;
    blk = min(max(blk, 0), P - 1);
    const int64_t my_off =
        ((static_cast<int64_t>(blk) * bs + (pos - j * bs)) * Kv + h) * D;
    const int n_here = min(kChunk, n_pos - ci * kChunk);  // live positions

    float kr[kChunk][DPL], vr[kChunk][DPL];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int64_t off = __shfl_sync(0xffffffffu, my_off, u);
      if (u < n_here && d0 < D) {
        if (vec) {
          load_lane<T, DPL>(k_pool + off + d0, kr[u]);
          load_lane<T, DPL>(v_pool + off + d0, vr[u]);
        } else {
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const bool in = d0 + i < D;
            kr[u][i] = in ? to_float(k_pool[off + d0 + i]) : 0.f;
            vr[u][i] = in ? to_float(v_pool[off + d0 + i]) : 0.f;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }

#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        float qv[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          qv[i] = d0 + i < D ? q_s[g * D + d0 + i] : 0.f;
        float sc[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) dot += qv[i] * kr[u][i];
          sc[u] = dot;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int u = 0; u < kChunk; ++u)
            sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
        }
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          sc[u] = u < n_here ? sc[u] * scale : kNegInf;
          mx = fmaxf(mx, sc[u]);
        }
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        float psum = 0.f, pv[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) pv[i] = 0.f;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const float p = u < n_here ? expf(sc[u] - m_new) : 0.f;
          psum += p;
#pragma unroll
          for (int i = 0; i < DPL; ++i) pv[i] += p * vr[u][i];
        }
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = acc[g][i] * alpha + pv[i];
      }
    }
  }

  // merge the warps' states in warp order
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        if (d0 + i < D) acc_s[(warp * G + g) * D + d0 + i] = acc[g][i];
      if (lane == 0) {
        m_s[warp * G + g] = m[g];
        l_s[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();
  const int64_t po = static_cast<int64_t>(bk) * splits + s;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + g]);
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w)
      o += acc_s[w * G * D + i] * expf(m_s[w * G + g] - mx);
    acc_out[po * G * D + i] = o;
  }
  for (int g = tid; g < G; g += kThreads) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + g]);
    float lt = 0.f;
    for (int w = 0; w < kWarps; ++w)
      lt += l_s[w * G + g] * expf(m_s[w * G + g] - mx);
    m_out[po * G + g] = mx;
    l_out[po * G + g] = lt;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine_kernel(const float* __restrict__ acc,  // (B*Kv, S, G, D)
                            const float* __restrict__ m,    // (B*Kv, S, G)
                            const float* __restrict__ l,    // (B*Kv, S, G)
                            T* __restrict__ out,            // (B*Kv, G, D)
                            int splits, int G, int D) {
  const int64_t bk = blockIdx.x;
  for (int i = threadIdx.x; i < G * D; i += kCombineThreads) {
    const int g = i / D, dd = i - g * D;
    float m_max = kNegInf;
    for (int s = 0; s < splits; ++s) m_max = fmaxf(m_max, m[(bk * splits + s) * G + g]);
    float l_tot = 0.f, o = 0.f;
    for (int s = 0; s < splits; ++s) {
      const int64_t ps = (bk * splits + s) * G + g;
      const float alpha = expf(m[ps] - m_max);   // empty splits: l = 0, acc = 0
      l_tot += l[ps] * alpha;
      o += acc[ps * D + dd] * alpha;
    }
    out[(bk * G + g) * D + dd] = from_float<T>(o / fmaxf(l_tot, 1e-30f));
  }
}

int split_smem_bytes(int G, int D) {
  return (G * D + kWarps * G * D + 2 * kWarps * G) *
         static_cast<int>(sizeof(float));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

struct SplitArgs {
  const void *q, *k_pool, *v_pool, *tbl, *ctx;
  void *acc, *m, *l;
  int B, Kv, G, D, P, bs, nb, splits, bps;
  float scale;
};

template <typename T, int GM, int DPL>
cudaError_t launch_split_tile(const SplitArgs& a, cudaStream_t st) {
  const int smem = split_smem_bytes(a.G, a.D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_split_kernel<T, GM, DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  // 16-byte vector loads need every lane's first column on its boundary
  const int vec = a.D % DPL == 0 && aligned16(a.k_pool) && aligned16(a.v_pool);
  if (a.B > 0)
    flash_decode_split_kernel<T, GM, DPL>
        <<<dim3(a.B * a.Kv, a.splits), kThreads, smem, st>>>(
            static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
            static_cast<const T*>(a.v_pool), static_cast<const int*>(a.tbl),
            static_cast<const int*>(a.ctx), static_cast<float*>(a.acc),
            static_cast<float*>(a.m), static_cast<float*>(a.l), a.Kv, a.G,
            a.D, a.P, a.bs, a.nb, a.splits, a.bps, a.scale, vec);
  return cudaGetLastError();
}

template <typename T, int GM>
cudaError_t launch_split_g(const SplitArgs& a, cudaStream_t st) {
  if (a.D <= 64) return launch_split_tile<T, GM, 2>(a, st);
  if (a.D <= 128) return launch_split_tile<T, GM, 4>(a, st);
  return launch_split_tile<T, GM, 8>(a, st);
}

template <typename T>
int launch_split(const SplitArgs& a, void* stream) {
  if (a.G < 1 || a.G > kMaxG || a.D < 1 || a.D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a.G == 1) e = launch_split_g<T, 1>(a, st);
  else if (a.G == 2) e = launch_split_g<T, 2>(a, st);
  else if (a.G <= 4) e = launch_split_g<T, 4>(a, st);
  else if (a.G <= 8) e = launch_split_g<T, 8>(a, st);
  else e = launch_split_g<T, 16>(a, st);
  return static_cast<int>(e);
}

template <typename T>
int launch_combine(const void* acc, const void* m, const void* l, void* out,
                   int BKv, int splits, int G, int D, void* stream) {
  if (BKv > 0)
    flash_decode_combine_kernel<T><<<BKv, kCombineThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(acc), static_cast<const float*>(m),
        static_cast<const float*>(l), static_cast<T*>(out), splits, G, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, 1, H=Kv*G, D), pools (P, bs, Kv, D) in the named type; tbl (B, nb)
// and ctx (B,) int32; partials acc (B*Kv, splits, G, D), m and l
// (B*Kv, splits, G) f32; all contiguous.  Each returns cudaGetLastError()
// right after its launch.
extern "C" int flash_decode_split_f32(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tbl,
                                      const void* ctx, void* acc, void* m,
                                      void* l, int B, int Kv, int G, int D,
                                      int P, int bs, int nb, int splits,
                                      int bps, float scale, void* stream) {
  return launch_split<float>({q, k_pool, v_pool, tbl, ctx, acc, m, l, B, Kv,
                              G, D, P, bs, nb, splits, bps, scale},
                             stream);
}

extern "C" int flash_decode_split_bf16(const void* q, const void* k_pool,
                                       const void* v_pool, const void* tbl,
                                       const void* ctx, void* acc, void* m,
                                       void* l, int B, int Kv, int G, int D,
                                       int P, int bs, int nb, int splits,
                                       int bps, float scale, void* stream) {
  return launch_split<__nv_bfloat16>({q, k_pool, v_pool, tbl, ctx, acc, m, l,
                                      B, Kv, G, D, P, bs, nb, splits, bps,
                                      scale},
                                     stream);
}

// out (B, 1, H, D) in the named type.
extern "C" int flash_decode_combine_f32(const void* acc, const void* m,
                                        const void* l, void* out, int BKv,
                                        int splits, int G, int D,
                                        void* stream) {
  return launch_combine<float>(acc, m, l, out, BKv, splits, G, D, stream);
}

extern "C" int flash_decode_combine_bf16(const void* acc, const void* m,
                                         const void* l, void* out, int BKv,
                                         int splits, int G, int D,
                                         void* stream) {
  return launch_combine<__nv_bfloat16>(acc, m, l, out, BKv, splits, G, D,
                                       stream);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
