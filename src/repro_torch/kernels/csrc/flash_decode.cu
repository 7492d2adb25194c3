// Split-K GQA flash-decode over a paged KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::_decode_kernel
// (called from flash_decode) and the jnp logsumexp merge that follows it
// there (flash_decode.py:147-153), as two kernels:
//
//   flash_decode_split_kernel   grid (B*Kv, splits), one CTA per
//                               (request * kv head, K-split).  The CTA reads
//                               its pool block ids from the block table
//                               itself (the TPU fed them to the DMA engine
//                               as scalar-prefetch operands), stages each
//                               block's K and V (bs x D) in shared memory as
//                               f32, scores the G query heads of its kv head
//                               against them, and keeps a running
//                               (m, l, acc) online softmax in f32.  It writes
//                               the split's unnormalised partial.
//   flash_decode_combine_kernel grid (B*Kv), merges the splits' partials
//                               with one logsumexp rescale and writes the
//                               (B, 1, H, D) output in q's type.
//
// Numerics follow the TPU kernel: table entries < 0 are clamped to block 0
// and padded tail entries of the split plan read block 0; positions >= ctx
// are masked with NEG_INF = -1e30 and their p is exactly 0; the combine
// divides by max(l, 1e-30).  A block with no valid position is a no-op of
// the online update (alpha = 1, p = 0), so a CTA stops at the request's
// last valid block instead of walking its whole range.
//
// Bound on the H100: bytes.  Decode reads every cached K/V element once for
// one query token per head: 2 * G operations per element, so the kernel is
// memory-bound at any context length.  The design reads each needed pool
// block exactly once per kv head (the G query heads of a kv head share the
// staged tile: GQA costs no extra bytes), spreads the context over splits
// so B*Kv*splits CTAs cover the 132 SMs at small batch, and skips blocks
// past ctx.  Shared memory, not the head dimension, is what limits the
// shapes it takes: (2*G*D + 2*bs*D + G*bs + 3*G) * 4 bytes must fit the
// 227 KB a CTA may hold; any D works (lanes stride over it).  cp.async/TMA
// double buffering of the block loads is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
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

template <typename T>
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
                          int splits, int bps, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;              // G*D   query heads of this kv head
  float* k_s = q_s + G * D;       // bs*D  staged K block
  float* v_s = k_s + bs * D;      // bs*D  staged V block
  float* acc_s = v_s + bs * D;    // G*D   running numerator
  float* p_s = acc_s + G * D;     // G*bs  scores, then probabilities
  float* m_s = p_s + G * bs;      // G     running max
  float* l_s = m_s + G;           // G     running denominator
  float* a_s = l_s + G;           // G     this block's rescale factor

  const int bk = blockIdx.x;      // request * Kv + kv head
  const int s = blockIdx.y;       // K-split
  const int b = bk / Kv, h = bk - (bk / Kv) * Kv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_valid = ctx[b];

  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_float(q[static_cast<int64_t>(bk) * G * D + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  // blocks holding at least one position < n_valid; later ones are no-ops
  const int live = n_valid <= 0 ? 0 : (n_valid - 1) / bs + 1;
  const int j0 = s * bps;
  const int j1 = min(j0 + bps, live);
  for (int j = j0; j < j1; ++j) {
    int blk = j < nb ? tbl[static_cast<int64_t>(b) * nb + j] : 0;
    blk = min(max(blk, 0), P - 1);
    const int64_t base = static_cast<int64_t>(blk) * bs * Kv * D;
    for (int i = tid; i < bs * D; i += kThreads) {
      const int t = i / D, dd = i - t * D;
      const int64_t off = base + (static_cast<int64_t>(t) * Kv + h) * D + dd;
      k_s[i] = to_float(k_pool[off]);
      v_s[i] = to_float(v_pool[off]);
    }
    __syncthreads();

    // scores: one warp per (head, position) pair, lanes across D
    for (int pr = warp; pr < G * bs; pr += kWarps) {
      const int g = pr / bs, t = pr - g * bs;
      float dot = 0.f;
      for (int dd = lane; dd < D; dd += 32) dot += q_s[g * D + dd] * k_s[t * D + dd];
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) p_s[pr] = (j * bs + t < n_valid) ? dot * scale : kNegInf;
    }
    __syncthreads();

    // online softmax state: one thread per query head
    for (int g = tid; g < G; g += kThreads) {
      float mx = kNegInf;
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, p_s[g * bs + t]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = (j * bs + t < n_valid) ? expf(p_s[g * bs + t] - m_new) : 0.f;
        p_s[g * bs + t] = p;
        sum += p;
      }
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
      a_s[g] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ v
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, dd = i - g * D;
      float pv = 0.f;
      for (int t = 0; t < bs; ++t) pv += p_s[g * bs + t] * v_s[t * D + dd];
      acc_s[i] = acc_s[i] * a_s[g] + pv;
    }
    __syncthreads();
  }

  const int64_t po = static_cast<int64_t>(bk) * splits + s;
  for (int i = tid; i < G * D; i += kThreads) acc_out[po * G * D + i] = acc_s[i];
  for (int g = tid; g < G; g += kThreads) {
    m_out[po * G + g] = m_s[g];
    l_out[po * G + g] = l_s[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine_kernel(const float* __restrict__ acc,  // (B*Kv, S, G, D)
                            const float* __restrict__ m,    // (B*Kv, S, G)
                            const float* __restrict__ l,    // (B*Kv, S, G)
                            T* __restrict__ out,            // (B*Kv, G, D)
                            int splits, int G, int D) {
  const int64_t bk = blockIdx.x;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
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

int split_smem_bytes(int G, int D, int bs) {
  return (2 * G * D + 2 * bs * D + G * bs + 3 * G) * static_cast<int>(sizeof(float));
}

template <typename T>
int launch_split(const void* q, const void* k_pool, const void* v_pool,
                 const void* tbl, const void* ctx, void* acc, void* m,
                 void* l, int B, int Kv, int G, int D, int P, int bs, int nb,
                 int splits, int bps, float scale, void* stream) {
  const int smem = split_smem_bytes(G, D, bs);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_split_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (B > 0) {
    const dim3 grid(B * Kv, splits);
    flash_decode_split_kernel<T><<<grid, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), static_cast<const int*>(tbl),
        static_cast<const int*>(ctx), static_cast<float*>(acc),
        static_cast<float*>(m), static_cast<float*>(l), Kv, G, D, P, bs, nb,
        splits, bps, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_combine(const void* acc, const void* m, const void* l, void* out,
                   int BKv, int splits, int G, int D, void* stream) {
  if (BKv > 0)
    flash_decode_combine_kernel<T><<<BKv, kThreads, 0,
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
  return launch_split<float>(q, k_pool, v_pool, tbl, ctx, acc, m, l, B, Kv, G,
                             D, P, bs, nb, splits, bps, scale, stream);
}

extern "C" int flash_decode_split_bf16(const void* q, const void* k_pool,
                                       const void* v_pool, const void* tbl,
                                       const void* ctx, void* acc, void* m,
                                       void* l, int B, int Kv, int G, int D,
                                       int P, int bs, int nb, int splits,
                                       int bps, float scale, void* stream) {
  return launch_split<__nv_bfloat16>(q, k_pool, v_pool, tbl, ctx, acc, m, l,
                                     B, Kv, G, D, P, bs, nb, splits, bps,
                                     scale, stream);
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
