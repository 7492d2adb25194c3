// Flash attention for training on Hopper (sm_90a): the forward (o and the
// logsumexp residual) and the FlashAttention-2 backward as two kernels.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//
//   flash_fwd_kernel      _flash_kernel (called from _flash_forward).
//                         Grid (q blocks, H, B): one CTA per 64 query rows
//                         of one head walks the kv blocks in a loop with a
//                         running (m, l, acc) online softmax and writes
//                         o = acc / max(l, 1e-30) and lse = m + log(max(l,
//                         1e-30)); the TPU carried (m, l, acc) across a
//                         sequential grid axis in VMEM scratch.
//   flash_bwd_dq_kernel   _flash_bwd_dq_kernel (from _flash_backward).
//                         Grid (q blocks, H, B): p = exp(s - lse),
//                         ds = p * (dp - delta) * scale, dq += ds k.
//   flash_bwd_dkv_kernel  _flash_bwd_dkv_kernel.  Grid (kv blocks, Kv, B):
//                         one CTA per 64 kv rows of one kv head loops over
//                         the G query heads of that kv head and their q
//                         blocks (the TPU's flattened (group, q block)
//                         sequential axis): dv += p^T do, dk += ds^T q.
//                         dk/dv stay in registers; no atomics, so the result
//                         is the same bits from run to run.
//
// Layouts are the JAX package's: q, o, do (B, S, H, D); k, v (B, S, Kv, D);
// query head h reads kv head h / G (GQA by index arithmetic, no repeated
// K/V); lse and delta (B, H, S) f32.  Masks as _block_mask: key position
// < S, causal k <= q, window k > q - window; query rows >= S are masked
// too and never written.  The TPU pads S up to a block multiple and visits
// every block; here each CTA masks the ragged edge itself (rows past S are
// zero-filled in shared memory) and loops only over the blocks that the
// causal and window bounds leave visible.  A fully masked block is an
// exact no-op of the online update (alpha = 1, p = 0), so the bounds change
// no number.
//
// Bound on the H100: operations.  At the training shape (S 512, D 128) the
// causal forward does ~S/2 * D * 4 operations per query row against ~D * 4
// bytes read per row: far above the f32 ridge (~20 operations per byte).
// The inputs may be bf16, but all products are f32 FMAs outside the tensor
// cores (the f32 training path must not round through TF32), so the peak
// that bounds it is the 67 TFLOP/s f32 SIMT rate.  The design keeps every
// tile of a CTA in shared memory as f32 (64 rows x (D + 1): the odd row
// stride makes both the row-wise and the column-wise reads of one layout
// free of bank conflicts, so no transposed copy is needed), and each of the
// 256 threads computes a 4 x 4 piece of the 64 x 64 score tile and a
// 4 x (D / 16) piece of each 64 x D output, rows ty + 16 a and columns
// tx + 16 b.  Shared memory per CTA (D 128): forward 116 KB, dq 149 KB,
// dk/dv 166 KB, so the launch raises the dynamic limit first.  Tensor-core
// products for bf16 (wgmma) and TMA double buffering are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 64;           // query rows and kv rows per tile
constexpr int kLdP = kBlock + 1;     // row stride of the 64 x 64 tiles
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

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  bool m = kp < S && qp < S;
  if (causal) m = m && kp <= qp;
  if (window) m = m && kp > qp - window;
  return m;
}

// 64 rows starting at row0 of a (.., S, heads, D) tensor (src points at the
// row-0 element of the head) -> dst [64][D + 1] f32; rows >= S read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int S) {
  for (int e = threadIdx.x; e < kBlock * D; e += kThreads) {
    const int r = e / D, c = e % D, s = row0 + r;
    dst[r * (D + 1) + c] =
        s < S ? to_float(src[static_cast<int64_t>(s) * row_stride + c]) : 0.f;
  }
}

// max and sum over the 16 lanes (tx) that share a row
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int Kv, int causal,
                 int window, float scale) {
  constexpr int DC = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [64][LD]
  float* k_s = q_s + kBlock * LD;      // [64][LD]
  float* v_s = k_s + kBlock * LD;      // [64][LD]
  float* p_s = v_s + kBlock * LD;      // [64][kLdP] probabilities

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qb * kBlock;
  const int64_t q_rs = static_cast<int64_t>(H) * D;
  const int64_t k_rs = static_cast<int64_t>(Kv) * D;
  const int64_t q_base = (static_cast<int64_t>(b) * S * H + h) * D;
  const int64_t k_base = (static_cast<int64_t>(b) * S * Kv + kvh) * D;

  load_tile<T, D>(q_s, q + q_base, q_rs, q0, S);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  const int q_last = min(q0 + kBlock, S) - 1;
  const int kb_end = causal ? q_last / kBlock + 1 : (S + kBlock - 1) / kBlock;
  const int first = q0 - window + 1;
  const int kb_begin = (window && first > 0) ? first / kBlock : 0;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();                   // the last block's tiles are done
    load_tile<T, D>(k_s, k + k_base, k_rs, k0, S);
    load_tile<T, D>(v_s, v + k_base, k_rs, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qa[4], kj[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = q_s[(ty + 16 * a) * LD + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kj[j] = k_s[(tx + 16 * j) * LD + dd];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] += qa[a] * kj[j];
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qp = q0 + ty + 16 * a;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[a][j] = visible(qp, k0 + tx + 16 * j, S, causal, window)
                      ? s[a][j] * scale : kNegInf;
        mx = fmaxf(mx, s[a][j]);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      const float alpha = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(qp, k0 + tx + 16 * j, S, causal, window)
                            ? expf(s[a][j] - m_new) : 0.f;
        p_s[(ty + 16 * a) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
      l[a] = l[a] * alpha + row_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float pa[4], vc[DC];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = p_s[(ty + 16 * a) * kLdP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vc[c] = v_s[j * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] += pa[a] * vc[c];
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + ty + 16 * a;
    if (qp >= S) continue;
    const float denom = fmaxf(l[a], 1e-30f);
    T* orow = o + q_base + static_cast<int64_t>(qp) * q_rs;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      orow[tx + 16 * c] = from_float<T>(acc[a][c] / denom);
    if (tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + qp] = m[a] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// backward: dq (q-block-major)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int Kv, int causal, int window,
                    float scale) {
  constexpr int DC = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [64][LD]
  float* do_s = q_s + kBlock * LD;     // [64][LD]
  float* k_s = do_s + kBlock * LD;     // [64][LD]
  float* v_s = k_s + kBlock * LD;      // [64][LD]
  float* ds_s = v_s + kBlock * LD;     // [64][kLdP]

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qb * kBlock;
  const int64_t q_rs = static_cast<int64_t>(H) * D;
  const int64_t k_rs = static_cast<int64_t>(Kv) * D;
  const int64_t q_base = (static_cast<int64_t>(b) * S * H + h) * D;
  const int64_t k_base = (static_cast<int64_t>(b) * S * Kv + kvh) * D;
  const int64_t r_base = (static_cast<int64_t>(b) * H + h) * S;

  load_tile<T, D>(q_s, q + q_base, q_rs, q0, S);
  load_tile<T, D>(do_s, dout + q_base, q_rs, q0, S);
  float lse_r[4], delta_r[4], acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + ty + 16 * a;
    lse_r[a] = qp < S ? lse[r_base + qp] : 0.f;
    delta_r[a] = qp < S ? delta[r_base + qp] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  const int q_last = min(q0 + kBlock, S) - 1;
  const int kb_end = causal ? q_last / kBlock + 1 : (S + kBlock - 1) / kBlock;
  const int first = q0 - window + 1;
  const int kb_begin = (window && first > 0) ? first / kBlock : 0;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();
    load_tile<T, D>(k_s, k + k_base, k_rs, k0, S);
    load_tile<T, D>(v_s, v + k_base, k_rs, k0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = dp[a][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < D; ++dd) {
      float qa[4], da[4], kj[4], vj[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qa[a] = q_s[(ty + 16 * a) * LD + dd];
        da[a] = do_s[(ty + 16 * a) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kj[j] = k_s[(tx + 16 * j) * LD + dd];
        vj[j] = v_s[(tx + 16 * j) * LD + dd];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[a][j] += qa[a] * kj[j];
          dp[a][j] += da[a] * vj[j];
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qp = q0 + ty + 16 * a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(qp, k0 + tx + 16 * j, S, causal, window)
                            ? expf(s[a][j] * scale - lse_r[a]) : 0.f;
        ds_s[(ty + 16 * a) * kLdP + tx + 16 * j] =
            p * (dp[a][j] - delta_r[a]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float sa[4], kc[DC];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = ds_s[(ty + 16 * a) * kLdP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kc[c] = k_s[j * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] += sa[a] * kc[c];
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + ty + 16 * a;
    if (qp >= S) continue;
    T* row = dq + q_base + static_cast<int64_t>(qp) * q_rs;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 16 * c] = from_float<T>(acc[a][c]);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv (kv-block-major, the G query heads folded into the loop)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int Kv, int causal,
                     int window, float scale) {
  constexpr int DC = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                   // [64][LD] this CTA's kv rows
  float* v_s = k_s + kBlock * LD;      // [64][LD]
  float* q_s = v_s + kBlock * LD;      // [64][LD] the current q block
  float* do_s = q_s + kBlock * LD;     // [64][LD]
  float* p_s = do_s + kBlock * LD;     // [64 kv][kLdP] p^T
  float* ds_s = p_s + kBlock * kLdP;   // [64 kv][kLdP] ds^T
  float* lse_s = ds_s + kBlock * kLdP; // [64]
  float* delta_s = lse_s + kBlock;     // [64]

  const int kb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = kb * kBlock;
  const int64_t q_rs = static_cast<int64_t>(H) * D;
  const int64_t k_rs = static_cast<int64_t>(Kv) * D;
  const int64_t k_base = (static_cast<int64_t>(b) * S * Kv + kvh) * D;

  load_tile<T, D>(k_s, k + k_base, k_rs, k0, S);
  load_tile<T, D>(v_s, v + k_base, k_rs, k0, S);
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  const int nq = (S + kBlock - 1) / kBlock;
  const int k_last = min(k0 + kBlock, S) - 1;
  const int qb_begin = causal ? k0 / kBlock : 0;
  const int qb_end = window ? min(nq, (k_last + window - 1) / kBlock + 1) : nq;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t q_base = (static_cast<int64_t>(b) * S * H + h) * D;
    const int64_t r_base = (static_cast<int64_t>(b) * H + h) * S;
    for (int qb = qb_begin; qb < qb_end; ++qb) {
      const int q0 = qb * kBlock;
      __syncthreads();
      load_tile<T, D>(q_s, q + q_base, q_rs, q0, S);
      load_tile<T, D>(do_s, dout + q_base, q_rs, q0, S);
      if (threadIdx.x < kBlock) {
        const int qp = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qp < S ? lse[r_base + qp] : 0.f;
        delta_s[threadIdx.x] = qp < S ? delta[r_base + qp] : 0.f;
      }
      __syncthreads();

      // s^T and dp^T: rows are this CTA's kv positions, columns q rows
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[a][j] = dpt[a][j] = 0.f;
#pragma unroll 2
      for (int dd = 0; dd < D; ++dd) {
        float ka[4], va[4], qj[4], dj[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ka[a] = k_s[(ty + 16 * a) * LD + dd];
          va[a] = v_s[(ty + 16 * a) * LD + dd];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qj[j] = q_s[(tx + 16 * j) * LD + dd];
          dj[j] = do_s[(tx + 16 * j) * LD + dd];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[a][j] += ka[a] * qj[j];
            dpt[a][j] += va[a] * dj[j];
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int kp = k0 + ty + 16 * a;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const float p = visible(q0 + r, kp, S, causal, window)
                              ? expf(st[a][j] * scale - lse_s[r]) : 0.f;
          p_s[(ty + 16 * a) * kLdP + r] = p;
          ds_s[(ty + 16 * a) * kLdP + r] = p * (dpt[a][j] - delta_s[r]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int r = 0; r < kBlock; ++r) {
        float pa[4], sa[4], dor[DC], qr[DC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = p_s[(ty + 16 * a) * kLdP + r];
          sa[a] = ds_s[(ty + 16 * a) * kLdP + r];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dor[c] = do_s[r * LD + tx + 16 * c];
          qr[c] = q_s[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[a][c] += pa[a] * dor[c];
            dk_acc[a][c] += sa[a] * qr[c];
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kp = k0 + ty + 16 * a;
    if (kp >= S) continue;
    const int64_t off = k_base + static_cast<int64_t>(kp) * k_rs;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + 16 * c] = from_float<T>(dk_acc[a][c]);
      dv[off + tx + 16 * c] = from_float<T>(dv_acc[a][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D> constexpr size_t fwd_smem() {
  return (3 * kBlock * (D + 1) + kBlock * kLdP) * sizeof(float);
}
template <int D> constexpr size_t dq_smem() {
  return (4 * kBlock * (D + 1) + kBlock * kLdP) * sizeof(float);
}
template <int D> constexpr size_t dkv_smem() {
  return (4 * kBlock * (D + 1) + 2 * kBlock * kLdP + 2 * kBlock) *
         sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int S, int H, int Kv, int causal, int window, float scale,
        cudaStream_t st) {
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, fwd_smem<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + kBlock - 1) / kBlock, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, fwd_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, Kv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int S, int H,
           int Kv, int causal, int window, float scale, cudaStream_t st) {
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, dq_smem<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + kBlock - 1) / kBlock, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, dq_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, H, Kv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int B,
            int S, int H, int Kv, int causal, int window, float scale,
            cudaStream_t st) {
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, D>, dkv_smem<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + kBlock - 1) / kBlock, Kv, B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, dkv_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, Kv, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// head dims with a compiled kernel (those of the port's configs); anything
// else is refused
#define FLASH_DISPATCH_D(D, CALL)                                     \
  switch (D) {                                                        \
    case 128: { constexpr int kD = 128; return CALL; }                \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }

template <typename T>
int fwd_any(const void* q, const void* k, const void* v, void* o, void* lse,
            int B, int S, int H, int Kv, int D, int causal, int window,
            float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, (fwd<T, kD>(q, k, v, o, lse, B, S, H, Kv, causal,
                                  window, scale, st)))
}

template <typename T>
int dq_any(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int S, int H,
           int Kv, int D, int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, (bwd_dq<T, kD>(q, k, v, dout, lse, delta, dq, B, S, H,
                                     Kv, causal, window, scale, st)))
}

template <typename T>
int dkv_any(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int B,
            int S, int H, int Kv, int D, int causal, int window, float scale,
            void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, (bwd_dkv<T, kD>(q, k, v, dout, lse, delta, dk, dv, B,
                                      S, H, Kv, causal, window, scale, st)))
}

}  // namespace

// Forward: q, o (B, S, H, D) and k, v (B, S, Kv, D) in the named type;
// lse (B, H, S) f32; all contiguous.  Returns cudaGetLastError() right
// after the launch (cudaErrorInvalidValue for a head dim with no kernel).
extern "C" int flash_attn_fwd_f32(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int B,
                                  int S, int H, int Kv, int D, int causal,
                                  int window, float scale, void* stream) {
  return fwd_any<float>(q, k, v, o, lse, B, S, H, Kv, D, causal, window,
                        scale, stream);
}

extern "C" int flash_attn_fwd_bf16(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int S, int H, int Kv, int D, int causal,
                                   int window, float scale, void* stream) {
  return fwd_any<__nv_bfloat16>(q, k, v, o, lse, B, S, H, Kv, D, causal,
                                window, scale, stream);
}

// Backward dq: dout and dq as q; lse and delta (B, H, S) f32.
extern "C" int flash_attn_dq_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int S,
                                 int H, int Kv, int D, int causal, int window,
                                 float scale, void* stream) {
  return dq_any<float>(q, k, v, dout, lse, delta, dq, B, S, H, Kv, D, causal,
                       window, scale, stream);
}

extern "C" int flash_attn_dq_bf16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int B, int S, int H, int Kv,
                                  int D, int causal, int window, float scale,
                                  void* stream) {
  return dq_any<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, S, H, Kv, D,
                               causal, window, scale, stream);
}

// Backward dk/dv: dk and dv as k.
extern "C" int flash_attn_dkv_f32(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int S, int H,
                                  int Kv, int D, int causal, int window,
                                  float scale, void* stream) {
  return dkv_any<float>(q, k, v, dout, lse, delta, dk, dv, B, S, H, Kv, D,
                        causal, window, scale, stream);
}

extern "C" int flash_attn_dkv_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int S, int H,
                                   int Kv, int D, int causal, int window,
                                   float scale, void* stream) {
  return dkv_any<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                                Kv, D, causal, window, scale, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
