// Chunked WKV-6 forward (RWKV-6 "Finch" time mix) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py::_wkv_kernel (called
// from _wkv6_forward).  Per (batch, head), from a zero state S (N x N, key
// channel n -> value channel m), over chunks of C tokens:
//
//   lw = log(max(w, 1e-12)),  lc = inclusive cumsum of lw along the chunk
//   qp = r * exp(lc - lw),    kp = k * exp(-lc)
//   A  = qp kp^T, strictly lower triangular
//   y  = (A v + diag(sum_n r u k) v) + qp S
//   S <- exp(lc_C)^T o S + (k * exp(lc_C - lc))^T v
//
// in that order of rounding (log, cumsum, then exp), as the TPU kernel and
// the port's plain version (kernels/wkv6.py::wkv6_plain) compute it.  y is
// written in r's type, the final state in f32.
//
// Bound on the H100: bytes at the training shape (about 2*C*N + 4*N*N f32
// operations per token and head against 4*N values read and N written).
// The TPU grid (B*H, n_chunks) ran the chunk axis in order on one core; CTAs
// run in parallel and in no order, so one CTA takes one (b, h) and loops
// over the chunks itself, keeping the f32 state in shared memory (16 KB at
// N 64) for the whole sequence.  The four (C, N) input tiles are read
// straight from the (B, T, H, N) layout (stride H*N between tokens), so the
// TPU wrapper's transpose and padding copies are gone: rows past T are
// identity steps (w = 1, k = r = v = 0) and write nothing.  Tiles are f32 in
// shared memory with an odd row stride (N + 1), so column walks over
// different rows fall in different banks.  All arithmetic is f32 with logf
// and expf (no fast math).  A simple kernel: scalar FMAs from shared memory,
// one thread per channel for the cumsum; wgmma, TMA and more CTAs per head
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kN = 64;            // head dim the kernel is compiled for
constexpr int kLd = kN + 1;       // row stride of the (C, N) tiles

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
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <int C>
constexpr int smem_floats() {
  // R, K, V, W tiles; S; A (C x (C + 1)); diag; decay
  return 4 * C * kLd + kN * kN + C * (C + 1) + C + kN;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, T* __restrict__ y,
                float* __restrict__ s_out, int T_len, int H) {
  extern __shared__ float smem[];
  float* R = smem;               // r, then qp
  float* K = R + C * kLd;        // k, then k * exp(lc_C - lc)
  float* V = K + C * kLd;
  float* W = V + C * kLd;        // w, then lc, then kp
  float* S = W + C * kLd;        // state, row n = key channel
  float* A = S + kN * kN;        // C x (C + 1)
  float* diag = A + C * (C + 1);
  float* decay = diag + C;       // exp(lc_C) per key channel

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int64_t tok = static_cast<int64_t>(H) * kN;       // token stride
  const int64_t base = static_cast<int64_t>(b) * T_len * tok + h * kN;
  const float* uh = u + h * kN;

  for (int i = tid; i < kN * kN; i += kThreads) S[i] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += C) {
    // 1. the four tiles; rows past T are identity steps
    for (int i = tid; i < C * kN; i += kThreads) {
      const int t = i / kN, n = i % kN;
      const bool live = t0 + t < T_len;
      const int64_t off = base + (t0 + t) * tok + n;
      R[t * kLd + n] = live ? to_float(r[off]) : 0.f;
      K[t * kLd + n] = live ? to_float(k[off]) : 0.f;
      V[t * kLd + n] = live ? to_float(v[off]) : 0.f;
      W[t * kLd + n] = live ? w[off] : 1.f;
    }
    __syncthreads();

    // 2. the u diagonal: one warp per row, sum over n of (r * u) * k
    for (int t = warp; t < C; t += kThreads / 32) {
      float s = 0.f;
      for (int n = lane; n < kN; n += 32)
        s += R[t * kLd + n] * uh[n] * K[t * kLd + n];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) diag[t] = s;
    }
    __syncthreads();

    // 3. one thread per channel: log, inclusive cumsum, then the exps
    if (tid < kN) {
      const int n = tid;
      float lc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = logf(fmaxf(W[t * kLd + n], 1e-12f));
        lc = lc + lw;
        W[t * kLd + n] = lc;
        R[t * kLd + n] = R[t * kLd + n] * expf(lc - lw);
      }
      const float lc_tot = lc;
      decay[n] = expf(lc_tot);
      for (int t = 0; t < C; ++t) {
        const float l = W[t * kLd + n], kk = K[t * kLd + n];
        W[t * kLd + n] = kk * expf(-l);
        K[t * kLd + n] = kk * expf(lc_tot - l);
      }
    }
    __syncthreads();

    // 4. A = qp kp^T below the diagonal (zero on and above it)
    for (int i = tid; i < C * C; i += kThreads) {
      const int ti = i / C, tj = i % C;
      float a = 0.f;
      if (tj < ti) {
        for (int n = 0; n < kN; ++n) a += R[ti * kLd + n] * W[tj * kLd + n];
      }
      A[ti * (C + 1) + tj] = a;
    }
    __syncthreads();

    // 5. y = (A v + diag v) + qp S, rows inside T only
    for (int i = tid; i < C * kN; i += kThreads) {
      const int t = i / kN, m = i % kN;
      float av = 0.f;
      for (int j = 0; j < t; ++j) av += A[t * (C + 1) + j] * V[j * kLd + m];
      av = av + diag[t] * V[t * kLd + m];
      float qs = 0.f;
      for (int n = 0; n < kN; ++n) qs += R[t * kLd + n] * S[n * kN + m];
      if (t0 + t < T_len)
        y[base + (t0 + t) * tok + m] = from_float<T>(av + qs);
    }
    __syncthreads();

    // 6. S <- exp(lc_C) o S + k_tail^T v
    for (int i = tid; i < kN * kN; i += kThreads) {
      const int n = i / kN, m = i % kN;
      float kv = 0.f;
      for (int t = 0; t < C; ++t) kv += K[t * kLd + n] * V[t * kLd + m];
      S[i] = decay[n] * S[i] + kv;
    }
    __syncthreads();
  }

  float* so = s_out + static_cast<int64_t>(blockIdx.x) * kN * kN;
  for (int i = tid; i < kN * kN; i += kThreads) so[i] = S[i];
}

template <typename T, int C>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, void* s_out, int B, int T_len, int H,
           cudaStream_t st) {
  constexpr int bytes = smem_floats<C>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_fwd_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv6_fwd_kernel<T, C><<<B * H, kThreads, bytes, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<T*>(y),
      static_cast<float*>(s_out), T_len, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_any(const void* r, const void* k, const void* v, const void* w,
            const void* u, void* y, void* s_out, int B, int T_len, int H,
            int N, int chunk, void* stream) {
  if (N != kN) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16: return launch<T, 16>(r, k, v, w, u, y, s_out, B, T_len, H, st);
    case 32: return launch<T, 32>(r, k, v, w, u, y, s_out, B, T_len, H, st);
    case 64: return launch<T, 64>(r, k, v, w, u, y, s_out, B, T_len, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v, y (B, T, H, N) in the named type; w (B, T, H, N) and u (H, N)
// f32; s_out (B, H, N, N) f32; all contiguous.  N must be 64 and chunk one
// of 16, 32, 64 (cudaErrorInvalidValue otherwise).  A chunk longer than T
// runs as one chunk of T (the rows past T are identity steps).  Returns
// cudaGetLastError() right after the launch.
extern "C" int wkv6_fwd_f32(const void* r, const void* k, const void* v,
                            const void* w, const void* u, void* y,
                            void* s_out, int B, int T, int H, int N,
                            int chunk, void* stream) {
  return fwd_any<float>(r, k, v, w, u, y, s_out, B, T, H, N, chunk, stream);
}

extern "C" int wkv6_fwd_bf16(const void* r, const void* k, const void* v,
                             const void* w, const void* u, void* y,
                             void* s_out, int B, int T, int H, int N,
                             int chunk, void* stream) {
  return fwd_any<__nv_bfloat16>(r, k, v, w, u, y, s_out, B, T, H, N, chunk,
                                stream);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
