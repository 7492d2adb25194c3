// RMSNorm forward and backward for Hopper (sm_90a).
//
// Forward: replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (called from _rmsnorm_forward): y = x * rsqrt(mean(x^2) + eps) * scale,
// accumulated in f32 whatever the input type, y written in x's type, and the
// per-row rstd written in f32 so the backward can reuse it.
//
// Backward: replaces src/repro/kernels/rmsnorm.py::_rmsnorm_bwd_kernel
// (called from _rmsnorm_backward): with c = mean(g*s*x) per row,
// dx = rstd * (g*s - x * rstd^2 * c), and dscale = sum over rows of
// g * x * rstd.  The TPU kernel accumulates dscale in an output block that
// its sequential grid revisits; CTAs run in parallel, so here each CTA
// (kBwdRows rows) writes its own partial row of dscale and a second small
// kernel sums the partials in a fixed order: deterministic, no atomics.
// Bound: bytes, as the forward (x and g read, dx written, a few operations
// per element); the partials add n / kBwdRows * d * 4 bytes each way.
//
// Bound on the H100: bytes.  Each element is read once, squared and summed,
// then scaled and written: a few operations per 4 or 2 bytes, far below the
// card's ~20 f32 operations per byte.  The design therefore moves each byte
// once from device memory: one CTA per row, the row's second read (the
// scale pass) hits L1/L2 right after the first, neighbouring threads touch
// neighbouring elements (coalesced), and the ragged edge of any width d is
// handled by the strided loop bound (no lane-alignment rule, unlike the
// TPU's d % 128 == 0).  Vector loads and several rows per CTA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, float* __restrict__ rstd, int d,
                   float eps) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float row_rstd;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_float(xr[i]);
    ss += v * v;
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) {
      const float r = rsqrtf(t / static_cast<float>(d) + eps);
      row_rstd = r;
      rstd[row] = r;
    }
  }
  __syncthreads();
  const float r = row_rstd;
  for (int i = threadIdx.x; i < d; i += kThreads)
    yr[i] = from_float<T>(to_float(xr[i]) * r * scale[i]);
}

template <typename T>
int launch(const void* x, const void* scale, void* y, void* rstd, int n,
           int d, float eps, void* stream) {
  if (n > 0 && d > 0)
    rmsnorm_fwd_kernel<T><<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<T*>(y), static_cast<float*>(rstd), d, eps);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBwdRows = 16;  // rows per CTA of the backward (one partial)

// Sum of v over the CTA, returned to every thread; ws holds kThreads/32.
__device__ __forceinline__ float block_sum(float v, float* ws) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  float t = lane < kThreads / 32 ? ws[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  __syncthreads();  // ws is reused by the next call
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ rstd, const T* __restrict__ g,
                   T* __restrict__ dx, float* __restrict__ partial, int n,
                   int d) {
  extern __shared__ float part[];  // d: this CTA's dscale partial
  __shared__ float warp_sums[kThreads / 32];
  const int r0 = blockIdx.x * kBwdRows;
  const int r1 = min(r0 + kBwdRows, n);
  // each thread owns columns tid, tid + kThreads, ...: no sync on part
  for (int i = threadIdx.x; i < d; i += kThreads) part[i] = 0.f;
  for (int row = r0; row < r1; ++row) {
    const int64_t off = static_cast<int64_t>(row) * d;
    const float r = rstd[row];
    float acc = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float xv = to_float(x[off + i]), gv = to_float(g[off + i]);
      acc += gv * scale[i] * xv;
      part[i] += gv * xv * r;
    }
    const float c = block_sum(acc, warp_sums) / static_cast<float>(d);
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float xv = to_float(x[off + i]);
      const float gs = to_float(g[off + i]) * scale[i];
      dx[off + i] = from_float<T>(r * (gs - xv * (r * r) * c));
    }
  }
  float* out = partial + static_cast<int64_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += kThreads) out[i] = part[i];
}

// dscale[i] = sum over the partials p = 0, 1, ... of partial[p, i], in order
__global__ void __launch_bounds__(kThreads)
rmsnorm_dscale_reduce_kernel(const float* __restrict__ partial,
                             float* __restrict__ dscale, int n_parts, int d) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= d) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += partial[static_cast<int64_t>(p) * d + i];
  dscale[i] = s;
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* rstd,
               const void* g, void* dx, void* partial, void* dscale, int n,
               int d, void* stream) {
  if (d <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_parts = (n + kBwdRows - 1) / kBwdRows;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (n_parts > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    rmsnorm_bwd_kernel<T><<<n_parts, kThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(rstd), static_cast<const T*>(g),
        static_cast<T*>(dx), static_cast<float*>(partial), n, d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rmsnorm_dscale_reduce_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0,
                                 st>>>(static_cast<const float*>(partial),
                                       static_cast<float*>(dscale), n_parts,
                                       d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Backward: x, g, dx (n, d) in the named type; scale (d,), rstd (n,),
// partial (ceil(n / 16), d) scratch and dscale (d,) in f32; all contiguous.
// Launches the row kernel, then the partials' reduce.
extern "C" int rmsnorm_bwd_f32(const void* x, const void* scale,
                               const void* rstd, const void* g, void* dx,
                               void* partial, void* dscale, int n, int d,
                               void* stream) {
  return launch_bwd<float>(x, scale, rstd, g, dx, partial, dscale, n, d,
                           stream);
}

extern "C" int rmsnorm_bwd_bf16(const void* x, const void* scale,
                                const void* rstd, const void* g, void* dx,
                                void* partial, void* dscale, int n, int d,
                                void* stream) {
  return launch_bwd<__nv_bfloat16>(x, scale, rstd, g, dx, partial, dscale, n,
                                   d, stream);
}

// x (n, d) and y (n, d) in the named type, scale (d,) f32, rstd (n,) f32;
// all contiguous.  Returns cudaGetLastError() right after the launch.
extern "C" int rmsnorm_fwd_f32(const void* x, const void* scale, void* y,
                               void* rstd, int n, int d, float eps,
                               void* stream) {
  return launch<float>(x, scale, y, rstd, n, d, eps, stream);
}

extern "C" int rmsnorm_fwd_bf16(const void* x, const void* scale, void* y,
                                void* rstd, int n, int d, float eps,
                                void* stream) {
  return launch<__nv_bfloat16>(x, scale, y, rstd, n, d, eps, stream);
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
