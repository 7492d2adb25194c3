// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (called from _rmsnorm_forward): y = x * rsqrt(mean(x^2) + eps) * scale,
// accumulated in f32 whatever the input type, y written in x's type, and the
// per-row rstd written in f32 so the backward can reuse it.
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

}  // namespace

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
