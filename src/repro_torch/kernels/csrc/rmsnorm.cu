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
// its sequential grid revisits; CTAs run in parallel, so here each CTA of
// kBwdRows rows writes its own partial row of dscale and a second kernel
// sums the partials in a fixed order: deterministic, no atomics.
// Bound on the H100: bytes (x and g read, dx written: 12 bytes per f32
// element for ~11 operations, against ~20 operations per byte the card
// could do).  The qwen3 training rows, f32 4096 x 1024, move 50.3 MB: 15.0
// us at 3.35 TB/s.  The first design (one CTA of 256 threads walking its 16
// rows one after another, 4 scalar columns a thread, two barriers per row,
// x and g read twice, a 4-CTA reduce) took 48.9 us there on an H100 80GB
// HBM3 at 700 W: row kernel 37.4 us, reduce 6.0 us.  This design keeps
// loads in flight and reads each byte once: a warp holds a row of up to
// 1024 columns in registers (32 values of x and 32 of g a lane, loaded as
// 16-byte vectors before any arithmetic), sums it with shuffles and no
// barrier, and writes dx from the same registers; scale is read once per
// CTA into shared memory; 8 warps take a CTA's 16 rows in turn and two
// CTAs share an SM, so 16 rows (128 KB of loads) are in flight per SM.
// Wider rows go to a team of 2-16 warps (d <= 16384) that adds its warps'
// sums through shared memory.  The reduce runs one CTA of 32 warps per 32
// columns and is launched as a programmatic dependent of the row kernel,
// so its launch overlaps the row kernel's tail.  Same card: row kernel
// 22.3 us, reduce 1.7 us.  Loading a warp's next row before the current
// row's arithmetic, or the first row before scale is staged, made the row
// kernel slower (26.0 us), as did streaming cache hints (24.8 us).
//
// Forward, bound on the H100: bytes.  Each element is read once, squared and
// summed, then scaled and written: a few operations per 4 or 2 bytes, far
// below the card's ~20 f32 operations per byte.  The design therefore moves
// each byte once from device memory: one CTA per row, the row's second read
// (the scale pass) hits L1/L2 right after the first, neighbouring threads
// touch neighbouring elements (coalesced), and the ragged edge of any width
// d is handled by the strided loop bound (no lane-alignment rule, unlike the
// TPU's d % 128 == 0).  Vector loads and several rows per CTA are later
// work.
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

constexpr int kBwdRows = 16;     // rows per CTA = rows per dscale partial
constexpr int kBwdWarps = 8;     // warps per CTA (more only for wider rows)
constexpr int kRowFloats = 32;   // values of x, and of g, a lane holds
constexpr int kMaxTeam = 16;     // warps holding one row, at most
constexpr int kReduceWarps = 32; // warps per CTA of dscale's reduce

// 16 bytes of T <-> f32 values (4 of f32, 8 of bf16)
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)   // round to nearest even, as __float2bfloat16
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void team_sync(int team, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(threads) : "memory");
}

// The rows of CTA b are b * kBwdRows .. + kBwdRows - 1.  A team of TW warps
// holds one row in registers, E values of x and E of g per lane; the CTA's
// kTeams teams take its rows in turn (team t: rows t, t + kTeams, ...).
// With V = 16 / sizeof(T) values per 16-byte vector, lane l of warp w of a
// team owns, in vector k < E / V, the V columns
//   c0 + j * step,  c0 = (k * TW + w) * 32 * V + l * (vec ? V : 1),
//   step = vec ? 1 : 32,  j < V:
// one 16-byte load per lane when vec (d a multiple of V, 16-byte aligned
// pointers), else V scalar loads, each coalesced across the warp.  Both
// cover the same 32 * V columns per warp.  dscale: each team sums
// g * x * rstd over its rows in shared memory (a lane owns its columns, no
// sync), then the CTA adds the teams in order into its partial row.
template <typename T, int TW, int E>
__global__ void __launch_bounds__((TW > kBwdWarps ? TW : kBwdWarps) * 32,
                                  TW > kBwdWarps ? 1 : 2)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ rstd, const T* __restrict__ g,
                   T* __restrict__ dx, float* __restrict__ partial, int n,
                   int d, int vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NV = E / V;
  constexpr int kWarps = TW > kBwdWarps ? TW : kBwdWarps;
  constexpr int kTeams = kWarps / TW;
  extern __shared__ float smem[];
  float* s_s = smem;                        // d: scale, read once per CTA
  float* part_s = s_s + d;                  // kTeams x d: dscale per team
  __shared__ float red_s[kTeams][2][TW];    // a row's sum across the team

  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int team = wid / TW, w = wid % TW;
  const int step = vec ? 1 : 32;
  const int r1 = min((blockIdx.x + 1) * kBwdRows, n);
  float xv[E], gv[E];
  // every load of a row is issued before any arithmetic on it
  auto load_row = [&](int row) {
    const int64_t off = static_cast<int64_t>(row) * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = (k * TW + w) * 32 * V + lane * (vec ? V : 1);
      if (vec) {
        if (c0 < d) {
          load16(x + off + c0, xv + k * V);
          load16(g + off + c0, gv + k * V);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) xv[k * V + j] = gv[k * V + j] = 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int c = c0 + j * 32;
          xv[k * V + j] = c < d ? to_float(x[off + c]) : 0.f;
          gv[k * V + j] = c < d ? to_float(g[off + c]) : 0.f;
        }
      }
    }
  };
  for (int i = threadIdx.x; i < d; i += kWarps * 32) s_s[i] = scale[i];
  for (int i = threadIdx.x; i < kTeams * d; i += kWarps * 32) part_s[i] = 0.f;
  __syncthreads();

  float* part = part_s + team * d;
  int it = 0;
  for (int row = blockIdx.x * kBwdRows + team; row < r1;
       row += kTeams, ++it) {
    const int64_t off = static_cast<int64_t>(row) * d;
    load_row(row);
    const float r = rstd[row];
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = (k * TW + w) * 32 * V + lane * (vec ? V : 1);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = c0 + j * step;
        if (c < d) {
          const float xj = xv[k * V + j], gj = gv[k * V + j];
          part[c] += gj * xj * r;
          gv[k * V + j] = gj * s_s[c];      // g * s from here on
          dot += gv[k * V + j] * xj;
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if constexpr (TW > 1) {
      if (lane == 0) red_s[team][it & 1][w] = dot;
      if constexpr (kTeams == 1) __syncthreads();
      else team_sync(team, TW * 32);
      dot = 0.f;
#pragma unroll
      for (int i = 0; i < TW; ++i) dot += red_s[team][it & 1][i];
    }
    const float c = dot / static_cast<float>(d);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = (k * TW + w) * 32 * V + lane * (vec ? V : 1);
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = r * (gv[k * V + j] - xv[k * V + j] * (r * r) * c);
      if (vec) {
        if (c0 < d) store16(dx + off + c0, o);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (c0 + j * 32 < d) dx[off + c0 + j * 32] = from_float<T>(o[j]);
      }
    }
  }
  __syncthreads();
  float* out = partial + static_cast<int64_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += kWarps * 32) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < kTeams; ++t) s += part_s[t * d + i];
    out[i] = s;
  }
}

// dscale[i] = sum of partial[p, i] over p: warp w of the CTA of columns
// 32 * blockIdx.x .. + 31 sums p = w, w + kReduceWarps, ... in order, then
// the warps' sums are added in warp order.  Fixed order: the same bits on
// every run.
__global__ void __launch_bounds__(kReduceWarps * 32)
rmsnorm_dscale_reduce_kernel(const float* __restrict__ partial,
                             float* __restrict__ dscale, int n_parts, int d) {
  __shared__ float sums[kReduceWarps][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  // launched as a programmatic dependent of the row kernel: wait here
  // until its partials are complete and visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float s = 0.f;
  if (i < d) {
#pragma unroll 8
    for (int p = w; p < n_parts; p += kReduceWarps)
      s += partial[static_cast<int64_t>(p) * d + i];
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && i < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kReduceWarps; ++k) t += sums[k][lane];
    dscale[i] = t;
  }
}

template <typename T, int TW, int E>
cudaError_t launch_bwd_rows(const void* x, const void* scale,
                            const void* rstd, const void* g, void* dx,
                            void* partial, int n, int d, int vec,
                            cudaStream_t st) {
  constexpr int kWarps = TW > kBwdWarps ? TW : kBwdWarps;
  const int smem = (1 + kWarps / TW) * d * static_cast<int>(sizeof(float));
  if (smem + 2 * kWarps * static_cast<int>(sizeof(float)) > 48 * 1024) {
    // past 48 KB with the static red_s: opt in to more
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<T, TW, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  rmsnorm_bwd_kernel<T, TW, E><<<(n + kBwdRows - 1) / kBwdRows, kWarps * 32,
                                 smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(rstd), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<float*>(partial), n, d, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* rstd,
               const void* g, void* dx, void* partial, void* dscale, int n,
               int d, void* stream) {
  if (d <= 0) return 0;
  if (d > kMaxTeam * 32 * kRowFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_parts = (n + kBwdRows - 1) / kBwdRows;
  const int vec = d % (16 / sizeof(T)) == 0 && aligned16(x) &&
                  aligned16(g) && aligned16(dx);
  if (n_parts > 0) {
    cudaError_t e;
    if (d <= 32 * 8)
      e = launch_bwd_rows<T, 1, 8>(x, scale, rstd, g, dx, partial, n, d, vec, st);
    else if (d <= 32 * 16)
      e = launch_bwd_rows<T, 1, 16>(x, scale, rstd, g, dx, partial, n, d, vec, st);
    else if (d <= 32 * kRowFloats)
      e = launch_bwd_rows<T, 1, 32>(x, scale, rstd, g, dx, partial, n, d, vec, st);
    else if (d <= 2 * 32 * kRowFloats)
      e = launch_bwd_rows<T, 2, 32>(x, scale, rstd, g, dx, partial, n, d, vec, st);
    else if (d <= 4 * 32 * kRowFloats)
      e = launch_bwd_rows<T, 4, 32>(x, scale, rstd, g, dx, partial, n, d, vec, st);
    else if (d <= 8 * 32 * kRowFloats)
      e = launch_bwd_rows<T, 8, 32>(x, scale, rstd, g, dx, partial, n, d, vec, st);
    else
      e = launch_bwd_rows<T, 16, 32>(x, scale, rstd, g, dx, partial, n, d, vec, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the reduce may be scheduled while the row kernel's last CTAs finish
  // (programmatic dependent launch); it waits for them before it reads
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d + 31) / 32);
  cfg.blockDim = dim3(kReduceWarps * 32);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, rmsnorm_dscale_reduce_kernel, static_cast<const float*>(partial),
      static_cast<float*>(dscale), n_parts, d));
}

}  // namespace

// Backward: x, g, dx (n, d) in the named type; scale (d,), rstd (n,),
// partial (ceil(n / 16), d) scratch and dscale (d,) in f32; all contiguous;
// d <= 16384 (cudaErrorInvalidValue otherwise).  Launches the row kernel,
// then the partials' reduce.
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
