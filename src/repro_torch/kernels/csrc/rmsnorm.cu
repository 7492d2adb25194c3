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
//
// Both directions hold a row the same way: a warp, or a team of 2-16 warps,
// keeps the row in registers (up to 32 values a lane), loaded as 16-byte
// vectors before any arithmetic on it, sums it with warp shuffles (a team
// adds its warps' sums through shared memory), and writes its output from
// the same registers.  A ragged d, or a pointer off a 16-byte boundary,
// takes scalar loads over the same columns (first_col).
//
// Forward, bound on the H100: bytes (x read, y written: a few f32
// operations per 4 or 2 bytes, against ~20 operations per byte the card
// could do).  The qwen3 training rows, f32 4096 x 1024, move 33.6 MB:
// 10.0 us at 3.35 TB/s; the decode rows (8 x 1024) move 66 KB, and their
// time is a launch and the chain of one row's loads and arithmetic.  The
// first design (one CTA of 256 threads a row, scalar loads, two barriers
// a row, the row read twice, scale read after the row's sum) took 18.3
// us at 4096 x 1024 (14.3 us of device time) and 6.4 us (2.4) at 8 x 1024
// between CUDA events on an H100 80GB HBM3 at 700 W.  This design: a lane
// holds its columns of x and of scale, both loaded before the row's sum
// (so scale costs no second round trip); one row per team, and
// kFwdSpread (256) rows or fewer each take a CTA of their own with a team
// of warps at 8 values a lane (a short chain per warp), while more rows
// share CTAs of up to kFwdWarps warps, one warp a row at d 1024.  Rows
// wider than a 16-warp team holds (16 * 32 * 32 = 16384) are walked in
// slices, read a second time (from L2) for the scale pass.  Same card:
// 17.5 us (13.5 device) and 5.9 us (1.9).  Staging scale in shared memory
// instead was slower at every row count.
//
// Backward, bound on the H100: bytes (x and g read, dx written: 12 bytes
// per f32 element for ~11 operations).  The qwen3 training rows move 50.3
// MB: 15.0 us at 3.35 TB/s.  The first design (one CTA of 256 threads
// walking its 16 rows one after another, 4 scalar columns a thread, two
// barriers per row, x and g read twice, a 4-CTA reduce) took 48.9 us there
// on the same card: row kernel 37.4 us, reduce 6.0 us.  This design: a
// warp holds x and g (64 values a lane); scale is read once per CTA into
// shared memory; 8 warps take a CTA's 16 rows in turn and two CTAs share
// an SM; rows to d 16384.  The reduce runs one CTA of 32 warps per 32
// columns and is launched as a programmatic dependent of the row kernel,
// so its launch overlaps the row kernel's tail.  Same card: row kernel
// 22.3 us, reduce 1.7 us.  Loading a warp's next row before the current
// row's arithmetic, or the first row before scale is staged, made the row
// kernel slower (26.0 us), as did streaming cache hints (24.8 us).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowFloats = 32;   // values of a row (of x, of g) a lane holds
constexpr int kMaxTeam = 16;     // warps holding one row, at most
constexpr int kFwdWarps = 8;     // warps per forward CTA (more for wide rows)
constexpr int kFwdSpread = 256;  // rows up to which each takes a CTA alone
constexpr int kFwdMinCtas = 3;   // forward CTAs per SM for a warp a row
constexpr int kBwdRows = 16;     // rows per CTA = rows per dscale partial
constexpr int kBwdWarps = 8;     // warps per CTA (more only for wider rows)
constexpr int kReduceWarps = 32; // warps per CTA of dscale's reduce

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

// A team of TW warps holds a row; with V = 16 / sizeof(T) values per
// 16-byte vector, lane l of warp w owns, in vector k, the V columns
//   c0 + j * (vec ? 1 : 32),  c0 = (k * TW + w) * 32 * V + l * (vec ? V : 1),
// j < V: one 16-byte load per lane when vec (d a multiple of V, 16-byte
// aligned pointers), else V scalar loads, each coalesced across the warp.
// Both cover the same 32 * V columns per warp.
template <int V, int TW>
__device__ __forceinline__ int first_col(int k, int w, int lane, int vec) {
  return (k * TW + w) * 32 * V + lane * (vec ? V : 1);
}

// The V columns of c0 (as above) of p, in f32; columns >= d read 0.
template <int V, typename T>
__device__ __forceinline__ void load_cols(const T* p, int c0, int d, int vec,
                                          float* o) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    if (c0 < d) {
#pragma unroll
      for (int i = 0; i < V / kPer; ++i)
        load16(p + c0 + i * kPer, o + i * kPer);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = c0 + j * 32;
      o[j] = c < d ? to_float(p[c]) : 0.f;
    }
  }
}

// Writes v to the V columns of c0 of p that are < d, in T.
template <int V, typename T>
__device__ __forceinline__ void store_cols(T* p, int c0, int d, int vec,
                                           const float* v) {
  if (vec) {
    if (c0 < d) store16(p + c0, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (c0 + j * 32 < d) p[c0 + j * 32] = from_float<T>(v[j]);
  }
}

__device__ __forceinline__ void team_sync(int team, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(threads) : "memory");
}

// A row's sum across the TW warps of its team, in warp order, through
// red (kTeams x 2 x TW floats, double-buffered by the row's parity).
template <int TW, int kTeams>
__device__ __forceinline__ float team_sum(float v, float (*red)[2][TW],
                                          int team, int w, int lane,
                                          int it) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (TW > 1) {
    if (lane == 0) red[team][it & 1][w] = v;
    if constexpr (kTeams == 1) __syncthreads();
    else team_sync(team, TW * 32);
    v = 0.f;
#pragma unroll
    for (int i = 0; i < TW; ++i) v += red[team][it & 1][i];
  }
  return v;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A CTA of `teams` teams of TW warps (launch_fwd_rows); team t of CTA b
// holds row b * teams + t.  A lane holds E values of x, of a slice of
// TW * 32 * E columns, and the same columns of scale, loaded with the
// row's x before any arithmetic.  A wider row is walked in slices: each is
// loaded and summed, then all but the last (still in registers) are read
// again, with their scale, for the scale pass.
// Registers: a lane's x and scale (2 E values) fit kFwdMinCtas CTAs a
// SM for a warp a row; a team's tile, with its barrier, spilled there
// (ptxas), so teams take 2 CTAs a SM (1 at 16 warps).
template <typename T, int TW, int E>
__global__ void __launch_bounds__((TW > kFwdWarps ? TW : kFwdWarps) * 32,
                                  TW > kFwdWarps ? 1
                                                 : TW > 1 ? 2 : kFwdMinCtas)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, float* __restrict__ rstd, int n, int d,
                   float eps, int vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NV = E / V;
  constexpr int kSlice = TW * 32 * E;
  constexpr int kTeams = TW > kFwdWarps ? 1 : kFwdWarps / TW;
  __shared__ float red_s[kTeams][2][TW];

  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int team = wid / TW, w = wid % TW;
  const int row = blockIdx.x * (blockDim.x / (32 * TW)) + team;
  if (row >= n) return;     // a whole team leaves: no barrier waits for it
  const int n_slices = (d + kSlice - 1) / kSlice;
  const int64_t off = static_cast<int64_t>(row) * d;
  float xv[E], sv[E];
  auto load_slice = [&](int sl, bool with_scale) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = sl * kSlice + first_col<V, TW>(k, w, lane, vec);
      load_cols<V>(x + off, c0, d, vec, xv + k * V);
      if (with_scale) load_cols<V>(scale, c0, d, vec, sv + k * V);
    }
  };
  float part[4] = {0.f, 0.f, 0.f, 0.f};   // four independent chains
  for (int sl = 0; sl < n_slices; ++sl) {
    load_slice(sl, sl == n_slices - 1);
#pragma unroll
    for (int i = 0; i < E; ++i) part[i % 4] += xv[i] * xv[i];
  }
  const float ss = team_sum<TW, kTeams>((part[0] + part[1]) +
                                        (part[2] + part[3]),
                                        red_s, team, w, lane, 0);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  if (w == 0 && lane == 0) rstd[row] = r;
  for (int sl = n_slices - 1; sl >= 0; --sl) {
    if (sl < n_slices - 1) load_slice(sl, true);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = xv[k * V + j] * r * sv[k * V + j];
      store_cols<V>(y + off,
                    sl * kSlice + first_col<V, TW>(k, w, lane, vec), d, vec,
                    o);
    }
  }
}

template <typename T, int TW, int E>
cudaError_t launch_fwd_rows(const void* x, const void* scale, void* y,
                            void* rstd, int n, int d, float eps, int vec,
                            cudaStream_t st) {
  // teams per CTA: as many as keep >= kFwdSpread CTAs on the card, so few
  // rows spread over as many SMs and many rows share each CTA
  constexpr int kMaxTeams = TW > kFwdWarps ? 1 : kFwdWarps / TW;
  const int teams = min(max(n / kFwdSpread, 1), kMaxTeams);
  rmsnorm_fwd_kernel<T, TW, E><<<(n + teams - 1) / teams, teams * TW * 32, 0,
                                 st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(y), static_cast<float*>(rstd), n, d, eps, vec);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* scale, void* y, void* rstd, int n,
           int d, float eps, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = d % (16 / sizeof(T)) == 0 && aligned16(x) && aligned16(y)
                  && aligned16(scale);
  cudaError_t e;
  if (d <= 32 * 8)
    e = launch_fwd_rows<T, 1, 8>(x, scale, y, rstd, n, d, eps, vec, st);
  else if (n <= kFwdSpread && d <= kMaxTeam * 32 * 8) {
    // every row has a CTA of its own: a team of warps a row, 8 values a
    // lane, so each warp's chain of loads and arithmetic is short
    if (d <= 2 * 32 * 8)
      e = launch_fwd_rows<T, 2, 8>(x, scale, y, rstd, n, d, eps, vec, st);
    else if (d <= 4 * 32 * 8)
      e = launch_fwd_rows<T, 4, 8>(x, scale, y, rstd, n, d, eps, vec, st);
    else if (d <= 8 * 32 * 8)
      e = launch_fwd_rows<T, 8, 8>(x, scale, y, rstd, n, d, eps, vec, st);
    else
      e = launch_fwd_rows<T, 16, 8>(x, scale, y, rstd, n, d, eps, vec, st);
  } else if (d <= 32 * 16)
    e = launch_fwd_rows<T, 1, 16>(x, scale, y, rstd, n, d, eps, vec, st);
  else if (d <= 32 * kRowFloats)
    e = launch_fwd_rows<T, 1, 32>(x, scale, y, rstd, n, d, eps, vec, st);
  else if (d <= 2 * 32 * kRowFloats)
    e = launch_fwd_rows<T, 2, 32>(x, scale, y, rstd, n, d, eps, vec, st);
  else if (d <= 4 * 32 * kRowFloats)
    e = launch_fwd_rows<T, 4, 32>(x, scale, y, rstd, n, d, eps, vec, st);
  else if (d <= 8 * 32 * kRowFloats)
    e = launch_fwd_rows<T, 8, 32>(x, scale, y, rstd, n, d, eps, vec, st);
  else   // 16 warps, in slices past 16384 columns
    e = launch_fwd_rows<T, 16, 32>(x, scale, y, rstd, n, d, eps, vec, st);
  return static_cast<int>(e);
}

// The rows of CTA b are b * kBwdRows .. + kBwdRows - 1.  A team of TW warps
// holds one row in registers, E values of x and E of g per lane; the CTA's
// kTeams teams take its rows in turn (team t: rows t, t + kTeams, ...), on
// the columns of first_col.  dscale: each team sums g * x * rstd over its
// rows in shared memory (a lane owns its columns, no sync), then the CTA
// adds the teams in order into its partial row.
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
  for (int i = threadIdx.x; i < d; i += kWarps * 32) s_s[i] = scale[i];
  for (int i = threadIdx.x; i < kTeams * d; i += kWarps * 32) part_s[i] = 0.f;
  __syncthreads();

  float* part = part_s + team * d;
  int it = 0;
  for (int row = blockIdx.x * kBwdRows + team; row < r1;
       row += kTeams, ++it) {
    const int64_t off = static_cast<int64_t>(row) * d;
    // every load of a row is issued before any arithmetic on it
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = first_col<V, TW>(k, w, lane, vec);
      load_cols<V>(x + off, c0, d, vec, xv + k * V);
      load_cols<V>(g + off, c0, d, vec, gv + k * V);
    }
    const float r = rstd[row];
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = first_col<V, TW>(k, w, lane, vec);
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
    dot = team_sum<TW, kTeams>(dot, red_s, team, w, lane, it);
    const float c = dot / static_cast<float>(d);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = r * (gv[k * V + j] - xv[k * V + j] * (r * r) * c);
      store_cols<V>(dx + off, first_col<V, TW>(k, w, lane, vec), d, vec, o);
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
// all contiguous; any d.  Returns cudaGetLastError() right after the launch.
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
