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
// over the chunks itself, keeping the f32 state on chip for the whole
// sequence.  The input tiles are read straight from the (B, T, H, N)
// layout (stride H*N between tokens), so the TPU wrapper's transpose and
// padding copies are gone: rows past T are identity steps (w = 1, k = r =
// v = 0) and write nothing.  The design:
// - 8 warps per CTA, two CTAs per SM: B*H = 256 CTAs at the training
//   shape fill the card's 264 slots in one wave.  Splitting a head's value
//   columns over 2 or 4 CTAs (each recomputing the key side) was slower on
//   an H100: the recomputed logs, exps and A cost more than the extra CTAs
//   gained.
// - Register tiles: each thread computes a block of outputs of A (4 x 1),
//   qp S (4 x 4), y (2 x 4) or the state (8 x 4) and reads its operands
//   from shared memory as 16-byte vectors, so each value loaded feeds 4-8
//   FMAs.  Half the threads keep the state in registers from chunk to
//   chunk and update it while the other half compute qp S from its copy
//   in shared memory.  Row strides of the [C][N] tiles are N + 4 floats,
//   so the rows a quarter-warp reads fall in distinct banks.
// - The log and the exps run on all threads; only the cumsum's C adds per
//   channel run one thread per channel, beside the widening of v.
// - cp.async brings chunk c + 1's r, k, v, w tiles in as soon as chunk c
//   has consumed its own (after the exps), so they land while chunk c
//   computes A, y and the state (zero-filled past T; w reads as 1 there).
// - f32 SIMT FMAs, no tensor cores: at the training shape the chunked form
//   needs ~2.8 GFLOP (chip_smoke.wkv6_ops), 0.042 ms at 67 TFLOP/s, under
//   the 0.051 ms the bytes take, so TF32 MMAs buy nothing, and 3xTF32
//   would change the rounding.
// - Every output keeps the sums, and their order, of the first version of
//   this kernel (one thread per output): A over n = 0..N-1; y as
//   (sum over j < t of A v in j order) + diag v, then + (sum over n of qp
//   S in n order); S as decay * S + the sum over t in t order; the u
//   diagonal as its warp reduction.  So y and the final state are the same
//   bits.
// All arithmetic is f32 with logf and expf (no fast math).  wgmma and TMA
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One CTA per (b, h): 8 warps, 4 for y and 4 for the state
constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;  // threads of each role
constexpr int kN = 64;               // head dim the kernel is compiled for
constexpr int kLd = kN + 4;          // row stride of the f32 [C][N] tiles
constexpr int kWarps = kThreads / 32;
static_assert(kN * kN / 32 == kHalf, "the state's 8 x 4 blocks, one each");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// four consecutive outputs, rounded to T (bf16: to nearest even, as
// torch's cast); dst is 8-byte (bf16) or 16-byte (f32) aligned
__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(dst) = make_uint2(
      *reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

__device__ __forceinline__ void unpack(const float4 x, float (&a)[4]) {
  a[0] = x.x;
  a[1] = x.y;
  a[2] = x.z;
  a[3] = x.w;
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// asynchronous 16-byte global -> shared copy; an invalid one writes zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory of a CTA: the raw chunk tiles (r, k, v [C][N] in the input
// type, row strides padded by 16 bytes; w [C][kLd] f32), then the f32 work
// tiles.
template <typename T, int C>
struct Smem {
  static constexpr int kLdT = kN + 16 / sizeof(T);
  // X (lc - lw, then qp), KP (kp), KT (k exp(lc_C - lc)), V, Q (qp S)
  // [C][kLd]; A [C][C + 4]; S [kN][kN]; diag [C]; decay, lc_C [kN]
  static constexpr size_t kBytes =
      3 * C * kLdT * sizeof(T) +
      (6 * C * kLd + C * (C + 4) + kN * kN + C + 2 * kN) * sizeof(float);
};

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, T* __restrict__ y,
                float* __restrict__ s_out, int T_len, int H) {
  constexpr int kLdT = Smem<T, C>::kLdT, kLdA = C + 4, kQ = C / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  T* rs = reinterpret_cast<T*>(smem);
  T* ks = rs + C * kLdT;
  T* vs = ks + C * kLdT;
  float* ws = reinterpret_cast<float*>(vs + C * kLdT);   // w, lw, then lc
  float* X = ws + C * kLd;
  float* KP = X + C * kLd;
  float* KT = KP + C * kLd;
  float* V = KT + C * kLd;
  float* Q = V + C * kLd;
  float* A = Q + C * kLd;
  float* S = A + C * kLdA;
  float* diag = S + kN * kN;
  float* decay = diag + C;
  float* lc_tot = decay + kN;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t tok = static_cast<int64_t>(H) * kN;       // token stride
  const int64_t base = static_cast<int64_t>(b) * T_len * tok + h * kN;
  const float u_lo = u[h * kN + lane], u_hi = u[h * kN + lane + 32];
  const int n_chunks = (T_len + C - 1) / C;
  // roles in steps 4-5: the first half computes y, the second the state
  const bool y_role = tid < kHalf;
  const int rt = tid % kHalf;

  // the raw tiles of chunk c; rows past T are zero-filled
  auto fetch = [&](int c) {
    constexpr int kPer = 16 / sizeof(T);                 // values per copy
    const int t0 = c * C;
    for (int e = tid; e < C * kN / kPer; e += kThreads) {
      const int t = e / (kN / kPer), n = (e % (kN / kPer)) * kPer;
      const bool live = t0 + t < T_len;
      const int64_t off = base + (live ? t0 + t : 0) * tok + n;
      cp_async16(rs + t * kLdT + n, r + off, live);
      cp_async16(ks + t * kLdT + n, k + off, live);
      cp_async16(vs + t * kLdT + n, v + off, live);
    }
    for (int e = tid; e < C * kN / 4; e += kThreads) {
      const int t = e / (kN / 4), n = (e % (kN / 4)) * 4;
      const bool live = t0 + t < T_len;
      cp_async16(ws + t * kLd + n, w + base + (live ? t0 + t : 0) * tok + n,
                 live);
    }
    cp_async_commit();
  };

  // a state thread's 8 x 4 block of S: rows sn0 + i and sn0 + N/2 + i
  // (i < 4), columns sm0..sm0 + 3; srow(i) is the row of s_reg[i]
  const int sn0 = 4 * (rt % (kN / 8)), sm0 = 4 * (rt / (kN / 8));
  auto srow = [&](int i) { return sn0 + (i / 4) * (kN / 2) + i % 4; };
  float s_reg[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) s_reg[i][x] = 0.f;
  for (int i = tid; i < kN * kN; i += kThreads) S[i] = 0.f;

  fetch(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * C;
    cp_async_wait_all();
    __syncthreads();

    // 1. lw = log(max(w, 1e-12)) in place, w = 1 past T; the u diagonal,
    //    one warp per row: sum over n of (r * u) * k
#pragma unroll
    for (int i = 0; i < C * kN / kThreads; ++i) {
      const int e = tid + kThreads * i, t = e / kN, n = e % kN;
      const float wv = t0 + t < T_len ? ws[t * kLd + n] : 1.f;
      ws[t * kLd + n] = logf(fmaxf(wv, 1e-12f));
    }
    {
      float s[C / kWarps];
#pragma unroll
      for (int i = 0; i < C / kWarps; ++i) {
        const int t = warp + kWarps * i;
        s[i] = 0.f;
        s[i] += to_float(rs[t * kLdT + lane]) * u_lo *
                to_float(ks[t * kLdT + lane]);
        s[i] += to_float(rs[t * kLdT + lane + 32]) * u_hi *
                to_float(ks[t * kLdT + lane + 32]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < C / kWarps; ++i)
          s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < C / kWarps; ++i) diag[warp + kWarps * i] = s[i];
      }
    }
    __syncthreads();

    // 2. warps 0-1, one thread per channel: the inclusive cumsum lc (in
    //    place of lw) and lc - lw; the other warps widen v to f32
    if (tid < kN) {
      const int n = tid;
      float lc = 0.f;
#pragma unroll 8
      for (int t = 0; t < C; ++t) {
        const float lw = ws[t * kLd + n];
        lc = lc + lw;
        ws[t * kLd + n] = lc;
        X[t * kLd + n] = lc - lw;
      }
      lc_tot[n] = lc;
      decay[n] = expf(lc);
    } else {
      for (int e = tid - kN; e < C * kN; e += kThreads - kN) {
        const int t = e / kN, n = e % kN;
        V[t * kLd + n] = to_float(vs[t * kLdT + n]);
      }
    }
    __syncthreads();

    // 3. the exps: qp = r exp(lc - lw) (X), kp = k exp(-lc) (KP),
    //    k exp(lc_C - lc) (KT).  Then the raw tiles are free: the next
    //    chunk's copies run while this one computes.
#pragma unroll
    for (int i = 0; i < C * kN / kThreads; ++i) {
      const int e = tid + kThreads * i, t = e / kN, n = e % kN;
      const float l = ws[t * kLd + n], kk = to_float(ks[t * kLdT + n]);
      X[t * kLd + n] = to_float(rs[t * kLdT + n]) * expf(X[t * kLd + n]);
      KP[t * kLd + n] = kk * expf(-l);
      KT[t * kLd + n] = kk * expf(lc_tot[n] - l);
    }
    __syncthreads();
    if (c + 1 < n_chunks) fetch(c + 1);

    // 4. all threads: A = qp kp^T below the diagonal (zero on and above
    //    it), blocks of rows a + C/4 i (i < 4) in column tj
    for (int e = tid; e < kQ * C; e += kThreads) {
      const int a = e % kQ, tj = e / kQ;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int n0 = 0; n0 < kN; n0 += 4) {
        float qv[4][4], pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          unpack(load4(X + (a + kQ * i) * kLd + n0), qv[i]);
        unpack(load4(KP + tj * kLd + n0), pv);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] += qv[i][nn] * pv[nn];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ti = a + kQ * i;
        A[ti * kLdA + tj] = tj < ti ? acc[i] : 0.f;
      }
    }

    //    Then y threads: Q = qp S (the old S, sum over n in order) in
    //    blocks of rows ya + C/4 i (i < 4) and columns ym0..ym0 + 3.
    //    State threads: their 8 x 4 block of S <- exp(lc_C) o S +
    //    k_tail^T v, in registers.
    if (y_role) {
      for (int e = rt; e < kQ * (kN / 4); e += kHalf) {
        const int ya = e % kQ, ym0 = 4 * (e / kQ);
        float qs[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int x = 0; x < 4; ++x) qs[i][x] = 0.f;
#pragma unroll 2
        for (int n0 = 0; n0 < kN; n0 += 4) {
          float qr[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            unpack(load4(X + (ya + kQ * i) * kLd + n0), qr[i]);
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            float ss[4];
            unpack(load4(S + (n0 + nn) * kN + ym0), ss);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int x = 0; x < 4; ++x) qs[i][x] += qr[i][nn] * ss[x];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(Q + (ya + kQ * i) * kLd + ym0) =
              make_float4(qs[i][0], qs[i][1], qs[i][2], qs[i][3]);
      }
    } else {
      float kv[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) kv[i][x] = 0.f;
#pragma unroll 2
      for (int t = 0; t < C; ++t) {
        float kk[2][4], vv[4];
        unpack(load4(KT + t * kLd + sn0), kk[0]);
        unpack(load4(KT + t * kLd + sn0 + kN / 2), kk[1]);
        unpack(load4(V + t * kLd + sm0), vv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int x = 0; x < 4; ++x) kv[i][x] += kk[i / 4][i % 4] * vv[x];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          s_reg[i][x] = decay[srow(i)] * s_reg[i][x] + kv[i][x];
    }
    __syncthreads();               // A and Q are ready; S was read

    // 5. all threads: y = (A v + diag v) + Q, rows inside T, in blocks of
    //    rows ya + C/2 i (i < 2) and columns ym0..ym0 + 3; row t needs
    //    j < t only, so j stops below C/2 (i + 1) (the zeros above A's
    //    diagonal add nothing).  Then state threads: S <- their block.
    for (int e = tid; e < C / 2 * (kN / 4); e += kThreads) {
      const int ya = e % (C / 2), ym0 = 4 * (e / (C / 2));
      float av[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) av[i][x] = 0.f;
#pragma unroll
      for (int j0 = 0; j0 < C; j0 += 4) {
        float vv[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          unpack(load4(V + (j0 + jj) * kLd + ym0), vv[jj]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (j0 >= C / 2 * (i + 1)) continue;
          float ar[4];
          unpack(load4(A + (ya + C / 2 * i) * kLdA + j0), ar);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int x = 0; x < 4; ++x) av[i][x] += ar[jj] * vv[jj][x];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = ya + C / 2 * i;
        if (t0 + t >= T_len) continue;
        float vv[4], qs[4];
        unpack(load4(V + t * kLd + ym0), vv);
        unpack(load4(Q + t * kLd + ym0), qs);
#pragma unroll
        for (int x = 0; x < 4; ++x) av[i][x] = av[i][x] + diag[t] * vv[x];
        store4(y + base + (t0 + t) * tok + ym0, av[i][0] + qs[0],
               av[i][1] + qs[1], av[i][2] + qs[2], av[i][3] + qs[3]);
      }
    }
    if (!y_role) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(S + srow(i) * kN + sm0) = make_float4(
            s_reg[i][0], s_reg[i][1], s_reg[i][2], s_reg[i][3]);
    }
  }

  if (!y_role) {
    float* so = s_out + static_cast<int64_t>(bh) * kN * kN + sm0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(so + srow(i) * kN) = make_float4(
          s_reg[i][0], s_reg[i][1], s_reg[i][2], s_reg[i][3]);
  }
}

template <typename T, int C>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, void* s_out, int B, int T_len, int H,
           cudaStream_t st) {
  constexpr int bytes = static_cast<int>(Smem<T, C>::kBytes);
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
// f32; s_out (B, H, N, N) f32; all contiguous, r, k, v and w starting on a
// 16-byte boundary.  N must be 64 and chunk one of 16, 32, 64
// (cudaErrorInvalidValue otherwise).  A chunk longer than T runs as one
// chunk of T (the rows past T are identity steps).  Returns
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
