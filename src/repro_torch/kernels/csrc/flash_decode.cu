// Split-K GQA flash-decode over a paged KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::_decode_kernel
// (called from flash_decode) and the jnp logsumexp merge that follows it
// there (flash_decode.py:147-153), in one launch:
//
//   flash_decode_kernel  grid (B*Kv*T, C), C = min(splits, kMaxCluster),
//                        one CTA of kWarps warps per (request * kv head,
//                        head tile t < T, rank r < C), launched as
//                        clusters of (1, C): the C CTAs of one (request,
//                        kv head, head tile) are one cluster.  A kv head's
//                        G query heads are cut into T = ceil(G / kMaxG)
//                        tiles of at most kMaxG (head_tile): G 48 (MQA,
//                        granite-20b) is three tiles of 16, each its own
//                        cluster re-reading the kv head's rows.
//                        The CTA of rank r takes the K-splits r, r + C,
//                        ...  For each it reads its pool block ids from
//                        the block table itself (the TPU fed them to the
//                        DMA engine as scalar-prefetch operands), scores
//                        the G query heads of its kv head against each K
//                        row and keeps online softmax states (m, l, acc)
//                        in f32, and leaves the split's merged state in
//                        its own shared memory.  After a cluster barrier,
//                        rank 0 reads every split's state, in split order,
//                        from its owner's shared memory (distributed
//                        shared memory), merges them with one logsumexp
//                        rescale and writes the (B, 1, H, D) output in
//                        q's type; a second cluster barrier keeps every
//                        CTA's shared memory live until rank 0 is done.
//
// Numerics follow the TPU kernel: table entries < 0 are clamped to block 0
// and padded tail entries of the split plan read block 0; positions >= ctx
// score NEG_INF = -1e30 and their p is exactly 0; the merge divides by
// max(l, 1e-30).  Positions past ctx are a no-op of the online update
// (alpha = 1, p = 0), so a CTA stops at the request's last valid position
// instead of walking its whole range; a split with no valid position
// leaves m = -1e30, l = 0, acc = 0, which vanish in the merge (its CTA
// still reaches both cluster barriers).
//
// Bound on the H100: bytes.  Decode reads every cached K/V element once for
// one query token per head: 2 * G operations per element, far below the
// ~20 f32 operations per byte the card could do, at any context length.
// The serving shape (B 8, H 16, Kv 8, D 128, block 16, ctx <= 320, 4
// splits) reads 8.1 MB: 2.4 us at 3.35 TB/s, less than one launch costs.
// The first design staged each block in shared memory behind four
// barriers, scored with one warp per (head, position), ran the softmax on
// G = 2 of 128 threads and walked a split's blocks one after another: 53.7
// us on an H100 80GB HBM3 at 700 W.  The split loop has no barrier: each
// warp owns chunks of kChunk positions (chunk c of the split to warp c %
// kWarps) and its own (m, l, acc) in registers; a lane holds DPL
// consecutive columns (16 bytes of f32 at D 128), so one K or V row is one
// coalesced warp load, and all 2 * kChunk rows of a chunk are loaded
// before any arithmetic on them.  The warps' states meet once, at the end
// of a split, in shared memory, merged in warp order: the same bits on
// every launch.  Until the merge moved into the cluster, each split wrote
// its partial (acc, m, l) to device memory and a second kernel merged
// them: 18.9 us between CUDA events for both at the serving shape, 112.3
// us at B 8, ctx 4096 (268 MB).  One launch, same card: 17.5 us (13.5 us
// of device time) and 110.2 us, 73 % of its 80 us bound.  All C CTAs of
// a cluster must be resident at once: with 2 CTAs per SM (124 registers
// a thread), 66 clusters of 4 fit on the card with the hardware's load
// balancing policy (62 with its default), the 64 of the serving shape
// in one wave; clusters of 8 fit 30 at once, a second wave that made
// 12 splits slower than two launches, so C stops at 4 and a CTA takes
// several splits in turn.
// Registers bound the shapes: a head tile of Gt <= kMaxG query heads, D <=
// kMaxD; shared memory holds the tile's q, the warps' states and the
// CTA's splits' states, smem_bytes().  Heads never meet in the arithmetic
// (each has its own softmax, butterflies and merges), so the tiling
// changes no head's numbers.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;            // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 8;            // positions a warp takes per step
constexpr int kMaxG = 16;            // query heads per CTA, at most
constexpr int kMaxD = 256;           // head dim, at most (8 values a lane)
constexpr int kMaxCluster = 4;       // CTAs per cluster, at most (header)
constexpr float kNegInf = -1e30f;
// returned when no cluster of the launch's shape fits on the card
constexpr int kNoClusterFits = -1;

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

// Query heads per CTA for G per kv head: G cut into ceil(G / kMaxG) tiles
// as even as they come (the last may be smaller).
int head_tile(int G) {
  const int T = (G + kMaxG - 1) / kMaxG;
  return (G + T - 1) / T;
}

// Shared memory of one CTA of a tile of G heads, in floats' bytes: q
// (G*D), the warps' states (kWarps * G * (D + 2)), then the states of the
// CTA's ceil(splits / C) splits (G * (D + 2) each).  Every CTA of a
// cluster has the same layout, so a split's state sits at the same offset
// in its owner's memory.
int smem_bytes(int G, int D, int splits) {
  const int C = splits < kMaxCluster ? splits : kMaxCluster;
  const int slots = (splits + C - 1) / C;
  return (G * D + (kWarps + slots) * G * (D + 2)) *
         static_cast<int>(sizeof(float));
}

// The split s of (request b, kv head h) into the state slot st_acc (G*D),
// st_m, st_l (G each).  Its positions p0 .. p0 + bps*bs - 1 that are < ctx
// are cut into chunks of kChunk; warp w takes chunks w, w + kWarps, ...
// and keeps its own online softmax (m, l, acc) for each of the G query
// heads in registers (lane l holds columns l*DPL .. l*DPL + DPL - 1 of
// acc).  Per chunk: lane u < kChunk reads the block id of position u of
// the chunk from the table (one load for the warp), the warp loads the
// chunk's kChunk K rows and V rows (one coalesced row per load
// instruction) before any arithmetic on them, then per head scores them
// (lane-partial dots, xor butterflies: every lane gets the same bits), and
// updates m, l, acc once for the chunk.  At the end the warps' states go
// through shared memory once and are merged in warp order into the slot.
// Two barriers: before and after the warps' merge.
template <typename T, int GM, int DPL>
__device__ __forceinline__ void split_state(
    const float* q_s, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tbl, int ctx_b,
    float* acc_s, float* m_s, float* l_s, float* st_acc, float* st_m,
    float* st_l, int b, int h, int s, int Kv, int G, int D, int P, int bs,
    int nb, int bps, float scale, int vec) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d0 = lane * DPL;              // this lane's first column
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
  const int n_pos = max(min(p0 + bps * bs, ctx_b) - p0, 0);
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
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + g]);
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w)
      o += acc_s[w * G * D + i] * expf(m_s[w * G + g] - mx);
    st_acc[i] = o;
  }
  for (int g = tid; g < G; g += kThreads) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + g]);
    float lt = 0.f;
    for (int w = 0; w < kWarps; ++w)
      lt += l_s[w * G + g] * expf(m_s[w * G + g] - mx);
    st_m[g] = mx;
    st_l[g] = lt;
  }
  __syncthreads();            // acc_s, m_s, l_s are reused by the next split
}

// grid (B*Kv*T, C), clusters of (1, C): see the header.  The CTA runs the
// heads g0 .. g0 + G - 1 of its tile (G from here on counts the tile's
// heads, Gall the kv head's).  The splits' states live in shared memory
// slots: split s in slot s / C of rank s % C.
template <typename T, int GM, int DPL>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q,       // (B*Kv, Gall, D)
                    const T* __restrict__ k_pool,  // (P, bs, Kv, D)
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tbl,   // (B, nb)
                    const int* __restrict__ ctx,   // (B,)
                    T* __restrict__ out,           // (B*Kv, Gall, D)
                    int Kv, int Gall, int Gt, int D, int P, int bs, int nb,
                    int splits, int bps, float scale, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int slots = (splits + C - 1) / C;
  const int n_tiles = (Gall + Gt - 1) / Gt;
  const int bk = blockIdx.x / n_tiles;    // request * Kv + kv head
  const int g0 = (blockIdx.x - bk * n_tiles) * Gt;
  const int G = min(Gt, Gall - g0);       // this tile's heads
  const int64_t q0 = (static_cast<int64_t>(bk) * Gall + g0) * D;
  extern __shared__ float smem[];
  float* q_s = smem;                      // G*D          query heads
  float* acc_s = q_s + G * D;             // kWarps*G*D   warps' acc
  float* m_s = acc_s + kWarps * G * D;    // kWarps*G     warps' m
  float* l_s = m_s + kWarps * G;          // kWarps*G     warps' l
  float* st_acc = l_s + kWarps * G;       // slots*G*D    splits' acc
  float* st_m = st_acc + slots * G * D;   // slots*G      splits' m
  float* st_l = st_m + slots * G;         // slots*G      splits' l

  const int b = bk / Kv, h = bk - b * Kv;
  const int tid = threadIdx.x;
  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = to_float(q[q0 + i]);
  __syncthreads();

  const int ctx_b = ctx[b];
  for (int s = rank, j = 0; s < splits; s += C, ++j)
    split_state<T, GM, DPL>(q_s, k_pool, v_pool, tbl, ctx_b, acc_s, m_s, l_s,
                            st_acc + j * G * D, st_m + j * G, st_l + j * G,
                            b, h, s, Kv, G, D, P, bs, nb, bps, scale, vec);

  cluster.sync();             // every split's state is in shared memory
  if (rank == 0) {
    // logsumexp merge in split order: empty splits (m = -1e30, l = 0,
    // acc = 0) vanish
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      float m_max = kNegInf;
      for (int s = 0; s < splits; ++s) {
        const float* m_r = cluster.map_shared_rank(st_m, s % C);
        m_max = fmaxf(m_max, m_r[s / C * G + g]);
      }
      float l_tot = 0.f, o = 0.f;
      for (int s = 0; s < splits; ++s) {
        const int r = s % C, slot = s / C;
        const float alpha =
            expf(cluster.map_shared_rank(st_m, r)[slot * G + g] - m_max);
        l_tot += cluster.map_shared_rank(st_l, r)[slot * G + g] * alpha;
        o += cluster.map_shared_rank(st_acc, r)[slot * G * D + i] * alpha;
      }
      out[q0 + i] = from_float<T>(o / fmaxf(l_tot, 1e-30f));
    }
  }
  cluster.sync();             // no CTA leaves while rank 0 reads its memory
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

struct DecodeArgs {
  const void *q, *k_pool, *v_pool, *tbl, *ctx;
  void* out;
  int B, Kv, G, D, P, bs, nb, splits, bps;
  float scale;
};

template <typename T, int GM, int DPL>
int launch_tile(const DecodeArgs& a, cudaStream_t st) {
  auto* kernel = flash_decode_kernel<T, GM, DPL>;
  const int C = a.splits < kMaxCluster ? a.splits : kMaxCluster;
  const int Gt = head_tile(a.G), n_tiles = (a.G + Gt - 1) / Gt;
  const int smem = smem_bytes(Gt, a.D, a.splits);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // clusters of (1, C), placed by the hardware's load balancing policy
  // (more clusters resident at once than its default: see the header)
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = C;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attrs[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicyLoadBalancing;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.Kv * n_tiles, C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  // all C CTAs of a cluster must be resident at once: ask the card
  // whether one such cluster fits (once per cluster size and shared
  // memory size; less shared memory fits too)
  static int fits[kMaxCluster + 1] = {};
  if (smem > fits[C]) {
    int n_clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n_clusters < 1) return kNoClusterFits;
    fits[C] = smem;
  }
  // 16-byte vector loads need every lane's first column on its boundary
  const int vec = a.D % DPL == 0 && aligned16(a.k_pool) && aligned16(a.v_pool);
  e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k_pool), static_cast<const T*>(a.v_pool),
      static_cast<const int*>(a.tbl), static_cast<const int*>(a.ctx),
      static_cast<T*>(a.out), a.Kv, a.G, Gt, a.D, a.P, a.bs, a.nb,
      a.splits, a.bps, a.scale, vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int GM>
int launch_g(const DecodeArgs& a, cudaStream_t st) {
  if (a.D <= 64) return launch_tile<T, GM, 2>(a, st);
  if (a.D <= 128) return launch_tile<T, GM, 4>(a, st);
  return launch_tile<T, GM, 8>(a, st);
}

template <typename T>
int launch(const DecodeArgs& a, void* stream) {
  if (a.G < 1 || a.D < 1 || a.D > kMaxD || a.splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Gt = head_tile(a.G);
  if (Gt == 1) return launch_g<T, 1>(a, st);
  if (Gt == 2) return launch_g<T, 2>(a, st);
  if (Gt <= 4) return launch_g<T, 4>(a, st);
  if (Gt <= 8) return launch_g<T, 8>(a, st);
  return launch_g<T, 16>(a, st);
}

}  // namespace

// q (B, 1, H=Kv*G, D), pools (P, bs, Kv, D) and out (B, 1, H, D) in the
// named type; tbl (B, nb) and ctx (B,) int32; all contiguous.  Returns
// cudaGetLastError() right after the launch, or -1 when no cluster of
// min(splits, 4) CTAs with this shape's shared memory fits on the card.
extern "C" int flash_decode_f32(const void* q, const void* k_pool,
                                const void* v_pool, const void* tbl,
                                const void* ctx, void* out, int B, int Kv,
                                int G, int D, int P, int bs, int nb,
                                int splits, int bps, float scale,
                                void* stream) {
  return launch<float>({q, k_pool, v_pool, tbl, ctx, out, B, Kv, G, D, P, bs,
                        nb, splits, bps, scale},
                       stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k_pool,
                                 const void* v_pool, const void* tbl,
                                 const void* ctx, void* out, int B, int Kv,
                                 int G, int D, int P, int bs, int nb,
                                 int splits, int bps, float scale,
                                 void* stream) {
  return launch<__nv_bfloat16>({q, k_pool, v_pool, tbl, ctx, out, B, Kv, G,
                                D, P, bs, nb, splits, bps, scale},
                               stream);
}

extern "C" const char* flash_decode_error_string(int code) {
  if (code == kNoClusterFits)
    return "no cluster of this shape fits on the card";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
