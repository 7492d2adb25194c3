// Flash attention for training on Hopper (sm_90a), bf16 inputs: the
// forward (o and the f32 logsumexp residual) and the FlashAttention-2
// backward as two kernels, on the card's bf16 tensor cores.  The f32
// kernels live in flash_attention.cu; flash_attention.py loads this
// library for bf16 tensors and that one for f32 tensors.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py for
// bf16 inputs:
//
//   flash_fwd_bf16_kernel  _flash_kernel (:60, from _flash_forward :216).
//       Grid (H, B, q blocks): one CTA per 16 W query rows of one head
//       walks the visible kv tiles with a running (m, l, acc) online
//       softmax; o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//       The TPU carried (m, l, acc) across a sequential grid axis in VMEM
//       scratch.
//   flash_dq_bf16_kernel   _flash_bwd_dq_kernel (:102, from
//       _flash_backward :255).  Grid (H, B, q blocks): p = exp(s - lse),
//       ds = p (dp - delta) scale, dq += ds k over the visible kv tiles.
//   flash_dkv_bf16_kernel  _flash_bwd_dkv_kernel (:134).  Grid (Kv, B, kv
//       blocks): one CTA per 16 W kv rows of one kv head loops over the G
//       query heads of that kv head and their visible q tiles (the TPU's
//       flattened (group, q block) sequential axis): dv += p^T do, dk +=
//       ds^T q, both in registers.  No atomics: the same bits from run to
//       run.
//
// Layouts, masks and positions are those of flash_attention.cu: q, o, do
// (B, Sq, H, D); k, v (B, Sk, Kv, D); query head h reads kv head h / G;
// lse, delta (B, H, Sq) f32; query row i at position q0 + i, key row j at
// j; visible iff j < Sk, i < Sq, (causal) j <= q0 + i, (window) j > q0 + i -
// window.  Each CTA loops only over the tiles that the causal and window
// bounds leave visible and masks only the tiles that a bound or a ragged
// edge crosses (rows past Sq or Sk are zero-filled in shared memory).
//
// Bound on the H100 at the T5 shape (B 8, S 512, H 16, Kv 8, D 128, causal):
// bytes.  The forward moves 2 * 16.8 MB of q and o, 2 * 8.4 MB of k and v
// and 0.26 MB of lse, 50.6 MB in all: 0.0151 ms at 3.35 TB/s; its 8.6 GFLOP
// of products take 0.0087 ms at 989 TFLOP/s.  dq and dk/dv move 67.6 MB
// each (0.0202 ms) for 12.9 and 17.2 GFLOP.  So the kernels must keep
// intermediates out of device memory (s, p, ds never leave the chip; K/V
// are read once per CTA) and then run the tensor cores as fast as the
// shared-memory traffic lets them.  The design:
// - Products: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, bf16
//   operands with f32 accumulators, each warp owning 16 rows (query rows
//   in the forward and dq, kv rows in dk/dv).  mma.sync and not wgmma: it
//   takes every operand layout these three kernels need from registers
//   (p and ds are C fragments) or through ldmatrix, and its 16-row warp
//   tiles keep the tile edges (D 80, ragged S, window) in one code path;
//   wgmma is later work.
// - Tiles stay bf16 in shared memory, rows padded to kPitch = D + 8
//   elements: an odd number of 16-byte chunks (17, 11, 9 at D 128, 80,
//   64), so any 8 consecutive rows' chunk c fall on 8 distinct bank groups
//   and every ldmatrix, plain or .trans, and every 16-byte cp.async and
//   store is conflict-free at every head dim.  D 80 needs no split: its
//   rows are 11 chunks, its k loop 5 steps of 16.
// - Fragments come from ldmatrix.x4, with .trans where a product reads a
//   tile along its rows as the reduced index: v in p v, k in ds k, do in
//   p^T do and q in ds^T q.  No transposed copy.
// - The forward's q fragments are loaded once into registers; dq and dk/dv
//   read their own rows' fragments (q, do; k, v) from shared memory per
//   tile, which leaves registers for their two accumulators.
// - Rounding: s, dp, the online maximum, the rescale, l, lse and delta are
//   f32; l is summed from the f32 p before any rounding, so lse keeps its
//   1e-5 bar.  In the forward p is rounded to bf16 in registers (round to
//   nearest even) as the A operand of p v, as FlashAttention-2 and cuDNN
//   do: one MMA.  In the backward p and ds go to their products (ds k, p^T
//   do, ds^T q) as a hi/lo pair of bf16, hi = bf16(x), lo = bf16(x - hi),
//   about 16 significant bits: two MMAs.  The CPU model of both roundings,
//   tests/test_torch_flash_bf16.py, decided it: with p rounded to bf16 o
//   stays within 0.44 of its bar (1e-2 + 1e-2 |o|), but with p and ds
//   rounded to bf16 the gradients move by up to 2.1e-3 of scale before
//   their own rounding to bf16, whose one ulp alone may be 7.8e-3 of scale
//   (a maximum just above a power of two): no margin under the 1e-2 bar.
//   Sums over tiles (o over kv tiles, dq over kv tiles, dk/dv over G x q
//   tiles) accumulate in the tensor cores' f32 accumulators: their
//   truncating adds cost ~7e-5 of scale over the longest sums
//   (flash_attention.cu), far inside the bf16 bars, so no fresh
//   accumulator per tile is kept.
// - exp is exp2f of the score scaled by scale * log2(e) (one FMA);
//   lse = m ln 2 + log(l).
// - Streamed tiles (k, v for the forward and dq; q, do, lse, delta for
//   dk/dv) run through a ring of kStages buffers filled with cp.async
//   (16 bytes per copy, zero-filled past S), kStages - 1 tiles in flight.
// - Outputs are staged through the warp's own rows of a shared tile and
//   written with 16-byte stores.
// - The grid puts the block index on its slowest axis, heaviest first
//   (the last q block for the forward and dq, kv block 0 for dk/dv).
// Tile rows, warps and stages (below) were chosen by timing at the T5 shape
// on an H100 (flash_bf16_tiles.py; PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// warps per CTA (each owns 16 of the CTA's rows), rows per streamed tile,
// and buffers in the ring of streamed tiles, per kernel.  Chosen at the T5
// shape (D 128) on an H100 (flash_bf16_tiles.py): the forward took 0.0680
// ms with 32-row kv tiles, 0.0756 with 64, 0.0710-0.0728 with 8 warps and
// 0.1183 with 3 stages; dq and dk/dv took 0.0849 and 0.1106 ms with 64-row
// tiles, 0.1007 and 0.1282 with 8 warps, 0.1158 and 0.1478 with 3 stages.
// dk/dv at D 128 holds both accumulators in 255 registers (24 bytes
// spilled).
constexpr int kFwdWarps = 4, kFwdTile = 32, kFwdStages = 2;
constexpr int kDqWarps = 4, kDqTile = 64, kDqStages = 2;
constexpr int kDkvWarps = 4, kDkvTile = 64, kDkvStages = 2;

// bf16 elements per shared row: an odd number of 16-byte chunks
template <int D>
constexpr int kPitch = D + 8;

// query row qr at position q0 + qr against key kp
__device__ __forceinline__ bool visible(int qr, int q0, int kp, int Sq, int Sk,
                                        int causal, int window) {
  const int qp = q0 + qr;
  bool m = kp < Sk && qr < Sq;
  if (causal) m = m && kp <= qp;
  if (window) m = m && kp > qp - window;
  return m;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// asynchronous global -> shared copies; a copy that is not valid writes
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b on the bf16 tensor cores (m16n8k16, f32 accumulators)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (to nearest even), x0 in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two f32 as a hi/lo pair of bf16: hi = bf16(x), lo = bf16(x - hi), so
// hi + lo keeps ~16 significant bits of x
__device__ __forceinline__ void pack_split(uint32_t& hi, uint32_t& lo,
                                           float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Fragment layouts of m16n8k16 (lane = 4 g + tq): A (16 x 16) holds rows g,
// g + 8 and columns 2 tq, 2 tq + 1 in a0 / a1, columns + 8 in a2 / a3;
// B (16 x 8) holds k 2 tq, 2 tq + 1 (b0) and + 8 (b1) of column n = g;
// C (16 x 8) holds (g, 2 tq..2 tq + 1) in c0, c1 and (g + 8, ..) in c2, c3.
//
// A of rows r0.. and columns k0.. of a [rows][kPitch] tile
template <int D>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int r0,
                                       int k0, int lane) {
  ldsm_x4(a, t + (r0 + (lane & 15)) * kPitch<D> + k0 + (lane >> 4) * 8);
}
// B of two n blocks (n0.., n0 + 8..) whose n runs along the tile's rows and
// k along its columns k0.. (s = q k^T: k stored [kv][d], reduced over d):
// b[0], b[1] for the first block, b[2], b[3] for the second
template <int D>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* t,
                                          int n0, int k0, int lane) {
  ldsm_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * kPitch<D> + k0 +
                 ((lane >> 3) & 1) * 8);
}
// B of two n blocks whose k runs along the tile's rows k0.. and n along its
// columns n0.. (o = p v: v stored [kv][d], reduced over kv), transposed by
// ldmatrix
template <int D>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* t,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch<D> +
                   n0 + (lane >> 4) * 8);
}
// The C fragments of 16 columns (blocks 2 kk, 2 kk + 1) as the A fragment
// of a product reduced over those columns: rounded to bf16 (hi), and with
// kSplit also the remainder (lo)
template <bool kSplit>
__device__ __forceinline__ void frag_a_from_c(uint32_t (&hi)[4],
                                              uint32_t (&lo)[4],
                                              const float (&c0)[4],
                                              const float (&c1)[4]) {
  if constexpr (kSplit) {
    pack_split(hi[0], lo[0], c0[0], c0[1]);
    pack_split(hi[1], lo[1], c0[2], c0[3]);
    pack_split(hi[2], lo[2], c1[0], c1[1]);
    pack_split(hi[3], lo[3], c1[2], c1[3]);
  } else {
    hi[0] = pack_bf16(c0[0], c0[1]);
    hi[1] = pack_bf16(c0[2], c0[3]);
    hi[2] = pack_bf16(c1[0], c1[1]);
    hi[3] = pack_bf16(c1[2], c1[3]);
  }
}

// acc (16 rows x D, C fragments) += c t: c the 16 rows' C fragments over
// the R rows of tile t, taken as A fragments (bf16; with kSplit a hi/lo
// pair, two MMAs, the small term first), t [R][kPitch] read along its rows
template <int D, int R, bool kSplit>
__device__ __forceinline__ void reduce_rows(float (&acc)[D / 8][4],
                                            const float (&c)[R / 8][4],
                                            const bf16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    uint32_t hi[4], lo[4];
    frag_a_from_c<kSplit>(hi, lo, c[2 * kk], c[2 * kk + 1]);
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t b[4];
      frag_b_kn<D>(b, t, 16 * kk, 16 * nd, lane);
      if constexpr (kSplit) {
        mma(acc[2 * nd], lo, b[0], b[1]);
        mma(acc[2 * nd + 1], lo, b[2], b[3]);
      }
      mma(acc[2 * nd], hi, b[0], b[1]);
      mma(acc[2 * nd + 1], hi, b[2], b[3]);
    }
  }
}

// R rows of D bf16 from row0 of a (.., S, heads, D) tensor (src points at
// the row-0 element of the head, rows row_stride elements apart) into a
// [R][kPitch] tile, 16 bytes per cp.async; rows >= S are zero-filled
template <int D, int R, int kThr>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          int64_t row_stride, int row0,
                                          int S) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < R * kChunks; e += kThr) {
    const int r = e / kChunks, c = (e % kChunks) * 8, s = row0 + r;
    cp_async16(dst + r * kPitch<D> + c,
               src + static_cast<int64_t>(s < S ? s : 0) * row_stride + c,
               s < S);
  }
}

// the warp's 16 rows of C fragments (acc / div per row) -> bf16 in the
// warp's own rows of shared tile t, then rows row0.. of the (.., S, heads,
// D) output (dst at its row-0 element of the head), 16 bytes per store;
// rows >= S are not written
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t row_stride,
                                           int row0, int S, bf16* t,
                                           const float (&acc)[D / 8][4],
                                           const float (&div)[2], int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(t + (g + 8 * i) * kPitch<D> + 8 * n +
                                   2 * tq) =
          pack_bf16(acc[n][2 * i] / div[i], acc[n][2 * i + 1] / div[i]);
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int e = lane; e < 16 * kChunks; e += 32) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(row0 + r) *
                                          row_stride + c) =
          *reinterpret_cast<const uint4*>(t + r * kPitch<D> + c);
  }
}

// ---------------------------------------------------------------------------
// forward (q-block-major)
// ---------------------------------------------------------------------------

// Grid (H, B, q blocks), the last q block first.  Warp w owns query rows
// 16 w .. 16 w + 15 of the CTA's 16 W, their q fragments in registers;
// per kv tile of BK rows: s = q k^T, the online softmax on the C fragments
// (a row's 4 lanes share its maximum by two shuffles; each lane keeps its
// own part of l, summed at the end), acc = acc * alpha + bf16(p) v.
template <int D, int W, int BK, int kStages>
__global__ void __launch_bounds__(32 * W)
flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                      const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int H, int Kv,
                      int q0, int causal, int window, float scale_log2) {
  constexpr int kThr = 32 * W, BQ = 16 * W, P = kPitch<D>;
  constexpr int NT = BK / 8, DT = D / 8, DK = D / 16;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(fwd_smem);  // [BQ][P]
  bf16* ring = q_s + BQ * P;                       // [kStages][k, v][BK][P]

  const int h = blockIdx.x, b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the CTA's first row
  const int kvh = h / (H / Kv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, wr = 16 * warp;
  const int64_t q_rs = static_cast<int64_t>(H) * D;
  const int64_t k_rs = static_cast<int64_t>(Kv) * D;
  const int64_t q_base = (static_cast<int64_t>(b) * Sq * H + h) * D;
  const int64_t k_base = (static_cast<int64_t>(b) * Sk * Kv + kvh) * D;

  // the visible kv tiles: up to the last row's position (causal), from the
  // first row's window start
  const int nkt = (Sk + BK - 1) / BK;
  const int q_first = q0 + r0, q_last = q0 + min(r0 + BQ, Sq) - 1;
  const int kt_end = causal ? min(q_last / BK + 1, nkt) : nkt;
  const int first = q_first - window + 1;
  const int kt_begin = (window && first > 0) ? first / BK : 0;
  const int n = kt_end - kt_begin;

  auto load = [&](int i) {
    bf16* t = ring + (i % kStages) * 2 * BK * P;
    const int kt = kt_begin + i;
    copy_tile<D, BK, kThr>(t, k + k_base, k_rs, kt * BK, Sk);
    copy_tile<D, BK, kThr>(t + BK * P, v + k_base, k_rs, kt * BK, Sk);
  };
  copy_tile<D, BQ, kThr>(q_s, q + q_base, q_rs, r0, Sq);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) load(i);
    cp_async_commit();          // q lands with the first tile
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  uint32_t qf[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) frag_a<D>(qf[kk], q_s, wr, 16 * kk, lane);

  int qr[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qr[i] = r0 + wr + g + 8 * i;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int nd = 0; nd < DT; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile i
    __syncthreads();                // everyone's; slot (i - 1) is free
    if (i + kStages - 1 < n) load(i + kStages - 1);
    cp_async_commit();
    const bf16* ks = ring + (i % kStages) * 2 * BK * P;
    const bf16* vs = ks + BK * P;
    const int k0 = (kt_begin + i) * BK;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
#pragma unroll
      for (int nj = 0; nj < BK / 16; ++nj) {
        uint32_t bk[4];
        frag_b_nk<D>(bk, ks, 16 * nj, 16 * kk, lane);
        mma(s[2 * nj], qf[kk], bk[0], bk[1]);
        mma(s[2 * nj + 1], qf[kk], bk[2], bk[3]);
      }

    // a tile that a bound or an edge crosses is masked element by element
    // (-inf: exp2 gives an exact 0 whatever the running maximum)
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q_first) ||
                      (window && k0 <= q_last - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = e >> 1, kp = k0 + 8 * j + 2 * tq + (e & 1);
        float x = s[j][e] * scale_log2;
        if (edge && !visible(qr[ii], q0, kp, Sq, Sk, causal, window))
          x = -INFINITY;
        s[j][e] = x;
        mx[ii] = fmaxf(mx[ii], x);
      }
    float alpha[2];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 1));
      mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 2));
      alpha[ii] = exp2f(m[ii] - mx[ii]);
      m[ii] = mx[ii];
      l[ii] *= alpha[ii];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);           // p, f32
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int nd = 0; nd < DT; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];
    reduce_rows<D, BK, false>(acc, s, vs, lane);        // acc += bf16(p) v
  }

  float div[2];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    l[ii] += __shfl_xor_sync(0xffffffffu, l[ii], 1);
    l[ii] += __shfl_xor_sync(0xffffffffu, l[ii], 2);
    div[ii] = fmaxf(l[ii], 1e-30f);
    if (tq == 0 && qr[ii] < Sq)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + qr[ii]] =
          m[ii] * kLn2 + logf(div[ii]);
  }
  // q_s's rows of this warp were read into qf only: stage o there
  store_rows<D>(o + q_base, q_rs, r0 + wr, Sq, q_s + wr * P, acc, div, lane);
}

// ---------------------------------------------------------------------------
// backward: dq (q-block-major)
// ---------------------------------------------------------------------------

// Grid (H, B, q blocks), the last q block first.  Warp w owns query rows
// 16 w .. of the CTA's 16 W; per kv tile of BK rows: s = q k^T and dp =
// do v^T, then in registers p = exp(s scale - lse), ds = p (dp - delta)
// scale and dq += ds k, ds a hi/lo pair of bf16.
template <int D, int W, int BK, int kStages>
__global__ void __launch_bounds__(32 * W)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int Sq, int Sk, int H, int Kv, int q0, int causal,
                     int window, float scale, float scale_log2) {
  constexpr int kThr = 32 * W, BQ = 16 * W, P = kPitch<D>;
  constexpr int NT = BK / 8, DT = D / 8, DK = D / 16;
  extern __shared__ __align__(16) unsigned char dq_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(dq_smem);  // [BQ][P]
  bf16* do_s = q_s + BQ * P;                      // [BQ][P]
  bf16* ring = do_s + BQ * P;                     // [kStages][k, v][BK][P]

  const int h = blockIdx.x, b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / Kv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, wr = 16 * warp;
  const int64_t q_rs = static_cast<int64_t>(H) * D;
  const int64_t k_rs = static_cast<int64_t>(Kv) * D;
  const int64_t q_base = (static_cast<int64_t>(b) * Sq * H + h) * D;
  const int64_t k_base = (static_cast<int64_t>(b) * Sk * Kv + kvh) * D;
  const int64_t r_base = (static_cast<int64_t>(b) * H + h) * Sq;

  const int nkt = (Sk + BK - 1) / BK;
  const int q_first = q0 + r0, q_last = q0 + min(r0 + BQ, Sq) - 1;
  const int kt_end = causal ? min(q_last / BK + 1, nkt) : nkt;
  const int first = q_first - window + 1;
  const int kt_begin = (window && first > 0) ? first / BK : 0;
  const int n = kt_end - kt_begin;

  auto load = [&](int i) {
    bf16* t = ring + (i % kStages) * 2 * BK * P;
    const int kt = kt_begin + i;
    copy_tile<D, BK, kThr>(t, k + k_base, k_rs, kt * BK, Sk);
    copy_tile<D, BK, kThr>(t + BK * P, v + k_base, k_rs, kt * BK, Sk);
  };
  copy_tile<D, BQ, kThr>(q_s, q + q_base, q_rs, r0, Sq);
  copy_tile<D, BQ, kThr>(do_s, dout + q_base, q_rs, r0, Sq);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) load(i);
    cp_async_commit();
  }

  int qr[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qr[i] = r0 + wr + g + 8 * i;
    lse2[i] = qr[i] < Sq ? lse[r_base + qr[i]] * kLog2e : 0.f;
    dl[i] = qr[i] < Sq ? delta[r_base + qr[i]] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int nd = 0; nd < DT; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < n) load(i + kStages - 1);
    cp_async_commit();
    const bf16* ks = ring + (i % kStages) * 2 * BK * P;
    const bf16* vs = ks + BK * P;
    const int k0 = (kt_begin + i) * BK;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t qa[4], da[4];
      frag_a<D>(qa, q_s, wr, 16 * kk, lane);
      frag_a<D>(da, do_s, wr, 16 * kk, lane);
#pragma unroll
      for (int nj = 0; nj < BK / 16; ++nj) {
        uint32_t bk[4], bv[4];
        frag_b_nk<D>(bk, ks, 16 * nj, 16 * kk, lane);
        frag_b_nk<D>(bv, vs, 16 * nj, 16 * kk, lane);
        mma(s[2 * nj], qa, bk[0], bk[1]);
        mma(s[2 * nj + 1], qa, bk[2], bk[3]);
        mma(dp[2 * nj], da, bv[0], bv[1]);
        mma(dp[2 * nj + 1], da, bv[2], bv[3]);
      }
    }
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q_first) ||
                      (window && k0 <= q_last - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = e >> 1, kp = k0 + 8 * j + 2 * tq + (e & 1);
        float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[ii]));
        if (edge && !visible(qr[ii], q0, kp, Sq, Sk, causal, window))
          p = 0.f;
        s[j][e] = p * (dp[j][e] - dl[ii]) * scale;    // ds, f32
      }
    reduce_rows<D, BK, true>(acc, s, ks, lane);         // dq += ds k
  }

  const float one[2] = {1.f, 1.f};
  // q_s's rows of this warp are read by this warp only: stage dq there
  store_rows<D>(dq + q_base, q_rs, r0 + wr, Sq, q_s + wr * P, acc, one,
                lane);
}

// ---------------------------------------------------------------------------
// backward: dk, dv (kv-block-major, the G query heads folded into the loop)
// ---------------------------------------------------------------------------

// Grid (Kv, B, kv blocks), kv block 0 first.  Warp w owns kv rows 16 w ..
// of the CTA's 16 W and keeps both of their D-wide accumulators.  The CTA
// walks the G query heads of its kv head and their visible q tiles of BQ
// rows in one flattened loop; per tile: s^T = k q^T and dp^T = v do^T,
// p = exp(s^T scale - lse), dv += p do, ds = p (dp^T - delta) scale,
// dk += ds q, p and ds each a hi/lo pair of bf16.
template <int D, int W, int BQ, int kStages>
__global__ void __launch_bounds__(32 * W)
flash_dkv_bf16_kernel(const bf16* __restrict__ q,
                      const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Sq, int Sk, int H, int Kv,
                      int q0, int causal, int window, float scale,
                      float scale_log2) {
  constexpr int kThr = 32 * W, BKV = 16 * W, P = kPitch<D>;
  constexpr int NT = BQ / 8, DT = D / 8, DK = D / 16;
  static_assert(2 * BQ <= kThr, "one thread per lse and delta copy");
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(dkv_smem);  // [BKV][P]
  bf16* v_s = k_s + BKV * P;                       // [BKV][P]
  bf16* ring = v_s + BKV * P;                      // [kStages][q, do][BQ][P]
  float* rows_s = reinterpret_cast<float*>(ring + kStages * 2 * BQ * P);
  //                                                  [kStages][lse, delta][BQ]

  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BKV;
  const int G = H / Kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, wr = 16 * warp;
  const int64_t q_rs = static_cast<int64_t>(H) * D;
  const int64_t k_rs = static_cast<int64_t>(Kv) * D;
  const int64_t k_base = (static_cast<int64_t>(b) * Sk * Kv + kvh) * D;

  // the visible q tiles (row r at position q0 + r): none wholly before the
  // kv block (causal), none wholly past its window
  const int nqt = (Sq + BQ - 1) / BQ;
  const int k_last = min(k0 + BKV, Sk) - 1;
  const int qt_begin = causal ? max(k0 - q0, 0) / BQ : 0;
  const int w_last = k_last + window - 1 - q0;   // last row in the window
  const int qt_end =
      window ? (w_last < 0 ? 0 : min(nqt, w_last / BQ + 1)) : nqt;
  const int nt = max(qt_end - qt_begin, 0), n = G * nt;

  auto load = [&](int it) {
    const int slot = it % kStages;
    const int hh = kvh * G + it / nt, r0 = (qt_begin + it % nt) * BQ;
    const int64_t q_base = (static_cast<int64_t>(b) * Sq * H + hh) * D;
    const int64_t r_base = (static_cast<int64_t>(b) * H + hh) * Sq;
    bf16* t = ring + slot * 2 * BQ * P;
    copy_tile<D, BQ, kThr>(t, q + q_base, q_rs, r0, Sq);
    copy_tile<D, BQ, kThr>(t + BQ * P, dout + q_base, q_rs, r0, Sq);
    const int i = threadIdx.x % BQ, qr = r0 + i;
    const int64_t at = r_base + (qr < Sq ? qr : 0);
    float* rs = rows_s + slot * 2 * BQ;
    if (threadIdx.x < BQ)
      cp_async4(rs + i, lse + at, qr < Sq);
    else if (threadIdx.x < 2 * BQ)
      cp_async4(rs + BQ + i, delta + at, qr < Sq);
  };
  copy_tile<D, BKV, kThr>(k_s, k + k_base, k_rs, k0, Sk);
  copy_tile<D, BKV, kThr>(v_s, v + k_base, k_rs, k0, Sk);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) load(i);
    cp_async_commit();          // k and v land with the first tile
  }

  int kp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kp[i] = k0 + wr + g + 8 * i;
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int nd = 0; nd < DT; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n) load(it + kStages - 1);
    cp_async_commit();
    const bf16* qs = ring + (it % kStages) * 2 * BQ * P;
    const bf16* dos = qs + BQ * P;
    const float* ls = rows_s + (it % kStages) * 2 * BQ;
    const float* dl = ls + BQ;
    const int r0 = (qt_begin + it % nt) * BQ;

    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t ka[4], va[4];
      frag_a<D>(ka, k_s, wr, 16 * kk, lane);
      frag_a<D>(va, v_s, wr, 16 * kk, lane);
#pragma unroll
      for (int nj = 0; nj < BQ / 16; ++nj) {
        uint32_t bq[4], bd[4];
        frag_b_nk<D>(bq, qs, 16 * nj, 16 * kk, lane);
        frag_b_nk<D>(bd, dos, 16 * nj, 16 * kk, lane);
        mma(st[2 * nj], ka, bq[0], bq[1]);
        mma(st[2 * nj + 1], ka, bq[2], bq[3]);
        mma(dpt[2 * nj], va, bd[0], bd[1]);
        mma(dpt[2 * nj + 1], va, bd[2], bd[3]);
      }
    }
    const int q_first = q0 + r0, q_last = q0 + min(r0 + BQ, Sq) - 1;
    const bool edge = r0 + BQ > Sq || k0 + BKV > Sk ||
                      (causal && k0 + BKV - 1 > q_first) ||
                      (window && k0 <= q_last - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * tq + (e & 1);
        float p = exp2f(fmaf(st[j][e], scale_log2, -ls[r] * kLog2e));
        if (edge && !visible(r0 + r, q0, kp[e >> 1], Sq, Sk, causal, window))
          p = 0.f;
        st[j][e] = p;                                      // p, f32
        dpt[j][e] = p * (dpt[j][e] - dl[r]) * scale;      // ds, f32
      }
    reduce_rows<D, BQ, true>(dv_acc, st, dos, lane);    // dv += p^T do
    reduce_rows<D, BQ, true>(dk_acc, dpt, qs, lane);     // dk += ds^T q
  }

  // k_s's and v_s's rows of this warp are read by this warp only: stage
  // dk and dv there, once every thread's copies into them have landed (a
  // block with no visible q tile never waited in the loop)
  cp_async_wait<0>();
  __syncthreads();
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk + k_base, k_rs, k0 + wr, Sk, k_s + wr * P, dk_acc, one,
                lane);
  store_rows<D>(dv + k_base, k_rs, k0 + wr, Sk, v_s + wr * P, dv_acc, one,
                lane);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int Sq, int Sk, int H, int Kv, int q0, int causal, int window,
        float scale, cudaStream_t st) {
  constexpr int W = kFwdWarps, R = kFwdTile, S = kFwdStages;
  constexpr size_t smem = (16 * W + S * 2 * R) * kPitch<D> * sizeof(bf16);
  auto* kernel = flash_fwd_bf16_kernel<D, W, R, S>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(H, B, (Sq + 16 * W - 1) / (16 * W));
  kernel<<<grid, 32 * W, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Sq, Sk, H, Kv, q0, causal, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int Sq,
           int Sk, int H, int Kv, int q0, int causal, int window, float scale,
           cudaStream_t st) {
  constexpr int W = kDqWarps, R = kDqTile, S = kDqStages;
  constexpr size_t smem = (2 * 16 * W + S * 2 * R) * kPitch<D> * sizeof(bf16);
  auto* kernel = flash_dq_bf16_kernel<D, W, R, S>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(H, B, (Sq + 16 * W - 1) / (16 * W));
  kernel<<<grid, 32 * W, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Sq, Sk, H, Kv, q0, causal, window, scale,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int B,
            int Sq, int Sk, int H, int Kv, int q0, int causal, int window,
            float scale, cudaStream_t st) {
  constexpr int W = kDkvWarps, R = kDkvTile, S = kDkvStages;
  constexpr size_t smem = (2 * 16 * W + S * 2 * R) * kPitch<D> *
                              sizeof(bf16) +
                          S * 2 * R * sizeof(float);
  auto* kernel = flash_dkv_bf16_kernel<D, W, R, S>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(Kv, B, (Sk + 16 * W - 1) / (16 * W));
  kernel<<<grid, 32 * W, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H, Kv, q0,
      causal, window, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// head dims with a compiled kernel (those of flash_attention.cu); anything
// else is refused
#define FLASH_DISPATCH_D(D, CALL)                                     \
  switch (D) {                                                        \
    case 64: { constexpr int kD = 64; return CALL; }                  \
    case 80: { constexpr int kD = 80; return CALL; }                  \
    case 128: { constexpr int kD = 128; return CALL; }                \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }

}  // namespace

// Forward: q, o (B, Sq, H, D) and k, v (B, Sk, Kv, D) bf16; lse (B, H, Sq)
// f32; all contiguous; query row i at position q0 + i.  Returns
// cudaGetLastError() right after the launch (cudaErrorInvalidValue for a
// head dim with no kernel).
extern "C" int flash_attn_fwd_bf16(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int Sq, int Sk, int H, int Kv, int D,
                                   int q0, int causal, int window,
                                   float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, (fwd<kD>(q, k, v, o, lse, B, Sq, Sk, H, Kv, q0, causal,
                               window, scale, st)))
}

// Backward dq: dout and dq as q; lse and delta (B, H, Sq) f32.
extern "C" int flash_attn_dq_bf16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int B, int Sq, int Sk, int H,
                                  int Kv, int D, int q0, int causal,
                                  int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, (bwd_dq<kD>(q, k, v, dout, lse, delta, dq, B, Sq, Sk,
                                  H, Kv, q0, causal, window, scale, st)))
}

// Backward dk/dv: dk and dv as k.
extern "C" int flash_attn_dkv_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int Sq, int Sk,
                                   int H, int Kv, int D, int q0, int causal,
                                   int window, float scale, void* stream) {
  if (B <= 0 || Sk <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, (bwd_dkv<kD>(q, k, v, dout, lse, delta, dk, dv, B, Sq,
                                   Sk, H, Kv, q0, causal, window, scale,
                                   st)))
}

extern "C" const char* flash_attention_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
