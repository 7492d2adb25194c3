// Flash attention for training on Hopper (sm_90a), f32 inputs: the forward
// (o and the logsumexp residual) and the FlashAttention-2 backward as two
// kernels.  bf16 inputs have a design of their own, in
// flash_attention_bf16.cu.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//
//   flash_fwd_kernel      _flash_kernel (called from _flash_forward).
//                         Grid (H, B, q blocks): one CTA per 16 W query rows
//                         of one head walks the visible kv tiles with a
//                         running (m, l, acc) online softmax and writes
//                         o = acc / max(l, 1e-30) and lse = m + log(max(l,
//                         1e-30)); the TPU carried (m, l, acc) across a
//                         sequential grid axis in VMEM scratch.
//   flash_bwd_dq_kernel   _flash_bwd_dq_kernel (from _flash_backward).
//                         Grid (H, B, q blocks): p = exp(s - lse),
//                         ds = p * (dp - delta) * scale, dq += ds k.
//   flash_bwd_dkv_kernel  _flash_bwd_dkv_kernel.  Grid (Kv, B, kv blocks):
//                         one CTA per 8 W kv rows of one kv head loops over
//                         the G query heads of that kv head and their q
//                         blocks (the TPU's flattened (group, q block)
//                         sequential axis): dv += p^T do, dk += ds^T q.
//                         dk/dv stay in registers; no atomics, so the result
//                         is the same bits from run to run.
//
// Layouts are the JAX package's: q, o, do (B, Sq, H, D); k, v (B, Sk, Kv,
// D); query head h reads kv head h / G (GQA by index arithmetic, no
// repeated K/V); lse and delta (B, H, Sq) f32.  Query row i sits at
// position q0 + i, key row j at position j: self-attention has q0 = 0 and
// Sq = Sk; a context-parallel rank attends its Sq = Sk / n queries at
// q0 = rank * Sq against every key (the JAX package's _cp_attend).  Masks
// as _block_mask, on positions: key row < Sk, causal k <= q, window
// k > q - window; query rows >= Sq are masked too and never written.  The
// TPU pads S up to a block multiple and visits every block; here each CTA
// masks the ragged edge itself (rows past Sq or Sk are zero-filled in
// shared memory) and loops only over the tiles that the causal and window
// bounds leave visible (with q0: the forward and dq stop at the key tile
// of their last row's position, dk/dv starts at the first q tile whose
// rows reach its key block).  With q0 = 0 and Sq = Sk every bound is the
// self-attention one, so those launches run as before, bit for bit.  A
// fully masked tile is an exact no-op of the online update (alpha = 1,
// p = 0), so the bounds change no number.
//
// Bound on the H100: operations.  At the training shape (S 512, D 128) the
// causal forward does ~S/2 * D * 4 operations per query row against ~D * 4
// bytes read per row, far above the ridge of any of the card's rates.
//
// All three kernels multiply on the tensor cores.  The f32 path must keep
// f32 products (TF32 alone, 10 mantissa bits, would miss the 1e-5 output
// and 1e-4 gradient tolerances), so each f32 operand x is split into
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest (cvt.rna's
// rounding), and a b is summed as a_lo b_hi + a_hi b_lo + a_hi b_hi in f32
// ("3xTF32", CUTLASS's OpMultiplyAddFastF32): three mma.sync.m16n8k8 TF32
// per product, so the bound is 495 / 3 = 165 TFLOP/s.  The kernels run at
// ~20 % of that bound: every f32 fragment value costs a shared load and
// five ALU instructions of splitting for the 3 MMAs it feeds.  The design:
// - Tiles: a warp owns 16 rows of the CTA's own rows (query rows for the
//   forward and dq, kv rows for dk/dv) and walks tiles of streamed rows (kv
//   rows for the forward and dq; q rows of the G query heads for dk/dv).
//   All tiles are f32 in shared memory, [rows][D] with an XOR swizzle (swz)
//   that keeps the fragment reads of both orientations conflict-free, so
//   no transposed copy is needed.  The swizzle moves columns
//   within 32-column groups, so a tile's rows are D rounded up to 32
//   floats apart (kPitch: 96 at D 80, whose last 16 columns would
//   otherwise spill into the next row).
// - p and ds never leave the registers in the forward and dq: the C
//   fragment of s / dp is the A fragment of o += p v / dq += ds k once its
//   8 columns are read in the order 0, 2, 4, 6 | 1, 3, 5, 7, which the
//   matching B fragment reads too.  The forward's online softmax runs on
//   the C fragments: a row's 4 lanes (tq) share its maximum and sum by two
//   shuffles.
// - dk/dv splits each 16-row block over a warp pair: one warp computes
//   s^T, p and dv, the other dp^T, ds and dk, p passing through shared
//   memory, so each warp holds one D-wide accumulator (two spilled).
// - The products that reduce over rows (o, dq, dk, dv) sum each streamed
//   tile in a fresh accumulator and add it to the running sum in IEEE f32
//   (the forward as acc * alpha + tile, the plain version's update): the
//   tensor cores' own accumulation truncates, which over the S or G * S
//   rows of a long sum cost up to 7e-5 of scale.
// - The next streamed tile is copied with cp.async (16 bytes per copy,
//   zero-filled past S) into a second buffer while the current one is
//   multiplied.
// - Shared memory per CTA (D 128): forward 96 KB (4 warps, 64 query
//   rows, 32-row kv tiles; two CTAs per SM), dq 192 KB (8 warps, 128 query
//   rows; one CTA per SM), dk/dv 100.5 KB (4 warps, 32 kv rows; two CTAs
//   per SM); at D 80 the tiles are 96 floats wide: 72, 144 and 76.5 KB;
//   at D 64 (two whole 32-column groups, so the swizzle reads the same
//   banks as at D 128) 48, 96 and 52.5 KB, with the same warp counts and
//   tile rows.
//   The grid puts the block index on its slowest axis, heaviest
//   first (the last q block for the forward and dq, kv block 0 for dk/dv),
//   so the causal tail is short.
// wgmma (TF32 only K-major from shared memory), TMA and producer warps are
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// query row qr at position q0 + qr against key kp
__device__ __forceinline__ bool visible(int qr, int q0, int kp, int Sq, int Sk,
                                        int causal, int window) {
  const int qp = q0 + qr;
  bool m = kp < Sk && qr < Sq;
  if (causal) m = m && kp <= qp;
  if (window) m = m && kp > qp - window;
  return m;
}

// ---------------------------------------------------------------------------
// shared pieces (tensor-core products, swizzled f32 tiles, asynchronous
// copies)
// ---------------------------------------------------------------------------

// Warps per CTA (each owns 16 of the CTA's own rows) and rows per streamed
// tile, for the forward, dq and dk/dv; chosen by timing on an H100
// (PERF.md).  The plain forward walks kFwdStream-row blocks too
// (flash_attention.py FWD_BLOCK), so both rescale at the same points.
constexpr int kFwdWarps = 4, kFwdStream = 32;
constexpr int kDqWarps = 8, kDqStream = 32;
constexpr int kDkvWarps = 4, kDkvStream = 32;

// Row pitch, in floats, of a shared f32 tile of head dim D: D rounded up
// to a whole 32-column group.  The swizzle below moves a column anywhere
// within its 32-column group, so a D that is not a multiple of 32 (80:
// columns 64-79 of the last group may land on 64-95) needs the group's
// whole width.  Logical columns D..kPitch-1 are never used, but the
// swizzle may store any logical column of the last group in any physical
// column of that group (at D 80, logical 64-79 land on physical 80-95 in
// rows whose mask is 16 or more), so the whole group must be allocated
// and no other data may live in its tail.
template <int D>
constexpr int kPitch = (D + 31) / 32 * 32;

// Index of element (r, c) of a [rows][kPitch<D>] f32 tile whose columns are
// XOR-swizzled in 4-column steps within each 32-column group.  Reads of both
// fragment shapes below (8 rows x 4 columns; 4 or 8 rows x 8 columns in the
// order 0, 2, 4, 6 | 1, 3, 5, 7) hit 32 distinct banks, so one layout of a
// tile serves both orientations of every product.  16-byte chunks stay
// whole, which the 16-byte copies need.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * kPitch<D> + (c ^ ((((r & 3) ^ ((r >> 2) & 1)) << 3) | (r & 4)));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds.  For finite x that is adding half a
// TF32 ulp to the bits of |x| and clearing the 13 low bits: two integer
// instructions, which ran faster on an H100 than the cvt (PERF.md).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// N operand registers of one mma.sync.  With kSplit each value x is held as
// hi = tf32(x) and lo = tf32(x - hi) (3xTF32: a*b ~ a_hi*b_hi + a_hi*b_lo +
// a_lo*b_hi, f32 accuracy); without, x is exact in TF32 and only hi is
// kept.
template <int N, bool kSplit>
struct Frag {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float x) {
    if constexpr (kSplit) {
      hi[i] = to_tf32(x);
      lo[i] = to_tf32(x - __uint_as_float(hi[i]));
    } else {
      hi[i] = __float_as_uint(x);
    }
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a b[j] on the tensor cores for N independent accumulators: the
// small cross terms first, then hi*hi, each term over all N before the
// next, so that no MMA waits on the one issued just before it
template <int N, bool kSA, bool kSB>
__device__ __forceinline__ void mma3(float (&d)[N][4], const Frag<4, kSA>& a,
                                     const Frag<2, kSB> (&b)[N]) {
  if constexpr (kSA) {
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(d[j], a.lo, b[j].hi);
  }
  if constexpr (kSB) {
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(d[j], a.hi, b[j].lo);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], a.hi, b[j].hi);
}

// as mma3, with the small cross terms summed in their own accumulators dl
// (added to d by the caller): the running sum d then takes one truncating
// tensor-core accumulation per k step instead of three
template <int N, bool kSA, bool kSB>
__device__ __forceinline__ void mma3(float (&d)[N][4], float (&dl)[N][4],
                                     const Frag<4, kSA>& a,
                                     const Frag<2, kSB> (&b)[N]) {
  if constexpr (kSA) {
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(dl[j], a.lo, b[j].hi);
  }
  if constexpr (kSB) {
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(dl[j], a.hi, b[j].lo);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], a.hi, b[j].hi);
}

// acc += part in IEEE f32.  The tensor cores add into their accumulator
// with truncation, which biases a long sum (dq over S keys, dk/dv over G * S
// queries); so the products that reduce over rows sum each streamed tile
// into a fresh accumulator and add it to the running sum here.
__device__ __forceinline__ void add4(float (&acc)[4], const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// Fragment layouts of m16n8k8 (lane = 4 g + tq): A (16 x 8) holds (g, tq),
// (g + 8, tq), (g, tq + 4), (g + 8, tq + 4); B (8 x 8) holds (k tq, n g),
// (k tq + 4, n g); C (16 x 8) holds (g, 2 tq), (g, 2 tq + 1), (g + 8, 2 tq),
// (g + 8, 2 tq + 1).
//
// A: rows r0.. and columns k0.. of a tile
template <int D, bool kS>
__device__ __forceinline__ void frag_a(Frag<4, kS>& a, const float* t, int r0,
                                       int k0, int g, int tq) {
  a.set(0, t[swz<D>(r0 + g, k0 + tq)]);
  a.set(1, t[swz<D>(r0 + g + 8, k0 + tq)]);
  a.set(2, t[swz<D>(r0 + g, k0 + tq + 4)]);
  a.set(3, t[swz<D>(r0 + g + 8, k0 + tq + 4)]);
}
// B whose n runs along the tile's rows n0.. and k along its columns k0..
// (s = q k^T: k is stored [kv][d], reduced over d)
template <int D, bool kS>
__device__ __forceinline__ void frag_b_nk(Frag<2, kS>& b, const float* t,
                                          int n0, int k0, int g, int tq) {
  b.set(0, t[swz<D>(n0 + g, k0 + tq)]);
  b.set(1, t[swz<D>(n0 + g, k0 + tq + 4)]);
}
// A C fragment reused as the A of the next product: its 8 columns become
// the reduced index in the order 0, 2, 4, 6 | 1, 3, 5, 7, so the registers
// only change places (p and ds never leave the registers)
__device__ __forceinline__ void frag_a_from_c(Frag<4, true>& a,
                                              const float (&c)[4]) {
  a.set(0, c[0]);
  a.set(1, c[2]);
  a.set(2, c[1]);
  a.set(3, c[3]);
}
// the B that goes with it: k runs along the tile's rows k0.. in that order,
// n along its columns n0.. (dq = ds k: k stored [kv][d], reduced over kv)
template <int D, bool kS>
__device__ __forceinline__ void frag_b_kn(Frag<2, kS>& b, const float* t,
                                          int k0, int n0, int g, int tq) {
  b.set(0, t[swz<D>(k0 + 2 * tq, n0 + g)]);
  b.set(1, t[swz<D>(k0 + 2 * tq + 1, n0 + g)]);
}

// acc (16 rows x D) += a t over the 8 NT rows of tile t, a given as NT A
// fragments taken from C fragments: the second product of each kernel
// (dq += ds k, dv += p^T do, dk += ds^T q).  Four column blocks at a time
// sum into fresh accumulators, added to acc in f32 (add4).
template <int D, int NT, bool kS>
__device__ __forceinline__ void reduce_rows(float (&acc)[D / 8][4],
                                            const Frag<4, true> (&a)[NT],
                                            const float* t, int g, int tq) {
  constexpr int kGroup = (D / 8) % 4 == 0 ? 4 : 2;   // D 80: 10 blocks
  static_assert((D / 8) % kGroup == 0, "head dim: a multiple of 16");
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += kGroup) {
    float part[kGroup][4];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      Frag<2, kS> bf[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        frag_b_kn<D>(bf[i], t, 8 * j, 8 * (n0 + i), g, tq);
      mma3(part, a[j], bf);
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) add4(acc[n0 + i], part[i]);
  }
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

// R rows from row0 of a (.., S, heads, D) tensor (src points at the row-0
// element of the head), 16 bytes per copy, straight into a swizzled tile.
// Rows >= S are zero-filled.
template <int D, int R, int kThr>
__device__ __forceinline__ void copy_rows_async(float* dst, const float* src,
                                                int64_t row_stride, int row0,
                                                int S) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < R * kChunks; e += kThr) {
    const int r = e / kChunks, c = (e % kChunks) * 4, s = row0 + r;
    const float* from =
        src + static_cast<int64_t>(s < S ? s : 0) * row_stride + c;
    cp_async16(dst + swz<D>(r, c), from, s < S);
  }
}

// R rows as copy_rows_async, but loaded now (the CTA's own tiles, read
// once)
template <int D, int R, int kThr>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t row_stride, int row0,
                                          int S) {
  for (int e = threadIdx.x; e < R * D / 4; e += kThr) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4, s = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S)
      x = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(s) * row_stride + c);
    *reinterpret_cast<float4*>(dst + swz<D>(r, c)) = x;
  }
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// shared memory of a CTA with `own` tiles of `rows` own rows and R rows per
// streamed tile: two double-buffered streamed tiles, and for dk/dv (`dkv`)
// p and the streamed rows' lse and delta.  Tiles have rows of kPitch<D>
// floats.
template <int D, int R>
constexpr size_t tile_smem_bytes(int own, int rows, bool dkv) {
  constexpr int P = kPitch<D>;
  return (own * rows * P + 2 * 2 * R * P) * sizeof(float) +
         (dkv ? (rows * R + 4 * R) * sizeof(float) : 0);
}

// ---------------------------------------------------------------------------
// forward (q-block-major)
// ---------------------------------------------------------------------------

// Grid (H, B, q blocks), the last q block (the most causal work) first.
// Each of the W warps owns 16 of the CTA's 16 W query rows; the CTA walks
// the visible kv tiles of BK rows, the next one in flight (cp.async) while
// it computes s = q k^T into C fragments, then in registers the online
// softmax (m, l per row; p = exp(s * scale - m_new), alpha = exp(m -
// m_new)) and acc = acc * alpha + p v, the tile's p v summed in a fresh
// accumulator.
template <int D, int W, int BK>
__global__ void __launch_bounds__(32 * W, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Kv,
                 int q0, int causal, int window, float scale) {
  constexpr int kThr = 32 * W, BQ = 16 * W, NT = BK / 8, DT = D / 8;
  constexpr int P = kPitch<D>;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  float* q_s = reinterpret_cast<float*>(fwd_smem);  // [BQ][P]
  float* k_s = q_s + BQ * P;                         // [2][BK][P]
  float* v_s = k_s + 2 * BK * P;                     // [2][BK][P]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = (Sq + BQ - 1) / BQ - 1 - blockIdx.z;
  const int kvh = h / (H / Kv);
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            tq = threadIdx.x & 3, wr = 16 * warp;
  const int r0 = qb * BQ;            // the CTA's first query row
  const int64_t q_rs = static_cast<int64_t>(H) * D;
  const int64_t k_rs = static_cast<int64_t>(Kv) * D;
  const int64_t q_base = (static_cast<int64_t>(b) * Sq * H + h) * D;
  const int64_t k_base = (static_cast<int64_t>(b) * Sk * Kv + kvh) * D;

  // the visible kv tiles: up to the last row's position (causal), from
  // the first row's window start
  const int nkt = (Sk + BK - 1) / BK;
  const int q_last = q0 + min(r0 + BQ, Sq) - 1;
  const int kt_end = causal ? min(q_last / BK + 1, nkt) : nkt;
  const int first = q0 + r0 - window + 1;
  const int kt_begin = (window && first > 0) ? first / BK : 0;

  auto prefetch = [&](int kt, int buf) {
    copy_rows_async<D, BK, kThr>(k_s + buf * BK * P, k + k_base, k_rs,
                                 kt * BK, Sk);
    copy_rows_async<D, BK, kThr>(v_s + buf * BK * P, v + k_base, k_rs,
                                 kt * BK, Sk);
  };
  prefetch(kt_begin, 0);
  cp_async_commit();
  load_rows<D, BQ, kThr>(q_s, q + q_base, q_rs, r0, Sq);

  // this lane's two rows (g and g + 8 of the warp's 16)
  int qp[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qp[i] = r0 + wr + g + 8 * i;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    __syncthreads();                 // every warp is done with buffer buf ^ 1
    if (kt + 1 < kt_end) prefetch(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();              // this thread's copies of tile kt
    __syncthreads();                 // everyone's
    const float* kt_s = k_s + buf * BK * P;
    const float* vt_s = v_s + buf * BK * P;

    // s: hi * hi terms in s, the cross terms in sl (half the error of
    // one accumulator, at the same speed on an H100)
    float s[NT][4], sl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      Frag<4, true> qa;
      Frag<2, true> kf[NT];
      frag_a<D>(qa, q_s, wr, 8 * kk, g, tq);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        frag_b_nk<D>(kf[j], kt_s, 8 * j, 8 * kk, g, tq);
      mma3(s, sl, qa, kf);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) add4(s[j], sl[j]);

    // online softmax on the C fragments: element e of s[j] is row i = e / 2
    // (g or g + 8), key k0 + 8 j + 2 tq + e % 2; a row's 4 lanes share
    // its maximum and sum
    const int k0 = kt * BK;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kp = k0 + 8 * j + 2 * tq + (e & 1);
        s[j][e] = visible(qp[i], q0, kp, Sq, Sk, causal, window)
                      ? s[j][e] * scale : kNegInf;
        mx[i] = fmaxf(mx[i], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kp = k0 + 8 * j + 2 * tq + (e & 1);
        s[j][e] = visible(qp[i], q0, kp, Sq, Sk, causal, window)
                      ? expf(s[j][e] - m[i]) : 0.f;         // p
        sum[i] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // acc += p v, the tile summed in fresh accumulators (reduce_rows)
    Frag<4, true> a[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) frag_a_from_c(a[j], s[j]);
    reduce_rows<D, NT, true>(acc, a, vt_s, g, tq);
  }

  const int64_t r_base = (static_cast<int64_t>(b) * H + h) * Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qp[i] >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* row = o + q_base + static_cast<int64_t>(qp[i]) * q_rs;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      store2(row + 8 * n + 2 * tq, acc[n][2 * i] / denom,
             acc[n][2 * i + 1] / denom);
    if (tq == 0) lse[r_base + qp[i]] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// backward: dq (q-block-major)
// ---------------------------------------------------------------------------

// Grid (H, B, q blocks), the last q block (the most causal work) first.
// Each of the W warps owns 16 of the CTA's 16 W query rows; the CTA walks
// the visible kv tiles of BK rows, the next one in flight (cp.async) while
// it computes:
// s = q k^T and dp = do v^T into C fragments, then in registers
// p = exp(s * scale - lse), ds = p (dp - delta) scale, dq += ds k.
template <int D, int W, int BK>
__global__ void __launch_bounds__(32 * W, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Sq, int Sk, int H, int Kv, int q0, int causal,
                    int window, float scale) {
  constexpr int kThr = 32 * W, BQ = 16 * W, NT = BK / 8, DT = D / 8;
  constexpr int P = kPitch<D>;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* q_s = reinterpret_cast<float*>(bwd_smem);  // [BQ][P]
  float* do_s = q_s + BQ * P;                        // [BQ][P]
  float* k_s = do_s + BQ * P;                        // [2][BK][P]
  float* v_s = k_s + 2 * BK * P;                     // [2][BK][P]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = (Sq + BQ - 1) / BQ - 1 - blockIdx.z;
  const int kvh = h / (H / Kv);
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            tq = threadIdx.x & 3, wr = 16 * warp;
  const int r0 = qb * BQ;            // the CTA's first query row
  const int64_t q_rs = static_cast<int64_t>(H) * D;
  const int64_t k_rs = static_cast<int64_t>(Kv) * D;
  const int64_t q_base = (static_cast<int64_t>(b) * Sq * H + h) * D;
  const int64_t k_base = (static_cast<int64_t>(b) * Sk * Kv + kvh) * D;
  const int64_t r_base = (static_cast<int64_t>(b) * H + h) * Sq;

  // the visible kv tiles: up to the last row's position (causal), from
  // the first row's window start
  const int nkt = (Sk + BK - 1) / BK;
  const int q_last = q0 + min(r0 + BQ, Sq) - 1;
  const int kt_end = causal ? min(q_last / BK + 1, nkt) : nkt;
  const int first = q0 + r0 - window + 1;
  const int kt_begin = (window && first > 0) ? first / BK : 0;

  auto prefetch = [&](int kt, int buf) {
    copy_rows_async<D, BK, kThr>(k_s + buf * BK * P, k + k_base, k_rs,
                                 kt * BK, Sk);
    copy_rows_async<D, BK, kThr>(v_s + buf * BK * P, v + k_base, k_rs,
                                 kt * BK, Sk);
  };
  prefetch(kt_begin, 0);
  cp_async_commit();
  load_rows<D, BQ, kThr>(q_s, q + q_base, q_rs, r0, Sq);
  load_rows<D, BQ, kThr>(do_s, dout + q_base, q_rs, r0, Sq);

  int qp[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qp[i] = r0 + wr + g + 8 * i;
    lse_r[i] = qp[i] < Sq ? lse[r_base + qp[i]] : 0.f;
    delta_r[i] = qp[i] < Sq ? delta[r_base + qp[i]] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    __syncthreads();                 // every warp is done with buffer buf ^ 1
    if (kt + 1 < kt_end) prefetch(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();              // this thread's copies of tile kt
    __syncthreads();                 // everyone's
    const float* kt_s = k_s + buf * BK * P;
    const float* vt_s = v_s + buf * BK * P;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      Frag<4, true> qa, da;
      Frag<2, true> kf[NT], vf[NT];
      frag_a<D>(qa, q_s, wr, 8 * kk, g, tq);
      frag_a<D>(da, do_s, wr, 8 * kk, g, tq);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        frag_b_nk<D>(kf[j], kt_s, 8 * j, 8 * kk, g, tq);
        frag_b_nk<D>(vf[j], vt_s, 8 * j, 8 * kk, g, tq);
      }
      mma3(s, qa, kf);
      mma3(dp, da, vf);
    }
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kp = k0 + 8 * j + 2 * tq + (e & 1);
        const float p = visible(qp[i], q0, kp, Sq, Sk, causal, window)
                            ? expf(s[j][e] * scale - lse_r[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[i]) * scale;   // ds
      }
    Frag<4, true> a[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) frag_a_from_c(a[j], s[j]);
    reduce_rows<D, NT, true>(acc, a, kt_s, g, tq);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qp[i] >= Sq) continue;
    float* row = dq + q_base + static_cast<int64_t>(qp[i]) * q_rs;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      store2(row + 8 * n + 2 * tq, acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv (kv-block-major, the G query heads folded into the loop)
// ---------------------------------------------------------------------------

// Grid (Kv, B, kv blocks), kv block 0 (the most causal work) first.  The W
// warps form W / 2 pairs, and pair i owns kv rows 16 i .. 16 i + 15 of the
// CTA's 8 W.  The CTA walks the G query heads of its kv head and their
// visible q tiles of BQ rows in one flattened loop, the next tile (q, do,
// lse, delta) in flight while it computes.  Per tile, warp i computes
// s^T = k q^T, p = exp(s^T scale - lse) (handed to its partner through
// shared memory) and dv += p^T do; warp i + W / 2 computes dp^T = v do^T,
// then ds = p (dp^T - delta) scale and dk += ds^T q.  The two halves run
// the same instructions on other tiles, and each warp keeps one D-wide
// accumulator in registers instead of two.  No atomics: the result is the
// same bits from run to run.
template <int D, int W, int BQ>
__global__ void __launch_bounds__(32 * W, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Sk, int H, int Kv,
                     int q0, int causal, int window, float scale) {
  constexpr int kThr = 32 * W, BKV = 8 * W, NT = BQ / 8, DT = D / 8;
  static_assert(W % 2 == 0 && 2 * BQ <= kThr, "warp pairs; lse/delta copies");
  constexpr int P = kPitch<D>;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* k_s = reinterpret_cast<float*>(bwd_smem);  // [BKV][P]
  float* v_s = k_s + BKV * P;                        // [BKV][P]
  float* q_s = v_s + BKV * P;                        // [2][BQ][P]
  float* do_s = q_s + 2 * BQ * P;                    // [2][BQ][P]
  float* p_s = do_s + 2 * BQ * P;                    // [BKV * BQ] p, by lane
  float* lse_s = p_s + BKV * BQ;                     // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                   // [2][BQ]

  const int kvh = blockIdx.x, b = blockIdx.y, kb = blockIdx.z;
  const int G = H / Kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bool dk_half = warp >= W / 2;      // this warp computes dk, not dv
  const int wr = 16 * (warp % (W / 2));    // its pair's rows
  const int k0 = kb * BKV;
  const int64_t q_rs = static_cast<int64_t>(H) * D;
  const int64_t k_rs = static_cast<int64_t>(Kv) * D;
  const int64_t k_base = (static_cast<int64_t>(b) * Sk * Kv + kvh) * D;

  // the visible q tiles (of rows; row r sits at position q0 + r): none
  // that lies wholly before the kv block (causal), none wholly past its
  // window
  const int nqt = (Sq + BQ - 1) / BQ;
  const int k_last = min(k0 + BKV, Sk) - 1;
  const int qt_begin = causal ? max(k0 - q0, 0) / BQ : 0;
  const int w_last = k_last + window - 1 - q0;   // last row in the window
  const int qt_end =
      window ? (w_last < 0 ? 0 : min(nqt, w_last / BQ + 1)) : nqt;
  const int nt = max(qt_end - qt_begin, 0), n_it = G * nt;

  auto prefetch = [&](int it, int buf) {
    const int hh = kvh * G + it / nt, r0 = (qt_begin + it % nt) * BQ;
    const int64_t q_base = (static_cast<int64_t>(b) * Sq * H + hh) * D;
    const int64_t r_base = (static_cast<int64_t>(b) * H + hh) * Sq;
    copy_rows_async<D, BQ, kThr>(q_s + buf * BQ * P, q + q_base, q_rs, r0,
                                 Sq);
    copy_rows_async<D, BQ, kThr>(do_s + buf * BQ * P, dout + q_base, q_rs,
                                 r0, Sq);
    const int i = threadIdx.x % BQ, qr = r0 + i;
    const int64_t at = r_base + (qr < Sq ? qr : 0);
    if (threadIdx.x < BQ)
      cp_async4(lse_s + buf * BQ + i, lse + at, qr < Sq);
    else if (threadIdx.x < 2 * BQ)
      cp_async4(delta_s + buf * BQ + i, delta + at, qr < Sq);
  };
  if (n_it > 0) prefetch(0, 0);
  cp_async_commit();
  load_rows<D, BKV, kThr>(k_s, k + k_base, k_rs, k0, Sk);
  load_rows<D, BKV, kThr>(v_s, v + k_base, k_rs, k0, Sk);

  int kp[2];
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) kp[i] = k0 + wr + g + 8 * i;
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this lane's C fragments of p, one float4 per 8 q columns
  float4* p_mine = reinterpret_cast<float4*>(p_s) + (wr / 16) * NT * 32 + lane;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    __syncthreads();                 // every warp is done with buffer buf ^ 1
    if (it + 1 < n_it) prefetch(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* qt_s = q_s + buf * BQ * P;
    const float* dt_s = do_s + buf * BQ * P;
    const float* ls = lse_s + buf * BQ;
    const float* dl = delta_s + buf * BQ;
    const int r0 = (qt_begin + it % nt) * BQ;

    // s^T = k q^T (dv half) or dp^T = v do^T (dk half)
    const float* a_t = dk_half ? v_s : k_s;
    const float* b_t = dk_half ? dt_s : qt_s;
    float c[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      Frag<4, true> af;
      Frag<2, true> bf[NT];
      frag_a<D>(af, a_t, wr, 8 * kk, g, tq);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        frag_b_nk<D>(bf[j], b_t, 8 * j, 8 * kk, g, tq);
      mma3(c, af, bf);
    }
    if (!dk_half) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * tq + (e & 1);
          c[j][e] = visible(r0 + r, q0, kp[e >> 1], Sq, Sk, causal, window)
                        ? expf(c[j][e] * scale - ls[r]) : 0.f;   // p
        }
        p_mine[32 * j] = make_float4(c[j][0], c[j][1], c[j][2], c[j][3]);
      }
    }
    __syncthreads();                 // p of every pair is in shared memory
    if (dk_half) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 p = p_mine[32 * j];
        const float pe[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * tq + (e & 1);
          c[j][e] = pe[e] * (c[j][e] - dl[r]) * scale;            // ds
        }
      }
    }

    // dv += p^T do (dv half) or dk += ds^T q (dk half)
    const float* b2_t = dk_half ? qt_s : dt_s;
    Frag<4, true> a[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) frag_a_from_c(a[j], c[j]);
    reduce_rows<D, NT, true>(acc, a, b2_t, g, tq);
  }

  float* out = dk_half ? dk : dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kp[i] >= Sk) continue;
    float* row = out + k_base + static_cast<int64_t>(kp[i]) * k_rs;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      store2(row + 8 * n + 2 * tq, acc[n][2 * i], acc[n][2 * i + 1]);
  }
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
  constexpr int W = kFwdWarps, R = kFwdStream;
  constexpr size_t smem = tile_smem_bytes<D, R>(1, 16 * W, false);
  auto* kernel = flash_fwd_kernel<D, W, R>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(H, B, (Sq + 16 * W - 1) / (16 * W));
  kernel<<<grid, 32 * W, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Sq, Sk, H, Kv, q0, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int Sq,
           int Sk, int H, int Kv, int q0, int causal, int window, float scale,
           cudaStream_t st) {
  constexpr int W = kDqWarps, R = kDqStream;
  constexpr size_t smem = tile_smem_bytes<D, R>(2, 16 * W, false);
  auto* kernel = flash_bwd_dq_kernel<D, W, R>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(H, B, (Sq + 16 * W - 1) / (16 * W));
  kernel<<<grid, 32 * W, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), Sq, Sk, H, Kv, q0, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int B,
            int Sq, int Sk, int H, int Kv, int q0, int causal, int window,
            float scale, cudaStream_t st) {
  constexpr int W = kDkvWarps, R = kDkvStream;
  constexpr size_t smem = tile_smem_bytes<D, R>(2, 8 * W, true);
  auto* kernel = flash_bwd_dkv_kernel<D, W, R>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(Kv, B, (Sk + 8 * W - 1) / (8 * W));
  kernel<<<grid, 32 * W, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H, Kv, q0,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// head dims with a compiled kernel (those of the port's configs: 128,
// h2o-danube-1.8b's 2560 / 32 = 80, and musicgen-medium's 1536 / 24 = 64,
// also the reduced configs'); anything else is refused
#define FLASH_DISPATCH_D(D, CALL)                                     \
  switch (D) {                                                        \
    case 64: { constexpr int kD = 64; return CALL; }                  \
    case 80: { constexpr int kD = 80; return CALL; }                  \
    case 128: { constexpr int kD = 128; return CALL; }                \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }

}  // namespace

// Forward: q, o (B, Sq, H, D) and k, v (B, Sk, Kv, D) f32; lse (B, H, Sq)
// f32; all contiguous; query row i at position q0 + i.  Returns
// cudaGetLastError() right after the launch (cudaErrorInvalidValue for a
// head dim with no kernel).
extern "C" int flash_attn_fwd_f32(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int B,
                                  int Sq, int Sk, int H, int Kv, int D,
                                  int q0, int causal, int window, float scale,
                                  void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, (fwd<kD>(q, k, v, o, lse, B, Sq, Sk, H, Kv, q0, causal,
                               window, scale, st)))
}

// Backward dq: dout and dq as q; lse and delta (B, H, Sq) f32.
extern "C" int flash_attn_dq_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int Sq,
                                 int Sk, int H, int Kv, int D, int q0,
                                 int causal, int window, float scale,
                                 void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, (bwd_dq<kD>(q, k, v, dout, lse, delta, dq, B, Sq, Sk,
                                  H, Kv, q0, causal, window, scale, st)))
}

// Backward dk/dv: dk and dv as k.
extern "C" int flash_attn_dkv_f32(const void* q, const void* k,
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

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
