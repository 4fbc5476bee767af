// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/flash_attention.py:88, body
// `flash_attention_kernel` :31) and, for the backward, the reference's
// custom VJP `_fa_bwd` (src/repro/models/attention.py:204), which has no
// Pallas kernel.  It computes what they compute:
//
//   out = softmax(q·kᵀ·scale + mask)·v,   lse = m + log(max(l, 1e-30))
//
// with a causal mask and an optional sliding window (key c is seen by
// query r iff (!causal || r >= c) && (!window || r - c < window)), kv
// tiles that the mask empties skipped, and the backward's two passes: a dq
// pass over each q tile's kv band (which also writes Dvec = rowsum(dO ⊙ O)),
// then a dk/dv pass over each kv tile's q band.
//
// Layout (the reference's public one): q, out, dout, dq (B, S, KV, G, D);
// k, v, dk, dv (B, S, KV, D); lse and Dvec (B, KV, G, S) float32.  The kv
// head of query head (kv, g) is `kv` -- the kernels index it and never
// broadcast k or v G times, as the Pallas wrapper does.  D is a multiple
// of 8, at most 256; S is any length (the ragged last tile is masked in the kernel, never padded in
// memory); offsets are 64-bit.
//
// Two routes, chosen by the input type (the wrapper, ops.py, picks the
// entry point):
//
// * bfloat16 -> tensor cores (`fa_fwd_tc_kernel`, `fa_bwd_dq_tc_kernel`,
//   `fa_bwd_dkdv_tc_kernel`).  What bounds attention is arithmetic: causal
//   attention at the training path's shape (S = 4096, 32 heads, D = 64)
//   does 68.7 GFLOP against 67 MB moved, ~1,000 operations a byte, far
//   above the card's ~295.  So every product runs on the tensor cores as
//   `wgmma.m64n64k16` (bf16 in, float32 sums): a consumer warpgroup owns
//   64 query rows (or, in the dk/dv pass, 64 keys) of one head, and one
//   producer warp keeps a ring of kStages = 2 tiles in shared memory, each
//   filled by TMA (`cp.async.bulk.tensor`, rank-4 maps (D, heads, S, B), so
//   rows past S and columns past D arrive as zeros from the hardware and a
//   map never reads the next batch row) and signalled on an `mbarrier`;
//   the consumers release a stage on a second `mbarrier`.  A forward block
//   at D <= 128 holds two consumer warpgroups, on two neighbouring q tiles
//   of one head, that share each K and V tile of their kv bands: every q
//   tile reads its whole band, so this halves what the forward reads from
//   L2 (~1.1 GB a call at the training path's shape with one a block).
//   At D = 256 a block holds one: a third warp on each of the SM's four
//   sub-partitions would cap registers at 168 a thread, and O alone takes
//   128 (two warpgroups spilled and ran slower than one).  Tiles are
//   stored as 64 x 64 boxes of 128-byte rows in the 128-byte swizzle that
//   TMA writes and `wgmma` reads, a D-wide tile as ceil(D/64) boxes (D
//   rounded up to 64, 128 or 256; the zero columns cost operations, not
//   correctness).  Score tiles are K-major on both sides (S = Q·Kᵀ,
//   dP = dO·Vᵀ, and their transposes in the dk/dv pass); the second
//   product of each pair takes its A operand from registers -- P, or dS,
//   rounded to bf16, the accumulator's layout reused as the A fragment --
//   and its B operand MN-major with the transpose bit (V in P·V, K in
//   dS·K, dO in Pᵀ·dO, Q in dSᵀ·Q), one 64-column box per instruction.
//   The online softmax stays in float32 registers, one FFMA (scale·log2 e
//   folded in) and one ex2 a score, O rescaled only when a row's max
//   moved; only tiles on the diagonal, at a window's edge or at the ragged
//   end are masked.  The one departure from the Pallas kernel: P and dS
//   are rounded to bf16 before their products (the Pallas kernel keeps
//   them in float32).
//   What holds it back.  Not the products and not the loads: with the
//   softmax taken out the forward at the training shape runs twice as
//   fast (410 TFLOP/s), without S or without P·V 4-10 % faster.  The
//   softmax's chain (max, two shuffles, one ex2 per score on the SM's 16
//   special-function lanes) runs between the two products of a tile, and
//   the 2-4 warpgroups an SM holds do not hide it.  Issuing the next
//   tile's S before this tile's softmax (FA3's in-warpgroup overlap)
//   needs 32 more registers, which halved the blocks an SM at D = 64 and
//   ran slower there (a producer warpgroup giving its registers up with
//   `setmaxnreg` did not help: ptxas kept the consumers at the launch
//   cap); two warpgroups a block in the backward at D <= 128 also ran
//   slower (fewer warpgroups an SM).  The backward recomputes S and dP in
//   both passes (7 products, not 5) to stay free of atomics.
//   Budgets.  Shared memory (1 KB more for alignment): forward
//   2 x Q + 2 x (K + V) = 6 tiles of 8 KB per 64 columns: 48 KB at D = 64
//   (two blocks an SM, as registers allow), 96 KB at 128; at 256 Q + 2 x
//   (K + V) = 160 KB (one block an SM, of the 227 KB a block may have);
//   backward two fixed tiles + 2 x two ring tiles = 48 KB at D = 64, 96 KB
//   at 128, 192 KB and the exchange at 256.  Registers: each consumer
//   thread holds 32 float32 of every 64 x 64 accumulator, so the forward
//   at D = 256 holds 128 of O + 32 of S + 16 of P; the blocks are
//   declared with __launch_bounds__ so ptxas keeps them under 255 (the
//   build log, `-Xptxas -v`, prints registers and spills).  The forward
//   walks the heaviest q tiles (the last, under a causal mask) first.
//   The backward at D = 256 (`fa_bwd_dq256_kernel`,
//   `fa_bwd_dkdv256_kernel`).  What bounds it is still the products, but
//   one warpgroup cannot hold what a tile pair needs: dQ, dK and dV are
//   64 x 256 float32, 128 registers a thread each.  The first design
//   split each tile's output columns over 2 (dq) or 4 (dk/dv) blocks,
//   every one of which took S and dP over all of D: 15 full-width products
//   a tile pair instead of 7, 4.06 ms at recurrentgemma's (30, 1024, 1,
//   10, 256), 10.0 % of the bound.  Now a block holds two consumer
//   warpgroups on one tile pair, and S and dP are taken once each:
//     dk/dv: warpgroup 0 takes Sᵀ, Pᵀ and dV += Pᵀ·dO, warpgroup 1 dPᵀ,
//       dSᵀ and dK += dSᵀ·Q; each forms its second product's A operand
//       from its own tile, so only P crosses (float32, 16 KB);
//     dq: warpgroup 0 takes S, dP, P and dS, warpgroup 1 dQ += dS·K over
//       all of D; dS crosses (bf16 A fragments, 8 KB), and warpgroup 0 goes
//       on to the next tile pair while warpgroup 1 multiplies (splitting
//       S | dP, with half of dQ each, ran no faster).
//   Each thread leaves its part where the other warpgroup's thread of the
//   same rank reads it; two named barriers (written, read) order the one
//   buffer.  Neither block has a producer warp: a ninth warp puts three
//   warps on one of the SM's four sub-partitions and caps registers at 168
//   a thread, too few for the accumulator, a score tile and the fragments
//   (ptxas spilled them, and a producer warpgroup giving registers up with
//   `setmaxnreg` kept the cap, as in the forward).  The first warp of
//   warpgroup 1 fills the ring instead, one tile pair ahead, the rows' lse
//   and Dvec by `cp.async` that arrives on the stage's barrier.  Registers
//   (`-Xptxas -v`): dk/dv 226, dq 184, no spills.  Shared memory: two
//   fixed tiles (64 KB) + a ring of two stages of two tiles (128 KB) + the
//   exchange (24 KB) + row values = 223,272 B.  The gradients equal the
//   first design's bit for bit (the same products in the same order), free
//   of atomics.  Tried and not kept (`kernels/backward_ab.py`, the pair of
//   passes at recurrentgemma's shape, 1.78 ms shipped): the rows' lse and
//   Dvec by plain loads in the loader warp, 1.91 ms; the dq pass's Dvec
//   loop unrolled with every load in flight, 2.16 ms.
//
// * float32 -> CUDA cores (`fa_fwd_kernel`, `fa_bwd_dq_kernel`,
//   `fa_bwd_dkdv_kernel`, instances for float only).  Tensor cores would
//   take float32 as TF32, which keeps about three decimal digits, and the
//   float32 checks (rtol 2e-5 forward) need all of float32.  On the card
//   float32 attention serves only checks (small runs against the CPU), so
//   this route is the simple one: each block owns a 64x64 score tile, each
//   of its 256 threads a 4x4 register sub-tile, every value read from
//   shared memory feeds four FMAs; rows in shared memory are padded to an
//   odd stride (D + 1) so the 16 threads of a half-warp that read 16 rows at
//   one column hit 16 banks.  Its tiles take 4·(3·64·(D + 1) + 64·65 + 128)
//   bytes, 214,528 at D = 256 (one block an SM); the backward's passes
//   would need about 281 KB and 297 KB at D = 256, so above D = 128 they
//   run `fa_bwd_dq_wide_kernel` and `fa_bwd_dkdv_wide_kernel`: a block
//   owns 128 output columns and takes the D-contractions in chunks of 128
//   columns (150 KB and 166 KB).
//
// Both routes are deterministic: the dq pass owns a q tile (and a group of
// its columns), and the dk/dv pass sums the G query heads of its kv head
// and their q tiles inside one block, in a fixed order, without atomics.

#include <cuda.h>              // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;             // rows of a q tile and of a kv tile
constexpr int kThreads = 256;         // 16 x 16 threads, 4 x 4 each
constexpr int kLdP = kTile + 1;       // stride of a 64 x 64 score tile
constexpr float kNegInit = -1e30f;    // the reference's running-max start


struct Shape {
  int B, S, KV, G, D;
  float scale;
  int causal, window;
};

__device__ __forceinline__ bool visible(const Shape& sh, int r, int c) {
  return r < sh.S && c < sh.S && (!sh.causal || r >= c) &&
         (!sh.window || r - c < sh.window);
}

// kv tiles [*lo, *hi) that q tile qt can see
__device__ __forceinline__ void kv_band(const Shape& sh, int qt, int* lo,
                                        int* hi) {
  const int n_k = (sh.S + kTile - 1) / kTile;
  const int q0 = qt * kTile;
  const int q_last = min(q0 + kTile - 1, sh.S - 1);
  *lo = 0;
  *hi = n_k;
  if (sh.causal) *hi = min(n_k, q_last / kTile + 1);
  if (sh.window) {
    // live iff kt*64 + 63 > q0 - window
    const int x = q0 - sh.window - (kTile - 1);
    *lo = x < 0 ? 0 : x / kTile + 1;
  }
}

// q tiles [*lo, *hi) that can see kv tile kt (the same rule, inverted)
__device__ __forceinline__ void q_band(const Shape& sh, int kt, int* lo,
                                       int* hi) {
  const int n_q = (sh.S + kTile - 1) / kTile;
  *lo = 0;
  *hi = n_q;
  if (sh.causal) *lo = kt;
  if (sh.window) {
    // live iff qt*64 < kt*64 + 63 + window
    const int x = kt * kTile + (kTile - 1) + sh.window;
    *hi = min(n_q, (x - 1) / kTile + 1);
  }
}

// rows [row0, row0 + 64) of a (.., S, .., D) tensor into shared memory as
// float (times `mul`), zeros beyond S; `stride` is the distance between
// consecutive positions, `ld` the shared-memory row stride
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int64_t stride, int row0,
                                          const Shape& sh, float mul) {
  for (int idx = threadIdx.x; idx < kTile * sh.D; idx += kThreads) {
    const int r = idx / sh.D, d = idx - r * sh.D;
    const int row = row0 + r;
    dst[r * ld + d] =
        row < sh.S ? src[(int64_t)row * stride + d] * mul : 0.f;
  }
}

// the 4 x 4 sub-tile of a·bᵀ over D owned by thread (ty, tx): rows
// ty + 16i of `a`, rows tx + 16j of `b`
__device__ __forceinline__ void dot_tile(float acc[4][4], const float* a,
                                         const float* b, int ld, int D,
                                         int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// reductions over the 16 threads (tx = 0..15) that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

// ------------------------------------------------------------------------
// forward: one block per (64-row q tile, query head (kv, g), batch row)
// ------------------------------------------------------------------------
template <int NJ>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, Shape sh) {
  extern __shared__ float smem[];
  const int ld = sh.D + 1;
  float* sQ = smem;
  float* sK = sQ + kTile * ld;
  float* sV = sK + kTile * ld;
  float* sP = sV + kTile * ld;

  const int n_q = (sh.S + kTile - 1) / kTile;
  const int qt = n_q - 1 - blockIdx.x;          // heaviest tiles first
  const int h = blockIdx.y, kv = h / sh.G, b = blockIdx.z;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t q_stride = (int64_t)sh.KV * sh.G * sh.D;
  const int64_t k_stride = (int64_t)sh.KV * sh.D;
  const float* qb = q + (int64_t)b * sh.S * q_stride + (int64_t)h * sh.D;
  const float* kb = k + (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;
  const float* vb = v + (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;

  load_tile(sQ, ld, qb, q_stride, q0, sh, sh.scale);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInit;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int kt_lo, kt_hi;
  kv_band(sh, qt, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                 // the last tile's readers are done
    load_tile(sK, ld, kb, k_stride, k0, sh, 1.f);
    load_tile(sV, ld, vb, k_stride, k0, sh, 1.f);
    __syncthreads();

    float s[4][4] = {};
    dot_tile(s, sQ, sK, ld, sh.D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(sh, r, k0 + tx + 16 * j)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);     // 0 where masked
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    // acc += P·V; columns d >= D read padding or the next row and are
    // never written
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[c * ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = out + (int64_t)b * sh.S * q_stride + (int64_t)h * sh.D;
  float* lb = lse + ((int64_t)b * sh.KV * sh.G + h) * sh.S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sh.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < sh.D) ob[(int64_t)r * q_stride + d] = acc[i][j] / lc;
    }
    if (tx == 0) lb[r] = m[i] + logf(lc);
  }
}

// ------------------------------------------------------------------------
// backward, pass 1: Dvec = rowsum(dout ⊙ out) and dq, one block per
// (q tile, query head, batch row), over the tile's kv band
// ------------------------------------------------------------------------
template <int NJ>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ out,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ dvec, float* __restrict__ dq, Shape sh) {
  extern __shared__ float smem[];
  const int ld = sh.D + 1;
  float* sQ = smem;
  float* sdO = sQ + kTile * ld;
  float* sK = sdO + kTile * ld;
  float* sV = sK + kTile * ld;
  float* sdS = sV + kTile * ld;
  float* sL = sdS + kTile * kLdP;
  float* sDv = sL + kTile;

  const int n_q = (sh.S + kTile - 1) / kTile;
  const int qt = n_q - 1 - blockIdx.x;
  const int h = blockIdx.y, kv = h / sh.G, b = blockIdx.z;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t q_stride = (int64_t)sh.KV * sh.G * sh.D;
  const int64_t k_stride = (int64_t)sh.KV * sh.D;
  const int64_t q_off = (int64_t)b * sh.S * q_stride + (int64_t)h * sh.D;
  const float* kb = k + (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;
  const float* vb = v + (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;
  const int64_t row_off = ((int64_t)b * sh.KV * sh.G + h) * sh.S;

  load_tile(sQ, ld, q + q_off, q_stride, q0, sh, sh.scale);
  load_tile(sdO, ld, dout + q_off, q_stride, q0, sh, 1.f);
  // Dvec: one warp per row, lanes over d
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < sh.S) {
      const float* o_row = out + q_off + (int64_t)row * q_stride;
      const float* do_row = dout + q_off + (int64_t)row * q_stride;
      for (int d = lane; d < sh.D; d += 32)
        acc = fmaf(do_row[d], o_row[d], acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      sDv[r] = acc;
      sL[r] = row < sh.S ? lse[row_off + row] : 0.f;
      if (row < sh.S) dvec[row_off + row] = acc;
    }
  }

  float dqa[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dqa[i][j] = 0.f;

  int kt_lo, kt_hi;
  kv_band(sh, qt, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(sK, ld, kb, k_stride, k0, sh, 1.f);
    load_tile(sV, ld, vb, k_stride, k0, sh, 1.f);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    dot_tile(s, sQ, sK, ld, sh.D, ty, tx);
    dot_tile(dp, sdO, sV, ld, sh.D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const float p = visible(sh, q0 + rl, k0 + cl)
                            ? expf(s[i][j] - sL[rl]) : 0.f;
        sdS[rl * kLdP + cl] = p * (dp[i][j] - sDv[rl]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float a[4], kk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sdS[(ty + 16 * i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = sK[c * ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dqa[i][j] = fmaf(a[i], kk[j], dqa[i][j]);
    }
  }

  float* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sh.S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < sh.D)
        dqb[(int64_t)r * q_stride + d] = dqa[i][j] * sh.scale;
    }
  }
}

// ------------------------------------------------------------------------
// backward, pass 2: dk and dv, one block per (kv tile, kv head, batch
// row), summing the G query heads of the kv head and the q tiles of each
// ------------------------------------------------------------------------
template <int NJ>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dvec, float* __restrict__ dk,
                   float* __restrict__ dv, Shape sh) {
  extern __shared__ float smem[];
  const int ld = sh.D + 1;
  float* sK = smem;
  float* sV = sK + kTile * ld;
  float* sQ = sV + kTile * ld;
  float* sdO = sQ + kTile * ld;
  float* sPT = sdO + kTile * ld;
  float* sdST = sPT + kTile * kLdP;
  float* sL = sdST + kTile * kLdP;
  float* sDv = sL + kTile;

  const int kt = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t q_stride = (int64_t)sh.KV * sh.G * sh.D;
  const int64_t k_stride = (int64_t)sh.KV * sh.D;
  const int64_t k_off = (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;

  load_tile(sK, ld, k + k_off, k_stride, k0, sh, 1.f);
  load_tile(sV, ld, v + k_off, k_stride, k0, sh, 1.f);

  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  int qt_lo, qt_hi;
  q_band(sh, kt, &qt_lo, &qt_hi);
  for (int g = 0; g < sh.G; ++g) {
    const int h = kv * sh.G + g;
    const int64_t q_off = (int64_t)b * sh.S * q_stride + (int64_t)h * sh.D;
    const int64_t row_off = ((int64_t)b * sh.KV * sh.G + h) * sh.S;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile(sQ, ld, q + q_off, q_stride, q0, sh, sh.scale);
      load_tile(sdO, ld, dout + q_off, q_stride, q0, sh, 1.f);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const bool in = q0 + r < sh.S;
        sL[r] = in ? lse[row_off + q0 + r] : 0.f;
        sDv[r] = in ? dvec[row_off + q0 + r] : 0.f;
      }
      __syncthreads();

      // transposed tiles: rows are keys (ty + 16i), columns queries
      float st[4][4] = {}, dpt[4][4] = {};
      dot_tile(st, sK, sQ, ld, sh.D, ty, tx);
      dot_tile(dpt, sV, sdO, ld, sh.D, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cl = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rl = tx + 16 * j;
          const float p = visible(sh, q0 + rl, k0 + cl)
                              ? expf(st[i][j] - sL[rl]) : 0.f;
          sPT[cl * kLdP + rl] = p;
          sdST[cl * kLdP + rl] = p * (dpt[i][j] - sDv[rl]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pa[4], sa[4], dov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = sPT[(ty + 16 * i) * kLdP + r];
          sa[i] = sdST[(ty + 16 * i) * kLdP + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dov[j] = sdO[r * ld + tx + 16 * j];
          qv[j] = sQ[r * ld + tx + 16 * j];      // q already times scale
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dva[i][j] = fmaf(pa[i], dov[j], dva[i][j]);
            dka[i][j] = fmaf(sa[i], qv[j], dka[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= sh.S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < sh.D) {
        dk[k_off + (int64_t)c * k_stride + d] = dka[i][j];
        dv[k_off + (int64_t)c * k_stride + d] = dva[i][j];
      }
    }
  }
}

// ------------------------------------------------------------------------
// backward at D > 128, float32: the passes above would need about 281 KB
// and 297 KB of shared memory at D = 256.  Each block owns the output
// columns of one group of kWideCols (dq, or dk and dv) and sums the
// D-contractions S = Q·Kᵀ and dP = dO·Vᵀ over chunks of kWideCols
// columns, loaded in turn, its own chunk last: that chunk's tiles are the
// ones its outputs need, and they are still in shared memory.  The grid's
// x axis holds the groups of each tile; nothing is summed across blocks.
// ------------------------------------------------------------------------
constexpr int kWideCols = 128;
constexpr int kLdW = kWideCols + 1;
constexpr int kWideNJ = kWideCols / 16;

__host__ __device__ inline int wide_groups(int D) {
  return (D + kWideCols - 1) / kWideCols;
}

// columns [col0, col0 + n) of rows [row0, row0 + 64) of a (.., S, .., D)
// tensor as float (times `mul`), zeros beyond S and beyond n
__device__ __forceinline__ void load_cols(float* dst, const float* src,
                                          int64_t stride, int row0, int col0,
                                          int n, const Shape& sh, float mul) {
  for (int idx = threadIdx.x; idx < kTile * kWideCols; idx += kThreads) {
    const int r = idx / kWideCols, c = idx - r * kWideCols;
    const int row = row0 + r;
    dst[r * kLdW + c] = row < sh.S && c < n
                            ? src[(int64_t)row * stride + col0 + c] * mul
                            : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_wide_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ out,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ dvec, float* __restrict__ dq,
                      Shape sh) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * kLdW;
  float* sK = sdO + kTile * kLdW;
  float* sV = sK + kTile * kLdW;
  float* sdS = sV + kTile * kLdW;
  float* sL = sdS + kTile * kLdP;
  float* sDv = sL + kTile;

  const int n_q = (sh.S + kTile - 1) / kTile, n_grp = wide_groups(sh.D);
  const int qt = n_q - 1 - blockIdx.x / n_grp, grp = blockIdx.x % n_grp;
  const int h = blockIdx.y, kv = h / sh.G, b = blockIdx.z;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t q_stride = (int64_t)sh.KV * sh.G * sh.D;
  const int64_t k_stride = (int64_t)sh.KV * sh.D;
  const int64_t q_off = (int64_t)b * sh.S * q_stride + (int64_t)h * sh.D;
  const float* kb = k + (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;
  const float* vb = v + (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;
  const int64_t row_off = ((int64_t)b * sh.KV * sh.G + h) * sh.S;

  // Dvec: one warp per row, lanes over d; the first group writes it
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < sh.S) {
      const float* o_row = out + q_off + (int64_t)row * q_stride;
      const float* do_row = dout + q_off + (int64_t)row * q_stride;
      for (int d = lane; d < sh.D; d += 32)
        acc = fmaf(do_row[d], o_row[d], acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      sDv[r] = acc;
      sL[r] = row < sh.S ? lse[row_off + row] : 0.f;
      if (row < sh.S && grp == 0) dvec[row_off + row] = acc;
    }
  }

  float dqa[4][kWideNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kWideNJ; ++j) dqa[i][j] = 0.f;

  int kt_lo, kt_hi;
  kv_band(sh, qt, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kTile;
    float s[4][4] = {}, dp[4][4] = {};
    for (int ci = 1; ci <= n_grp; ++ci) {
      const int col0 = (grp + ci) % n_grp * kWideCols;
      const int n = min(kWideCols, sh.D - col0);
      __syncthreads();
      load_cols(sQ, q + q_off, q_stride, q0, col0, n, sh, sh.scale);
      load_cols(sdO, dout + q_off, q_stride, q0, col0, n, sh, 1.f);
      load_cols(sK, kb, k_stride, k0, col0, n, sh, 1.f);
      load_cols(sV, vb, k_stride, k0, col0, n, sh, 1.f);
      __syncthreads();
      dot_tile(s, sQ, sK, kLdW, n, ty, tx);
      dot_tile(dp, sdO, sV, kLdW, n, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const float p = visible(sh, q0 + rl, k0 + cl)
                            ? expf(s[i][j] - sL[rl]) : 0.f;
        sdS[rl * kLdP + cl] = p * (dp[i][j] - sDv[rl]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {           // sK holds this group's
      float a[4], kk[kWideNJ];                  // columns
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sdS[(ty + 16 * i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < kWideNJ; ++j) kk[j] = sK[c * kLdW + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kWideNJ; ++j)
          dqa[i][j] = fmaf(a[i], kk[j], dqa[i][j]);
    }
  }

  float* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sh.S) continue;
#pragma unroll
    for (int j = 0; j < kWideNJ; ++j) {
      const int d = grp * kWideCols + tx + 16 * j;
      if (d < sh.D)
        dqb[(int64_t)r * q_stride + d] = dqa[i][j] * sh.scale;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_wide_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec,
                        float* __restrict__ dk, float* __restrict__ dv,
                        Shape sh) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * kLdW;
  float* sQ = sV + kTile * kLdW;
  float* sdO = sQ + kTile * kLdW;
  float* sPT = sdO + kTile * kLdW;
  float* sdST = sPT + kTile * kLdP;
  float* sL = sdST + kTile * kLdP;
  float* sDv = sL + kTile;

  const int n_grp = wide_groups(sh.D);
  const int kt = blockIdx.x / n_grp, grp = blockIdx.x % n_grp;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t q_stride = (int64_t)sh.KV * sh.G * sh.D;
  const int64_t k_stride = (int64_t)sh.KV * sh.D;
  const int64_t k_off = (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;

  float dka[4][kWideNJ], dva[4][kWideNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kWideNJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  int qt_lo, qt_hi;
  q_band(sh, kt, &qt_lo, &qt_hi);
  for (int g = 0; g < sh.G; ++g) {
    const int h = kv * sh.G + g;
    const int64_t q_off = (int64_t)b * sh.S * q_stride + (int64_t)h * sh.D;
    const int64_t row_off = ((int64_t)b * sh.KV * sh.G + h) * sh.S;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kTile;
      // transposed tiles: rows are keys (ty + 16i), columns queries
      float st[4][4] = {}, dpt[4][4] = {};
      for (int ci = 1; ci <= n_grp; ++ci) {
        const int col0 = (grp + ci) % n_grp * kWideCols;
        const int n = min(kWideCols, sh.D - col0);
        __syncthreads();
        load_cols(sK, k + k_off, k_stride, k0, col0, n, sh, 1.f);
        load_cols(sV, v + k_off, k_stride, k0, col0, n, sh, 1.f);
        load_cols(sQ, q + q_off, q_stride, q0, col0, n, sh, sh.scale);
        load_cols(sdO, dout + q_off, q_stride, q0, col0, n, sh, 1.f);
        if (ci == 1) {
          for (int r = threadIdx.x; r < kTile; r += kThreads) {
            const bool in = q0 + r < sh.S;
            sL[r] = in ? lse[row_off + q0 + r] : 0.f;
            sDv[r] = in ? dvec[row_off + q0 + r] : 0.f;
          }
        }
        __syncthreads();
        dot_tile(st, sK, sQ, kLdW, n, ty, tx);
        dot_tile(dpt, sV, sdO, kLdW, n, ty, tx);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cl = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rl = tx + 16 * j;
          const float p = visible(sh, q0 + rl, k0 + cl)
                              ? expf(st[i][j] - sL[rl]) : 0.f;
          sPT[cl * kLdP + rl] = p;
          sdST[cl * kLdP + rl] = p * (dpt[i][j] - sDv[rl]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {       // sQ and sdO hold this
        float pa[4], sa[4], dov[kWideNJ], qv[kWideNJ];   // group's columns
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = sPT[(ty + 16 * i) * kLdP + r];
          sa[i] = sdST[(ty + 16 * i) * kLdP + r];
        }
#pragma unroll
        for (int j = 0; j < kWideNJ; ++j) {
          dov[j] = sdO[r * kLdW + tx + 16 * j];
          qv[j] = sQ[r * kLdW + tx + 16 * j];     // q already times scale
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kWideNJ; ++j) {
            dva[i][j] = fmaf(pa[i], dov[j], dva[i][j]);
            dka[i][j] = fmaf(sa[i], qv[j], dka[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= sh.S) continue;
#pragma unroll
    for (int j = 0; j < kWideNJ; ++j) {
      const int d = grp * kWideCols + tx + 16 * j;
      if (d < sh.D) {
        dk[k_off + (int64_t)c * k_stride + d] = dka[i][j];
        dv[k_off + (int64_t)c * k_stride + d] = dva[i][j];
      }
    }
  }
}

// shared memory of each kernel, in bytes; the slack after the last buffer
// covers the reads of columns d >= D (up to 16·NJ - 1) in the last row
constexpr int kSlack = 128;
constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kLdP + kSlack);
}
constexpr size_t dq_smem(int D) {
  return sizeof(float) *
         (4 * kTile * (D + 1) + kTile * kLdP + 2 * kTile + kSlack);
}
constexpr size_t dkdv_smem(int D) {
  return sizeof(float) *
         (4 * kTile * (D + 1) + 2 * kTile * kLdP + 2 * kTile + kSlack);
}
constexpr size_t kDqWideSmem = dq_smem(kWideCols);
constexpr size_t kDkdvWideSmem = dkdv_smem(kWideCols);

template <int NJ>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, const Shape& sh,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem(sh.D);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.S + kTile - 1) / kTile, sh.KV * sh.G, sh.B);
  fa_fwd_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, sh);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const void* lse,
                       void* dvec, void* dq, void* dk, void* dv,
                       const Shape& sh, cudaStream_t stream) {
  size_t smem = dq_smem(sh.D);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_t = (sh.S + kTile - 1) / kTile;
  fa_bwd_dq_kernel<NJ><<<dim3(n_t, sh.KV * sh.G, sh.B), kThreads, smem,
                         stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)out,
      (const float*)dout, (const float*)lse, (float*)dvec, (float*)dq, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = dkdv_smem(sh.D);
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_kernel<NJ><<<dim3(n_t, sh.KV, sh.B), kThreads, smem,
                           stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)dvec, (float*)dk, (float*)dv, sh);
  return cudaGetLastError();
}

cudaError_t launch_bwd_wide(const void* q, const void* k, const void* v,
                            const void* out, const void* dout,
                            const void* lse, void* dvec, void* dq, void* dk,
                            void* dv, const Shape& sh, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqWideSmem);
  if (err != cudaSuccess) return err;
  const int n_t = (sh.S + kTile - 1) / kTile, n_grp = wide_groups(sh.D);
  fa_bwd_dq_wide_kernel<<<dim3(n_t * n_grp, sh.KV * sh.G, sh.B), kThreads,
                          kDqWideSmem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)out,
      (const float*)dout, (const float*)lse, (float*)dvec, (float*)dq, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dkdv_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDkdvWideSmem);
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_wide_kernel<<<dim3(n_t * n_grp, sh.KV, sh.B), kThreads,
                            kDkdvWideSmem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)dvec, (float*)dk, (float*)dv, sh);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// the tensor-core route (bfloat16): TMA, mbarriers and wgmma
// ------------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kBoxCols = 64;            // bf16 columns of a box: 128 bytes
constexpr int kBoxBytes = kTile * 128;  // one 64-row box, 8 KB
constexpr int kStages = 2;              // depth of the ring
constexpr int kConsumers = 128;         // threads of a warpgroup
constexpr int kBwdThreads = kConsumers + 32;  // backward: one, and a producer
// forward: two sharing K and V, but one at D > 128, where a third
// warp on an SM sub-partition would cap registers at 168 (O alone is 128)
template <int NB> __host__ __device__ constexpr int fwd_wgs() {
  return NB > 2 ? 1 : 2;
}
template <int NB> __host__ __device__ constexpr int fwd_threads() {
  return fwd_wgs<NB>() * kConsumers + 32;
}
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// a wait that never ends (a barrier protocol broken) traps after 2^20
// polls (each may suspend the thread for microseconds: seconds in all), so
// the launch fails instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 20)) __trap();
  }
}

// one 64 x 64 box of a rank-4 map (D, heads, S, B): columns d0.., head h,
// positions s0.., batch row b; the hardware zero-fills what lies outside
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int h, int s0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h),
      "r"(s0), "r"(b) : "memory");
}

// 4 bytes global -> shared, asynchronously; zeros where !in (nothing read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// a wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units), layout 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (its 64 rows hold the reduction dimension contiguous):
// columns [16 kk, 16 kk + 16) of a tile stored as boxes of 64 columns;
// 8-row groups lie 1,024 bytes apart, the 16 columns 32 bytes into a row
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * kBoxBytes + (kk & 3) * 32, 16, 1024);
}
// MN-major operand (its rows are the reduction dimension): rows
// [16 kk, 16 kk + 16) of column box c, two 8-row groups 1,024 bytes apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int c, int kk) {
  return desc(tile + c * kBoxBytes + kk * 2048, kBoxBytes, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from touching wgmma's registers before wg_wait()
__device__ __forceinline__ void keep(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (+)= A·B, A and B from shared memory, both K-major; acc = 0 overwrites
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d += A·B, A from registers (the bf16 fragment of a 64 x 16 slice), B
// from shared memory, MN-major (transpose bit set)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragments.  Thread (warp w, lane ln) of the consumer warpgroup holds, of
// every 64 x 64 float32 accumulator d[32], rows r0 = 16w + ln/4 and r0 + 8
// at columns 8j + 2(ln%4) + {0, 1}: d[4j + {0, 1}] on row r0, d[4j + {2, 3}]
// on row r0 + 8.  The bf16 A fragment of columns [16kk, 16kk + 16) is then
// a[kk] = {pack(d[8kk], d[8kk+1]), pack(d[8kk+2], d[8kk+3]),
//          pack(d[8kk+4], d[8kk+5]), pack(d[8kk+6], d[8kk+7])}.

// true unless every (row, column) of the 64 x 64 tile is visible
__device__ __forceinline__ bool need_mask(const Shape& sh, int q0, int k0) {
  return q0 + kTile > sh.S || k0 + kTile > sh.S ||
         (sh.causal && k0 + kTile - 1 > q0) ||
         (sh.window && q0 + kTile - 1 - k0 >= sh.window);
}

// Shared memory, NB boxes of 64 columns a tile.  Backward: two fixed
// tiles, a ring of two tiles a stage, per-stage row values (the dk/dv
// pass's lse and Dvec), then the mbarriers.  Forward (kFwdBytes): a Q
// tile a warpgroup, the rings of K and V, the mbarriers.
template <int NB>
struct Smem {
  static constexpr int kTileBytes = NB * kBoxBytes;
  static constexpr int kFixA = 0, kFixB = kTileBytes;
  static constexpr int kRingA = 2 * kTileBytes;
  static constexpr int kRingB = kRingA + kStages * kTileBytes;
  static constexpr int kRowVals = kRingB + kStages * kTileBytes;
  static constexpr int kBars = kRowVals + 2 * kStages * kTile * 4;
  // fixed, full[kStages], empty[kStages]; 1 KB to align the tiles
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
  // the forward: a Q tile a warpgroup, the rings of K and V, the barriers
  static constexpr int kFwdBytes =
      (fwd_wgs<NB>() + 2 * kStages) * kTileBytes + 8 * (1 + 2 * kStages) +
      1024;
};

// the block's shared memory, aligned to the 1,024 bytes the swizzle needs
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void init_barriers(uint32_t bars, int full_count,
                                              int empty_count) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * (1 + s), full_count);
      mbar_init(bars + 8 * (1 + kStages + s), empty_count);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// ------------------------------------------------------------------------
// forward: one block per (fwd_wgs 64-row q tiles, query head, batch row);
// its consumer warpgroups share the K and V tiles of the union of their kv
// bands, each computing only on the tiles of its own band
// ------------------------------------------------------------------------
template <int NB>
__global__ void __launch_bounds__(fwd_threads<NB>(), NB == 1 ? 2 : 1)
fa_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ out, float* __restrict__ lse, Shape sh) {
  typedef Smem<NB> L;
  constexpr int kFwdWGs = fwd_wgs<NB>();
  extern __shared__ uint8_t smem_raw[];
  // layout: the Q tiles, the ring of K, the ring of V, the barriers
  const uint32_t base = smem_u32(smem_base(smem_raw));
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kFwdWGs * L::kTileBytes;
  const uint32_t sV = sK + kStages * L::kTileBytes;
  const uint32_t bars = sV + kStages * L::kTileBytes;
  const uint32_t fixed = bars;

  const int n_q = (sh.S + kTile - 1) / kTile;
  const int n_blk = (n_q + kFwdWGs - 1) / kFwdWGs;
  const int qt0 = (n_blk - 1 - blockIdx.x) * kFwdWGs;   // heaviest first
  const int h = blockIdx.y, kv = h / sh.G, b = blockIdx.z;
  // the union [lo, hi) of the warpgroups' kv bands (a tile past the last
  // q tile has none)
  int lo = n_q, hi = 0;
  for (int i = 0; i < kFwdWGs && qt0 + i < n_q; ++i) {
    int l, u;
    kv_band(sh, qt0 + i, &l, &u);
    lo = min(lo, l);
    hi = max(hi, u);
  }
  init_barriers(bars, 1, kFwdWGs * kConsumers);

  if (threadIdx.x >= kFwdWGs * kConsumers) {    // the producer warp
    if (threadIdx.x == kFwdWGs * kConsumers) {
      mbar_expect_tx(fixed, kFwdWGs * L::kTileBytes);
      for (int i = 0; i < kFwdWGs; ++i)
        for (int c = 0; c < NB; ++c)
          tma_load(sQ + i * L::kTileBytes + c * kBoxBytes, &tq, fixed,
                   c * kBoxCols, h, (qt0 + i) * kTile, b);
      for (int it = 0; it < hi - lo; ++it) {
        const int s = it % kStages, k0 = (lo + it) * kTile;
        const uint32_t full = bars + 8 * (1 + s);
        mbar_wait(bars + 8 * (1 + kStages + s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kTileBytes);
        for (int c = 0; c < NB; ++c) {
          tma_load(sK + s * L::kTileBytes + c * kBoxBytes, &tk, full,
                   c * kBoxCols, kv, k0, b);
          tma_load(sV + s * L::kTileBytes + c * kBoxBytes, &tv, full,
                   c * kBoxCols, kv, k0, b);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / kConsumers;
  const int w = (threadIdx.x >> 5) & 3, ln = threadIdx.x & 31;
  const int q0 = (qt0 + wg) * kTile;
  const uint32_t tQ = sQ + wg * L::kTileBytes;
  int my_lo = 0, my_hi = 0;                     // this warpgroup's band
  if (qt0 + wg < n_q) kv_band(sh, qt0 + wg, &my_lo, &my_hi);
  const int r0 = q0 + 16 * w + (ln >> 2), r1 = r0 + 8;
  const int cq = 2 * (ln & 3);
  const float sl2 = sh.scale * kLog2e;
  float o[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  // running max (in units of scale·log2 e) and this thread's partial sums
  float m0 = kNegInit, m1 = kNegInit, l0 = 0.f, l1 = 0.f;

  mbar_wait(fixed, 0);
  for (int it = 0; it < hi - lo; ++it) {
    const int s = it % kStages, kt = lo + it, k0 = kt * kTile;
    const uint32_t tK = sK + s * L::kTileBytes, tV = sV + s * L::kTileBytes;
    mbar_wait(bars + 8 * (1 + s), (it / kStages) & 1);
    if (kt < my_lo || kt >= my_hi) {            // outside this band
      mbar_arrive(bars + 8 * (1 + kStages + s));
      continue;
    }

    float sc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      mma_ss(sc, desc_k(tQ, kk), desc_k(tK, kk), kk);
    wg_commit();
    wg_wait();
    keep(sc);

    // the softmax is what bounds this kernel (its instructions, not the
    // products), so each score costs one FFMA and one ex2: the max is
    // taken on the raw scores (scale > 0), and O is rescaled only where
    // a row's max moved
    const bool edge = need_mask(sh, q0, k0);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge && !visible(sh, e < 2 ? r0 : r1, k0 + 8 * j + cq + (e & 1)))
          sc[4 * j + e] = -INFINITY;
        if (e < 2) mx0 = fmaxf(mx0, sc[4 * j + e]);
        else mx1 = fmaxf(mx1, sc[4 * j + e]);
      }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float n0 = fmaxf(m0, mx0 * sl2), n1 = fmaxf(m1, mx1 * sl2);
    const bool moved = n0 != m0 || n1 != m1;
    const float c0 = ex2(m0 - n0), c1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= c0;
    l1 *= c1;
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = ex2(fmaf(sc[4 * j], sl2, -n0));
      const float p1 = ex2(fmaf(sc[4 * j + 1], sl2, -n0));
      const float p2 = ex2(fmaf(sc[4 * j + 2], sl2, -n1));
      const float p3 = ex2(fmaf(sc[4 * j + 3], sl2, -n1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= (i & 2) ? c1 : c0;
    }

    wg_fence();
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_rs(o[c], pa[kk], desc_mn(tV, c, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < NB; ++c) keep(o[c]);
    keep(pa);
    mbar_arrive(bars + 8 * (1 + kStages + s));
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const float i0 = 1.f / lc0, i1 = 1.f / lc1;
  const int64_t q_stride = (int64_t)sh.KV * sh.G * sh.D;
  bf16* ob = out + (int64_t)b * sh.S * q_stride + (int64_t)h * sh.D;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = c * kBoxCols + 8 * j + cq;
      if (d >= sh.D) continue;
      if (r0 < sh.S)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * q_stride + d) =
            __floats2bfloat162_rn(o[c][4 * j] * i0, o[c][4 * j + 1] * i0);
      if (r1 < sh.S)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * q_stride + d) =
            __floats2bfloat162_rn(o[c][4 * j + 2] * i1,
                                  o[c][4 * j + 3] * i1);
    }
  if ((ln & 3) == 0) {
    float* lb = lse + ((int64_t)b * sh.KV * sh.G + h) * sh.S;
    if (r0 < sh.S) lb[r0] = m0 * kLn2 + logf(lc0);
    if (r1 < sh.S) lb[r1] = m1 * kLn2 + logf(lc1);
  }
}

// ------------------------------------------------------------------------
// backward, pass 1: Dvec = rowsum(dout ⊙ out) and dq, one block per
// (q tile, query head, batch row), over the tile's kv band
// ------------------------------------------------------------------------
template <int NB>
__global__ void __launch_bounds__(kBwdThreads, NB == 1 ? 2 : 1)
fa_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const bf16* __restrict__ out,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dvec,
                    bf16* __restrict__ dq, Shape sh) {
  typedef Smem<NB> L;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_base(smem_raw));
  const uint32_t sQ = base + L::kFixA, sdO = base + L::kFixB;
  const uint32_t sK = base + L::kRingA, sV = base + L::kRingB;
  const uint32_t bars = base + L::kBars, fixed = bars;

  const int n_q = (sh.S + kTile - 1) / kTile;
  const int qt = n_q - 1 - blockIdx.x;
  const int h = blockIdx.y, kv = h / sh.G, b = blockIdx.z;
  const int q0 = qt * kTile;
  int lo, hi;
  kv_band(sh, qt, &lo, &hi);
  init_barriers(bars, 1, kConsumers);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(fixed, 2 * L::kTileBytes);
      for (int c = 0; c < NB; ++c) {
        tma_load(sQ + c * kBoxBytes, &tq, fixed, c * kBoxCols, h, q0, b);
        tma_load(sdO + c * kBoxBytes, &tdo, fixed, c * kBoxCols, h, q0, b);
      }
      for (int it = 0; it < hi - lo; ++it) {
        const int s = it % kStages, k0 = (lo + it) * kTile;
        const uint32_t full = bars + 8 * (1 + s);
        mbar_wait(bars + 8 * (1 + kStages + s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kTileBytes);
        for (int c = 0; c < NB; ++c) {
          tma_load(sK + s * L::kTileBytes + c * kBoxBytes, &tk, full,
                   c * kBoxCols, kv, k0, b);
          tma_load(sV + s * L::kTileBytes + c * kBoxBytes, &tv, full,
                   c * kBoxCols, kv, k0, b);
        }
      }
    }
    return;
  }

  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int r0 = q0 + 16 * w + (ln >> 2), r1 = r0 + 8;
  const int cq = 2 * (ln & 3);
  const float sl2 = sh.scale * kLog2e;
  const int64_t q_stride = (int64_t)sh.KV * sh.G * sh.D;
  const int64_t q_off = (int64_t)b * sh.S * q_stride + (int64_t)h * sh.D;
  const int64_t row_off = ((int64_t)b * sh.KV * sh.G + h) * sh.S;

  // Dvec of rows r0 and r1: the four threads of a row split D
  float dv0 = 0.f, dv1 = 0.f;
  for (int d = cq; d < sh.D; d += 8) {
    if (r0 < sh.S) {
      const float2 o2 = __bfloat1622float2(*reinterpret_cast<
          const __nv_bfloat162*>(out + q_off + r0 * q_stride + d));
      const float2 g2 = __bfloat1622float2(*reinterpret_cast<
          const __nv_bfloat162*>(dout + q_off + r0 * q_stride + d));
      dv0 = fmaf(g2.x, o2.x, fmaf(g2.y, o2.y, dv0));
    }
    if (r1 < sh.S) {
      const float2 o2 = __bfloat1622float2(*reinterpret_cast<
          const __nv_bfloat162*>(out + q_off + r1 * q_stride + d));
      const float2 g2 = __bfloat1622float2(*reinterpret_cast<
          const __nv_bfloat162*>(dout + q_off + r1 * q_stride + d));
      dv1 = fmaf(g2.x, o2.x, fmaf(g2.y, o2.y, dv1));
    }
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    dv0 += __shfl_xor_sync(0xffffffffu, dv0, o_);
    dv1 += __shfl_xor_sync(0xffffffffu, dv1, o_);
  }
  if ((ln & 3) == 0) {
    if (r0 < sh.S) dvec[row_off + r0] = dv0;
    if (r1 < sh.S) dvec[row_off + r1] = dv1;
  }
  const float L0 = r0 < sh.S ? lse[row_off + r0] * kLog2e : 0.f;
  const float L1 = r1 < sh.S ? lse[row_off + r1] * kLog2e : 0.f;

  float dqa[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[c][i] = 0.f;

  mbar_wait(fixed, 0);
  for (int it = 0; it < hi - lo; ++it) {
    const int s = it % kStages, k0 = (lo + it) * kTile;
    const uint32_t tK = sK + s * L::kTileBytes, tV = sV + s * L::kTileBytes;
    mbar_wait(bars + 8 * (1 + s), (it / kStages) & 1);

    float sc[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      mma_ss(sc, desc_k(sQ, kk), desc_k(tK, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      mma_ss(dp, desc_k(sdO, kk), desc_k(tV, kk), kk);
    wg_commit();
    wg_wait();
    keep(sc);
    keep(dp);

    const bool edge = need_mask(sh, q0, k0);
    uint32_t da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool top = e < 2;
        const float p =
            edge && !visible(sh, top ? r0 : r1, k0 + 8 * j + cq + (e & 1))
                ? 0.f
                : ex2(sc[4 * j + e] * sl2 - (top ? L0 : L1));
        ds[e] = p * (dp[4 * j + e] - (top ? dv0 : dv1));
      }
      da[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    wg_fence();
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs(dqa[c], da[kk], desc_mn(tK, c, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < NB; ++c) keep(dqa[c]);
    keep(da);
    mbar_arrive(bars + 8 * (1 + kStages + s));
  }

  bf16* dqb = dq + q_off;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = c * kBoxCols + 8 * j + cq;
      if (d >= sh.D) continue;
      if (r0 < sh.S)
        *reinterpret_cast<__nv_bfloat162*>(dqb + r0 * q_stride + d) =
            __floats2bfloat162_rn(dqa[c][4 * j] * sh.scale,
                                  dqa[c][4 * j + 1] * sh.scale);
      if (r1 < sh.S)
        *reinterpret_cast<__nv_bfloat162*>(dqb + r1 * q_stride + d) =
            __floats2bfloat162_rn(dqa[c][4 * j + 2] * sh.scale,
                                  dqa[c][4 * j + 3] * sh.scale);
    }
}

// ------------------------------------------------------------------------
// backward, pass 2: dk and dv, one block per (kv tile, kv head, batch
// row), summing the G query heads of the kv head and the q tiles of each
// ------------------------------------------------------------------------
template <int NB>
__global__ void __launch_bounds__(kBwdThreads, NB == 1 ? 2 : 1)
fa_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ dvec, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, Shape sh) {
  typedef Smem<NB> L;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* gbase = smem_base(smem_raw);
  const uint32_t base = smem_u32(gbase);
  const uint32_t sK = base + L::kFixA, sV = base + L::kFixB;
  const uint32_t sQ = base + L::kRingA, sdO = base + L::kRingB;
  // per stage: lse·log2 e of the tile's 64 rows, then their Dvec
  float* rows = reinterpret_cast<float*>(gbase + L::kRowVals);
  const uint32_t bars = base + L::kBars, fixed = bars;

  const int kt = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  int qlo, qhi;
  q_band(sh, kt, &qlo, &qhi);
  const int n_band = qhi - qlo, n_it = sh.G * n_band;
  // full: the producer's expect_tx and its 32 lanes' row values
  init_barriers(bars, 33, kConsumers);

  if (threadIdx.x >= kConsumers) {
    const int lane = threadIdx.x - kConsumers;
    if (lane == 0) {
      mbar_expect_tx(fixed, 2 * L::kTileBytes);
      for (int c = 0; c < NB; ++c) {
        tma_load(sK + c * kBoxBytes, &tk, fixed, c * kBoxCols, kv, k0, b);
        tma_load(sV + c * kBoxBytes, &tv, fixed, c * kBoxCols, kv, k0, b);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int g = it / n_band, q0 = (qlo + it % n_band) * kTile;
      const int h = kv * sh.G + g, s = it % kStages;
      const uint32_t full = bars + 8 * (1 + s);
      mbar_wait(bars + 8 * (1 + kStages + s), ((it / kStages) & 1) ^ 1);
      const int64_t row_off = ((int64_t)b * sh.KV * sh.G + h) * sh.S;
      float* rl = rows + s * 2 * kTile;
      for (int r = lane; r < kTile; r += 32) {
        const bool in = q0 + r < sh.S;
        rl[r] = in ? lse[row_off + q0 + r] * kLog2e : 0.f;
        rl[kTile + r] = in ? dvec[row_off + q0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full, 2 * L::kTileBytes);
        for (int c = 0; c < NB; ++c) {
          tma_load(sQ + s * L::kTileBytes + c * kBoxBytes, &tq, full,
                   c * kBoxCols, h, q0, b);
          tma_load(sdO + s * L::kTileBytes + c * kBoxBytes, &tdo, full,
                   c * kBoxCols, h, q0, b);
        }
      }
      mbar_arrive(full);
    }
    return;
  }

  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int kr0 = k0 + 16 * w + (ln >> 2), kr1 = kr0 + 8;   // keys
  const int cq = 2 * (ln & 3);
  const float sl2 = sh.scale * kLog2e;
  float dka[NB][32], dva[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[c][i] = dva[c][i] = 0.f;

  mbar_wait(fixed, 0);
  for (int it = 0; it < n_it; ++it) {
    const int q0 = (qlo + it % n_band) * kTile, s = it % kStages;
    const uint32_t tQ = sQ + s * L::kTileBytes, tdO = sdO + s * L::kTileBytes;
    const float* rl = rows + s * 2 * kTile;
    mbar_wait(bars + 8 * (1 + s), (it / kStages) & 1);

    // transposed tiles: rows are keys, columns queries
    float st[32], dpt[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      mma_ss(st, desc_k(sK, kk), desc_k(tQ, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      mma_ss(dpt, desc_k(sV, kk), desc_k(tdO, kk), kk);
    wg_commit();
    wg_wait();
    keep(st);
    keep(dpt);

    const bool edge = need_mask(sh, q0, k0);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qc = 8 * j + cq;
      const float2 lq = *reinterpret_cast<const float2*>(rl + qc);
      const float2 dq_ = *reinterpret_cast<const float2*>(rl + kTile + qc);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? lq.y : lq.x;
        const float dvv = (e & 1) ? dq_.y : dq_.x;
        p[e] = edge && !visible(sh, q0 + qc + (e & 1), e < 2 ? kr0 : kr1)
                   ? 0.f
                   : ex2(st[4 * j + e] * sl2 - lv);
        ds[e] = p[e] * (dpt[4 * j + e] - dvv);
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      da[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    wg_fence();
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs(dva[c], pa[kk], desc_mn(tdO, c, kk));
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs(dka[c], da[kk], desc_mn(tQ, c, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      keep(dka[c]);
      keep(dva[c]);
    }
    keep(pa);
    keep(da);
    mbar_arrive(bars + 8 * (1 + kStages + s));
  }

  const int64_t k_stride = (int64_t)sh.KV * sh.D;
  const int64_t k_off = (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = c * kBoxCols + 8 * j + cq;
      if (d >= sh.D) continue;
      if (kr0 < sh.S) {
        const int64_t at = k_off + kr0 * k_stride + d;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
            dka[c][4 * j] * sh.scale, dka[c][4 * j + 1] * sh.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dva[c][4 * j], dva[c][4 * j + 1]);
      }
      if (kr1 < sh.S) {
        const int64_t at = k_off + kr1 * k_stride + d;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
            dka[c][4 * j + 2] * sh.scale, dka[c][4 * j + 3] * sh.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dva[c][4 * j + 2], dva[c][4 * j + 3]);
      }
    }
}

// ------------------------------------------------------------------------
// backward at D = 256 (NB = 4): two consumer warpgroups a block, which
// split the products of each tile pair and pass P (float32) or dS (bf16,
// packed as the A fragment) through shared memory, each thread's part in
// the same place for the other warpgroup's thread of the same rank (the
// note at the top of the file)
// ------------------------------------------------------------------------
struct Smem256 {
  static constexpr int kTileBytes = 4 * kBoxBytes;        // 64 x 256 bf16
  static constexpr int kFixA = 0, kFixB = kTileBytes;
  static constexpr int kRingA = 2 * kTileBytes;
  static constexpr int kRingB = kRingA + kStages * kTileBytes;
  static constexpr int kP = kRingB + kStages * kTileBytes;   // 128 x 32 f32
  static constexpr int kDS = kP + kConsumers * 32 * 4;       // 128 x 16 u32
  static constexpr int kRowVals = kDS + kConsumers * 16 * 4;
  static constexpr int kBars = kRowVals + 2 * kStages * kTile * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
// a thread's 32 float32 of a 64 x 64 tile, and its 16 packed bf16 pairs,
// to and from the exchange buffers (thread t's i-th vector at i·128 + t)
__device__ __forceinline__ void put_f32(float4* buf, int t,
                                        const float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    buf[i * kConsumers + t] =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}
__device__ __forceinline__ void put_frag(uint4* buf, int t,
                                         const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    buf[i * kConsumers + t] = make_uint4(a[i][0], a[i][1], a[i][2], a[i][3]);
}
__device__ __forceinline__ void get_frag(const uint4* buf, int t,
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 v = buf[i * kConsumers + t];
    a[i][0] = v.x;
    a[i][1] = v.y;
    a[i][2] = v.z;
    a[i][3] = v.w;
  }
}
// the named barriers: P written, dS written, the buffer read again
constexpr int kBarP = 1, kBarDS = 2, kBarFree = 3;

// pass 1 at D = 256: dq and Dvec, one block per (q tile, query head, batch
// row) over the tile's kv band.  Warpgroup 0 takes S = Q·Kᵀ and dP =
// dO·Vᵀ, P and dS = P ⊙ (dP - Dvec), and writes dS (bf16 A fragments)
// before barrier 1 (kBarDS); warpgroup 1 accumulates all of dQ (64 x 256
// float32, 128 registers a thread) from it and frees the buffer at
// barrier 2 (kBarFree), while warpgroup 0 goes on to the next tile pair.
// No producer warp, as in the dk/dv pass: the first warp of warpgroup 1
// fills the ring, one tile pair ahead.
__global__ void __launch_bounds__(2 * kConsumers, 1)
fa_bwd_dq256_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const bf16* __restrict__ out,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dvec,
                    bf16* __restrict__ dq, Shape sh) {
  constexpr int NB = 4;
  typedef Smem256 L;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* gbase = smem_base(smem_raw);
  const uint32_t base = smem_u32(gbase);
  const uint32_t sQ = base + L::kFixA, sdO = base + L::kFixB;
  const uint32_t sK = base + L::kRingA, sV = base + L::kRingB;
  uint4* xDS = reinterpret_cast<uint4*>(gbase + L::kDS);
  const uint32_t bars = base + L::kBars, fixed = bars;

  const int n_q = (sh.S + kTile - 1) / kTile;
  const int qt = n_q - 1 - blockIdx.x;
  const int h = blockIdx.y, kv = h / sh.G, b = blockIdx.z;
  const int q0 = qt * kTile;
  int lo, hi;
  kv_band(sh, qt, &lo, &hi);
  init_barriers(bars, 1, 2 * kConsumers);

  // tile pair `it`'s K and V tiles into its stage, by lane 0 of warp 4
  // once both warpgroups have released the stage
  const bool loader = threadIdx.x == 4 * 32;
  auto load = [&](int it) {
    const int s = it % kStages, k0 = (lo + it) * kTile;
    const uint32_t full = bars + 8 * (1 + s);
    mbar_wait(bars + 8 * (1 + kStages + s), ((it / kStages) & 1) ^ 1);
    mbar_expect_tx(full, 2 * L::kTileBytes);
    for (int c = 0; c < NB; ++c) {
      tma_load(sK + s * L::kTileBytes + c * kBoxBytes, &tk, full,
               c * kBoxCols, kv, k0, b);
      tma_load(sV + s * L::kTileBytes + c * kBoxBytes, &tv, full,
               c * kBoxCols, kv, k0, b);
    }
  };
  if (loader) {
    mbar_expect_tx(fixed, 2 * L::kTileBytes);
    for (int c = 0; c < NB; ++c) {
      tma_load(sQ + c * kBoxBytes, &tq, fixed, c * kBoxCols, h, q0, b);
      tma_load(sdO + c * kBoxBytes, &tdo, fixed, c * kBoxCols, h, q0, b);
    }
    load(0);
  }
  __syncwarp();

  const int wg = threadIdx.x / kConsumers, t = threadIdx.x % kConsumers;
  const int w = t >> 5, ln = t & 31;
  const int r0 = q0 + 16 * w + (ln >> 2), r1 = r0 + 8;
  const int cq = 2 * (ln & 3);
  const float sl2 = sh.scale * kLog2e;
  const int64_t q_stride = (int64_t)sh.KV * sh.G * sh.D;
  const int64_t q_off = (int64_t)b * sh.S * q_stride + (int64_t)h * sh.D;
  const int64_t row_off = ((int64_t)b * sh.KV * sh.G + h) * sh.S;

  if (wg == 0) {
    // Dvec of rows r0 and r1 (the four threads of a row split D), and
    // their lse (unrolled, the loop ran slower: the note at the top)
    float dv0 = 0.f, dv1 = 0.f;
    for (int d = cq; d < sh.D; d += 8) {
      if (r0 < sh.S) {
        const float2 o2 = __bfloat1622float2(*reinterpret_cast<
            const __nv_bfloat162*>(out + q_off + r0 * q_stride + d));
        const float2 g2 = __bfloat1622float2(*reinterpret_cast<
            const __nv_bfloat162*>(dout + q_off + r0 * q_stride + d));
        dv0 = fmaf(g2.x, o2.x, fmaf(g2.y, o2.y, dv0));
      }
      if (r1 < sh.S) {
        const float2 o2 = __bfloat1622float2(*reinterpret_cast<
            const __nv_bfloat162*>(out + q_off + r1 * q_stride + d));
        const float2 g2 = __bfloat1622float2(*reinterpret_cast<
            const __nv_bfloat162*>(dout + q_off + r1 * q_stride + d));
        dv1 = fmaf(g2.x, o2.x, fmaf(g2.y, o2.y, dv1));
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      dv0 += __shfl_xor_sync(0xffffffffu, dv0, o_);
      dv1 += __shfl_xor_sync(0xffffffffu, dv1, o_);
    }
    if ((ln & 3) == 0) {
      if (r0 < sh.S) dvec[row_off + r0] = dv0;
      if (r1 < sh.S) dvec[row_off + r1] = dv1;
    }
    const float L0 = r0 < sh.S ? lse[row_off + r0] * kLog2e : 0.f;
    const float L1 = r1 < sh.S ? lse[row_off + r1] * kLog2e : 0.f;

    mbar_wait(fixed, 0);
    for (int it = 0; it < hi - lo; ++it) {
      const int s = it % kStages, k0 = (lo + it) * kTile;
      const uint32_t tK = sK + s * L::kTileBytes, tV = sV + s * L::kTileBytes;
      mbar_wait(bars + 8 * (1 + s), (it / kStages) & 1);
      float sc[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        mma_ss(sc, desc_k(sQ, kk), desc_k(tK, kk), kk);
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        mma_ss(dp, desc_k(sdO, kk), desc_k(tV, kk), kk);
      wg_commit();
      wg_wait();
      keep(sc);
      keep(dp);
      mbar_arrive(bars + 8 * (1 + kStages + s));

      const bool edge = need_mask(sh, q0, k0);
      uint32_t da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool top = e < 2;
          const float p =
              edge && !visible(sh, top ? r0 : r1, k0 + 8 * j + cq + (e & 1))
                  ? 0.f
                  : ex2(sc[4 * j + e] * sl2 - (top ? L0 : L1));
          ds[e] = p * (dp[4 * j + e] - (top ? dv0 : dv1));
        }
        da[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      if (it > 0) bar_sync(kBarFree, 2 * kConsumers);
      put_frag(xDS, t, da);
      bar_arrive(kBarDS, 2 * kConsumers);
    }
    return;
  }

  // warpgroup 1: dQ += dS·K over the band, all 256 columns
  float dqa[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[c][i] = 0.f;
  for (int it = 0; it < hi - lo; ++it) {
    const int s = it % kStages;
    if (loader && it + 1 < hi - lo) load(it + 1);
    __syncwarp();
    uint32_t da[4][4];
    bar_sync(kBarDS, 2 * kConsumers);
    get_frag(xDS, t, da);
    if (it + 1 < hi - lo) bar_arrive(kBarFree, 2 * kConsumers);
    const uint32_t tK = sK + s * L::kTileBytes;
    wg_fence();
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs(dqa[c], da[kk], desc_mn(tK, c, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < NB; ++c) keep(dqa[c]);
    keep(da);
    mbar_arrive(bars + 8 * (1 + kStages + s));
  }

  bf16* dqb = dq + q_off;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = c * kBoxCols + 8 * j + cq;
      if (d >= sh.D) continue;
      if (r0 < sh.S)
        *reinterpret_cast<__nv_bfloat162*>(dqb + r0 * q_stride + d) =
            __floats2bfloat162_rn(dqa[c][4 * j] * sh.scale,
                                  dqa[c][4 * j + 1] * sh.scale);
      if (r1 < sh.S)
        *reinterpret_cast<__nv_bfloat162*>(dqb + r1 * q_stride + d) =
            __floats2bfloat162_rn(dqa[c][4 * j + 2] * sh.scale,
                                  dqa[c][4 * j + 3] * sh.scale);
    }
}

// pass 2 at D = 256: dk and dv, one block per (kv tile, kv head, batch
// row) over the G query heads and their q tiles.  Warpgroup 0: Sᵀ = K·Qᵀ,
// Pᵀ, then dV += Pᵀ·dO; warpgroup 1: dPᵀ = V·dOᵀ, dSᵀ = Pᵀ ⊙ (dPᵀ -
// Dvec), then dK += dSᵀ·Q.  Each forms the A operand of its second
// product from its own tile, so only P crosses: float32, written before
// barrier 1 (kBarP), its buffer free again after barrier 2 (kBarFree).
// Each holds one 64 x 256 float32 accumulator (128 registers a thread),
// so the block has no producer warp: a ninth warp would put three warps
// on one of the SM's four sub-partitions and cap registers at 168 a
// thread (the accumulator, a score tile and the A fragments spilled
// there).  The first warp of warpgroup 1 fills the ring instead, one tile
// pair ahead.
__global__ void __launch_bounds__(2 * kConsumers, 1)
fa_bwd_dkdv256_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ dvec, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, Shape sh) {
  constexpr int NB = 4;
  typedef Smem256 L;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* gbase = smem_base(smem_raw);
  const uint32_t base = smem_u32(gbase);
  const uint32_t sK = base + L::kFixA, sV = base + L::kFixB;
  const uint32_t sQ = base + L::kRingA, sdO = base + L::kRingB;
  float4* xP = reinterpret_cast<float4*>(gbase + L::kP);
  // per stage: lse of the tile's 64 rows, then their Dvec
  float* rows = reinterpret_cast<float*>(gbase + L::kRowVals);
  const uint32_t bars = base + L::kBars, fixed = bars;

  const int kt = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  int qlo, qhi;
  q_band(sh, kt, &qlo, &qhi);
  const int n_band = qhi - qlo, n_it = sh.G * n_band;
  // full: the loader's expect_tx and its 32 lanes' row values
  init_barriers(bars, 33, 2 * kConsumers);

  // tile pair `it`'s Q and dO tiles and row values into its stage, by the
  // 32 lanes of warp 4 once both warpgroups have released the stage
  const bool loader = threadIdx.x / 32 == 4;
  const int lane = threadIdx.x & 31;
  auto load = [&](int it) {
    const int g = it / n_band, q0 = (qlo + it % n_band) * kTile;
    const int h = kv * sh.G + g, s = it % kStages;
    const uint32_t full = bars + 8 * (1 + s);
    mbar_wait(bars + 8 * (1 + kStages + s), ((it / kStages) & 1) ^ 1);
    const int64_t row_off = ((int64_t)b * sh.KV * sh.G + h) * sh.S;
    float* rl = rows + s * 2 * kTile;
    if (lane == 0) {
      mbar_expect_tx(full, 2 * L::kTileBytes);
      for (int c = 0; c < NB; ++c) {
        tma_load(sQ + s * L::kTileBytes + c * kBoxBytes, &tq, full,
                 c * kBoxCols, h, q0, b);
        tma_load(sdO + s * L::kTileBytes + c * kBoxBytes, &tdo, full,
                 c * kBoxCols, h, q0, b);
      }
    }
    // the rows' lse and Dvec by asynchronous copies that arrive on `full`
    // when they land (zeros past S), so the warp does not wait for them
    for (int r = lane; r < kTile; r += 32) {
      const bool in = q0 + r < sh.S;
      const int64_t at = row_off + (in ? q0 + r : 0);
      cp_async4(rl + r, lse + at, in);
      cp_async4(rl + kTile + r, dvec + at, in);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::
                     "r"(full) : "memory");
  };
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(fixed, 2 * L::kTileBytes);
      for (int c = 0; c < NB; ++c) {
        tma_load(sK + c * kBoxBytes, &tk, fixed, c * kBoxCols, kv, k0, b);
        tma_load(sV + c * kBoxBytes, &tv, fixed, c * kBoxCols, kv, k0, b);
      }
    }
    if (n_it > 0) load(0);
  }

  const int wg = threadIdx.x / kConsumers, t = threadIdx.x % kConsumers;
  const int w = t >> 5, ln = t & 31;
  const int kr0 = k0 + 16 * w + (ln >> 2), kr1 = kr0 + 8;   // keys
  const int cq = 2 * (ln & 3);
  const float sl2 = sh.scale * kLog2e;
  // warpgroup 0 multiplies K and Q, then accumulates dV against dO;
  // warpgroup 1 multiplies V and dO, then accumulates dK against Q
  const uint32_t sA = wg == 0 ? sK : sV;
  const uint32_t sB = wg == 0 ? sQ : sdO, sC = wg == 0 ? sdO : sQ;
  float acc[NB][32];                   // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  mbar_wait(fixed, 0);
  for (int it = 0; it < n_it; ++it) {
    const int q0 = (qlo + it % n_band) * kTile, s = it % kStages;
    const float* rl = rows + s * 2 * kTile;
    if (loader && it + 1 < n_it) load(it + 1);
    mbar_wait(bars + 8 * (1 + s), (it / kStages) & 1);
    const bool edge = need_mask(sh, q0, k0);
    // transposed tiles: rows are keys, columns queries
    float x[32];                       // Sᵀ, then Pᵀ (0); dPᵀ (1)
    uint32_t fr[4][4];                 // Pᵀ (0) or dSᵀ (1) as A fragments
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      mma_ss(x, desc_k(sA, kk), desc_k(sB + s * L::kTileBytes, kk), kk);
    wg_commit();
    wg_wait();
    keep(x);
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = 8 * j + cq;
        const float2 lq = *reinterpret_cast<const float2*>(rl + qc);
        const float l0 = lq.x * kLog2e, l1 = lq.y * kLog2e;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[4 * j + e] =
              edge && !visible(sh, q0 + qc + (e & 1), e < 2 ? kr0 : kr1)
                  ? 0.f
                  : ex2(x[4 * j + e] * sl2 - ((e & 1) ? l1 : l0));
      }
      if (it > 0) bar_sync(kBarFree, 2 * kConsumers);
      put_f32(xP, t, x);
      bar_arrive(kBarP, 2 * kConsumers);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        fr[j >> 1][(j & 1) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);
        fr[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
      }
    } else {
      bar_sync(kBarP, 2 * kConsumers);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = 8 * j + cq;
        const float2 dd = *reinterpret_cast<const float2*>(rl + kTile + qc);
        const float4 p = xP[j * kConsumers + t];
        fr[j >> 1][(j & 1) * 2] = pack_bf16(p.x * (x[4 * j] - dd.x),
                                            p.y * (x[4 * j + 1] - dd.y));
        fr[j >> 1][(j & 1) * 2 + 1] =
            pack_bf16(p.z * (x[4 * j + 2] - dd.x),
                      p.w * (x[4 * j + 3] - dd.y));
      }
      if (it + 1 < n_it) bar_arrive(kBarFree, 2 * kConsumers);
    }

    wg_fence();
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs(acc[c], fr[kk], desc_mn(sC + s * L::kTileBytes, c, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < NB; ++c) keep(acc[c]);
    keep(fr);
    mbar_arrive(bars + 8 * (1 + kStages + s));
  }

  const int64_t k_stride = (int64_t)sh.KV * sh.D;
  const int64_t k_off = (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;
  bf16* ob = wg == 0 ? dv : dk;
  const float mul = wg == 0 ? 1.f : sh.scale;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = c * kBoxCols + 8 * j + cq;
      if (d >= sh.D) continue;
      if (kr0 < sh.S)
        *reinterpret_cast<__nv_bfloat162*>(ob + k_off + kr0 * k_stride + d) =
            __floats2bfloat162_rn(acc[c][4 * j] * mul,
                                  acc[c][4 * j + 1] * mul);
      if (kr1 < sh.S)
        *reinterpret_cast<__nv_bfloat162*>(ob + k_off + kr1 * k_stride + d) =
            __floats2bfloat162_rn(acc[c][4 * j + 2] * mul,
                                  acc[c][4 * j + 3] * mul);
    }
}

}  // namespace tc

// ------------------------------------------------------------------------
// host side of the tensor-core route
// ------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: fetched through the runtime, so
// the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a rank-4 map over a contiguous bf16 tensor (B, S, heads, D), innermost
// first, read in 64 x 64 boxes (64 columns of D, one head, 64 positions,
// one batch row) in the 128-byte swizzle; what lies outside reads as 0
cudaError_t make_map(CUtensorMap* map, const void* ptr, int heads,
                     const Shape& sh) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)sh.D, (cuuint64_t)heads,
                              (cuuint64_t)sh.S, (cuuint64_t)sh.B};
  const cuuint64_t row = (cuuint64_t)sh.D * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * sh.S};
  const cuuint32_t box[4] = {tc::kBoxCols, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int NB>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* out, void* lse, const Shape& sh,
                          cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, q, sh.KV * sh.G, sh)) != cudaSuccess ||
      (err = make_map(&tk, k, sh.KV, sh)) != cudaSuccess ||
      (err = make_map(&tv, v, sh.KV, sh)) != cudaSuccess)
    return err;
  const int smem = tc::Smem<NB>::kFwdBytes;
  if ((err = allow_smem(tc::fa_fwd_tc_kernel<NB>, smem)) != cudaSuccess)
    return err;
  const int n_q = (sh.S + kTile - 1) / kTile;
  constexpr int wgs = tc::fwd_wgs<NB>();
  const dim3 grid((n_q + wgs - 1) / wgs, sh.KV * sh.G, sh.B);
  tc::fa_fwd_tc_kernel<NB><<<grid, tc::fwd_threads<NB>(), smem, stream>>>(
      tq, tk, tv, (tc::bf16*)out, (float*)lse, sh);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* out, const void* dout, const void* lse,
                          void* dvec, void* dq, void* dk, void* dv,
                          const Shape& sh, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = make_map(&tq, q, sh.KV * sh.G, sh)) != cudaSuccess ||
      (err = make_map(&tk, k, sh.KV, sh)) != cudaSuccess ||
      (err = make_map(&tv, v, sh.KV, sh)) != cudaSuccess ||
      (err = make_map(&tdo, dout, sh.KV * sh.G, sh)) != cudaSuccess)
    return err;
  const int n_t = (sh.S + kTile - 1) / kTile;
  decltype(&tc::fa_bwd_dq256_kernel) dq_kernel;
  decltype(&tc::fa_bwd_dkdv256_kernel) dkdv_kernel;
  int smem = tc::Smem<NB>::kBytes, threads = tc::kBwdThreads;
  if constexpr (NB < 4) {
    dq_kernel = tc::fa_bwd_dq_tc_kernel<NB>;
    dkdv_kernel = tc::fa_bwd_dkdv_tc_kernel<NB>;
  } else {
    // two consumer warpgroups, no producer warp
    dq_kernel = tc::fa_bwd_dq256_kernel;
    dkdv_kernel = tc::fa_bwd_dkdv256_kernel;
    smem = tc::Smem256::kBytes;
    threads = 2 * tc::kConsumers;
  }
  if ((err = allow_smem(dq_kernel, smem)) != cudaSuccess ||
      (err = allow_smem(dkdv_kernel, smem)) != cudaSuccess)
    return err;
  dq_kernel<<<dim3(n_t, sh.KV * sh.G, sh.B), threads, smem, stream>>>(
      tq, tk, tv, tdo, (const tc::bf16*)out, (const tc::bf16*)dout,
      (const float*)lse, (float*)dvec, (tc::bf16*)dq, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv_kernel<<<dim3(n_t, sh.KV, sh.B), threads, smem, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)dvec,
      (tc::bf16*)dk, (tc::bf16*)dv, sh);
  return cudaGetLastError();
}

// widest head of each direction (see the note at the top)
constexpr int kMaxFwdD = 256;
constexpr int kMaxBwdD = 256;

// float32: NJ = columns of D per thread / 16, rounded up to a power of
// two; only the instances up to kMaxNJ are built
template <int kMaxNJ, typename F>
cudaError_t dispatch_nj(int D, const F& f) {
  if (D <= 16) return f.template run<1>();
  if (D <= 32) return f.template run<2>();
  if (D <= 64) return f.template run<4>();
  if constexpr (kMaxNJ <= 8) {
    return f.template run<8>();
  } else {
    if (D <= 128) return f.template run<8>();
    return f.template run<16>();
  }
}

// bf16: NB = boxes of 64 columns a tile (D rounded up to 64, 128 or 256)
template <int kMaxNB, typename F>
cudaError_t dispatch_nb(int D, const F& f) {
  if (D <= 64) return f.template run_tc<1>();
  if constexpr (kMaxNB <= 2) {
    return f.template run_tc<2>();
  } else {
    if (D <= 128) return f.template run_tc<2>();
    return f.template run_tc<4>();
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  void *out, *lse;
  Shape sh;
  cudaStream_t st;
  template <int NJ> cudaError_t run() const {
    return launch_fwd<NJ>(q, k, v, out, lse, sh, st);
  }
  template <int NB> cudaError_t run_tc() const {
    return launch_fwd_tc<NB>(q, k, v, out, lse, sh, st);
  }
};

struct BwdArgs {
  const void *q, *k, *v, *out, *dout, *lse;
  void *dvec, *dq, *dk, *dv;
  Shape sh;
  cudaStream_t st;
  template <int NJ> cudaError_t run() const {
    if constexpr (NJ > kWideNJ)
      return launch_bwd_wide(q, k, v, out, dout, lse, dvec, dq, dk, dv, sh,
                             st);
    else
      return launch_bwd<NJ>(q, k, v, out, dout, lse, dvec, dq, dk, dv, sh,
                            st);
  }
  template <int NB> cudaError_t run_tc() const {
    return launch_bwd_tc<NB>(q, k, v, out, dout, lse, dvec, dq, dk, dv, sh,
                             st);
  }
};

bool bad_args(const Shape& sh, int max_d) {
  return sh.B < 1 || sh.S < 1 || sh.KV < 1 || sh.G < 1 || sh.D < 8 ||
         sh.D > max_d || sh.D % 8 != 0 || sh.window < 0 ||
         (int64_t)sh.KV * sh.G > 65535 || sh.B > 65535;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 = success).  _f32: float32 tensors, the
// CUDA-core kernels; _bf16: bfloat16 tensors, the tensor-core kernels.
// `device` is made current first: the caller's thread may have no context
// current (autograd runs the backward on a thread of its own), and the
// tensor maps are encoded by a driver call that needs one.
int fa_fwd_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int S, int KV, int G, int D, float scale,
               int causal, int window, int device, void* stream) {
  const Shape sh{B, S, KV, G, D, scale, causal, window};
  if (const cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (bad_args(sh, kMaxFwdD)) return (int)cudaErrorInvalidValue;
  const FwdArgs f{q, k, v, out, lse, sh, (cudaStream_t)stream};
  return (int)dispatch_nj<kMaxFwdD / 16>(D, f);
}

int fa_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int S, int KV, int G, int D, float scale,
                int causal, int window, int device, void* stream) {
  const Shape sh{B, S, KV, G, D, scale, causal, window};
  if (const cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (bad_args(sh, kMaxFwdD)) return (int)cudaErrorInvalidValue;
  const FwdArgs f{q, k, v, out, lse, sh, (cudaStream_t)stream};
  return (int)dispatch_nb<kMaxFwdD / 64>(D, f);
}

// dvec is float32 scratch of lse's shape (B, KV, G, S).
int fa_bwd_f32(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, void* dvec, void* dq,
               void* dk, void* dv, int B, int S, int KV, int G, int D,
               float scale, int causal, int window, int device,
               void* stream) {
  const Shape sh{B, S, KV, G, D, scale, causal, window};
  if (const cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (bad_args(sh, kMaxBwdD)) return (int)cudaErrorInvalidValue;
  const BwdArgs f{q, k, v, out, dout, lse, dvec, dq, dk, dv, sh,
                  (cudaStream_t)stream};
  return (int)dispatch_nj<kMaxBwdD / 16>(D, f);
}

int fa_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const void* lse, void* dvec, void* dq,
                void* dk, void* dv, int B, int S, int KV, int G, int D,
                float scale, int causal, int window, int device,
                void* stream) {
  const Shape sh{B, S, KV, G, D, scale, causal, window};
  if (const cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (bad_args(sh, kMaxBwdD)) return (int)cudaErrorInvalidValue;
  const BwdArgs f{q, k, v, out, dout, lse, dvec, dq, dk, dv, sh,
                  (cudaStream_t)stream};
  return (int)dispatch_nb<kMaxBwdD / 64>(D, f);
}

// dynamic shared memory, in bytes, that the tensor-core route's forward
// (backward = 0) or backward kernels take at head width D
int fa_bf16_smem_bytes(int backward, int D) {
  const int nb = D <= 64 ? 1 : D <= 128 ? 2 : 4;
  if (backward)
    return nb == 1 ? tc::Smem<1>::kBytes
                   : nb == 2 ? tc::Smem<2>::kBytes : tc::Smem256::kBytes;
  return nb == 1 ? tc::Smem<1>::kFwdBytes
                 : nb == 2 ? tc::Smem<2>::kFwdBytes : tc::Smem<4>::kFwdBytes;
}

const char* fa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
