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
// pass over each q tile's kv band, then a dk/dv pass over each kv tile's
// q band.
//
// Layout (the reference's public one): q, out, dout, dq (B, S, KV, G, D);
// k, v, dk, dv (B, S, KV, D); lse and Dvec (B, KV, G, S) float32.  The kv
// head of query head (kv, g) is `kv` -- the kernel indexes it and never
// broadcasts k or v G times, as the Pallas wrapper does.  Types: float32
// or bfloat16 in and out, float32 arithmetic throughout.  D is a multiple
// of 8, at most 256 in the forward and at most 128 in the backward; S is
// any length (the ragged last tile is masked in the kernel, never padded in
// memory); offsets are 64-bit.
//
// Head width.  The tiles sit in shared memory as float32 rows of D + 1, so
// the forward's three 64-row tiles and its score tile take
// 4·(3·64·(D + 1) + 64·65 + 128) bytes: 214,528 at D = 256 (the `local`
// layers of recurrentgemma-2b, MQA at 256), under the 232,448 a block may
// opt into, at one block per SM; each thread then holds a 4 x 16 slice of
// the output in registers (NJ = 16).  The backward's passes hold one more
// (dq) or two more (dk/dv) tiles, about 281 KB and 297 KB at D = 256, which
// do not fit: they stop at 128, and the launcher refuses a wider head
// before any launch.  A wider backward needs D split across blocks or bf16
// tiles in shared memory (ROADMAP.md).
//
// What bounds it, and what the design does about it.  Causal attention
// does S(S+1)/2·H·4D operations against 4·S·H·D elements moved: at the
// training path's shape (S = 4096, H = 32, D = 64) that is 68.7 GFLOP
// against 67 MB, so the card's arithmetic rate bounds it, not its memory.
// This first kernel computes on the CUDA cores in float32 (no tensor
// cores; wgmma and TMA are later work): each block owns a 64x64 score
// tile, each of its 256 threads a 4x4 register sub-tile, so every value
// read from shared memory feeds four FMAs; rows in shared memory are
// padded to an odd stride so the 16 threads of a half-warp that read 16
// rows at one column hit 16 banks.  Fully masked tiles are never loaded.
// The forward walks the heaviest q tiles (the last, under a causal mask)
// first.  The dk/dv pass sums the G query heads of a kv head inside one
// block, in a fixed order, so no atomics are needed and results are
// reproducible.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;             // rows of a q tile and of a kv tile
constexpr int kThreads = 256;         // 16 x 16 threads, 4 x 4 each
constexpr int kLdP = kTile + 1;       // stride of a 64 x 64 score tile
constexpr float kNegInit = -1e30f;    // the reference's running-max start

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

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
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t stride, int row0,
                                          const Shape& sh, float mul) {
  for (int idx = threadIdx.x; idx < kTile * sh.D; idx += kThreads) {
    const int r = idx / sh.D, d = idx - r * sh.D;
    const int row = row0 + r;
    dst[r * ld + d] =
        row < sh.S ? to_f(src[(int64_t)row * stride + d]) * mul : 0.f;
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
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
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
  const T* qb = q + (int64_t)b * sh.S * q_stride + (int64_t)h * sh.D;
  const T* kb = k + (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;
  const T* vb = v + (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;

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

  T* ob = out + (int64_t)b * sh.S * q_stride + (int64_t)h * sh.D;
  float* lb = lse + ((int64_t)b * sh.KV * sh.G + h) * sh.S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sh.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < sh.D) ob[(int64_t)r * q_stride + d] = from_f<T>(acc[i][j] / lc);
    }
    if (tx == 0) lb[r] = m[i] + logf(lc);
  }
}

// ------------------------------------------------------------------------
// backward, pass 1: Dvec = rowsum(dout ⊙ out) and dq, one block per
// (q tile, query head, batch row), over the tile's kv band
// ------------------------------------------------------------------------
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ out,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ dvec, T* __restrict__ dq, Shape sh) {
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
  const T* kb = k + (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;
  const T* vb = v + (int64_t)b * sh.S * k_stride + (int64_t)kv * sh.D;
  const int64_t row_off = ((int64_t)b * sh.KV * sh.G + h) * sh.S;

  load_tile(sQ, ld, q + q_off, q_stride, q0, sh, sh.scale);
  load_tile(sdO, ld, dout + q_off, q_stride, q0, sh, 1.f);
  // Dvec: one warp per row, lanes over d
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < sh.S) {
      const T* o_row = out + q_off + (int64_t)row * q_stride;
      const T* do_row = dout + q_off + (int64_t)row * q_stride;
      for (int d = lane; d < sh.D; d += 32)
        acc = fmaf(to_f(do_row[d]), to_f(o_row[d]), acc);
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

  T* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sh.S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < sh.D)
        dqb[(int64_t)r * q_stride + d] = from_f<T>(dqa[i][j] * sh.scale);
    }
  }
}

// ------------------------------------------------------------------------
// backward, pass 2: dk and dv, one block per (kv tile, kv head, batch
// row), summing the G query heads of the kv head and the q tiles of each
// ------------------------------------------------------------------------
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dvec, T* __restrict__ dk,
                   T* __restrict__ dv, Shape sh) {
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
        dk[k_off + (int64_t)c * k_stride + d] = from_f<T>(dka[i][j]);
        dv[k_off + (int64_t)c * k_stride + d] = from_f<T>(dva[i][j]);
      }
    }
  }
}

// shared memory of each kernel, in bytes; the slack after the last buffer
// covers the reads of columns d >= D (up to 16·NJ - 1) in the last row
constexpr int kSlack = 128;
inline size_t fwd_smem(int D) {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kLdP + kSlack);
}
inline size_t dq_smem(int D) {
  return sizeof(float) *
         (4 * kTile * (D + 1) + kTile * kLdP + 2 * kTile + kSlack);
}
inline size_t dkdv_smem(int D) {
  return sizeof(float) *
         (4 * kTile * (D + 1) + 2 * kTile * kLdP + 2 * kTile + kSlack);
}

template <typename T, int NJ>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, const Shape& sh,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem(sh.D);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.S + kTile - 1) / kTile, sh.KV * sh.G, sh.B);
  fa_fwd_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, sh);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const void* lse,
                       void* dvec, void* dq, void* dk, void* dv,
                       const Shape& sh, cudaStream_t stream) {
  size_t smem = dq_smem(sh.D);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_t = (sh.S + kTile - 1) / kTile;
  fa_bwd_dq_kernel<T, NJ><<<dim3(n_t, sh.KV * sh.G, sh.B), kThreads, smem,
                            stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)out, (const T*)dout,
      (const float*)lse, (float*)dvec, (T*)dq, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = dkdv_smem(sh.D);
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<T, NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_kernel<T, NJ><<<dim3(n_t, sh.KV, sh.B), kThreads, smem,
                              stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)dvec, (T*)dk, (T*)dv, sh);
  return cudaGetLastError();
}

// widest head of each direction (see "Head width" above)
constexpr int kMaxFwdD = 256;
constexpr int kMaxBwdD = 128;

// NJ = columns of D per thread / 16, rounded up to a power of two; only
// the instances up to kMaxNJ are built
template <int kMaxNJ, typename T, typename F>
cudaError_t dispatch_nj(int D, const F& f) {
  if (D <= 16) return f.template run<T, 1>();
  if (D <= 32) return f.template run<T, 2>();
  if (D <= 64) return f.template run<T, 4>();
  if constexpr (kMaxNJ <= 8) {
    return f.template run<T, 8>();
  } else {
    if (D <= 128) return f.template run<T, 8>();
    return f.template run<T, 16>();
  }
}

template <int kMaxNJ, typename F>
cudaError_t dispatch(int dtype, int D, const F& f) {
  if (dtype == 0) return dispatch_nj<kMaxNJ, float>(D, f);
  return dispatch_nj<kMaxNJ, __nv_bfloat16>(D, f);
}

struct FwdArgs {
  const void *q, *k, *v;
  void *out, *lse;
  Shape sh;
  cudaStream_t st;
  template <typename T, int NJ> cudaError_t run() const {
    return launch_fwd<T, NJ>(q, k, v, out, lse, sh, st);
  }
};

struct BwdArgs {
  const void *q, *k, *v, *out, *dout, *lse;
  void *dvec, *dq, *dk, *dv;
  Shape sh;
  cudaStream_t st;
  template <typename T, int NJ> cudaError_t run() const {
    return launch_bwd<T, NJ>(q, k, v, out, dout, lse, dvec, dq, dk, dv, sh,
                             st);
  }
};

bool bad_args(int dtype, const Shape& sh, int max_d) {
  return (dtype != 0 && dtype != 1) || sh.B < 1 || sh.S < 1 || sh.KV < 1 ||
         sh.G < 1 || sh.D < 8 || sh.D > max_d || sh.D % 8 != 0 ||
         sh.window < 0 || (int64_t)sh.KV * sh.G > 65535 || sh.B > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int fa_fwd(int dtype, const void* q, const void* k, const void* v,
           void* out, void* lse, int B, int S, int KV, int G, int D,
           float scale, int causal, int window, void* stream) {
  const Shape sh{B, S, KV, G, D, scale, causal, window};
  if (bad_args(dtype, sh, kMaxFwdD)) return (int)cudaErrorInvalidValue;
  const FwdArgs f{q, k, v, out, lse, sh, (cudaStream_t)stream};
  return (int)dispatch<kMaxFwdD / 16>(dtype, D, f);
}

// dvec is float32 scratch of lse's shape (B, KV, G, S).
int fa_bwd(int dtype, const void* q, const void* k, const void* v,
           const void* out, const void* dout, const void* lse, void* dvec,
           void* dq, void* dk, void* dv, int B, int S, int KV, int G, int D,
           float scale, int causal, int window, void* stream) {
  const Shape sh{B, S, KV, G, D, scale, causal, window};
  if (bad_args(dtype, sh, kMaxBwdD)) return (int)cudaErrorInvalidValue;
  const BwdArgs f{q, k, v, out, dout, lse, dvec, dq, dk, dv, sh,
                  (cudaStream_t)stream};
  return (int)dispatch<kMaxBwdD / 16>(dtype, D, f);
}

const char* fa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
