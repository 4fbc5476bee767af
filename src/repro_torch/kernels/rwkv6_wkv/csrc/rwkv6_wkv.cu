// RWKV6 WKV recurrence, forward and backward, for Hopper (sm_90a): the
// forward an exact chunked form whose steps inside a chunk run in
// parallel, the backward a reverse sweep over recomputed states.
//
// Replaces the TPU kernel `wkv_pallas`
// (src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:76, body `wkv_kernel` :29).  It
// computes what that kernel computes, per (batch, head), from S_0 = 0:
//
//   out_t = r_t · (S_{t-1} + (u ⊙ k_t) ⊗ v_t),   S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
//
// and returns out (B, H, S, V) in r's type and S_last (B, H, K, V) float32.
// r, k, w are (B, H, S, K), v is (B, H, S, V), u is (H, K), all contiguous
// and 16-byte aligned; r, k, v, u are float32 or bfloat16, w is float32 in
// [0, 1]; the arithmetic is float32.  K, V are 16, 32 or 64; S >= 1.
//
// The chunked form.  Per chunk of L steps, from the state S carried in from
// the chunks before, with w[i:j] = Π_{i<=m<j} w_m (1 for an empty interval):
//
//   out_t = (r_t ⊙ w[0:t]) · S                   inter-chunk, (L x K)(K x V)
//         + Σ_{s<t} A[t,s] v_s,  A[t,s] = Σ_k r_tk k_sk w[s+1:t]_k
//         + (Σ_k r_tk u_k k_tk) v_t                   the bonus, A's diagonal
//   S    <- diag(w[0:L]) S + Σ_s (k_s ⊙ w[s+1:L]) ⊗ v_s
//
// Every output of a chunk depends only on S and the chunk's own inputs, so
// the chain across the sequence is S/L chunk steps, not S steps.
//
// The exponent rule, which makes it exact.  Every decay factor is the
// product of w over an interval between s and t: it lies in [0, 1], is
// never a ratio of two prefix products and never an inverse.  It equals
// exp(la[t-1] - la[s]) over the cumulative log-decay la, whose argument is
// <= 0, but it is computed by multiplying, so the kernel calls neither exp
// nor log: a zero in w gives an exact 0 past it (where log would give -inf
// and a difference of two -inf NaN), w = 1 gives exactly 1, and no floor
// under log w is needed.  The Pallas kernel and the reference's
// `wkv_chunked` instead factor the score as exp(la[t-1]) · exp(min(-la[s],
// 30)), which stops equalling it once la passes -30 inside a chunk: at
// rwkv6-1.6b's initial decay w = e^-1 and chunk 64 their output is off by up
// to 56.8.  `ref.py::wkv_chunked_exact` is this algorithm in plain torch.
//
// What bounds it on this card.  At the serve path's shape (4, 32, 1024, 64,
// 64) the minimal work is 4·K·V float32 operations a step and head (r·S and
// the state update): 2.19 GFLOP, 0.0327 ms at 67 TFLOP/s, against ~103 MB,
// 0.0307 ms at 3.35 TB/s.  A chunk's tiles are small (L = 16 rows), so a
// product of them on the CUDA cores reads an operand from shared memory
// for every one or two FMAs: this tiling with both products on the CUDA
// cores (register tiles of 1 x 4 and 4 x 4) took 1.77x as long on the card
// (`repro_torch/kernels/recurrence_ab.py` times it).  So the two products
// go to the tensor cores, where a fragment is read once, in a split form
// that keeps float32 accuracy.  The design:
//   * one block of 256 threads per (batch, head, V tile of VT = 32
//     columns): 256 blocks at the path's shape, two on each SM; r, k and w
//     are read once per V tile (the tiles of one head run side by side and
//     L2 serves the repeat);
//   * the products on the tensor cores, 3xTF32 `mma.sync.m16n8k8`: each
//     float32 operand x is split into hi = x with its low 13 bits cleared
//     and lo = (x - hi) likewise, and a·b is summed as al·bh + ah·bl +
//     ah·bh with float32 accumulation; what is dropped is below 3·2^-20 of
//     a product, next to float32's own rounding of the sums.  A v in bfloat16
//     is exact in TF32, so its bl = 0 term is skipped.  Plain TF32 (one
//     product, 10 bits) would not meet the float32 checks;
//   * the first half of the block (warps 0-3) makes, per column k, the
//     running products r_t ⊙ w[0:t], k_s ⊙ w[s+1:L], w[0:L] and the
//     half-chunk ones below; after the barrier sums A's parts and computes
//     out = [r ⊙ w[0:t] | A]·[S ; v], a 16 x 8 tile a warp (L x (K+L) by
//     (K+L) x VT), its A fragments by `ldmatrix`, stored from the
//     accumulators.  Its share of a chunk is the longer one, so the second
//     half issues the copies and converts v;
//   * A = [[A0, 0], [A10, A1]] in blocks of L/2.  A10 = Q·Kqᵀ with Q_t =
//     r_t ⊙ w[L/2:t] and Kq_s = k_s ⊙ w[s+1:L/2], every factor an interval
//     between s and t, is one more tensor-core product (first half).  A0
//     and A1 are built pairwise by the second half (warps 4-7): a thread
//     takes a k-slice of two rows s of one block and carries k_s ⊙
//     w[s+1:t] forward one step at a time (a multiply and an FMA an entry
//     and k), L/2-1 steps, and the k-slices are summed in shared memory;
//   * the second half holds the state S (K x VT, float32) in mma
//     accumulators for the whole sequence, a row of 16 x 8 tiles a warp,
//     and updates it as diag(w[0:L]) S + (k ⊙ w[s+1:L])ᵀ·v on the tensor
//     cores while the first half computes the outputs; it writes S to one
//     of two shared buffers, the B operand of the next chunk;
//   * two block barriers a chunk, and a named barrier among the first half;
//   * staging: the next chunks' r, k, w and v tiles are copied into a ring
//     of NST = 4 shared-memory stages by 16-byte `cp.async` while chunk c
//     computes.  cp.async and not TMA: a stage is four small tiles (the
//     r, k and w rows of a chunk are each one contiguous run of L·K
//     elements, v's tile L rows of 64 bytes), so 4-5 copies a thread of
//     the second half fill it with no tensor map and no barrier protocol; a
//     ragged last chunk copies only its rows, and never reads past its
//     (batch, head) row.

//
// The backward (`wkv_bwd_kernel`) replaces what the reference
// differentiates, its plain-JAX `wkv_chunked` (src/repro/models/rwkv6.py:54;
// the Pallas kernel has no backward).  From the gradients of out and of
// S_last, a reverse sweep carries dS (K x V float32, seeded by dS_last);
// with G = r_t ⊗ do_t and kv = k_t ⊗ v_t, each step takes what autograd of
// the step takes, in its order:
//
//   dr_t[k] = Σ_j do_t[j]·(S_{t-1}[k,j] + u[k]·kv[k,j])
//   gkv     = u[k]·G[k,j] + dS_t[k,j]
//   dk_t[k] = Σ_j gkv[k,j]·v_t[j],   dv_t[j] = Σ_k gkv[k,j]·k_t[k]
//   dw_t[k] = Σ_j dS_t[k,j]·S_{t-1}[k,j]
//   du[k]  += Σ_j G[k,j]·kv[k,j]            (over time and batch)
//   dS_{t-1} = diag(w_t)·dS_t + G
//
// (ref.py::wkv_bwd_ref writes it out in plain torch).  It needs S_{t-1}
// at every step, backwards: one block of 256 threads per (batch, head)
// runs the recurrence forward once and keeps the state before every chunk
// of kBwdL = 16 steps in device memory (a float32 K x V a chunk: 1 GB for
// 30 sequences x 32 heads x 1,024 steps at K = V = 64, one layer's at a
// time).  Then, chunk by chunk from the last, it recomputes the chunk's
// states from its checkpoint twice: once keeping the state before each of
// its four sub-chunks of 4 steps in shared memory (64 KB at K = V = 64),
// then, sub-chunk by sub-chunk from the last, its 4 states into
// registers, which the sweep back reads.  (The first design kept the 16
// states of a chunk in a device-memory scratch of its own: 32 KB moved a
// step and block, 31 GB a call at the path's shape, and 13.4 ms.)  A
// thread holds V/(256/K) entries of one row k of S and of dS: the sums over
// j are shuffles among the row's threads; the sums over k for dv a
// reduce-scatter among a warp's rows (each round halves what a lane
// keeps), then the 8 warps' partials summed in shared memory in a fixed
// order.  du is summed over time in each block, then over the batch by
// `wkv_bwd_du_kernel` in a fixed order: no atomics.  Products of w only,
// no exp or log.  What bounds it: the chain of steps a block runs, each
// a few dependent shuffle rounds and some 7·V/(256/K) FMAs a thread; two
// blocks an SM hide each other's latency.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void bf2_to_f32(uint32_t x, float* o) {
  o[0] = __uint_as_float(x << 16);             // the lower element first
  o[1] = __uint_as_float(x & 0xffff0000u);
}

// N consecutive elements at p (shared memory, aligned to N elements) as f32
template <int N>
__device__ __forceinline__ void ld_f32(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = x.x;
      o[4 * i + 1] = x.y;
      o[4 * i + 2] = x.z;
      o[4 * i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x;
    o[1] = x.y;
  } else {
    o[0] = p[0];
  }
}
template <int N>
__device__ __forceinline__ void ld_f32(const __nv_bfloat16* p, float* o) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[i];
      bf2_to_f32(x.x, o + 8 * i);
      bf2_to_f32(x.y, o + 8 * i + 2);
      bf2_to_f32(x.z, o + 8 * i + 4);
      bf2_to_f32(x.w, o + 8 * i + 6);
    }
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    bf2_to_f32(x.x, o);
    bf2_to_f32(x.y, o + 2);
  } else if constexpr (N == 2) {
    bf2_to_f32(*reinterpret_cast<const uint32_t*>(p), o);
  } else {
    o[0] = __bfloat162float(p[0]);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void add4(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// a 16 x 8 float32 A fragment of the mma by one `ldmatrix.x4`: lane l gives
// the address of row l % 16, columns (l / 16)·4.., of the row-major tile
// (16-byte aligned rows), and gets rows g and g + 8, columns tq and tq + 4
__device__ __forceinline__ void ldsm_x4(const float* row, float* f) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  uint32_t x[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(a));
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(x[i]);
}

// 3xTF32 on the tensor cores: x = hi + lo, both TF32 (hi its 10-bit
// mantissa truncated, lo the rest, truncated again); a·b is summed as
// al·bh + ah·bl (into e) and ah·bh (into d), dropping al·bl.  What is lost
// (al·bl and the truncations) is below 3·2^-20 of the product.  The
// split is two masks and a subtraction where the fragment is loaded (with
// cvt.rna.tf32 conversions instead, the kernel ran slower on the card).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
struct FragA {                       // a 16 x 8 A fragment, split
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit FragA(const float* x) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
  }
};
struct FragB {                       // an 8 x 8 B fragment, split
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ explicit FragB(const float* x) {
#pragma unroll
    for (int i = 0; i < 2; ++i) split_tf32(x[i], hi[i], lo[i]);
  }
};
// EXACT_B: b holds values that TF32 represents exactly (bfloat16 inputs),
// so bl = 0 and its product is skipped
template <bool EXACT_B = false>
__device__ __forceinline__ void mma_3xtf32(float* d, float* e, const FragA& a,
                                           const FragB& b) {
  mma_tf32(e, a.lo, b.hi);
  if constexpr (!EXACT_B) mma_tf32(e, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// the tiling of one instance: K, V the head widths, VT the V tile of a
// block, L the chunk, NST the stages of the copy ring
template <typename T, int K_, int V_, int VT_, int L_, int NST_>
struct Cfg {
  using E = T;
  static constexpr int K = K_, V = V_, VT = VT_, L = L_, NST = NST_;
  static constexpr int IN = K + L;                  // X's width: [r ⊙ w | A]
  // row strides chosen so that a warp's fragment loads hit 32 distinct
  // banks (and rows stay 16-byte aligned)
  static constexpr int XS = IN + 4, YS = VT + 8, KDS = K + 8;
  static constexpr int NT8 = VT / 8;                // 8-column tiles of out
  static constexpr int TT2 = (K / 16) * NT8;        // 16 x 8 tiles of S
  static constexpr int TPW = (TT2 + 3) / 4;         // ... a state warp
  // A = [[A0, 0], [A10, A1]] in L/2 x L/2 blocks.  The diagonal blocks
  // are built pairwise by the second half, KS k-slices of KPS each; A10 =
  // Q·Kqᵀ on the tensor cores by the first half, with Q_t = r_t ⊙ w[H:t]
  // and Kq_s = k_s ⊙ w[s+1:H] (H = L/2; every factor an interval below t).
  static constexpr int H2 = L / 2;
  static constexpr int KS = K < 16 ? K : 16, KPS = K / KS;
  static constexpr int EA = 2 * H2 * H2 + 1;        // A's slice-group stride
  static constexpr int QS = K + 4;                  // Q and Kq row stride
  // one stage of the ring: r, k (L x K, T), w (L x K, f32), v (L x VT, T)
  static constexpr int R_B = L * K * (int)sizeof(T);
  static constexpr int W_B = L * K * 4;
  static constexpr int V_B = L * VT * (int)sizeof(T);
  static constexpr int STAGE_B = 2 * R_B + W_B + V_B;
  // the float32 working area after the ring
  static constexpr int X_F = L * XS, SB_F = 2 * K * YS, VB_F = L * YS;
  static constexpr int KD_F = L * KDS, SA_F = KS * EA;
  static constexpr int Q_F = 2 * H2 * QS, SQ_F = H2 * H2 * 4;
  static constexpr int SMEM = NST * STAGE_B +
      4 * (X_F + SB_F + VB_F + KD_F + 2 * K + SA_F + Q_F + SQ_F);
  static_assert(L == 16 && NT8 <= 4 && TPW <= 4 && NT8 % TPW == 0,
                "warp tiling: a state warp's tiles share one m-tile");
  static_assert(K % KS == 0 && KS % 4 == 0 && H2 * KS <= kThreads / 2,
                "A's k-slices");
  static_assert(2 * K <= kThreads / 2 && SA_F % 4 == 0, "the first half");
  static_assert(V % VT == 0 && VT % 16 == 0, "V tiles");
  static_assert(R_B % 16 == 0 && V_B % 16 == 0, "16-byte copies");
};

template <class C>
__global__ void __launch_bounds__(kThreads, 2)
wkv_fwd_chunked_kernel(const typename C::E* __restrict__ r,
                       const typename C::E* __restrict__ k,
                       const typename C::E* __restrict__ v,
                       const float* __restrict__ w,
                       const typename C::E* __restrict__ u,
                       typename C::E* __restrict__ out,
                       float* __restrict__ s_last, int H, int S) {
  using T = typename C::E;
  constexpr int K = C::K, V = C::V, VT = C::VT, L = C::L, NST = C::NST;
  constexpr int IN = C::IN, XS = C::XS, YS = C::YS, KDS = C::KDS;
  constexpr int KS = C::KS, KPS = C::KPS, EA = C::EA, HALF = kThreads / 2;
  constexpr int H2 = C::H2, QS = C::QS;
  // v in bfloat16 is exact in TF32: its products need no low part
  constexpr bool kExactV = sizeof(T) == 2;
  constexpr int R_B = C::R_B, W_B = C::W_B, STAGE_B = C::STAGE_B;
  extern __shared__ __align__(16) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem + NST * STAGE_B);  // L x XS
  float* SB = X + C::X_F;            // 2 x K x YS: the state, by chunk parity
  float* VB = SB + C::SB_F;          // L x YS: v
  float* KD = VB + C::VB_F;          // L x KDS: k_s ⊙ w[s+1:L]
  float* CPL = KD + C::KD_F;         // K: w[0:L]
  float* U = CPL + K;                // K: u of this head
  float* SA = U + K;                 // A0, A1: partial sums over k-slices
  float* Q = SA + C::SA_F;           // H2 x QS: r_t ⊙ w[H2:t], t >= H2
  float* KQ = Q + H2 * C::QS;        // H2 x QS: k_s ⊙ w[s+1:H2], s < H2
  float* SQ = KQ + H2 * C::QS;       // A10: partial sums over 4 warps

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;          // fragment coordinates
  const int bh = blockIdx.x / (V / VT);
  const int v0 = blockIdx.x % (V / VT) * VT;
  const T* rb = r + (int64_t)bh * S * K;
  const T* kb = k + (int64_t)bh * S * K;
  const float* wb = w + (int64_t)bh * S * K;
  const T* vb = v + (int64_t)bh * S * V + v0;
  const int n_chunks = (S + L - 1) / L;

  // chunk c's rows into its stage (an empty group past the last chunk),
  // copied by the second half: the first half's share of a chunk is the
  // longer one
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int t0 = c * L, n = min(L, S - t0);
      unsigned char* st = smem + (c % NST) * STAGE_B;
      const char* rg = reinterpret_cast<const char*>(rb + (int64_t)t0 * K);
      const char* kg = reinterpret_cast<const char*>(kb + (int64_t)t0 * K);
      const char* wg = reinterpret_cast<const char*>(wb + (int64_t)t0 * K);
      const int rk = n * K * (int)sizeof(T) / 16;
      for (int p = tid - HALF; p >= 0 && p < rk; p += HALF) {
        cp_async16(st + p * 16, rg + p * 16);
        cp_async16(st + R_B + p * 16, kg + p * 16);
      }
      for (int p = tid - HALF; p >= 0 && p < n * K / 4; p += HALF)
        cp_async16(st + 2 * R_B + p * 16, wg + p * 16);
      constexpr int VP = VT * (int)sizeof(T) / 16;      // copies a v row
      for (int p = tid - HALF; p >= 0 && p < n * VP; p += HALF) {
        const int row = p / VP, q = p % VP;
        cp_async16(st + 2 * R_B + W_B + row * VT * (int)sizeof(T) + q * 16,
                   reinterpret_cast<const char*>(
                       vb + (int64_t)(t0 + row) * V) + q * 16);
      }
    }
    cp_async_commit();
  };

  for (int c = 0; c < NST - 1; ++c) issue(c);
  for (int j = tid; j < K; j += kThreads)
    U[j] = to_f(u[(int64_t)(bh % H) * K + j]);
  for (int j = tid; j < K * YS; j += kThreads) SB[j] = 0.0f;
  for (int e = tid; e < H2 * H2; e += kThreads)   // A's upper right block
    X[e / H2 * XS + K + H2 + e % H2] = 0.0f;

  // The state, in float32 registers of the second half's warps: warp
  // 4 + w' holds the 16 x 8 tiles mt = tile / NT8, nt = tile % NT8 for
  // tile = w'·TPW + i (a row of tiles), as mma accumulators (rows g and
  // g + 8, columns 2 tq and 2 tq + 1).  After each chunk it is also
  // written to SB[parity], the B operand of the next chunk's outputs.
  constexpr int TPW = C::TPW, NT8 = C::NT8;
  float st[TPW][4];
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) st[i][q] = 0.0f;
  auto tile_of = [&](int i) { return (warp - HALF / 32) * TPW + i; };
  auto put_state = [&](float* dst, int64_t ld) {
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      if (tile_of(i) >= C::TT2) continue;
      const int row = tile_of(i) / NT8 * 16 + g;
      const int col = tile_of(i) % NT8 * 8 + 2 * tq;
      *reinterpret_cast<float2*>(dst + row * ld + col) =
          make_float2(st[i][0], st[i][1]);
      *reinterpret_cast<float2*>(dst + (row + 8) * ld + col) =
          make_float2(st[i][2], st[i][3]);
    }
  };

  // Two barriers a chunk: (a) its stage has landed, the last chunk's
  // outputs are stored and its state is in SB; (b) X's first K columns,
  // KD, w[0:L], v and A's partial sums are in.  Then the first half builds
  // A and the outputs while the second half updates the state.  Loads come
  // before stores in every part: the compiler cannot tell the
  // shared-memory arrays apart, so a load after a store would wait for it.
  for (int c = 0; c < n_chunks; ++c) {
    issue(c + NST - 1);
    cp_async_wait<NST - 1>();
    __syncthreads();                                          // (a)
    const int t0 = c * L, n = min(L, S - t0);
    const unsigned char* sg = smem + (c % NST) * STAGE_B;
    const T* rs = reinterpret_cast<const T*>(sg);
    const T* ks = reinterpret_cast<const T*>(sg + R_B);
    const float* ws = reinterpret_cast<const float*>(sg + 2 * R_B);
    const T* vs = reinterpret_cast<const T*>(sg + 2 * R_B + W_B);

    if (tid < HALF) {
      // 1. the first half, per column k: r_t ⊙ w[0:t] into X, k_s ⊙
      //    w[s+1:L] into KD, w[0:L], and the half-chunk products Q and Kq.
      //    Rows past the sequence are r = k = 0, w = 1.
      if (tid < 2 * K) {
        const int j = tid % K;
        const T* xs = tid < K ? rs : ks;
        float xv[L], wv[L];
#pragma unroll
        for (int t = 0; t < L; ++t) {
          xv[t] = t < n ? to_f(xs[t * K + j]) : 0.0f;
          wv[t] = t < n ? ws[t * K + j] : 1.0f;
        }
        float p = 1.0f, ph = 1.0f;
        if (tid < K) {
#pragma unroll
          for (int t = 0; t < L; ++t) {
            X[t * XS + j] = xv[t] * p;
            if (t >= H2) {
              Q[(t - H2) * QS + j] = xv[t] * ph;
              ph *= wv[t];
            }
            p *= wv[t];
          }
          CPL[j] = p;
        } else {
#pragma unroll
          for (int s = L - 1; s >= 0; --s) {
            KD[s * KDS + j] = xv[s] * p;
            if (s < H2) {
              KQ[s * QS + j] = xv[s] * ph;
              ph *= wv[s];
            }
            p *= wv[s];
          }
        }
      }
    }
    if (tid < HALF) {
      // 2a. A10 = Q·Kqᵀ, a quarter of the inner dimension a warp, partial
      //     sums into SQ[t·H2 + s][warp] (rows 8..15 of the mma are zero)
      asm volatile("bar.sync 1, %0;\n" ::"n"(HALF) : "memory");
      float d[4] = {}, e[4] = {};
#pragma unroll
      for (int i = warp * 8; i < K; i += 32) {
        const float fa[4] = {Q[g * QS + i + tq], 0.0f, Q[g * QS + i + tq + 4],
                             0.0f};
        const float fb[2] = {KQ[g * QS + i + tq], KQ[g * QS + i + tq + 4]};
        mma_3xtf32(d, e, FragA(fa), FragB(fb));
      }
      SQ[(g * H2 + 2 * tq) * 4 + warp] = d[0] + e[0];
      SQ[(g * H2 + 2 * tq + 1) * 4 + warp] = d[1] + e[1];
    } else {
      // 2b. A0 and A1, pairwise: partial sums over a k-slice into
      //     SA[slice / 4][e][slice % 4], e = half·H2² + (t % H2)·H2 + s % H2:
      //     the bonus on the diagonal, and k_s ⊙ w[s+1:t] carried over t.
      //     A thread takes s1 = o + sp and s2 = o + H2-1-sp of one half (o =
      //     0 or H2), H2-1 steps in all: steps i < H2-1-sp are (t = s1+1+i,
      //     s1), the rest (t = o+1+i, s2).  Rows t >= n hold whatever; they
      //     are never stored.
      const int h = tid - HALF;
      const int pr = h / KS, slice = h % KS, k0 = slice * KPS;
      const int o = pr / (H2 / 2) * H2, sp = pr % (H2 / 2);
      const int s1 = o + sp, s2 = o + H2 - 1 - sp, sw = H2 - 1 - sp;
      float uu[KPS], kp[KPS], k2[KPS], r1[KPS], r2[KPS];
      ld_f32<KPS>(U + k0, uu);
      ld_f32<KPS>(ks + s1 * K + k0, kp);
      ld_f32<KPS>(ks + s2 * K + k0, k2);
      ld_f32<KPS>(rs + s1 * K + k0, r1);
      ld_f32<KPS>(rs + s2 * K + k0, r2);
      float d1 = 0.0f, d2 = 0.0f, acc[H2 - 1];
#pragma unroll
      for (int j = 0; j < KPS; ++j) {
        d1 = fmaf(r1[j] * uu[j], kp[j], d1);
        d2 = fmaf(r2[j] * uu[j], k2[j], d2);
      }
#pragma unroll
      for (int i = 0; i < H2 - 1; ++i) {
        const int t = i >= sw ? o + 1 + i : s1 + 1 + i;
        float rr[KPS], ww[KPS];
        ld_f32<KPS>(rs + t * K + k0, rr);
        ld_f32<KPS>(ws + t * K + k0, ww);
        if (i == sw) {
#pragma unroll
          for (int j = 0; j < KPS; ++j) kp[j] = k2[j];
        }
        float a = 0.0f;
#pragma unroll
        for (int j = 0; j < KPS; ++j) a = fmaf(rr[j], kp[j], a);
        acc[i] = a;
#pragma unroll
        for (int j = 0; j < KPS; ++j) kp[j] *= ww[j];
      }
      float* sa = SA + (slice / 4) * EA * 4 + slice % 4;
      const int eo = -o;                  // e of (t, s) = t·H2 + s + eo
      sa[(s1 * H2 + s1 + eo) * 4] = d1;
      sa[(s2 * H2 + s2 + eo) * 4] = d2;
#pragma unroll
      for (int i = 0; i < H2 - 1; ++i) {
        const int t = i >= sw ? o + 1 + i : s1 + 1 + i;
        sa[(t * H2 + (i >= sw ? s2 : s1) + eo) * 4] = acc[i];
      }
      // and v into VB, rows past the sequence 0
      constexpr int NV = (L * VT + HALF - 1) / HALF;
      float vv[NV];
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int e = tid - HALF + q * HALF;
        vv[q] = e < L * VT && e / VT < n ? to_f(vs[e]) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int e = tid - HALF + q * HALF;
        if (e < L * VT) VB[e / VT * YS + e % VT] = vv[q];
      }
    }
    __syncthreads();                                          // (b)
    if (tid < HALF) {
      // 3. A into X's last L columns: the two diagonal blocks (zeros above
      //    the diagonal) from SA, A10 from SQ
#pragma unroll
      for (int q = 0; q < 2 * H2 * H2 / HALF; ++q) {
        const int e = tid + q * HALF, hf = e / (H2 * H2);
        const int t = hf * H2 + e / H2 % H2, s = hf * H2 + e % H2;
        float a = 0.0f;
        if (s <= t) {
          float4 part[KS / 4];
#pragma unroll
          for (int gq = 0; gq < KS / 4; ++gq)
            part[gq] = ld4(SA + (gq * EA + e) * 4);
#pragma unroll
          for (int gq = 1; gq < KS / 4; ++gq) add4(part[0], part[gq]);
          a = (part[0].x + part[0].y) + (part[0].z + part[0].w);
        }
        X[t * XS + K + s] = a;
      }
      for (int e = tid; e < H2 * H2; e += HALF) {
        const float4 part = ld4(SQ + e * 4);
        X[(H2 + e / H2) * XS + K + e % H2] =
            (part.x + part.y) + (part.z + part.w);
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(HALF) : "memory");
      // 4. out = X·[S ; v] on the tensor cores, a 16 x 8 tile (columns
      //    warp·8..) a warp, stored from the accumulators
      if (warp < NT8) {
        const float* sb = SB + (c % 2) * K * YS;
        float acc[2][2][4] = {};        // [inner step parity][large, small]
#pragma unroll
        for (int i = 0; i < IN; i += 8) {
          const float* yp = (i < K ? sb + (i + tq) * YS
                                   : VB + (i - K + tq) * YS) + warp * 8 + g;
          float fa[4];
          ldsm_x4(X + (lane % 16) * XS + i + lane / 16 * 4, fa);
          const float fb[2] = {yp[0], yp[4 * YS]};
          if (i >= K && kExactV)
            mma_3xtf32<true>(acc[i / 8 % 2][0], acc[i / 8 % 2][1], FragA(fa),
                             FragB(fb));
          else
            mma_3xtf32(acc[i / 8 % 2][0], acc[i / 8 % 2][1], FragA(fa),
                       FragB(fb));
        }
        T* o = out + ((int64_t)bh * S + t0 + g) * V + v0 + warp * 8 + 2 * tq;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int q = 2 * h2;
          const float x0 = (acc[0][0][q] + acc[1][0][q]) +
                           (acc[0][1][q] + acc[1][1][q]);
          const float x1 = (acc[0][0][q + 1] + acc[1][0][q + 1]) +
                           (acc[0][1][q + 1] + acc[1][1][q + 1]);
          if (g + 8 * h2 < n) st2(o + 8 * h2 * V, x0, x1);
        }
      }
    } else {
      // 5. the state update S <- diag(w[0:L]) S + KDᵀ·v on the tensor
      //    cores (rows s >= n add 0), then into SB for the next chunk
      // A = KDᵀ (rows k, columns s) is one m-tile for all of a warp's
      // tiles, B = v (rows s, columns j) one n-tile each
      const int m0 = tile_of(0) / NT8 * 16;
      if (tile_of(0) < C::TT2) {
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          const float c0 = CPL[m0 + g], c1 = CPL[m0 + g + 8];
          st[i][0] *= c0;
          st[i][1] *= c0;
          st[i][2] *= c1;
          st[i][3] *= c1;
        }
        float e[TPW][L / 8][4] = {};
#pragma unroll
        for (int kk = 0; kk < L / 8; ++kk) {
          const float* kd = KD + (kk * 8 + tq) * KDS + m0 + g;
          const float fa[4] = {kd[0], kd[8], kd[4 * KDS], kd[4 * KDS + 8]};
          const FragA a(fa);
#pragma unroll
          for (int i = 0; i < TPW; ++i) {
            const float* vy =
                VB + (kk * 8 + tq) * YS + tile_of(i) % NT8 * 8 + g;
            const float fb[2] = {vy[0], vy[4 * YS]};
            mma_3xtf32<kExactV>(st[i], e[i][kk], a, FragB(fb));
          }
        }
#pragma unroll
        for (int i = 0; i < TPW; ++i)
#pragma unroll
          for (int kk = 0; kk < L / 8; ++kk)
#pragma unroll
            for (int q = 0; q < 4; ++q) st[i][q] += e[i][kk][q];
      }
      put_state(SB + (c + 1) % 2 * K * YS, YS);
    }
  }
  if (tid >= HALF) put_state(s_last + (int64_t)bh * K * V + v0, V);
}

struct Args {
  const void *r, *k, *v, *w, *u;
  void *out, *s_last;
  int B, H, S;
  cudaStream_t stream;
};

template <class C>
cudaError_t launch(const Args& a) {
  auto kernel = wkv_fwd_chunked_kernel<C>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  using T = typename C::E;
  kernel<<<a.B * a.H * (C::V / C::VT), kThreads, C::SMEM, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.w),
      static_cast<const T*>(a.u), static_cast<T*>(a.out),
      static_cast<float*>(a.s_last), a.H, a.S);
  return cudaGetLastError();
}

// the path's tiling for head widths K and V: V tiles of up to 32 columns,
// chunks of 16 steps, four copy stages
template <typename T, int K, int V>
using PathCfg = Cfg<T, K, V, (V < 32 ? V : 32), 16, 4>;

// calls `f` with the instance's Cfg type (a null pointer of it); returns
// cudaErrorInvalidValue where there is none
template <typename T, class F>
cudaError_t dispatch(int K, int V, F f) {
#define WKV_CASE(KK, VV) \
  if (K == KK && V == VV) return f(static_cast<PathCfg<T, KK, VV>*>(nullptr));
  WKV_CASE(16, 16) WKV_CASE(16, 32) WKV_CASE(16, 64)
  WKV_CASE(32, 16) WKV_CASE(32, 32) WKV_CASE(32, 64)
  WKV_CASE(64, 16) WKV_CASE(64, 32) WKV_CASE(64, 64)
#undef WKV_CASE
  return cudaErrorInvalidValue;
}

template <class F>
cudaError_t dispatch_dtype(int dtype, int K, int V, F f) {
  if (dtype == 0) return dispatch<float>(K, V, f);
  if (dtype == 1) return dispatch<__nv_bfloat16>(K, V, f);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------------------
// backward: one block per (batch, head), a reverse sweep over chunks of
// kBwdL steps whose states are recomputed from checkpoints
// ------------------------------------------------------------------------
constexpr int kBwdL = 16;

__device__ __forceinline__ float cvt_out(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 cvt_out(float x, __nv_bfloat16*) {
  return __float2bfloat16(x);
}

template <typename T, int K_, int V_>
struct BwdCfg {
  static constexpr int K = K_, V = V_, L = kBwdL;
  static constexpr int SUB = 4, NSUB = L / SUB;  // sub-chunks of a chunk
  static constexpr int TPR = kThreads / K;       // threads a row of S
  static constexpr int CPT = V / TPR;            // its columns a thread
  static constexpr int RB = 32 / TPR;            // rows a warp holds
  static constexpr int NW = kThreads / 32;       // warps
  static_assert(TPR <= 32 && CPT >= 1, "a row's threads share one warp");
  // floats: r, k, w (L x K); v, do (L x V); u (K); staged dr, dk, dw
  // (L x K); the warps' dv partials of a sub-chunk (SUB x NW x V); the
  // state before each sub-chunk (NSUB x K x V)
  static constexpr int SMEM = 4 * (6 * L * K + 2 * L * V + K + SUB * NW * V +
                                   NSUB * K * V);
};

template <typename T, int K, int V>
__global__ void __launch_bounds__(kThreads, 2)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const T* __restrict__ u, const T* __restrict__ dout,
               const float* __restrict__ ds_last, T* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ du_part,
               float* __restrict__ ckpt, int H, int S) {
  using C = BwdCfg<T, K, V>;
  constexpr int L = C::L, SUB = C::SUB, NSUB = C::NSUB, TPR = C::TPR;
  constexpr int CPT = C::CPT, RB = C::RB, NW = C::NW;
  extern __shared__ __align__(16) float sm[];
  float* sr = sm;
  float* sk = sr + L * K;
  float* sw = sk + L * K;
  float* sv = sw + L * K;
  float* sdo = sv + L * V;
  float* su = sdo + L * V;
  float* odr = su + K;
  float* odk = odr + L * K;
  float* odw = odk + L * K;
  float* red = odw + L * K;
  float* sub = red + SUB * NW * V;

  const int tid = threadIdx.x, bh = blockIdx.x, hh = bh % H;
  const int row = tid / TPR, cg = tid % TPR, j0 = cg * CPT;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_chunks = (S + L - 1) / L;
  const int64_t kb = (int64_t)bh * S * K, vb = (int64_t)bh * S * V;
  for (int i = tid; i < K; i += kThreads) su[i] = to_f(u[hh * K + i]);

  // chunk c's rows into shared memory (zeros past S); with_rdo: r and do
  // too, which the forward pass does not need
  auto load = [&](int c, bool with_rdo) {
    const int t0 = c * L, n = min(L, S - t0);
    for (int i = tid; i < L * K; i += kThreads) {
      const bool in = i < n * K;
      const int64_t g = kb + (int64_t)t0 * K + i;
      sk[i] = in ? to_f(k[g]) : 0.f;
      sw[i] = in ? w[g] : 0.f;
      if (with_rdo) sr[i] = in ? to_f(r[g]) : 0.f;
    }
    for (int i = tid; i < L * V; i += kThreads) {
      const bool in = i < n * V;
      const int64_t g = vb + (int64_t)t0 * V + i;
      sv[i] = in ? to_f(v[g]) : 0.f;
      if (with_rdo) sdo[i] = in ? to_f(dout[g]) : 0.f;
    }
  };
  // one step of the state: S <- diag(w_s) S + k_s ⊗ v_s, this thread's
  // entries
  auto advance = [&](float* st, int s) {
    const float wk = sw[s * K + row], kk = sk[s * K + row];
#pragma unroll
    for (int e = 0; e < CPT; ++e)
      st[e] = fmaf(wk, st[e], kk * sv[s * V + j0 + e]);
  };

  // pass 1: the state before each chunk
  float st[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) st[e] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    float* ck = ckpt + ((int64_t)bh * n_chunks + c) * CPT * kThreads + tid;
#pragma unroll
    for (int e = 0; e < CPT; ++e) ck[e * kThreads] = st[e];
    if (c == n_chunks - 1) break;
    __syncthreads();
    load(c, false);
    __syncthreads();
    for (int s = 0; s < L; ++s) advance(st, s);
  }

  // pass 2: chunks from the last.  A chunk's states are recomputed from
  // its checkpoint twice: first to keep the state before each sub-chunk of
  // SUB steps in shared memory (each thread its own entries), then, from
  // the last sub-chunk, into registers, which the sweep reads back
  float ds[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e)
    ds[e] = ds_last ? ds_last[(int64_t)bh * K * V + row * V + j0 + e] : 0.f;
  float du_acc = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * L, n = min(L, S - t0);
    __syncthreads();                    // the last chunk's readers are done
    load(c, true);
    __syncthreads();
    const float* ck = ckpt + ((int64_t)bh * n_chunks + c) * CPT * kThreads +
                      tid;
#pragma unroll
    for (int e = 0; e < CPT; ++e) st[e] = ck[e * kThreads];
    for (int q = 0; q < NSUB; ++q) {
#pragma unroll
      for (int e = 0; e < CPT; ++e) sub[(q * CPT + e) * kThreads + tid] = st[e];
      if (q + 1 < NSUB && (q + 1) * SUB < n) {
#pragma unroll
        for (int i = 0; i < SUB; ++i) advance(st, q * SUB + i);
      }
    }
    for (int q = NSUB - 1; q >= 0; --q) {
      if (q * SUB >= n) continue;
      float sp[SUB][CPT];               // S_{t-1} of the sub-chunk's steps
#pragma unroll
      for (int e = 0; e < CPT; ++e)
        sp[0][e] = sub[(q * CPT + e) * kThreads + tid];
#pragma unroll
      for (int i = 1; i < SUB; ++i) {
#pragma unroll
        for (int e = 0; e < CPT; ++e) sp[i][e] = sp[i - 1][e];
        advance(sp[i], q * SUB + i - 1);
      }
#pragma unroll
      for (int i = SUB - 1; i >= 0; --i) {
        const int s = q * SUB + i;
        if (s >= n) continue;
        const float rk = sr[s * K + row], kk = sk[s * K + row];
        const float wk = sw[s * K + row], uk = su[row];
        const float* dos = sdo + s * V + j0;
        const float* vs = sv + s * V + j0;
        float pr = 0.f, pk = 0.f, pw = 0.f, pu = 0.f, cv[CPT];
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          const float kv = kk * vs[e], g = rk * dos[e];
          const float gkv = fmaf(uk, g, ds[e]);
          pr = fmaf(dos[e], fmaf(uk, kv, sp[i][e]), pr);
          pk = fmaf(gkv, vs[e], pk);
          pw = fmaf(ds[e], sp[i][e], pw);
          pu = fmaf(g, kv, pu);
          cv[e] = gkv * kk;
          ds[e] = fmaf(wk, ds[e], g);
        }
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1) {   // over the row's threads
          pr += __shfl_xor_sync(0xffffffffu, pr, o);
          pk += __shfl_xor_sync(0xffffffffu, pk, o);
          pw += __shfl_xor_sync(0xffffffffu, pw, o);
          pu += __shfl_xor_sync(0xffffffffu, pu, o);
        }
        if (cg == 0) {
          odr[s * K + row] = pr;
          odk[s * K + row] = pk;
          odw[s * K + row] = pw;
          du_acc += pu;
        }
        // cv over the warp's rows; the warp's partial of column j to
        // red[i][warp][j]
        float* rw = red + (i * NW + warp) * V + j0;
        if constexpr (CPT >= RB) {
          // reduce-scatter: each round halves what a lane keeps, so each
          // of the RB lanes of a column group ends with CPT / RB sums
          int off = 0;
#pragma unroll
          for (int m = TPR, h = CPT / 2; m < 32; m <<= 1, h >>= 1) {
            const bool up = lane & m;
#pragma unroll
            for (int e = 0; e < h; ++e) {
              const float give = up ? cv[e] : cv[e + h];
              const float keep = up ? cv[e + h] : cv[e];
              cv[e] = keep + __shfl_xor_sync(0xffffffffu, give, m);
            }
            if (up) off += h;
          }
#pragma unroll
          for (int e = 0; e < CPT / RB; ++e) rw[off + e] = cv[e];
        } else {
#pragma unroll
          for (int o = TPR; o < 32; o <<= 1)
#pragma unroll
            for (int e = 0; e < CPT; ++e)
              cv[e] += __shfl_xor_sync(0xffffffffu, cv[e], o);
          if (lane < TPR) {
#pragma unroll
            for (int e = 0; e < CPT; ++e) rw[e] = cv[e];
          }
        }
      }
      __syncthreads();                  // the sub-chunk's dv partials
      const int m = min(SUB, n - q * SUB);
      for (int x = tid; x < m * V; x += kThreads) {
        const int i = x / V, j = x - i * V;
        float a = 0.f;
#pragma unroll
        for (int w_ = 0; w_ < NW; ++w_) a += red[(i * NW + w_) * V + j];
        dv[vb + (int64_t)(t0 + q * SUB) * V + x] = cvt_out(a, dv);
      }
      __syncthreads();                  // before red is written again
    }
    for (int x = tid; x < n * K; x += kThreads) {  // ordered by the last
      const int64_t g = kb + (int64_t)t0 * K + x;  // barrier above
      dr[g] = cvt_out(odr[x], dr);
      dk[g] = cvt_out(odk[x], dk);
      dw[g] = odw[x];
    }
  }
  if (cg == 0) du_part[(int64_t)bh * K + row] = du_acc;
}

// du[h, k] = Σ_b du_part[b, h, k], b in order
template <typename T>
__global__ void wkv_bwd_du_kernel(const float* __restrict__ du_part,
                                  T* __restrict__ du, int B, int HK) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HK) return;
  float a = 0.f;
  for (int b = 0; b < B; ++b) a += du_part[(int64_t)b * HK + i];
  du[i] = cvt_out(a, du);
}

struct BwdArgs {
  const void *r, *k, *v, *w, *u, *dout, *ds_last;
  void *dr, *dk, *dv, *dw, *du, *du_part, *ckpt;
  int B, H, S;
  cudaStream_t stream;
};

template <typename T, int K, int V>
cudaError_t launch_bwd(const BwdArgs& a) {
  using C = BwdCfg<T, K, V>;
  auto kernel = wkv_bwd_kernel<T, K, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<a.B * a.H, kThreads, C::SMEM, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.w),
      static_cast<const T*>(a.u), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.ds_last), static_cast<T*>(a.dr),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<float*>(a.dw), static_cast<float*>(a.du_part),
      static_cast<float*>(a.ckpt), a.H, a.S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int hk = a.H * K;
  wkv_bwd_du_kernel<T><<<(hk + 255) / 256, 256, 0, a.stream>>>(
      static_cast<const float*>(a.du_part), static_cast<T*>(a.du), a.B, hk);
  return cudaGetLastError();
}

// the backward's instances: every (K, V) of the forward's
template <typename T>
cudaError_t dispatch_bwd(int K, int V, const BwdArgs& a) {
#define WKV_BWD_CASE(KK, VV) \
  if (K == KK && V == VV) return launch_bwd<T, KK, VV>(a);
  WKV_BWD_CASE(16, 16) WKV_BWD_CASE(16, 32) WKV_BWD_CASE(16, 64)
  WKV_BWD_CASE(32, 16) WKV_BWD_CASE(32, 32) WKV_BWD_CASE(32, 64)
  WKV_BWD_CASE(64, 16) WKV_BWD_CASE(64, 32) WKV_BWD_CASE(64, 64)
#undef WKV_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype of r, k, v, u and out: 0 = float32, 1 = bfloat16; w is float32.
// Returns a cudaError_t (0 = success).
int wkv_fwd(int dtype, const void* r, const void* k, const void* v,
            const void* w, const void* u, void* out, void* s_last, int B,
            int H, int S, int K, int V, void* stream) {
  if (B < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const void* wide[] = {r, k, v, w, out, s_last};   // moved 16 B at a time
  for (const void* p : wide)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  const Args a{r, k, v, w, u, out, s_last, B, H, S, (cudaStream_t)stream};
  return (int)dispatch_dtype(dtype, K, V, [&](auto* cfg) {
    return launch<std::remove_pointer_t<decltype(cfg)>>(a);
  });
}

// The backward of `wkv_fwd` from its inputs and the gradients of its
// outputs: dout (B, H, S, V) in r's type, ds_last (B, H, K, V) float32 or
// null (a zero gradient).  Writes dr, dk (B, H, S, K), dv (B, H, S, V)
// and du (H, K) in r's type, dw (B, H, S, K) float32.  Scratch, float32:
// du_part (B, H, K) and ckpt (B, H, ceil(S / 16), K, V).  `device` is
// made current first: autograd runs the backward on a thread of its own.
// Returns a cudaError_t (0 = success).
int wkv_bwd(int dtype, const void* r, const void* k, const void* v,
            const void* w, const void* u, const void* dout,
            const void* ds_last, void* dr, void* dk, void* dv, void* dw,
            void* du, void* du_part, void* ckpt, int B, int H, int S, int K,
            int V, int device, void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (B < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const BwdArgs a{r,  k,  v,  w,  u,       dout, ds_last, dr, dk, dv,
                  dw, du, du_part, ckpt, B, H,  S,      (cudaStream_t)stream};
  if (dtype == 0) return (int)dispatch_bwd<float>(K, V, a);
  if (dtype == 1) return (int)dispatch_bwd<__nv_bfloat16>(K, V, a);
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory a block of the (K, V) instance takes, or -1
int wkv_smem_bytes(int dtype, int K, int V) {
  int bytes = -1;
  dispatch_dtype(dtype, K, V, [&](auto* cfg) {
    bytes = std::remove_pointer_t<decltype(cfg)>::SMEM;
    return cudaSuccess;
  });
  return bytes;
}

const char* wkv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
