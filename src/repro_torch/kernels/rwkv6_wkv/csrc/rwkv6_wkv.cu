// RWKV6 WKV recurrence, forward and backward, for Hopper (sm_90a): both
// an exact chunked form whose steps inside a chunk run in parallel, the
// backward over the chunks from the last.
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
// the Pallas kernel has no backward).  Step by step it is a reverse sweep
// carrying dS (K x V, seeded by dS_last), with G = r_t ⊗ do_t, kv = k_t ⊗
// v_t (ref.py::wkv_bwd_ref):
//
//   dr_t = (S_{t-1} + u ⊙ kv)·do_t,   dk_t = (u ⊙ G + dS_t)·v_t
//   dv_t = (u ⊙ G + dS_t)ᵀ·k_t,       dw_t = Σ_j dS_t ⊙ S_{t-1}
//   du  += Σ_j G ⊙ kv,                dS_{t-1} = diag(w_t) dS_t + G
//
// It runs in the forward's exact chunks of L = kBwdL = 16 steps instead:
// every gradient of a chunk depends only on the state S_in before it and
// on dS_out, the gradient of the state after it, so the chain across the
// sequence is S/L chunk steps.  With M[t,s] = w[s+1:t] and, over V, P =
// do·vᵀ, Z = do·S_inᵀ, Y = v·dS_outᵀ, C = Σ_j dS_out ⊙ S_in:
//
//   dr_t  = w[0:t] ⊙ Z_t + Σ_{s<t} P[t,s] M[t,s] ⊙ k_s + u ⊙ k_t P[t,t]
//   dk_s  = w[s+1:L] ⊙ Y_s + Σ_{t>s} P[t,s] M[t,s] ⊙ r_t + u ⊙ r_s P[s,s]
//   dv    = (k ⊙ w[s+1:L])·dS_out + Aᵀ·do   (A: the forward's, u on its
//           diagonal)
//   dS_in = diag(w[0:L]) dS_out + (r ⊙ w[0:t])ᵀ·do
//   dw_t  = w[0:t] w[t+1:L] ⊙ C + w[t+1:L] ⊙ Σ_{s<t} M[t,s] k_s ⊙ Y_s
//         + w[0:t] ⊙ Σ_{q>t} M[q,t] r_q ⊙ Z_q
//         + Σ_{s<t<q} M[t,s] M[q,t] k_s ⊙ r_q P[q,s]
//
// dw is Σ_j dS_t ⊙ S_{t-1} with both factors written over the chunk's
// intervals, the four products of their two parts each: no term divides
// by w, and (as in the forward) every decay is a product of w over an
// interval, so the kernel calls neither exp nor log.
// `ref.py::wkv_bwd_chunked_exact` is this algorithm in plain torch, held
// to wkv_bwd_ref and to jax.vjp of the reference on the CPU.
//
// What bounds it on this card.  The work is ~12·K·V float32 operations a
// step and head (0.7212 ms at 67 TFLOP/s at the training path's (30, 32,
// 1024, 64, 64)).  The reverse sweep a step at a time (the first design, one
// block a (batch, head) walking 1,024 steps, each a few rounds of
// shuffles) took 10.33 ms, 7.0 %: its chain of dependent steps bounded
// it.  Here one block of 256 threads per (batch, head), 960 blocks, two an
// SM (`-Xptxas -v`: 128 registers, 28 B of spill stores; 106,240 B of
// shared memory at K = V = 64 in bf16):
//   * pass 1, the chunked state pass: S <- diag(w[0:L]) S + (k ⊙
//     w[s+1:L])ᵀ·v on the tensor cores, two chunks an iteration, the state
//     before each chunk to a device checkpoint (float32 K x V a chunk: 1
//     GB written and read again at the path's shape, 0.6 ms of bytes);
//   * pass 2, chunks from the last, five barriers a chunk: v, do and the
//     chunk's r, k, w by column into float32; Z, Y, P on the tensor cores
//     (3xTF32 `mma.sync`, as the forward); then the pairs (s, t) on the
//     CUDA cores, warp w taking steps w and L-1-w of every column, the
//     same code in every warp (its loops run over its half of the chunk,
//     the terms outside the step's span zero), A's rows summed over k by
//     shuffles; then dv and the new dS on the tensor cores.  The next
//     chunk's rows (a cp.async ring of two stages) and checkpoint (a
//     buffer of its own) are copied while a chunk computes.
// The pairs on the CUDA cores and the checkpoints' traffic bound it now.
// du is summed over the chunks in each warp, the warps in order, then over
// the batch by `wkv_bwd_du_kernel` in order: no atomics, deterministic.
// The V columns are not split over blocks: 960 blocks fill the card 3.6
// times over, and a split would repeat the pairs' work (P, Z and the sums
// over k are per tile) and need a sum across blocks.  Tried and not kept
// (`kernels/backward_ab.py`, 3.98-4.05 ms shipped): each warp's loops
// specialised by template to its two steps (eight code paths, less
// arithmetic), 5.07-5.14 ms; the loop over a lane's two columns
// unrolled, 4.05-4.08 ms.

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
// EXACT_A / EXACT_B: a / b holds values that TF32 represents exactly
// (bfloat16 inputs), so its low part is 0 and the product with it is
// skipped
template <bool EXACT_A = false, bool EXACT_B = false>
__device__ __forceinline__ void mma_3xtf32(float* d, float* e, const FragA& a,
                                           const FragB& b) {
  if constexpr (!EXACT_A) mma_tf32(e, a.lo, b.hi);
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
            mma_3xtf32<false, true>(acc[i / 8 % 2][0], acc[i / 8 % 2][1],
                                    FragA(fa), FragB(fb));
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
            mma_3xtf32<false, kExactV>(st[i], e[i][kk], a, FragB(fb));
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
// backward: one block per (batch, head).  A chunked state pass keeps the
// state before each chunk of kBwdL steps; then, chunk by chunk from the
// last, every gradient of the chunk is computed in parallel from that
// state and the dS carried in from the later chunks
// ------------------------------------------------------------------------
constexpr int kBwdL = 16;
constexpr int kBwdWarps = kThreads / 32;

__device__ __forceinline__ float cvt_out(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 cvt_out(float x, __nv_bfloat16*) {
  return __float2bfloat16(x);
}

template <typename T, int K_, int V_>
struct BwdCfg {
  using E = T;
  static constexpr int K = K_, V = V_, L = kBwdL, NST = 2;
  // float row strides: a fragment load whose lanes take rows g and
  // columns tq hits 32 distinct banks; CS keeps a column's 16-byte loads
  // apart
  static constexpr int KP = K + 4, VP = V + 4, LP = L + 4, CS = L + 4;
  static constexpr int KPT = K < 32 ? 1 : K / 32;     // columns k a lane
  // one stage of the ring: r, k (L x K, T), w (L x K, f32), v, do (L x V,
  // T); the state before the chunk has one buffer (K x VP, f32) of its own
  static constexpr int R_B = L * K * (int)sizeof(T), W_B = L * K * 4;
  static constexpr int V_B = L * V * (int)sizeof(T), S_B = K * VP * 4;
  static constexpr int STAGE_B = 2 * R_B + W_B + 2 * V_B;
  static constexpr int TT = (K / 16) * (V / 8);        // 16 x 8 tiles of S
  static constexpr int TPW = (TT + kBwdWarps - 1) / kBwdWarps;
  // the float32 working area, offsets in floats: v, do (L x VP); dS (K x
  // VP); Z, Y, r ⊙ w[0:t], k ⊙ w[t+1:L] (L x KP); P, Aᵀ (L x LP); the
  // chunk's r, k and w by column (K x CS each); w[0:L], u, C, du
  static constexpr int O_DOF = L * VP, O_DS = 2 * L * VP;
  static constexpr int O_Z = O_DS + K * VP, O_Y = O_Z + L * KP;
  static constexpr int O_RP = O_Y + L * KP, O_KD = O_RP + L * KP;
  static constexpr int O_P = O_KD + L * KP, O_AT = O_P + L * LP;
  static constexpr int O_COL = O_AT + L * LP, O_WT = O_COL + 3 * K * CS;
  static constexpr int O_U = O_WT + K, O_CC = O_U + K, O_DU = O_CC + K;
  static constexpr int F = O_DU + kBwdWarps * K;
  // pass 1's ring, in the same bytes: two stages of two chunks' k, w, v
  static constexpr int P1C_B = R_B + W_B + V_B, P1_B = 2 * P1C_B;
  static constexpr int RING_B = NST * STAGE_B + S_B > 2 * P1_B
                                    ? NST * STAGE_B + S_B : 2 * P1_B;
  static constexpr int SMEM = RING_B + 4 * F;
  static_assert(L == 2 * kBwdWarps, "a warp takes steps t and L-1-t");
  static_assert(R_B % 16 == 0 && V_B % 16 == 0 && V % 4 == 0,
                "16-byte copies");
  static_assert(O_P % 4 == 0 && O_COL % 4 == 0 && LP % 4 == 0 &&
                CS % 4 == 0, "16-byte loads of rows of P and of columns");
};

// N consecutive floats at p (16-byte aligned), by float4 loads
template <int N>
__device__ __forceinline__ void ld_row(const float* p, float* o) {
#pragma unroll
  for (int i = 0; i < (N + 3) / 4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(p)[i];
    o[4 * i] = x.x;
    o[4 * i + 1] = x.y;
    o[4 * i + 2] = x.z;
    o[4 * i + 3] = x.w;
  }
}

// step t of the chunk, column k (rc, kc, wc: its r, k, w over the chunk,
// rows past the sequence r = k = 0, w = 1), t in the first half of the
// chunk (HI false: t < L/2) or the second (HI true): dr, dk and dw,
// r_t ⊙ w[0:t] and k_t ⊙ w[t+1:L] for the products, row t of A into xa
// (still to be summed over k) and du.  al[s] = M[t,s] k_s (s < t) and
// be[q] = M[q,t] r_q (q > t) with M[t,s] = w[s+1:t], each a running
// product of w, and 0 elsewhere: every warp runs the same code, its loops
// over its half's span with the terms outside [0, t) and (t, L) zero.
// F: the working area; dr, dk, dw: the chunk's first row of this (batch,
// head)
template <class C, bool HI>
__device__ __forceinline__ void bwd_step(float* F, const float* rc,
                                         const float* kc, const float* wc,
                                         int t, int k, int n, float* xa,
                                         float& du, typename C::E* dr,
                                         typename C::E* dk, float* dw) {
  constexpr int L = C::L, K = C::K, KP = C::KP, LP = C::LP, H = L / 2;
  constexpr int NS = HI ? L : H;           // s < t < NS
  constexpr int Q0 = HI ? H + 1 : 1;       // Q0 <= q: q > t >= Q0 - 1
  const float* P = F + C::O_P;
  const float* Z = F + C::O_Z;
  const float* Y = F + C::O_Y;
  float al[NS], be[L];
  float pre = 1.f, suf = 1.f;                    // w[0:t], w[t+1:L]
#pragma unroll
  for (int s = NS - 1; s >= 0; --s) {
    const bool in = s < t;
    al[s] = in ? kc[s] * pre : 0.f;
    pre = in ? pre * wc[s] : pre;
  }
#pragma unroll
  for (int q = Q0; q < L; ++q) {
    const bool in = q > t;
    be[q] = in ? rc[q] * suf : 0.f;
    suf = in ? suf * wc[q] : suf;
  }
  const float* col = F + C::O_COL + k * C::CS;
  const float rt = col[t], kt = col[K * C::CS + t], uk = F[C::O_U + k];
  const float ptt = P[t * LP + t], bonus = uk * ptt;
  float prow[NS];
  ld_row<NS>(P + t * LP, prow);                  // P[t][s]
  float ar = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f, ak = 0.f;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    ar = fmaf(al[s], prow[s], ar);
    a2 = fmaf(al[s], Y[s * KP + k], a2);
  }
  // a4 = Σ_q be[q] Σ_s al[s] P[q][s]; the rows of P by 16-byte loads
#pragma unroll
  for (int q = Q0; q < L; ++q) {
    float pq[NS];
    ld_row<NS>(P + q * LP, pq);
    float h = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) h = fmaf(al[s], pq[s], h);
    a4 = fmaf(be[q], h, a4);
    ak = fmaf(be[q], P[q * LP + t], ak);
    a3 = fmaf(be[q], Z[q * KP + k], a3);
  }
  const float g_r = fmaf(pre, Z[t * KP + k], ar) + kt * bonus;
  const float g_k = fmaf(suf, Y[t * KP + k], ak) + rt * bonus;
  const float g_w = pre * suf * F[C::O_CC + k] + suf * a2 + pre * a3 + a4;
  du = fmaf(rt * kt, ptt, du);
  F[C::O_RP + t * KP + k] = rt * pre;
  F[C::O_KD + t * KP + k] = kt * suf;
  if (HI && t == L - 1) F[C::O_WT + k] = pre * wc[L - 1];
#pragma unroll
  for (int s = 0; s < NS; ++s)
    xa[s] = fmaf(rt, s == t ? uk * kt : al[s], xa[s]);
  if (t < n) {
    dr[t * K + k] = cvt_out(g_r, dr);
    dk[t * K + k] = cvt_out(g_k, dk);
    dw[t * K + k] = g_w;
  }
}

// warp w's share of a chunk: steps w and L-1-w for its lanes' columns
// (each column's r, k, w by 16-byte loads); then rows w and L-1-w of A
// summed over k (the lanes' partials in a fixed butterfly) into AT's
// columns (AT[s][t] = A[t][s], 0 for s > t)
template <class C>
__device__ __forceinline__ void bwd_pairs(float* F, int warp, int lane,
                                          int n, float* du,
                                          typename C::E* dr,
                                          typename C::E* dk, float* dw) {
  constexpr int L = C::L, K = C::K, LP = C::LP, CS = C::CS, H = L / 2;
  const int t0 = warp, t1 = L - 1 - warp;
  float xa0[H], xa1[L];
#pragma unroll
  for (int s = 0; s < H; ++s) xa0[s] = 0.f;
#pragma unroll
  for (int s = 0; s < L; ++s) xa1[s] = 0.f;
#pragma unroll 1
  for (int i = 0; i < C::KPT; ++i) {
    const int k = lane + 32 * i;
    if (k < K) {
      float rc[L], kc[L], wc[L];
      const float* col = F + C::O_COL + k * CS;
      ld_row<L>(col, rc);
      ld_row<L>(col + K * CS, kc);
      ld_row<L>(col + 2 * K * CS, wc);
      float d = 0.f;
      bwd_step<C, false>(F, rc, kc, wc, t0, k, n, xa0, d, dr, dk, dw);
      bwd_step<C, true>(F, rc, kc, wc, t1, k, n, xa1, d, dr, dk, dw);
#pragma unroll
      for (int j = 0; j < C::KPT; ++j)     // du[i], the index in registers
        if (j == i) du[j] += d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int s = 0; s < H; ++s)
      xa0[s] += __shfl_xor_sync(0xffffffffu, xa0[s], o);
#pragma unroll
    for (int s = 0; s < L; ++s)
      xa1[s] += __shfl_xor_sync(0xffffffffu, xa1[s], o);
  }
  if (lane == 0) {
    float* AT = F + C::O_AT;
#pragma unroll
    for (int s = 0; s < L; ++s) {
      AT[s * LP + t0] = s < H ? xa0[s < H ? s : 0] : 0.f;
      AT[s * LP + t1] = xa1[s];
    }
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads, 2)
wkv_bwd_kernel(const typename C::E* __restrict__ r,
               const typename C::E* __restrict__ k,
               const typename C::E* __restrict__ v,
               const float* __restrict__ w,
               const typename C::E* __restrict__ u,
               const typename C::E* __restrict__ dout,
               const float* __restrict__ ds_last,
               typename C::E* __restrict__ dr, typename C::E* __restrict__ dk,
               typename C::E* __restrict__ dv, float* __restrict__ dw,
               float* __restrict__ du_part, float* __restrict__ ckpt, int H,
               int S) {
  using T = typename C::E;
  constexpr int K = C::K, V = C::V, L = C::L, KP = C::KP, VP = C::VP;
  constexpr int LP = C::LP, CS = C::CS, TPW = C::TPW, NT8 = V / 8;
  constexpr int R_B = C::R_B, W_B = C::W_B, V_B = C::V_B;
  constexpr bool EX = sizeof(T) == 2;    // bf16 v and do are exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  float* SIN = reinterpret_cast<float*>(smem + C::NST * C::STAGE_B);
  float* F = reinterpret_cast<float*>(smem + C::RING_B);
  float* VF = F;
  float* DOF = F + C::O_DOF;
  float* DS = F + C::O_DS;
  float* Z = F + C::O_Z;
  float* Y = F + C::O_Y;
  float* RP = F + C::O_RP;
  float* KD = F + C::O_KD;
  float* P = F + C::O_P;
  float* AT = F + C::O_AT;
  float* COL = F + C::O_COL;
  float* WT = F + C::O_WT;
  float* U = F + C::O_U;
  float* CC = F + C::O_CC;
  float* DU = F + C::O_DU;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;           // fragment coordinates
  const int bh = blockIdx.x;
  const int n_chunks = (S + L - 1) / L;
  const int64_t kb = (int64_t)bh * S * K, vb = (int64_t)bh * S * V;
  float* ck_b = ckpt + (int64_t)bh * n_chunks * K * V;

  auto stage = [&](int i) { return smem + (i % C::NST) * C::STAGE_B; };
  // chunk c's rows into ring slot i by 16-byte cp.async (an empty group
  // where c is out of range)
  auto issue = [&](int c, int i) {
    if (c >= 0) {
      const int t0 = c * L, n = min(L, S - t0);
      unsigned char* st = stage(i);
      const int rk = n * K * (int)sizeof(T) / 16;
      const int rv = n * V * (int)sizeof(T) / 16;
      const char* kg = reinterpret_cast<const char*>(k + kb + (int64_t)t0 * K);
      const char* wg = reinterpret_cast<const char*>(w + kb + (int64_t)t0 * K);
      const char* vg = reinterpret_cast<const char*>(v + vb + (int64_t)t0 * V);
      for (int p = tid; p < rk; p += kThreads)
        cp_async16(st + R_B + p * 16, kg + p * 16);
      for (int p = tid; p < n * K / 4; p += kThreads)
        cp_async16(st + 2 * R_B + p * 16, wg + p * 16);
      for (int p = tid; p < rv; p += kThreads)
        cp_async16(st + 2 * R_B + W_B + p * 16, vg + p * 16);
      const char* rg =
          reinterpret_cast<const char*>(r + kb + (int64_t)t0 * K);
      const char* dg =
          reinterpret_cast<const char*>(dout + vb + (int64_t)t0 * V);
      for (int p = tid; p < rk; p += kThreads)
        cp_async16(st + p * 16, rg + p * 16);
      for (int p = tid; p < rv; p += kThreads)
        cp_async16(st + 2 * R_B + W_B + V_B + p * 16, dg + p * 16);
    }
    cp_async_commit();
  };
  // chunk c's checkpoint (the state before it) into SIN, its rows VP
  // floats apart
  auto issue_state = [&](int c) {
    if (c >= 0) {
      const float* cg = ck_b + (int64_t)c * K * V;
      constexpr int RQ = V / 4;                    // copies a row of S
      for (int p = tid; p < K * RQ; p += kThreads)
        cp_async16(SIN + (p / RQ) * VP + p % RQ * 4, cg + p * 4);
    }
    cp_async_commit();
  };
  // the 16 x 8 tiles of a K x V matrix a warp holds as mma accumulators
  auto tile_at = [&](int i, int& m0, int& n0) {
    const int tl = warp * TPW + i;
    m0 = tl / NT8 * 16;
    n0 = tl % NT8 * 8;
    return tl < C::TT;
  };

  for (int j = tid; j < K; j += kThreads)
    U[j] = to_f(u[(int64_t)(bh % H) * K + j]);

  // pass 1: S <- diag(w[0:L]) S + (k ⊙ w[s+1:L])ᵀ·v a chunk, on the
  // tensor cores, two chunks an iteration (half the barriers and waits
  // for copies); the state before chunk c is written to its checkpoint.
  // Only chunks 0 .. n_chunks-2 are read, two a stage of the pass's own
  // ring (k, w, v a chunk), and each pair's second chunk takes RP, DOF
  // and CC as its KD, VF and WT.
  auto issue1 = [&](int c, int i) {
    for (int j = 0; j < 2 && c + j < n_chunks - 1; ++j) {
      const int t0 = (c + j) * L;
      unsigned char* st = smem + (i % 2) * C::P1_B + j * C::P1C_B;
      const char* kg = reinterpret_cast<const char*>(k + kb + (int64_t)t0 * K);
      const char* wg = reinterpret_cast<const char*>(w + kb + (int64_t)t0 * K);
      const char* vg = reinterpret_cast<const char*>(v + vb + (int64_t)t0 * V);
      for (int p = tid; p < R_B / 16; p += kThreads)
        cp_async16(st + p * 16, kg + p * 16);
      for (int p = tid; p < W_B / 16; p += kThreads)
        cp_async16(st + R_B + p * 16, wg + p * 16);
      for (int p = tid; p < V_B / 16; p += kThreads)
        cp_async16(st + R_B + W_B + p * 16, vg + p * 16);
    }
    cp_async_commit();
  };
  auto put_ckpt = [&](int c, const float (&st)[TPW][4]) {
    float* ck = ck_b + (int64_t)c * K * V;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      int m0, n0;
      if (!tile_at(i, m0, n0)) continue;
      st2(ck + (m0 + g) * V + n0 + 2 * tq, st[i][0], st[i][1]);
      st2(ck + (m0 + g + 8) * V + n0 + 2 * tq, st[i][2], st[i][3]);
    }
  };
  // S <- diag(wt) S + kdᵀ·vf, the warp's tiles
  auto advance = [&](float (&st)[TPW][4], const float* kd_, const float* vf,
                     const float* wt) {
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      int m0, n0;
      if (!tile_at(i, m0, n0)) continue;
      const float c0 = wt[m0 + g], c1 = wt[m0 + g + 8];
      st[i][0] *= c0;
      st[i][1] *= c0;
      st[i][2] *= c1;
      st[i][3] *= c1;
      float e4[4] = {};
#pragma unroll
      for (int kk = 0; kk < L / 8; ++kk) {
        const float* kd = kd_ + (kk * 8 + tq) * KP + m0 + g;
        const float fa[4] = {kd[0], kd[8], kd[4 * KP], kd[4 * KP + 8]};
        const float* vy = vf + (kk * 8 + tq) * VP + n0 + g;
        const float fb[2] = {vy[0], vy[4 * VP]};
        mma_3xtf32<false, EX>(st[i], e4, FragA(fa), FragB(fb));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) st[i][q] += e4[q];
    }
  };
  float st[TPW][4];
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) st[i][q] = 0.f;
  issue1(0, 0);
  for (int c = 0; c < n_chunks; c += 2) {
    cp_async_wait<0>();
    __syncthreads();
    issue1(c + 2, c / 2 + 1);
    put_ckpt(c, st);
    if (c == n_chunks - 1) break;
    const bool second = c + 1 < n_chunks - 1;
    const unsigned char* sg = smem + (c / 2 % 2) * C::P1_B;
    // k ⊙ w[s+1:L] and w[0:L] of chunk c (threads 0..K-1) and c + 1 (K..)
    if (tid < K || (second && tid < 2 * K)) {
      const int j = tid / K, kk = tid % K;
      const unsigned char* sj = sg + j * C::P1C_B;
      const T* ks = reinterpret_cast<const T*>(sj);
      const float* ws = reinterpret_cast<const float*>(sj + R_B);
      float* kd = j ? RP : KD;
      float m = 1.f;
#pragma unroll
      for (int s = L - 1; s >= 0; --s) {
        kd[s * KP + kk] = to_f(ks[s * K + kk]) * m;
        m *= ws[s * K + kk];
      }
      (j ? CC : WT)[kk] = m;
    }
    for (int e = tid; e < L * V; e += kThreads) {
      VF[e / V * VP + e % V] =
          to_f(reinterpret_cast<const T*>(sg + R_B + W_B)[e]);
      if (second)
        DOF[e / V * VP + e % V] = to_f(
            reinterpret_cast<const T*>(sg + C::P1C_B + R_B + W_B)[e]);
    }
    __syncthreads();
    advance(st, KD, VF, WT);
    if (c + 1 < n_chunks) put_ckpt(c + 1, st);
    if (second) advance(st, RP, DOF, CC);
  }
  cp_async_wait<0>();
  __syncthreads();                 // the checkpoints are in; the ring is free

  // pass 2: chunks from the last; dS (the gradient of the state after the
  // chunk) in DS.  Five barriers a chunk: (0) the rows and the state have
  // landed and dS is in; (1) v, do, the columns of r, k, w, C; (2) Z, Y,
  // P; (3) the outputs over k, A, the decayed r and k, w[0:L]; (4) dv and
  // the new dS, which read the old dS.  The next chunk's rows are copied
  // from (0), its state from (2)
  for (int e = tid; e < K * V; e += kThreads)
    DS[e / V * VP + e % V] = ds_last ? ds_last[(int64_t)bh * K * V + e] : 0.f;
  float du_acc[C::KPT];
#pragma unroll
  for (int i = 0; i < C::KPT; ++i) du_acc[i] = 0.f;
  issue(n_chunks - 1, 0);
  issue_state(n_chunks - 1);
  for (int i = 0; i < n_chunks; ++i) {
    const int c = n_chunks - 1 - i, t0 = c * L, n = min(L, S - t0);
    cp_async_wait<0>();
    __syncthreads();                                          // (0)
    issue(c - 1, i + 1);
    const unsigned char* sg = stage(i);
    const T* rs = reinterpret_cast<const T*>(sg);
    const T* ks = reinterpret_cast<const T*>(sg + R_B);
    const float* ws = reinterpret_cast<const float*>(sg + 2 * R_B);
    const T* vs = reinterpret_cast<const T*>(sg + 2 * R_B + W_B);
    const T* dos = reinterpret_cast<const T*>(sg + 2 * R_B + W_B + V_B);
    // 1a. v and do as float32, r, k and w as float32 columns (rows past
    //     the sequence r = k = v = do = 0, w = 1), and C = Σ_j dS ⊙ S_in,
    //     the threads of a row k adjacent lanes
    for (int e = tid; e < L * V; e += kThreads) {
      const int t = e / V, j = e % V;
      VF[t * VP + j] = t < n ? to_f(vs[e]) : 0.f;
      DOF[t * VP + j] = t < n ? to_f(dos[e]) : 0.f;
    }
    for (int e = tid; e < L * K; e += kThreads) {
      const int t = e / K, kk = e % K;
      const bool in = t < n;
      COL[kk * CS + t] = in ? to_f(rs[e]) : 0.f;
      COL[(K + kk) * CS + t] = in ? to_f(ks[e]) : 0.f;
      COL[(2 * K + kk) * CS + t] = in ? ws[e] : 1.f;
    }
    {
      constexpr int PARTS = kThreads / K, CPT = V / PARTS;
      const int kr = tid / PARTS, j0 = tid % PARTS * CPT;
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < CPT; ++e)
        a = fmaf(DS[kr * VP + j0 + e], SIN[kr * VP + j0 + e], a);
#pragma unroll
      for (int o = PARTS / 2; o > 0; o >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, o);
      if (tid % PARTS == 0) CC[kr] = a;
    }
    __syncthreads();                                          // (1)
    // 1b. Z = do·S_inᵀ, Y = v·dSᵀ (L x K) and P = do·vᵀ (L x L) on the
    //     tensor cores, a 16 x 8 tile at a time
    {
      constexpr int NZ = K / 8, NI = 2 * NZ + L / 8;
      for (int it = warp; it < NI; it += kBwdWarps) {
        const int which = it < NZ ? 0 : it < 2 * NZ ? 1 : 2;
        const int n0 = (it - which * NZ) * 8;
        const float* ar = which == 1 ? VF : DOF;
        const float* br = which == 0 ? SIN : which == 1 ? DS : VF;
        float hi4[4] = {}, lo4[4] = {};
#pragma unroll
        for (int j = 0; j < V; j += 8) {
          const float fa[4] = {ar[g * VP + j + tq], ar[(g + 8) * VP + j + tq],
                               ar[g * VP + j + tq + 4],
                               ar[(g + 8) * VP + j + tq + 4]};
          const float fb[2] = {br[(n0 + g) * VP + j + tq],
                               br[(n0 + g) * VP + j + tq + 4]};
          if (which == 2)
            mma_3xtf32<EX, EX>(hi4, lo4, FragA(fa), FragB(fb));
          else
            mma_3xtf32<EX, false>(hi4, lo4, FragA(fa), FragB(fb));
        }
        float* o = which == 0 ? Z : which == 1 ? Y : P;
        const int ld = which == 2 ? LP : KP;
        st2(o + g * ld + n0 + 2 * tq, hi4[0] + lo4[0], hi4[1] + lo4[1]);
        st2(o + (g + 8) * ld + n0 + 2 * tq, hi4[2] + lo4[2], hi4[3] + lo4[3]);
      }
    }
    __syncthreads();                                          // (2)
    issue_state(c - 1);
    // 2. the pairs (s, t) of the chunk on the CUDA cores: warp w takes
    //    steps w and L-1-w (the same work for each warp), its lanes the
    //    columns k
    {
      T* drc = dr + kb + (int64_t)t0 * K;
      T* dkc = dk + kb + (int64_t)t0 * K;
      float* dwc = dw + kb + (int64_t)t0 * K;
      bwd_pairs<C>(F, warp, lane, n, du_acc, drc, dkc, dwc);
    }
    __syncthreads();                                          // (3)
    // 4. dv = [k ⊙ w[s+1:L] | Aᵀ]·[dS ; do] (L x V) and the new dS =
    //    diag(w[0:L]) dS + (r ⊙ w[0:t])ᵀ·do (K x V), on the tensor cores
    for (int it = warp; it < NT8; it += kBwdWarps) {
      const int n0 = it * 8;
      float hi4[4] = {}, lo4[4] = {};
#pragma unroll
      for (int j = 0; j < K; j += 8) {
        const float fa[4] = {KD[g * KP + j + tq], KD[(g + 8) * KP + j + tq],
                             KD[g * KP + j + tq + 4],
                             KD[(g + 8) * KP + j + tq + 4]};
        const float fb[2] = {DS[(j + tq) * VP + n0 + g],
                             DS[(j + tq + 4) * VP + n0 + g]};
        mma_3xtf32<false, false>(hi4, lo4, FragA(fa), FragB(fb));
      }
#pragma unroll
      for (int j = 0; j < L; j += 8) {
        const float fa[4] = {AT[g * LP + j + tq], AT[(g + 8) * LP + j + tq],
                             AT[g * LP + j + tq + 4],
                             AT[(g + 8) * LP + j + tq + 4]};
        const float fb[2] = {DOF[(j + tq) * VP + n0 + g],
                             DOF[(j + tq + 4) * VP + n0 + g]};
        mma_3xtf32<false, EX>(hi4, lo4, FragA(fa), FragB(fb));
      }
      T* o = dv + vb + (int64_t)(t0 + g) * V + n0 + 2 * tq;
      if (g < n) st2(o, hi4[0] + lo4[0], hi4[1] + lo4[1]);
      if (g + 8 < n) st2(o + 8 * V, hi4[2] + lo4[2], hi4[3] + lo4[3]);
    }
    float dsn[TPW][4];
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      int m0, n0;
      if (!tile_at(i, m0, n0)) continue;
      const float c0 = WT[m0 + g], c1 = WT[m0 + g + 8];
      const float* d0 = DS + (m0 + g) * VP + n0 + 2 * tq;
      dsn[i][0] = c0 * d0[0];
      dsn[i][1] = c0 * d0[1];
      dsn[i][2] = c1 * d0[8 * VP];
      dsn[i][3] = c1 * d0[8 * VP + 1];
      float e4[4] = {};
#pragma unroll
      for (int kk = 0; kk < L / 8; ++kk) {
        const float* rp = RP + (kk * 8 + tq) * KP + m0 + g;
        const float fa[4] = {rp[0], rp[8], rp[4 * KP], rp[4 * KP + 8]};
        const float* dy = DOF + (kk * 8 + tq) * VP + n0 + g;
        const float fb[2] = {dy[0], dy[4 * VP]};
        mma_3xtf32<false, EX>(dsn[i], e4, FragA(fa), FragB(fb));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dsn[i][q] += e4[q];
    }
    __syncthreads();                                          // (4)
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      int m0, n0;
      if (!tile_at(i, m0, n0)) continue;
      float* d0 = DS + (m0 + g) * VP + n0 + 2 * tq;
      st2(d0, dsn[i][0], dsn[i][1]);
      st2(d0 + 8 * VP, dsn[i][2], dsn[i][3]);
    }
  }
  // du of this (batch, head): each warp's sum over the chunks, then the
  // warps in order
#pragma unroll
  for (int i = 0; i < C::KPT; ++i)
    if (lane + 32 * i < K) DU[warp * K + lane + 32 * i] = du_acc[i];
  __syncthreads();
  for (int j = tid; j < K; j += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w_ = 0; w_ < kBwdWarps; ++w_) a += DU[w_ * K + j];
    du_part[(int64_t)bh * K + j] = a;
  }
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
  auto kernel = wkv_bwd_kernel<C>;
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
  const void* wide[] = {r, k, v, w, dout, ckpt};    // moved 16 B at a time
  for (const void* p : wide)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  const BwdArgs a{r,  k,  v,  w,  u,       dout, ds_last, dr, dk, dv,
                  dw, du, du_part, ckpt, B, H,  S,      (cudaStream_t)stream};
  if (dtype == 0) return (int)dispatch_bwd<float>(K, V, a);
  if (dtype == 1) return (int)dispatch_bwd<__nv_bfloat16>(K, V, a);
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory a block of the (K, V) instance of the forward
// (backward = 0) or the backward takes, or -1
int wkv_smem_bytes(int dtype, int K, int V, int backward) {
  int bytes = -1;
  dispatch_dtype(dtype, K, V, [&](auto* cfg) {
    using C = std::remove_pointer_t<decltype(cfg)>;
    bytes = backward ? BwdCfg<typename C::E, C::K, C::V>::SMEM : C::SMEM;
    return cudaSuccess;
  });
  return bytes;
}

const char* wkv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
