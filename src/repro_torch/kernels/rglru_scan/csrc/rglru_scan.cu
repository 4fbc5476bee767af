// RG-LRU linear scan, forward and backward, for Hopper (sm_90a); the
// forward is fed by a ring of asynchronous copies.
//
// Replaces the TPU kernel `rglru_scan_pallas`
// (src/repro/kernels/rglru_scan/rglru_scan.py:54, body `rglru_scan_kernel`
// :27).  It computes what that kernel computes, per channel, from h_0 = 0:
//
//   h_t = a_t ⊙ h_{t-1} + b_t
//
// and returns out (B, S, D) = h in a's type and h_last (B, D) float32.  a
// and b are (B, S, D), contiguous, of one type, float32 or bfloat16; the
// arithmetic is float32.  Any S >= 1 and D >= 1: the ragged tails are
// masked here (the Pallas kernel asserts S % block_s == 0 and
// D % block_d == 0).  The gates that make a and b stay in PyTorch, as in
// the reference; a caller with a state h0 folds a_0·h0 into b_0.
//
// Each step is a multiply, then an add, each rounded to float32
// (__fmul_rn, __fadd_rn, never contracted into an FMA), in step order, by
// one thread per channel: the arithmetic of the plain sequential version
// (ref.py), so that the two agree bit for bit.  The reference's model scans
// with an associative (log-depth) combine instead, which rounds in another
// order.
//
// What bounds it on this card.  One multiply and one add per element
// against 2 elements read and 1 written: at the serve path's shape
// (4, 1024, 2560) in float32 that is 126 MB, 0.0376 ms at 3.35 TB/s, and
// 21 MFLOP, nothing.  So bytes bound it.  The steps of a channel form a
// chain, but a step is only ~8 cycles of dependent arithmetic: 1,024 of them
// take ~5 us, so the chain does not bound it either, if the loads are far
// enough ahead.  Little's law asks for ~2.3 MB in flight at 3.35 TB/s and
// ~0.7 us of latency.  The design (`rglru_scan_ring_kernel`):
//   * one warp a block on 32 neighbouring channels of one batch row: 320
//     blocks at the path's shape, two or three on each SM;
//   * a ring of NST = 2 shared-memory stages of TS = 64 steps x 32 channels
//     of a and of b (16 KB a stage in float32), filled by 16-byte
//     `cp.async`: the warp runs the chain on one stage while the next is in
//     flight, 5 MB across the card.  More stages measured slower (8 KB x 4,
//     4 KB x 8 and 16 KB x 4), 32 KB x 2 the same, and blocks of 128
//     channels slower (`repro_torch/kernels/recurrence_ab.py` times them).
//     cp.async and not TMA: a stage is rows of 128 bytes, and needs no
//     tensor map or barrier; a ragged last tile copies only its rows and
//     channels, and never reads the next batch row;
//   * each step's 32 results are stored by the warp as one coalesced row.
// It moves its bytes at ~83 % of the rate `torch.add(a, b, out=...)` moves
// the same bytes in the same layout (chip_smoke.py's `[times] rglru_scan`
// line); what holds back the rest is not known.
// A 16-byte copy needs 16-byte aligned rows: D·sizeof(a's type) a multiple
// of 16 and 16-byte aligned a and b.  Other inputs (the path never gives
// one) run `rglru_scan_rows_kernel`, the first design: the same chain, fed
// by registers that hold the next 16 steps' loads; it is bound by one
// memory round trip per 16 steps.

// The backward (`rglru_scan_bwd_kernel`) replaces what the reference
// differentiates, `jax.lax.associative_scan` (src/repro/models/rglru.py:46):
// no Pallas kernel has a backward.  It is the reverse linear scan, per
// channel, from the gradients of out and of h_last:
//
//   g_t = dout_t + a_{t+1} ⊙ g_{t+1}   (g_{S-1} = dout_{S-1} + dh_last)
//   da_t = g_t ⊙ h_{t-1}  (h_{-1} = 0),   db_t = g_t
//
// each product and sum rounded to float32 in that order (__fmul_rn,
// __fadd_rn), as the plain version (ref.py::rglru_bwd_ref) takes them, so
// the two agree bit for bit.  h is the forward's float32 output where a
// is float32; for bfloat16 inputs (whose output is rounded) a first pass of
// the same thread recomputes h in float32 into a scratch tensor.  What
// bounds it: bytes.  At the training path's shape (rows, 1024, 2560) in
// float32 it reads a, h and dout and writes da and db, 5 tensors of
// B·S·D float32; the steps of a channel form a chain, so each thread loads
// kBwdSteps steps of its three inputs into registers before it runs them:
// one thread a channel, 64 a block, as the forward's rows kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRowsThreads = 64;      // channels a block of the rows kernel
constexpr int kRowsSteps = 16;        // steps the rows kernel loads ahead

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

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
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

template <typename T, int TS_, int NST_, int CW_>
struct Ring {
  static constexpr int TS = TS_, NST = NST_, CW = CW_;  // CW: channels a block
  static constexpr int ROW_B = CW * (int)sizeof(T);      // one step's row
  static constexpr int COPIES = ROW_B / 16;              // 16 B copies a row
  static constexpr int STAGE_B = 2 * TS * ROW_B;         // a, then b
  static constexpr int SMEM = NST * STAGE_B;
};

template <typename T, class R>
__global__ void __launch_bounds__(R::CW)
rglru_scan_ring_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       T* __restrict__ out, float* __restrict__ h_last,
                       int S, int D) {
  constexpr int TS = R::TS, NST = R::NST, CW = R::CW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;                  // this thread's channel
  const int c0 = blockIdx.x * CW;
  const int nc = min(CW, D - c0);                // channels of this block
  const int copies = nc * (int)sizeof(T) / 16;   // valid copies a row
  const int64_t base = (int64_t)blockIdx.y * S * D + c0;
  const int n_tiles = (S + TS - 1) / TS;

  // tile c's rows into its stage (an empty group past the last tile)
  auto issue = [&](int c) {
    if (c < n_tiles) {
      const int t0 = c * TS, n = min(TS, S - t0);
      unsigned char* st = smem + (c % NST) * R::STAGE_B;
      for (int p = lane; p < TS * R::COPIES; p += CW) {
        const int row = p / R::COPIES, q = p % R::COPIES;
        if (row < n && q < copies) {
          const int64_t g = base + (int64_t)(t0 + row) * D;
          cp_async16(st + row * R::ROW_B + q * 16,
                     reinterpret_cast<const char*>(a + g) + q * 16);
          cp_async16(st + (TS + row) * R::ROW_B + q * 16,
                     reinterpret_cast<const char*>(b + g) + q * 16);
        }
      }
    }
    cp_async_commit();
  };

  for (int c = 0; c < NST - 1; ++c) issue(c);
  const bool live = lane < nc;                   // others run on stale data
  float h = 0.f;
  T* o = out + base + lane;
  for (int c = 0; c < n_tiles; ++c) {
    issue(c + NST - 1);
    cp_async_wait<NST - 1>();
    __syncthreads();                             // tile c has landed
    const T* as = reinterpret_cast<const T*>(smem + (c % NST) * R::STAGE_B);
    const T* bs = as + TS * CW;
    const int t0 = c * TS, n = min(TS, S - t0);
    if (n == TS) {
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        h = step(to_f(as[j * CW + lane]), h, to_f(bs[j * CW + lane]));
        if (live) o[(int64_t)(t0 + j) * D] = from_f<T>(h);
      }
    } else {
      for (int j = 0; j < n; ++j) {
        h = step(to_f(as[j * CW + lane]), h, to_f(bs[j * CW + lane]));
        if (live) o[(int64_t)(t0 + j) * D] = from_f<T>(h);
      }
    }
    __syncthreads();                             // before tile c's stage
  }                                              // is filled again
  if (live) h_last[(int64_t)blockIdx.y * D + c0 + lane] = h;
}

// steps [t0, t0 + kRowsSteps) of one channel into registers; a step past S
// is the identity (a = 1, b = 0), so it leaves h unchanged
template <typename T>
__device__ __forceinline__ void load_steps(float* ra, float* rb,
                                           const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           int64_t off, int t0, int S,
                                           int D) {
#pragma unroll
  for (int j = 0; j < kRowsSteps; ++j) {
    const int t = t0 + j;
    const int64_t i = off + (int64_t)t * D;
    ra[j] = t < S ? to_f(a[i]) : 1.f;
    rb[j] = t < S ? to_f(b[i]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowsThreads)
rglru_scan_rows_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       T* __restrict__ out, float* __restrict__ h_last,
                       int S, int D) {
  const int d = blockIdx.x * kRowsThreads + threadIdx.x;
  if (d >= D) return;
  const int64_t off = (int64_t)blockIdx.y * S * D + d;
  float ca[kRowsSteps], cb[kRowsSteps], na[kRowsSteps], nb[kRowsSteps];
  load_steps(ca, cb, a, b, off, 0, S, D);
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += kRowsSteps) {
    const bool more = t0 + kRowsSteps < S;
    if (more) load_steps(na, nb, a, b, off, t0 + kRowsSteps, S, D);
#pragma unroll
    for (int j = 0; j < kRowsSteps; ++j) {
      h = step(ca[j], h, cb[j]);
      if (t0 + j < S) out[off + (int64_t)(t0 + j) * D] = from_f<T>(h);
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < kRowsSteps; ++j) {
        ca[j] = na[j];
        cb[j] = nb[j];
      }
    }
  }
  h_last[(int64_t)blockIdx.y * D + d] = h;
}

// the ring of the path: TS = 64 steps a stage, NST = 2 stages, CW = 32
// channels a block
template <typename T>
using PathRing = Ring<T, 64, 2, 32>;

template <typename T, class R>
cudaError_t launch_ring(const void* a, const void* b, void* out,
                        void* h_last, int B, int S, int D,
                        cudaStream_t stream) {
  auto kernel = rglru_scan_ring_kernel<T, R>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((D + R::CW - 1) / R::CW, B);
  kernel<<<grid, R::CW, R::SMEM, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), static_cast<float*>(h_last), S, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* out, void* h_last,
                   int B, int S, int D, cudaStream_t stream) {
  const bool aligned =
      (D * sizeof(T)) % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
       16) == 0;
  if (aligned)
    return launch_ring<T, PathRing<T>>(a, b, out, h_last, B, S, D, stream);
  const dim3 grid((D + kRowsThreads - 1) / kRowsThreads, B);
  rglru_scan_rows_kernel<T><<<grid, kRowsThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), static_cast<float*>(h_last), S, D);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// backward: one thread a channel (b, d), steps from last to first
// ------------------------------------------------------------------------
constexpr int kBwdThreads = 64;       // channels a block of the backward
constexpr int kBwdSteps = 16;         // steps each thread loads at once

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
rglru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      float* __restrict__ h, const T* __restrict__ dout,
                      const float* __restrict__ dh_last, T* __restrict__ da,
                      T* __restrict__ db, int S, int D, int recompute) {
  const int d = blockIdx.x * kBwdThreads + threadIdx.x;
  if (d >= D) return;
  const int64_t off = (int64_t)blockIdx.y * S * D + d;
  if (recompute) {                      // h_t in float32, into the scratch
    float hf = 0.f;
    for (int t0 = 0; t0 < S; t0 += kBwdSteps) {
      float ra[kBwdSteps], rb[kBwdSteps];
#pragma unroll
      for (int j = 0; j < kBwdSteps; ++j) {
        const int t = t0 + j;
        ra[j] = t < S ? to_f(a[off + (int64_t)t * D]) : 1.f;
        rb[j] = t < S ? to_f(b[off + (int64_t)t * D]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBwdSteps; ++j) {
        hf = step(ra[j], hf, rb[j]);
        if (t0 + j < S) h[off + (int64_t)(t0 + j) * D] = hf;
      }
    }
  }
  float g = dh_last ? dh_last[(int64_t)blockIdx.y * D + d] : 0.f;
  float a_next = 1.f;                   // a_{t+1}; 1 seeds g with dh_last
  const int n_tiles = (S + kBwdSteps - 1) / kBwdSteps;
  for (int c = n_tiles - 1; c >= 0; --c) {
    const int t0 = c * kBwdSteps;
    float ra[kBwdSteps], rh[kBwdSteps], rg[kBwdSteps];
#pragma unroll
    for (int j = 0; j < kBwdSteps; ++j) {
      const int t = t0 + j;
      const int64_t i = off + (int64_t)t * D;
      ra[j] = t < S ? to_f(a[i]) : 1.f;
      rg[j] = t < S ? to_f(dout[i]) : 0.f;
      rh[j] = t < S && t > 0 ? h[i - D] : 0.f;
    }
#pragma unroll
    for (int j = kBwdSteps - 1; j >= 0; --j) {
      const int t = t0 + j;
      if (t >= S) continue;
      g = step(a_next, g, rg[j]);       // dout_t + a_{t+1}·g_{t+1}
      db[off + (int64_t)t * D] = from_f<T>(g);
      da[off + (int64_t)t * D] = from_f<T>(__fmul_rn(g, rh[j]));
      a_next = ra[j];
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const void* a, const void* b, void* h,
                       const void* dout, const void* dh_last, void* da,
                       void* db, int B, int S, int D, int recompute,
                       cudaStream_t stream) {
  const dim3 grid((D + kBwdThreads - 1) / kBwdThreads, B);
  rglru_scan_bwd_kernel<T><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(h), static_cast<const T*>(dout),
      static_cast<const float*>(dh_last), static_cast<T*>(da),
      static_cast<T*>(db), S, D, recompute);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of a, b and out: 0 = float32, 1 = bfloat16; h_last is float32.
// Runs the ring where a, b and D allow it, else the rows kernel.  Returns
// a cudaError_t (0 = success).
int rglru_scan_fwd(int dtype, const void* a, const void* b, void* out,
                   void* h_last, int B, int S, int D, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(a, b, out, h_last, B, S, D, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(a, b, out, h_last, B, S, D, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: dtype of a, b, dout, da and db as above; h (B, S, D) and
// dh_last (B, D) float32, dh_last may be null (a zero gradient).  With
// recompute = 0, h holds the forward's states (a float32 forward's out);
// with recompute = 1 it is scratch that the kernel fills from a and b
// first.  `device` is made current first: autograd runs the backward on a
// thread of its own.  Returns a cudaError_t (0 = success).
int rglru_scan_bwd(int dtype, const void* a, const void* b, void* h,
                   const void* dout, const void* dh_last, void* da, void* db,
                   int B, int S, int D, int recompute, int device,
                   void* stream) {
  if (const cudaError_t err = cudaSetDevice(device)) return (int)err;
  if (B < 1 || B > 65535 || S < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_bwd<float>(a, b, h, dout, dh_last, da, db, B, S, D,
                                  recompute, st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(a, b, h, dout, dh_last, da, db, B,
                                          S, D, recompute, st);
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory a block of the ring takes, or -1
int rglru_scan_smem_bytes(int dtype) {
  if (dtype == 0) return PathRing<float>::SMEM;
  if (dtype == 1) return PathRing<__nv_bfloat16>::SMEM;
  return -1;
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
