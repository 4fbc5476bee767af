// RG-LRU linear scan, forward, for Hopper (sm_90a).
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
// (__fmul_rn, __fadd_rn, never contracted into an FMA), in step order: the
// arithmetic of the plain sequential version (ref.py), so that the two
// agree bit for bit.  The reference's model scans with an associative
// (log-depth) combine instead, which rounds in another order.
//
// What bounds it on this card.  One multiply and one add per element
// against 2 elements read and 1 written: at the serve path's shape
// (4, 1024, 2560) in float32 that is 126 MB, 0.038 ms at 3.35 TB/s, and
// 21 MFLOP, nothing.  So bytes bound it; but the steps of a channel depend
// on each other, and the path has only B·D = 10,240 channels.  This first
// design is the simple one: one thread per channel, a warp on 32
// neighbouring channels so that each step's loads are coalesced, blocks of
// 64 threads so that the 160 blocks of the path's shape reach every SM,
// and each thread keeps the next kSteps steps' loads in flight (in
// registers) while it runs the dependent chain of the current kSteps.  The
// latency of a memory round trip per kSteps steps then bounds it, not the
// bytes.  The known next step is a chunked scan: local scans of S-chunks by
// several threads of a channel, then a carry pass through the chunks'
// cumulative decays.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;          // channels per block
constexpr int kSteps = 16;            // steps loaded ahead of the chain

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

// steps [t0, t0 + kSteps) of one channel into registers; a step past S is
// the identity (a = 1, b = 0), so it leaves h unchanged
template <typename T>
__device__ __forceinline__ void load_steps(float* ra, float* rb,
                                           const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           int64_t off, int t0, int S,
                                           int D) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int t = t0 + j;
    const int64_t i = off + (int64_t)t * D;
    ra[j] = t < S ? to_f(a[i]) : 1.f;
    rb[j] = t < S ? to_f(b[i]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ out, float* __restrict__ h_last, int S,
                  int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const int64_t off = (int64_t)blockIdx.y * S * D + d;
  float ca[kSteps], cb[kSteps], na[kSteps], nb[kSteps];
  load_steps(ca, cb, a, b, off, 0, S, D);
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const bool more = t0 + kSteps < S;
    if (more) load_steps(na, nb, a, b, off, t0 + kSteps, S, D);
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      h = __fadd_rn(__fmul_rn(ca[j], h), cb[j]);
      if (t0 + j < S) out[off + (int64_t)(t0 + j) * D] = from_f<T>(h);
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        ca[j] = na[j];
        cb[j] = nb[j];
      }
    }
  }
  h_last[(int64_t)blockIdx.y * D + d] = h;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* out, void* h_last,
                   int B, int S, int D, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), static_cast<float*>(h_last), S, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of a, b and out: 0 = float32, 1 = bfloat16; h_last is float32.
// Returns a cudaError_t (0 = success).
int rglru_scan_fwd(int dtype, const void* a, const void* b, void* out,
                   void* h_last, int B, int S, int D, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(a, b, out, h_last, B, S, D, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(a, b, out, h_last, B, S, D, st);
  return (int)cudaErrorInvalidValue;
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
