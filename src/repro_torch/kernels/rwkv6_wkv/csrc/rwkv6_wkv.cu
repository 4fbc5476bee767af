// RWKV6 WKV recurrence, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `wkv_pallas`
// (src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:76, body `wkv_kernel` :30).  It
// computes what that kernel computes, per (batch, head), from S_0 = 0:
//
//   out_t = r_t · (S_{t-1} + (u ⊙ k_t) ⊗ v_t),   S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
//
// and returns out (B, H, S, V) in r's type and S_last (B, H, K, V) float32.
// r, k, w are (B, H, S, K), v is (B, H, S, V), u is (H, K), all contiguous;
// r, k, v, u are float32 or bfloat16, w is float32; the arithmetic is
// float32.  K, V are 16, 32 or 64; S is any length >= 1.
//
// It runs the recurrence exactly, one step at a time.  The Pallas kernel
// (and the reference's `wkv_chunked`) instead factor the intra-chunk scores
// as exp(la[t-1]) * exp(min(-la[s], 30)) over the cumulative log-decay la,
// which stops equalling exp(la[t-1] - la[s]) once la passes -30 inside a
// chunk -- at rwkv6-1.6b's initial decay w = e^-1 with chunk 64 their output
// is off by up to 56.8.  A sequential recurrence has no such exponent, so it
// is right over w's whole range [exp(-e^2), exp(-e^-8)].
//
// What bounds it on this card.  Per step and head the minimal work is
// r·S (2·K·V flops) and the state update (2·K·V), against 3·K + V input
// and V output elements: at the serve path's shape (4, 32, 1024, 64) that is
// 2.1 GFLOP float32 against ~103 MB, about 0.03 ms either way.  But the
// steps depend on each other, so what bounds this first kernel is the
// latency of one step times S, not a rate.  The design (the RWKV project's
// own CUDA kernel's):
//   * one block per (batch, head), one thread per v column; each thread keeps
//     its K-long column of the state in float32 registers for the whole
//     sequence, so the state never touches memory until S_last is written;
//   * r, k, w and v are staged through shared memory kC steps at a time with
//     coalesced loads (neighbouring threads, neighbouring addresses), and each
//     step reads them back as float4 broadcasts;
//   * the bonus term is factored: r_t · ((u ⊙ k_t) ⊗ v_t) = (Σ_k r u k) v_t,
//     one dot product per step, computed once per chunk for all its steps;
//   * r·S is summed in four independent partial sums so that the FMA chain
//     of one step is K/4 long, not K.
// Nothing is padded: the ragged last chunk is bounded by the sequence length.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;                // steps staged per chunk

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

template <typename T, int K, int V>
__global__ void __launch_bounds__(V)
wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const T* __restrict__ u, T* __restrict__ out,
               float* __restrict__ s_last, int H, int S) {
  __shared__ __align__(16) float r_s[kC * K];
  __shared__ __align__(16) float k_s[kC * K];
  __shared__ __align__(16) float w_s[kC * K];
  __shared__ float v_s[kC * V];
  __shared__ float u_s[K];
  __shared__ float bonus_s[kC];      // Σ_k r_t u k_t of each staged step

  const int bh = blockIdx.x;
  const int i = threadIdx.x;         // this thread's v column
  const int64_t base_k = (int64_t)bh * S * K;
  const int64_t base_v = (int64_t)bh * S * V;
  for (int j = i; j < K; j += V) u_s[j] = to_f(u[(int64_t)(bh % H) * K + j]);

  float st[K];
#pragma unroll
  for (int j = 0; j < K; ++j) st[j] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += kC) {
    const int n = min(kC, S - t0);
    __syncthreads();                 // the last chunk's readers are done
    const int64_t off_k = base_k + (int64_t)t0 * K;
    const int64_t off_v = base_v + (int64_t)t0 * V;
    for (int j = i; j < n * K; j += V) {
      r_s[j] = to_f(r[off_k + j]);
      k_s[j] = to_f(k[off_k + j]);
      w_s[j] = w[off_k + j];
    }
    for (int j = i; j < n * V; j += V) v_s[j] = to_f(v[off_v + j]);
    __syncthreads();
    for (int t = i; t < n; t += V) {
      float b = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j)
        b = fmaf(r_s[t * K + j] * u_s[j], k_s[t * K + j], b);
      bonus_s[t] = b;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float vt = v_s[t * V + i];
      const float4* r4 = reinterpret_cast<const float4*>(r_s + t * K);
      const float4* k4 = reinterpret_cast<const float4*>(k_s + t * K);
      const float4* w4 = reinterpret_cast<const float4*>(w_s + t * K);
      float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        float* s = st + 4 * q;
        y0 = fmaf(rr.x, s[0], y0);
        y1 = fmaf(rr.y, s[1], y1);
        y2 = fmaf(rr.z, s[2], y2);
        y3 = fmaf(rr.w, s[3], y3);
        s[0] = fmaf(ww.x, s[0], kk.x * vt);
        s[1] = fmaf(ww.y, s[1], kk.y * vt);
        s[2] = fmaf(ww.z, s[2], kk.z * vt);
        s[3] = fmaf(ww.w, s[3], kk.w * vt);
      }
      out[off_v + (int64_t)t * V + i] =
          from_f<T>((y0 + y1) + (y2 + y3) + bonus_s[t] * vt);
    }
  }
  float* sl = s_last + (int64_t)bh * K * V;
#pragma unroll
  for (int j = 0; j < K; ++j) sl[(int64_t)j * V + i] = st[j];
}

struct Args {
  const void *r, *k, *v, *w, *u;
  void *out, *s_last;
  int B, H, S;
  cudaStream_t stream;
};

template <typename T, int K, int V>
cudaError_t launch(const Args& a) {
  wkv_fwd_kernel<T, K, V><<<a.B * a.H, V, 0, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.w),
      static_cast<const T*>(a.u), static_cast<T*>(a.out),
      static_cast<float*>(a.s_last), a.H, a.S);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t dispatch_v(int V, const Args& a) {
  switch (V) {
    case 16: return launch<T, K, 16>(a);
    case 32: return launch<T, K, 32>(a);
    case 64: return launch<T, K, 64>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_k(int K, int V, const Args& a) {
  switch (K) {
    case 16: return dispatch_v<T, 16>(V, a);
    case 32: return dispatch_v<T, 32>(V, a);
    case 64: return dispatch_v<T, 64>(V, a);
  }
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
  const Args a{r, k, v, w, u, out, s_last, B, H, S, (cudaStream_t)stream};
  if (dtype == 0) return (int)dispatch_k<float>(K, V, a);
  if (dtype == 1) return (int)dispatch_k<__nv_bfloat16>(K, V, a);
  return (int)cudaErrorInvalidValue;
}

const char* wkv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
