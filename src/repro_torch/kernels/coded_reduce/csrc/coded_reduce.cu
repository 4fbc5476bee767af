// Coded decode-reduce for Hopper (sm_90a): out[d] = sum_s w[s] * g[s, d].
//
// Replaces repro/kernels/coded_reduce/coded_reduce.py::coded_reduce_pallas
// (body coded_reduce_kernel), the decode sum of the coded-training bridge:
// the arrived worker uploads g (n_slots, D), float32 or bfloat16, weighted by
// their decode weights w (n_slots,) float32 and summed into a (D,) float32
// gradient.
//
// What bounds it on this card: HBM bytes.  It reads n_slots * D * sizeof(g)
// and writes 4 * D bytes, doing 2 * n_slots * D flops on them -- under one
// flop per byte, far below the ~20 flop/byte at which an H100's float32 units
// would become the limit.  The design therefore aims at one pass over g and
// nothing else:
//   * the weights (at most kMaxSlots of them) are loaded once per block into
//     shared memory and read from there;
//   * each thread owns output columns (grid-stride) and walks the rows in
//     order, accumulating in float32 registers; a warp's loads of one row are
//     32 neighbouring elements, so every load instruction is coalesced;
//   * the ragged tail is masked by the column bound -- no zero padding, which
//     would cost a second copy of g as the TPU wrapper's jnp.pad does;
//   * loads are scalar (4 bytes for float32, 2 for bfloat16).  Rows of a
//     (n_slots, D) payload are only 8-byte aligned when D = 2 (mod 4), as the
//     paper's MLP gives (D = 235,146), so 16-byte vector loads would need a
//     peeled head per row; that is later work.
// The row loop is unrolled so that a thread has several independent loads in
// flight; with one thread per column, a (6, 235146) call fills the card in a
// single wave.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 1024;   // keep in step with MAX_SLOTS in ops.py

__device__ __forceinline__ float load_f32(const float* p) { return *p; }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
coded_reduce_kernel(const T* __restrict__ g, const float* __restrict__ w,
                    float* __restrict__ out, int n_slots, int64_t D) {
  extern __shared__ float w_s[];
  for (int s = threadIdx.x; s < n_slots; s += blockDim.x) w_s[s] = w[s];
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t d = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; d < D;
       d += stride) {
    const T* col = g + d;
    float acc = 0.0f;
#pragma unroll 8
    for (int s = 0; s < n_slots; ++s) {
      acc = fmaf(w_s[s], load_f32(col + (int64_t)s * D), acc);
    }
    out[d] = acc;
  }
}

template <typename T>
int launch(const void* g, const void* w, void* out, int n_slots, int64_t D,
           void* stream) {
  if (n_slots < 0 || n_slots > kMaxSlots || D < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (D == 0) return (int)cudaSuccess;
  int64_t blocks = (D + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) blocks = 2147483647LL;   // grid-stride covers the rest
  const size_t smem = (size_t)(n_slots > 0 ? n_slots : 1) * sizeof(float);
  coded_reduce_kernel<T><<<(unsigned)blocks, kThreads, smem,
                           (cudaStream_t)stream>>>(
      (const T*)g, (const float*)w, (float*)out, n_slots, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher enqueues the kernel on `stream` and returns
// cudaGetLastError() (0 on success); it allocates and synchronises nothing.
int coded_reduce_f32(const void* g, const void* w, void* out, int n_slots,
                     int64_t D, void* stream) {
  return launch<float>(g, w, out, n_slots, D, stream);
}

int coded_reduce_bf16(const void* g, const void* w, void* out, int n_slots,
                      int64_t D, void* stream) {
  return launch<__nv_bfloat16>(g, w, out, n_slots, D, stream);
}

const char* coded_reduce_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
