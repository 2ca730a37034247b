// FIR matvec for the fleet telemetry step, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel cueball_tpu/ops/fir.py:fir_apply_pallas
// (pallas_call at fir.py:84, body _fir_kernel at fir.py:61), which reverses
// the windows, pads the pools to a multiple of 256 and takes one f32 dot per
// [256, K] VMEM tile. Here:
//
//   out[p] = sum_c windows[p, c] * taps[K-1-c]      (f32 in, f32 accumulate)
//
// windows is [P, K] row-major, ordered oldest -> newest; taps[0] weights the
// newest sample. Any K >= 1 and any P.
//
// What bounds it: memory. Each window element is read once and used in one
// multiply-add. At P = 1,048,576 and K = 128 it reads 536,870,912 B of windows
// and writes 4,194,304 B of output, so at 3.35 TB/s it cannot take less than
// about 0.16 ms; its 2*P*K = 268 M flops take 0.004 ms at 67 TFLOP/s f32.
//
// The simple design for that bound: one warp per pool row, several rows per
// block, a grid over rows. The taps are staged once per block in shared
// memory, already reversed, so windows.flip(1) is never materialised and no
// lane reads the taps from device memory more than once per block. Lane l
// reads columns l, l+32, ..., so each step of a warp reads 128 contiguous
// bytes of one row. The partial sums meet in a __shfl_down_sync tree, and
// lane 0 writes the row's result. The last block's extra warps are masked
// out, not padded. Row offsets are 64-bit.
//
// Not done yet: 16-byte vector loads, several rows per warp, and fusing the
// step's reset and shift-append into this pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr size_t kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
fir_rows_f32(const float* __restrict__ windows,
             const float* __restrict__ taps,
             float* __restrict__ out, int64_t pools, int k) {
  extern __shared__ float rev_taps[];  // rev_taps[c] = taps[k-1-c]
  for (int c = threadIdx.x; c < k; c += kThreads) {
    rev_taps[c] = taps[k - 1 - c];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= pools) {
    return;  // a whole warp leaves together, so the shuffles stay full
  }
  const float* w = windows + row * static_cast<int64_t>(k);
  float acc = 0.0f;
  for (int c = lane; c < k; c += 32) {
    acc = fmaf(w[c], rev_taps[c], acc);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) {
    out[row] = acc;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() as an int (0 = success).
extern "C" int cb_fir_apply_f32(const void* windows, const void* taps,
                                void* out, int64_t pools, int k,
                                void* stream) {
  if (pools <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (pools + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = static_cast<size_t>(k) * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        fir_rows_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  fir_rows_f32<<<static_cast<unsigned int>(blocks), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(windows), static_cast<const float*>(taps),
      static_cast<float*>(out), pools, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
