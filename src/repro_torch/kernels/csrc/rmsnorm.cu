// RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rms_norm
// (body `_kernel`): per row, fp32 `x * rsqrt(mean(x^2) + eps) * (1 + scale)`,
// cast back to x's type.
//
// Bound: bytes.  Each element is read, squared, read again and written,
// about 4 operations for 2 * sizeof(T) bytes of device memory, far below
// the ~295 operations per byte where the H100 turns compute-bound.  So the
// design only tries to move each byte once, in wide transactions:
//   * one warp per row, four rows per 128-thread block; the sum of squares
//     is reduced in fp32 with warp shuffles, no shared memory, no barrier;
//   * 16-byte vector loads and stores when d % 8 == 0 and both pointers
//     are 16-byte aligned (4 fp32 or 8 bf16 values a lane), scalar
//     accesses otherwise;
//   * the second pass re-reads the row, which a warp has just read and
//     which then sits in L1 (8 KB for d = 2048 in fp32), so device memory
//     sees one read and one write;
//   * the last block masks rows past the end instead of padding them the
//     way the TPU kernel pads to its 256-row blocks.
// A launch allocates nothing and returns cudaGetLastError().

#include <cstdint>

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int kWarps = 4;  // rows per block

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rms_norm_kernel(T* __restrict__ out, const T* __restrict__ x,
                const float* __restrict__ scale, long long rows, int d,
                float eps, bool vec) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  constexpr int N = Vec16<T>::n;

  float ss = 0.f;
  if (vec) {
    for (int i = lane * N; i < d; i += 32 * N) {
      float v[N];
      load16(xr + i, v);
#pragma unroll
      for (int j = 0; j < N; ++j) ss += v[j] * v[j];
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float v = to_float(xr[i]);
      ss += v * v;
    }
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)d + eps);

  if (vec) {
    for (int i = lane * N; i < d; i += 32 * N) {
      float v[N];
      load16(xr + i, v);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = (v[j] * r) * (1.f + scale[i + j]);
      store16(orow + i, v);
    }
  } else {
    for (int i = lane; i < d; i += 32)
      orow[i] = from_float<T>((to_float(xr[i]) * r) * (1.f + scale[i]));
  }
}

template <typename T>
int launch(void* out, const void* x, const float* scale, long long rows,
           int d, float eps, cudaStream_t stream) {
  const bool vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  rms_norm_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(x), scale, rows, d, eps, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rms_norm_launch(void* out, const void* x, const void* scale,
                               long long rows, int d, float eps, int dtype,
                               void* stream) {
  if (rows == 0) return 0;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float>(out, x, s, rows, d, eps, st);
    case kBFloat16: return launch<__nv_bfloat16>(out, x, s, rows, d, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_torch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
