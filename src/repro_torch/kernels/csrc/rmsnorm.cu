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
//
// Backward (no TPU counterpart: the JAX package trains through its plain
// path).  With r = rsqrt(mean(x^2) + eps) and g = dy * (1 + scale):
//   dx     = r * g - x * r^3 * mean(g * x)           per row,
//   dscale = sum over rows of dy * x * r             per column.
// rms_norm_bwd_kernel gives a block 16 rows: its warps first reduce each
// row's sum of squares and sum of g * x with shuffles, then its threads
// walk the columns (coalesced) over those 16 rows, writing dx and one
// fp32 partial of dscale per column.  column_sum adds the partials of all
// blocks in a fixed order.  No atomics, so runs are deterministic.  Bound:
// bytes (x and dy read, dx written; the partials are 1/8 of that at
// d = 2048 in bf16).
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

constexpr int kBwdRows = 16;       // rows per block of the backward
constexpr int kBwdThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
rms_norm_bwd_kernel(T* __restrict__ dx, float* __restrict__ part,
                    const T* __restrict__ x, const float* __restrict__ scale,
                    const T* __restrict__ dy, long long rows, int d,
                    float eps) {
  __shared__ float r_s[kBwdRows];
  __shared__ float c_s[kBwdRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * kBwdRows;

  for (int i = warp; i < kBwdRows; i += kBwdThreads / 32) {
    const long long row = r0 + i;
    float ss = 0.f, gx = 0.f;
    if (row < rows) {
      const T* xr = x + row * d;
      const T* dr = dy + row * d;
      for (int c = lane; c < d; c += 32) {
        const float xv = to_float(xr[c]);
        ss += xv * xv;
        gx += to_float(dr[c]) * (1.f + scale[c]) * xv;
      }
    }
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    if (lane == 0) {
      const float r = rsqrtf(ss / (float)d + eps);
      r_s[i] = r;
      c_s[i] = r * r * r * (gx / (float)d);
    }
  }
  __syncthreads();

  const long long left = rows - r0;
  const int nr = left < kBwdRows ? (int)left : kBwdRows;
  for (int c = tid; c < d; c += kBwdThreads) {
    const float w = 1.f + scale[c];
    float acc = 0.f;
    for (int i = 0; i < nr; ++i) {
      const long long off = (r0 + i) * d + c;
      const float xv = to_float(x[off]), dv = to_float(dy[off]);
      const float r = r_s[i];
      dx[off] = from_float<T>(r * (dv * w) - xv * c_s[i]);
      acc += dv * xv * r;
    }
    part[(long long)blockIdx.x * d + c] = acc;
  }
}

__global__ void column_sum(float* __restrict__ out,
                           const float* __restrict__ part, int nparts, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += part[(long long)p * d + c];
  out[c] = s;
}

template <typename T>
int launch_bwd(void* dx, float* dscale, float* part, const void* x,
               const float* scale, const void* dy, long long rows, int d,
               float eps, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + kBwdRows - 1) / kBwdRows);
  rms_norm_bwd_kernel<T><<<blocks, kBwdThreads, 0, stream>>>(
      static_cast<T*>(dx), part, static_cast<const T*>(x), scale,
      static_cast<const T*>(dy), rows, d, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  column_sum<<<(unsigned)((d + 255) / 256), 256, 0, stream>>>(
      dscale, part, (int)blocks, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of x per dscale partial: the caller sizes `part` as
// ceil(rows / rms_norm_bwd_rows_per_block()) x d fp32.
extern "C" int rms_norm_bwd_rows_per_block() { return kBwdRows; }

extern "C" int rms_norm_bwd_launch(void* dx, void* dscale, void* part,
                                   const void* x, const void* scale,
                                   const void* dy, long long rows, int d,
                                   float eps, int dtype, void* stream) {
  const float* s = static_cast<const float*>(scale);
  float* ds = static_cast<float*>(dscale);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return (int)cudaMemsetAsync(ds, 0, sizeof(float) * d, st);
  switch (dtype) {
    case kFloat32:
      return launch_bwd<float>(dx, ds, pt, x, s, dy, rows, d, eps, st);
    case kBFloat16:
      return launch_bwd<__nv_bfloat16>(dx, ds, pt, x, s, dy, rows, d, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
