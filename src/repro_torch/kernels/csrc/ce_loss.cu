// Fused cross-entropy (forward and backward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ce_loss.py::ce_loss (body
// `_kernel`): per token t, the logits x[t] . W[v] for every vocab row v
// (fp32 products of x and the table widened to fp32), an online
// log-sum-exp over vocab tiles with padded vocab masked to the finite
// NEG_INF = -2**30, l clamped at 1e-30, and the gold logit gathered where
// v == label[t]; loss[t] = logZ[t] - gold[t].  The (T, V) logits never
// reach device memory.  The forward also writes logZ (T,) fp32 for the
// backward, which the TPU kernel does not have: there the JAX package
// trains through its plain path.  The backward recomputes each logit tile
// and forms P = g[t] * (exp(logit - logZ[t]) - onehot(label[t])):
//   * ce_bwd<kDW = false>: one block per tile of 16 token rows, streaming
//     the vocab, dx[t] = sum_v P[t, v] W[v];
//   * ce_bwd<kDW = true>: one block per tile of 16 vocab rows, streaming
//     the tokens, dW[v] = sum_t P[t, v] x[t].
// Neither uses atomics: each output row is summed by one block, in a
// fixed order, so runs are deterministic.
//
// Bound: operations.  2 T V d for the forward and 6 T V d for the
// backward (two recomputes and two products), against T d + V d inputs:
// at gemma-2b's training shape (T 2040, V 256000, d 2048) that is
// ~2,000 operations a byte.  This first version is simple and right, not
// fast: every product runs on the CUDA cores in fp32 (a bf16 x bf16
// product is exact in fp32, so bf16 inputs compute the same function as
// the Pallas kernel up to the order of the sums):
//   * a block owns 16 rows, one warp each, and streams 128 rows of the
//     other operand at a time; each lane computes 4 logits of its warp's
//     row, over K chunks of 32 staged in shared memory (the streamed
//     chunk stored transposed and padded by one float, so neither the
//     stores nor the reads conflict on banks);
//   * the forward keeps its running max, sum and gold logit in registers
//     and reduces across the warp with shuffles: a row is a warp;
//   * the backward keeps the block's 16 output rows in registers (16 x
//     ceil(d / 512) values a thread, 64 at d = 2048), adds P (staged in
//     shared memory) times the streamed rows read straight from device
//     memory (coalesced, mostly hits in L2), and writes each output row
//     once, in the output's type.
// Tensor cores (mma/wgmma on bf16 tiles) are later work.  A launch
// allocates nothing and returns cudaGetLastError().

#include <cstdint>

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int OM = 16;              // own rows per block, one warp each
constexpr int kThreads = OM * 32;   // 512
constexpr int SN = 128;             // streamed rows per tile (4 per lane)
constexpr int BKC = 32;             // depth of one staged K chunk
constexpr int SNP = SN + 1;         // padded row of the transposed chunk
constexpr float kNegInf = -1073741824.f;  // -2**30, finite as on the TPU

static_assert(kThreads == OM * BKC, "one A-chunk value per thread");

// s[j] = A[a0 + warp] . B[b0 + lane + 32 j] for j < 4, summed over d in
// fp32.  Rows past na / nb read as zeros.  Every thread of the block must
// call it (it synchronises).
template <typename T>
__device__ __forceinline__ void logit_tile(
    const T* __restrict__ A, long long na, long long a0,
    const T* __restrict__ B, long long nb, long long b0, int d,
    float* __restrict__ As, float* __restrict__ Bs, float (&s)[4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += BKC) {
    __syncthreads();  // the previous chunk's (or tile's) readers are done
    {
      const long long a = a0 + warp;
      const int k = k0 + lane;
      As[warp * BKC + lane] = (a < na && k < d) ? to_float(A[a * d + k]) : 0.f;
    }
    for (int i = tid; i < SN * BKC; i += kThreads) {
      const int c = i / BKC, kk = i - c * BKC;
      const long long b = b0 + c;
      const int k = k0 + kk;
      Bs[kk * SNP + c] = (b < nb && k < d) ? to_float(B[b * d + k]) : 0.f;
    }
    __syncthreads();
    const float* ar = As + warp * BKC;
#pragma unroll 8
    for (int k = 0; k < BKC; ++k) {
      const float av = ar[k];
      const float* br = Bs + k * SNP + lane;
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] += av * br[32 * j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd(const T* __restrict__ x, const T* __restrict__ w,
       const int* __restrict__ labels, float* __restrict__ loss,
       float* __restrict__ logz, int rows, int vocab, int d) {
  __shared__ float As[OM * BKC];
  __shared__ float Bs[BKC * SNP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long a0 = (long long)blockIdx.x * OM;
  const long long row = a0 + warp;
  const int lbl = row < rows ? labels[row] : -1;
  float m = kNegInf, l = 0.f, gold = 0.f;  // gold: this lane's share

  for (int v0 = 0; v0 < vocab; v0 += SN) {
    float s[4];
    logit_tile<T>(x, rows, a0, w, vocab, v0, d, As, Bs, s);
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + lane + 32 * j;
      if (v >= vocab) s[j] = kNegInf;
      if (v == lbl) gold += s[j];
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, warp_max(tmax));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) sum += expf(s[j] - m_new);
    l = l * expf(m - m_new) + warp_sum(sum);
    m = m_new;
  }
  gold = warp_sum(gold);
  if (row < rows && lane == 0) {
    const float lz = logf(fmaxf(l, 1e-30f)) + m;
    logz[row] = lz;
    loss[row] = lz - gold;
  }
}

// kDW = false: own rows are tokens (A = x), streamed rows the vocab
// (B = W), output dx.  kDW = true: own rows are vocab rows (A = W),
// streamed rows the tokens (B = x), output dW.  NC = ceil(d / 512).
template <typename T, int NC, bool kDW>
__global__ void __launch_bounds__(kThreads)
ce_bwd(const T* __restrict__ x, const T* __restrict__ w,
       const int* __restrict__ labels, const float* __restrict__ logz,
       const float* __restrict__ g, T* __restrict__ out, int rows, int vocab,
       int d) {
  __shared__ float As[OM * BKC];
  __shared__ float Bs[BKC * SNP];
  __shared__ float Ps[OM * SN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* A = kDW ? w : x;
  const T* B = kDW ? x : w;
  const long long na = kDW ? vocab : rows, nb = kDW ? rows : vocab;
  const long long a0 = (long long)blockIdx.x * OM;
  const long long a = a0 + warp;  // this warp's own row

  int lbl_a = -1;
  float lz_a = 0.f, g_a = 0.f;
  if (!kDW && a < na) {
    lbl_a = labels[a];
    lz_a = logz[a];
    g_a = g[a];
  }

  float acc[OM][NC];
#pragma unroll
  for (int r = 0; r < OM; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[r][n] = 0.f;

  for (long long b0 = 0; b0 < nb; b0 += SN) {
    float s[4];
    logit_tile<T>(A, na, a0, B, nb, b0, d, As, Bs, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long b = b0 + lane + 32 * j;
      float p = 0.f;
      if (a < na && b < nb) {
        const long long v = kDW ? a : b;
        const float lz = kDW ? logz[b] : lz_a;
        const float gt = kDW ? g[b] : g_a;
        const int lb = kDW ? labels[b] : lbl_a;
        p = gt * (expf(s[j] - lz) - (lb == v ? 1.f : 0.f));
      }
      Ps[warp * SN + lane + 32 * j] = p;
    }
    __syncthreads();
    const int nbt = (int)(nb - b0 < SN ? nb - b0 : SN);
    for (int c = 0; c < nbt; ++c) {
      const T* brow = B + (b0 + c) * d;
      float bv[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int col = tid + kThreads * n;
        bv[n] = col < d ? to_float(brow[col]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < OM; ++r) {
        const float pr = Ps[r * SN + c];
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[r][n] += pr * bv[n];
      }
    }
    // the next logit_tile starts with a barrier, so Ps is not
    // overwritten before every thread has read it
  }

#pragma unroll
  for (int r = 0; r < OM; ++r) {
    if (a0 + r >= na) break;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = tid + kThreads * n;
      if (col < d) out[(a0 + r) * d + col] = from_float<T>(acc[r][n]);
    }
  }
}

template <typename T, int NC>
int launch_bwd(void* dx, void* dw, const void* x, const void* w,
               const int* labels, const float* logz, const float* g,
               int rows, int vocab, int d, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  ce_bwd<T, NC, false><<<(unsigned)((rows + OM - 1) / OM), kThreads, 0, st>>>(
      xt, wt, labels, logz, g, static_cast<T*>(dx), rows, vocab, d);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ce_bwd<T, NC, true><<<(unsigned)((vocab + OM - 1) / OM), kThreads, 0, st>>>(
      xt, wt, labels, logz, g, static_cast<T*>(dw), rows, vocab, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_d(void* dx, void* dw, const void* x, const void* w,
                 const int* labels, const float* logz, const float* g,
                 int rows, int vocab, int d, cudaStream_t st) {
  if (d <= kThreads)
    return launch_bwd<T, 1>(dx, dw, x, w, labels, logz, g, rows, vocab, d, st);
  if (d <= 2 * kThreads)
    return launch_bwd<T, 2>(dx, dw, x, w, labels, logz, g, rows, vocab, d, st);
  if (d <= 4 * kThreads)
    return launch_bwd<T, 4>(dx, dw, x, w, labels, logz, g, rows, vocab, d, st);
  if (d <= 8 * kThreads)
    return launch_bwd<T, 8>(dx, dw, x, w, labels, logz, g, rows, vocab, d, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ce_loss_fwd_launch(void* loss, void* logz, const void* x,
                                  const void* w, const void* labels, int rows,
                                  int vocab, int d, int dtype, void* stream) {
  if (rows == 0) return 0;
  if (vocab <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((rows + OM - 1) / OM);
  const int* lb = static_cast<const int*>(labels);
  float* lo = static_cast<float*>(loss);
  float* lz = static_cast<float*>(logz);
  switch (dtype) {
    case kFloat32:
      ce_fwd<float><<<blocks, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w), lb, lo,
          lz, rows, vocab, d);
      break;
    case kBFloat16:
      ce_fwd<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(w), lb, lo, lz, rows, vocab, d);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int ce_loss_bwd_launch(void* dx, void* dw, const void* x,
                                  const void* w, const void* labels,
                                  const void* logz, const void* g, int rows,
                                  int vocab, int d, int dtype, void* stream) {
  if (rows == 0 || vocab == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(labels);
  const float* lz = static_cast<const float*>(logz);
  const float* gg = static_cast<const float*>(g);
  switch (dtype) {
    case kFloat32:
      return launch_bwd_d<float>(dx, dw, x, w, lb, lz, gg, rows, vocab, d, st);
    case kBFloat16:
      return launch_bwd_d<__nv_bfloat16>(dx, dw, x, w, lb, lz, gg, rows,
                                         vocab, d, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
