// Causal flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention (body `_kernel`):
// online-softmax attention of q (B,H,Sq,D) against k, v (B,KV,Sk,D), with
// GQA through kv_head = h / (H / KV), an optional tanh softcap applied
// after the scale and before the mask, a causal mask aligned top-left
// (k_pos <= q_pos), an optional window (k_pos > q_pos - window), masking of
// keys past Sk, the finite NEG_INF = -2**30, l clamped at 1e-30, q/k/v
// widened to fp32 and the output written in q's type.
//
// Bound: operations.  At gemma-2b's prefill shape (S = 1024, D = 256) a
// block does 2 * D operations per (q, k) pair against 4 * D bytes of K and
// V per key tile shared by 32 query rows, well above the card's balance
// point.  This first version is simple and right, not fast:
//   * one block per (b, h, 32-row q tile); a loop over 32-key tiles inside
//     the block replaces the TPU's sequential nk grid axis;
//   * Q, K and V tiles are widened to fp32 in shared memory (rows padded
//     by one float so a warp's column reads hit distinct banks); head_dim
//     256 makes that ~101 KB, so the launcher raises the block's dynamic
//     shared-memory limit with cudaFuncSetAttribute first;
//   * each of the 128 threads computes a 2x4 tile of scores and owns a
//     2 x D/8 slice of the fp32 accumulator in registers (64 registers at
//     D = 256); the running max m, sum l and rescale factor live in shared
//     memory;
//   * the softmax pass gives each warp 8 rows, one lane per key;
//   * the K/V head is indexed, never copied per query head;
//   * key tiles that the causal mask or the window hides whole are
//     skipped: the TPU kernel visits them, but their entries contribute
//     exp(NEG_INF - m) = 0, so the result is the same;
//   * the products run on the CUDA cores in fp32, with no tensor cores:
//     fp32 inputs must agree with the plain version to 2e-5.  wgmma, TMA
//     and bf16 tiles are later work.
// A launch allocates nothing and returns cudaGetLastError().

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int BQ = 32;         // query rows per block
constexpr int BK = 32;         // keys per tile (= warp size: a lane per key)
constexpr int kThreads = 128;  // 16 x 8 threads over the 32 x 32 score tile
constexpr int SP = BK + 1;     // padded row stride of the score tile
constexpr float kNegInf = -1073741824.f;  // -2**30, finite as on the TPU

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Sk, D;
  float scale, logit_cap;
  int causal, window;
};

size_t smem_bytes(int D) {
  const int DP = D + 1;
  return sizeof(float) *
         (size_t)(BQ * DP + BK * DP + BK * D + BQ * SP + 3 * BQ);
}

// DT: head_dim rounded up to 32, 64, 128 or 256 (sizes the accumulator).
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  extern __shared__ float smem[];
  const int D = p.D, DP = D + 1;
  float* Qs = smem;            // BQ x DP
  float* Ks = Qs + BQ * DP;    // BK x DP
  float* Vs = Ks + BK * DP;    // BK x D
  float* Ss = Vs + BK * D;     // BQ x SP: scores, then probabilities
  float* m_s = Ss + BQ * SP;   // running max per row
  float* l_s = m_s + BQ;       // running sum per row
  float* c_s = l_s + BQ;       // this tile's rescale factor per row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 3, tx = tid & 7;  // rows 2ty, 2ty+1; keys tx + 8j
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);

  const T* q = static_cast<const T*>(p.q) + (size_t)(b * p.H + h) * p.Sq * D;
  const T* k = static_cast<const T*>(p.k) + (size_t)(b * p.KV + kvh) * p.Sk * D;
  const T* v = static_cast<const T*>(p.v) + (size_t)(b * p.KV + kvh) * p.Sk * D;
  T* o = static_cast<T*>(p.o) + (size_t)(b * p.H + h) * p.Sq * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    Qs[r * DP + c] = q0 + r < p.Sq ? to_float(q[(size_t)(q0 + r) * D + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  constexpr int NA = DT / 8;  // accumulator columns per thread
  float acc[2][NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[0][a] = acc[1][a] = 0.f;

  // Key tiles that some query row of this block may see.
  const int nk = (p.Sk + BK - 1) / BK;
  const int kt_end = p.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const bool in = k0 + r < p.Sk;
      const size_t off = (size_t)(k0 + r) * D + c;
      Ks[r * DP + c] = in ? to_float(k[off]) : 0.f;
      Vs[r * D + c] = in ? to_float(v[off]) : 0.f;
    }
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[0][j] = s[1][j] = 0.f;
    const float* qa = Qs + (2 * ty) * DP;
    const float* qb = qa + DP;
    for (int d = 0; d < D; ++d) {
      const float a0 = qa[d], a1 = qb[d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = Ks[(tx + 8 * j) * DP + d];
        s[0][j] += a0 * kk;
        s[1][j] += a1 * kk;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 2 * ty + i, c = tx + 8 * j;
        const int qp = q0 + r, kp = k0 + c;
        float x = s[i][j] * p.scale;
        if (p.logit_cap > 0.f) x = p.logit_cap * tanhf(x / p.logit_cap);
        bool ok = kp < p.Sk;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        Ss[r * SP + c] = ok ? x : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: warp w owns rows 8w .. 8w+7, lane j holds key j.
    for (int i = 0; i < BQ / 4; ++i) {
      const int r = warp * (BQ / 4) + i;
      const float x = Ss[r * SP + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float pr = expf(x - m_new);
      Ss[r * SP + lane] = pr;
      const float sum = warp_sum(pr);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    const float c0 = c_s[2 * ty], c1 = c_s[2 * ty + 1];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      acc[0][a] *= c0;
      acc[1][a] *= c1;
    }
    const float* pa = Ss + (2 * ty) * SP;
    const float* pb = pa + SP;
    for (int j = 0; j < BK; ++j) {
      const float w0 = pa[j], w1 = pb[j];
      const float* vr = Vs + j * D;
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const int c = tx + 8 * a;
        if (c < D) {
          const float vv = vr[c];
          acc[0][a] += w0 * vv;
          acc[1][a] += w1 * vv;
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * ty + i, qp = q0 + r;
    if (qp >= p.Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const int c = tx + 8 * a;
      if (c < D) o[(size_t)qp * D + c] = from_float<T>(acc[i][a] / l);
    }
  }
}

template <typename T, int DT>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd<T, DT><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, stream);
  if (p.D <= 64) return launch<T, 64>(p, stream);
  if (p.D <= 128) return launch<T, 128>(p, stream);
  if (p.D <= 256) return launch<T, 256>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_launch(void* o, const void* q, const void* k,
                                      const void* v, int B, int H, int KV,
                                      int Sq, int Sk, int D, float scale,
                                      int causal, int window, float logit_cap,
                                      int dtype, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Params p{q, k, v, o, B, H, KV, Sq, Sk, D, scale, logit_cap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_d<float>(p, st);
    case kBFloat16: return launch_d<__nv_bfloat16>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
