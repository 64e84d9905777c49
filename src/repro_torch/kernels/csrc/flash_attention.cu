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
// When `lse` is not null the forward also writes each row's fp32
// log-sum-exp, m + log(max(l, 1e-30)), for the backward; serving passes
// null and is unchanged.
//
// Backward (no TPU counterpart: the JAX package trains through its plain
// path).  With s the scaled, soft-capped, masked score and
// p = exp(s - lse), dP = dO V^T, delta = rowsum(dO * O) and
// dS = p * (dP - delta) * scale * (1 - (s / cap)^2) (the last factor only
// with a softcap), dQ = dS K, dK = dS^T Q and dV = p^T dO.  Masked
// entries get exactly 0.  Three kernels:
//   * flash_bwd_delta: delta, a warp per row;
//   * flash_bwd_dkdv: one block per (b, kv head, 16-key tile); it loops
//     over the G query heads of its group and over the 32-row query tiles
//     that can see its keys, so the GQA/MQA sum over heads happens inside
//     the block, with no atomics; each thread keeps one key's dK and dV
//     over D/16 columns in registers (32 floats at D = 256);
//   * flash_bwd_dq: one block per (b, h, 32-row query tile), looping over
//     the key tiles it sees; each thread keeps 1 row x D/8 columns of dQ.
// The tiles are widened to fp32 in shared memory (~103 KB for dK/dV and
// ~136 KB for dQ at D = 256, both raised with cudaFuncSetAttribute) and
// every product runs on the CUDA cores in fp32, as in the forward.
// Bound: operations (about 2.5 times the forward's).
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
  float* lse;  // (B, H, Sq) fp32, or null
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

  if (p.lse != nullptr && tid < BQ && q0 + tid < p.Sq)
    p.lse[(size_t)(b * p.H + h) * p.Sq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
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

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int KB_K = 16;   // keys per dK/dV block
constexpr int KB_Q = 32;   // query rows per tile of the dK/dV loop
constexpr int QB_Q = 32;   // query rows per dQ block
constexpr int QB_K = 32;   // keys per tile of the dQ loop

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, H, KV, Sq, Sk, D;
  float scale, logit_cap;
  int causal, window;
};

__device__ __forceinline__ bool visible(const BwdParams& p, int qp, int kp) {
  bool ok = qp < p.Sq && kp < p.Sk;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  return ok;
}

// p = exp(s - lse) for the raw product `dot`, and in *fac the derivative of
// s with respect to `dot` (the scale, times 1 - (s/cap)^2 with a softcap).
__device__ __forceinline__ float prob(const BwdParams& p, float dot, float lse,
                                      float* fac) {
  float s = dot * p.scale;
  float f = p.scale;
  if (p.logit_cap > 0.f) {
    s = p.logit_cap * tanhf(s / p.logit_cap);
    const float t = s / p.logit_cap;
    f *= 1.f - t * t;
  }
  *fac = f;
  return expf(s - lse);
}

template <typename T>
__global__ void __launch_bounds__(128) flash_bwd_delta(BwdParams p) {
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.B * p.H * p.Sq) return;
  const T* o = static_cast<const T*>(p.o) + row * p.D;
  const T* dO = static_cast<const T*>(p.dout) + row * p.D;
  float s = 0.f;
  for (int c = lane; c < p.D; c += 32) s += to_float(o[c]) * to_float(dO[c]);
  s = warp_sum(s);
  if (lane == 0) p.delta[row] = s;
}

size_t dkdv_smem_bytes(int D) {
  const int DP = D + 1;
  return sizeof(float) * (size_t)(2 * KB_K * DP + 2 * KB_Q * DP +
                                  2 * KB_Q * (KB_K + 1) + 2 * KB_Q);
}

template <typename T, int DT>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkdv(BwdParams p) {
  extern __shared__ float smem[];
  const int D = p.D, DP = D + 1;
  constexpr int SP = KB_K + 1;
  float* Ks = smem;              // KB_K x DP
  float* Vs = Ks + KB_K * DP;    // KB_K x DP
  float* Qs = Vs + KB_K * DP;    // KB_Q x DP
  float* dOs = Qs + KB_Q * DP;   // KB_Q x DP
  float* Ps = dOs + KB_Q * DP;   // KB_Q x SP
  float* dSs = Ps + KB_Q * SP;   // KB_Q x SP
  float* lse_s = dSs + KB_Q * SP;
  float* dl_s = lse_s + KB_Q;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * KB_K, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV;
  const size_t kvoff = (size_t)(b * p.KV + kvh) * p.Sk;
  const T* kg = static_cast<const T*>(p.k) + kvoff * D;
  const T* vg = static_cast<const T*>(p.v) + kvoff * D;

  for (int i = tid; i < KB_K * D; i += kBwdThreads) {
    const int r = i / D, c = i - r * D;
    const bool in = k0 + r < p.Sk;
    const size_t off = (size_t)(k0 + r) * D + c;
    Ks[r * DP + c] = in ? to_float(kg[off]) : 0.f;
    Vs[r * DP + c] = in ? to_float(vg[off]) : 0.f;
  }

  constexpr int NA = DT / 16;
  float dk[NA], dv[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) dk[a] = dv[a] = 0.f;
  const int jr = tid >> 4, tc = tid & 15;   // accumulator: key jr, cols tc + 16a
  const int si = tid >> 3, sj = tid & 7;    // scores: row si, keys sj, sj + 8

  const int nq = (p.Sq + KB_Q - 1) / KB_Q;
  const int qt_begin = p.causal ? k0 / KB_Q : 0;
  const int qt_end =
      p.window > 0 ? min(nq, (k0 + KB_K - 2 + p.window) / KB_Q + 1) : nq;

  for (int g = 0; g < G; ++g) {
    const size_t qoff = (size_t)(b * p.H + kvh * G + g) * p.Sq;
    const T* qg = static_cast<const T*>(p.q) + qoff * D;
    const T* dOg = static_cast<const T*>(p.dout) + qoff * D;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * KB_Q;
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < KB_Q * D; i += kBwdThreads) {
        const int r = i / D, c = i - r * D;
        const bool in = q0 + r < p.Sq;
        const size_t off = (size_t)(q0 + r) * D + c;
        Qs[r * DP + c] = in ? to_float(qg[off]) : 0.f;
        dOs[r * DP + c] = in ? to_float(dOg[off]) : 0.f;
      }
      if (tid < KB_Q) {
        const bool in = q0 + tid < p.Sq;
        lse_s[tid] = in ? p.lse[qoff + q0 + tid] : 0.f;
        dl_s[tid] = in ? p.delta[qoff + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
      const float* qr = Qs + si * DP;
      const float* dor = dOs + si * DP;
      for (int c = 0; c < D; ++c) {
        const float qa = qr[c], da = dor[c];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = sj + 8 * t;
          s[t] += qa * Ks[j * DP + c];
          dp[t] += da * Vs[j * DP + c];
        }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = sj + 8 * t;
        float pr = 0.f, ds = 0.f;
        if (visible(p, q0 + si, k0 + j)) {
          float f;
          pr = prob(p, s[t], lse_s[si], &f);
          ds = pr * (dp[t] - dl_s[si]) * f;
        }
        Ps[si * SP + j] = pr;
        dSs[si * SP + j] = ds;
      }
      __syncthreads();

      for (int i = 0; i < KB_Q; ++i) {
        const float pw = Ps[i * SP + jr], dw = dSs[i * SP + jr];
        const float* dorow = dOs + i * DP;
        const float* qrow = Qs + i * DP;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          const int c = tc + 16 * a;
          if (c < D) {
            dv[a] += pw * dorow[c];
            dk[a] += dw * qrow[c];
          }
        }
      }
    }
  }

  const int kp = k0 + jr;
  if (kp < p.Sk) {
    T* dkg = static_cast<T*>(p.dk) + (kvoff + kp) * D;
    T* dvg = static_cast<T*>(p.dv) + (kvoff + kp) * D;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const int c = tc + 16 * a;
      if (c < D) {
        dkg[c] = from_float<T>(dk[a]);
        dvg[c] = from_float<T>(dv[a]);
      }
    }
  }
}

size_t dq_smem_bytes(int D) {
  const int DP = D + 1;
  return sizeof(float) * (size_t)(2 * QB_Q * DP + 2 * QB_K * DP +
                                  QB_Q * (QB_K + 1) + 2 * QB_Q);
}

template <typename T, int DT>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq(BwdParams p) {
  extern __shared__ float smem[];
  const int D = p.D, DP = D + 1;
  constexpr int SP = QB_K + 1;
  float* Qs = smem;              // QB_Q x DP
  float* dOs = Qs + QB_Q * DP;   // QB_Q x DP
  float* Ks = dOs + QB_Q * DP;   // QB_K x DP
  float* Vs = Ks + QB_K * DP;    // QB_K x DP
  float* dSs = Vs + QB_K * DP;   // QB_Q x SP
  float* lse_s = dSs + QB_Q * SP;
  float* dl_s = lse_s + QB_Q;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB_Q, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const size_t qoff = (size_t)(b * p.H + h) * p.Sq;
  const size_t kvoff = (size_t)(b * p.KV + kvh) * p.Sk;
  const T* qg = static_cast<const T*>(p.q) + qoff * D;
  const T* dOg = static_cast<const T*>(p.dout) + qoff * D;
  const T* kg = static_cast<const T*>(p.k) + kvoff * D;
  const T* vg = static_cast<const T*>(p.v) + kvoff * D;

  for (int i = tid; i < QB_Q * D; i += kBwdThreads) {
    const int r = i / D, c = i - r * D;
    const bool in = q0 + r < p.Sq;
    const size_t off = (size_t)(q0 + r) * D + c;
    Qs[r * DP + c] = in ? to_float(qg[off]) : 0.f;
    dOs[r * DP + c] = in ? to_float(dOg[off]) : 0.f;
  }
  if (tid < QB_Q) {
    const bool in = q0 + tid < p.Sq;
    lse_s[tid] = in ? p.lse[qoff + q0 + tid] : 0.f;
    dl_s[tid] = in ? p.delta[qoff + q0 + tid] : 0.f;
  }

  constexpr int NA = DT / 8;
  float acc[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = 0.f;
  const int si = tid >> 3, sj = tid & 7;  // row si; keys sj + 8t; cols sj + 8a

  const int nk = (p.Sk + QB_K - 1) / QB_K;
  const int kt_end = p.causal ? min(nk, (q0 + QB_Q - 1) / QB_K + 1) : nk;
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / QB_K : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * QB_K;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < QB_K * D; i += kBwdThreads) {
      const int r = i / D, c = i - r * D;
      const bool in = k0 + r < p.Sk;
      const size_t off = (size_t)(k0 + r) * D + c;
      Ks[r * DP + c] = in ? to_float(kg[off]) : 0.f;
      Vs[r * DP + c] = in ? to_float(vg[off]) : 0.f;
    }
    __syncthreads();

    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qr = Qs + si * DP;
    const float* dor = dOs + si * DP;
    for (int c = 0; c < D; ++c) {
      const float qa = qr[c], da = dor[c];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = sj + 8 * t;
        s[t] += qa * Ks[j * DP + c];
        dp[t] += da * Vs[j * DP + c];
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = sj + 8 * t;
      float ds = 0.f;
      if (visible(p, q0 + si, k0 + j)) {
        float f;
        const float pr = prob(p, s[t], lse_s[si], &f);
        ds = pr * (dp[t] - dl_s[si]) * f;
      }
      dSs[si * SP + j] = ds;
    }
    __syncthreads();

    const float* dsr = dSs + si * SP;
    for (int j = 0; j < QB_K; ++j) {
      const float w = dsr[j];
      const float* kr = Ks + j * DP;
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const int c = sj + 8 * a;
        if (c < D) acc[a] += w * kr[c];
      }
    }
  }

  const int qp = q0 + si;
  if (qp < p.Sq) {
    T* dqg = static_cast<T*>(p.dq) + (qoff + qp) * D;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const int c = sj + 8 * a;
      if (c < D) dqg[c] = from_float<T>(acc[a]);
    }
  }
}

template <typename T, int DT>
int launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.H * p.Sq;
  flash_bwd_delta<T><<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_kv = dkdv_smem_bytes(p.D);
  e = cudaFuncSetAttribute(flash_bwd_dkdv<T, DT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_kv((p.Sk + KB_K - 1) / KB_K, p.KV, p.B);
  flash_bwd_dkdv<T, DT><<<grid_kv, kBwdThreads, smem_kv, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_q = dq_smem_bytes(p.D);
  e = cudaFuncSetAttribute(flash_bwd_dq<T, DT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_q((p.Sq + QB_Q - 1) / QB_Q, p.H, p.B);
  flash_bwd_dq<T, DT><<<grid_q, kBwdThreads, smem_q, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_d(const BwdParams& p, cudaStream_t stream) {
  if (p.D <= 32) return launch_bwd<T, 32>(p, stream);
  if (p.D <= 64) return launch_bwd<T, 64>(p, stream);
  if (p.D <= 128) return launch_bwd<T, 128>(p, stream);
  if (p.D <= 256) return launch_bwd<T, 256>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// `lse` may be null (no gradient wanted); otherwise (B, H, Sq) fp32.
extern "C" int flash_attention_launch(void* o, void* lse, const void* q,
                                      const void* k, const void* v, int B,
                                      int H, int KV, int Sq, int Sk, int D,
                                      float scale, int causal, int window,
                                      float logit_cap, int dtype,
                                      void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Params p{q, k, v, o, static_cast<float*>(lse), B, H, KV, Sq, Sk, D,
                 scale, logit_cap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_d<float>(p, st);
    case kBFloat16: return launch_d<__nv_bfloat16>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dq (B,H,Sq,D), dk and dv (B,KV,Sk,D) in the inputs' type; lse and the
// scratch delta (B,H,Sq) fp32.
extern "C" int flash_attention_bwd_launch(
    void* dq, void* dk, void* dv, void* delta, const void* q, const void* k,
    const void* v, const void* o, const void* lse, const void* dout, int B,
    int H, int KV, int Sq, int Sk, int D, float scale, int causal, int window,
    float logit_cap, int dtype, void* stream) {
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return 0;
  const BwdParams p{q, k, v, o, dout, static_cast<const float*>(lse),
                    static_cast<float*>(delta), dq, dk, dv, B, H, KV, Sq, Sk,
                    D, scale, logit_cap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_bwd_d<float>(p, st);
    case kBFloat16: return launch_bwd_d<__nv_bfloat16>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
