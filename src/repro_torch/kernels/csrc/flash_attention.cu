// Flash attention (forward and backward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention (body `_kernel`):
// online-softmax attention of q (B,H,Sq,D) against k, v (B,KV,Sk,D), with
// GQA through kv_head = h / (H / KV), an optional tanh softcap applied
// after the scale and before the mask, a causal mask aligned top-left
// (k_pos <= q_pos), an optional window (k_pos > q_pos - window), masking of
// keys past Sk, the finite NEG_INF = -2**30, l clamped at 1e-30 and the
// output written in q's type.  The K/V head is indexed, never copied per
// query head.  When `lse` is not null the forward also writes each row's
// fp32 log-sum-exp, m + log(max(l, 1e-30)), for the backward.
//
// Backward (no TPU counterpart: the JAX package trains through its plain
// path).  With s the scaled, soft-capped, masked score and
// p = exp(s - lse), dP = dO V^T, delta = rowsum(dO * O) and
// dS = p * (dP - delta) * scale * (1 - (s / cap)^2) (the last factor only
// with a softcap), dQ = dS K, dK = dS^T Q and dV = p^T dO.  Masked
// entries get exactly 0.  No atomics: every output element is summed in a
// fixed order, so two runs are bitwise equal.
//
// Bound: operations.  4 D operations per visible (q, k) pair forward
// (S and P V) and 10 D backward (S again, dP, dV, dK, dQ; these kernels
// do 14 D, as the dK/dV and the dQ kernel each recompute S and dP),
// against 4 D bytes of K and V per key: at gemma-2b's shapes (D 256,
// S 256-1024) far above the card's ~295 operations a byte.
//
// Two routes, chosen by the wrapper from the dtype and head_dim alone:
//
// bf16 with head_dim 64, 128 or 256 (every main path): the tensor cores
// (namespace fa below).  Tiles are bf16 in shared memory with the
// 128-byte swizzle, loaded by TMA (3-d maps (D, rows, heads), so a tile
// never reads into the next head and rows past Sq or Sk read as zeros),
// and multiplied by wgmma (hopper.cuh) into fp32 registers:
//   * flash_tc_fwd: one block per (b, h, 128 q rows), the heaviest causal
//     tiles launched first; two consumer warpgroups of 64 rows and a
//     producer warpgroup (setmaxnreg 240 / 24) that loads Q once and
//     streams 64-key K and V tiles through a ring of 2 (D 256) or 4
//     stages.  S = Q K^T (m64n64k16, both K-major); softcap, masks (only
//     on tiles that cross the diagonal, the window or Sk), the row max
//     and sum in the accumulator's registers; P rounded to bf16 in
//     registers is the A operand of O += P V (the RS form, V read
//     MN-major through the transpose bit, m64nDk16), as the TPU kernel
//     rounds p to v's type.  Key tiles that no row of a warpgroup sees
//     are skipped.  O leaves through the warpgroup's rows of Q, swizzled,
//     by TMA store.
//   * flash_tc_dkdv: one block per (b * KV + kv head, head split, 64
//     keys).  It walks the q tiles of its split's heads that see its keys:
//     warpgroup 0 recomputes S^T = K Q^T and P^T = exp(S^T - lse), shares
//     P^T fac with warpgroup 1 through shared memory (named barriers) and
//     adds P^T dO to dV; warpgroup 1 forms dP^T = V dO^T and
//     dS^T = P^T (dP^T - delta) fac and adds dS^T Q to dK (each 64 x D
//     fp32, 128 registers a thread at D 256).  The G query heads of an
//     MQA/GQA group are split across blocks (`splits`, chosen by the
//     wrapper to fill the card); with more than one split each writes
//     fp32 partials and flash_tc_combine adds them in split order.
//   * flash_tc_dq: one block per (b, h, 64 q rows), one consumer
//     warpgroup: S, dP, dS as above, dQ += dS K with K MN-major.
//   * flash_bwd_delta (shared with the CUDA-core route): delta per row.
//   P and dS are rounded to bf16 before their products, with fp32
//   sums (kernels/ref.py::flash_attention_bwd_rounded_ref).  Needs
//   16-byte-aligned bases (TMA); the wrapper refuses others.
//
// fp32 (the parity checks), and bf16 at any other head_dim (up to 256:
// the tests' 32): the first, CUDA-core kernels, kept as they were.  One
// block per (b, h, 32-row q tile) looping over 32-key tiles; Q, K and V
// widened to fp32 in shared memory (rows padded by one float; ~101 KB
// at D 256, raised with cudaFuncSetAttribute); each of 128 threads
// computes a 2x4 score tile and owns a 2 x D/8 slice of the accumulator;
// m, l and the rescale factor in shared memory; fully masked key tiles
// skipped.  Backward: flash_bwd_delta; flash_bwd_dkdv, one block per
// (b, kv head, 16 keys) looping over the group's heads and the q tiles
// that see its keys; flash_bwd_dq, one block per (b, h, 32 q rows).
// Every product in fp32 on the CUDA cores, so fp32 holds the 2e-5 / 1e-4
// tolerances that TF32 would not.
//
// A launch allocates nothing (the wrapper passes the scratch: delta and
// the dK/dV partials) and returns a CUDA error code.

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma tiles fed by TMA
// ---------------------------------------------------------------------------

namespace fa {

using namespace hopper;

constexpr int kRows = 64;          // rows of a warpgroup's tile; keys a tile
constexpr int kBoxBytes = 64 * 64 * 2;   // one 64 x 64 bf16 box: 8 KB
constexpr int kConsumers = 2;      // consumer warpgroups (forward, dK/dV)

struct TcArgs {
  int B, H, KV, Sq, Sk;
  float scale, logit_cap;
  int causal, window;
  float* lse;            // (B, H, Sq) fp32: written by the forward (or
                         // null), read by the backward
  const float* delta;    // (B, H, Sq) fp32, backward
  float* part;           // (2, splits, B KV Sk D) fp32 dK / dV partials
  int splits;            // head splits of the dK/dV kernel
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
};

// Shared-memory plan of each kernel for head_dim D: a 64-row tile of Q, K,
// V or dO is D / 64 boxes of 64 rows x 128 B (box c at c * 8 KB), 128-byte
// swizzled, so one tile serves as a K-major operand (rows along M or N,
// D along K) and as an MN-major one (D along N, rows along K).
template <int D>
struct Plan {
  static constexpr int kTile = kRows * D * 2;
  // 2 stages at D 256 (the 227 KB cap), else 4
  static constexpr int kStages = D == 256 ? 2 : 4;
  // forward: Q (128 rows) + a ring of K, V tiles
  static constexpr int kFwdSmem =
      1024 + 2 * kTile + kStages * 2 * kTile + 8 * (1 + 2 * kStages);
  // dK/dV: K, V + a ring of Q, dO tiles + the shared P^T (64 x 64 fp32)
  static constexpr int kPf = kRows * kRows * 4;
  static constexpr int kDkdvSmem =
      1024 + 2 * kTile + kStages * 2 * kTile + kPf + 8 * (1 + 2 * kStages);
  // dQ: Q, dO + a ring of K, V tiles
  static constexpr int kDqSmem = kFwdSmem;
};
static_assert(Plan<256>::kDkdvSmem <= 232448, "shared memory");

// Is key kp visible to query qp (top-left causal alignment, window, Sk)?
__device__ __forceinline__ bool visible(const TcArgs& p, int qp, int kp) {
  bool ok = kp < p.Sk && qp < p.Sq;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  return ok;
}

// The scaled, soft-capped score of a raw product; *fac its derivative.
__device__ __forceinline__ float score(const TcArgs& p, float dot,
                                       float* fac) {
  float s = dot * p.scale;
  float f = p.scale;
  if (p.logit_cap > 0.f) {
    s = p.logit_cap * tanhf(s / p.logit_cap);
    const float t = s / p.logit_cap;
    f *= 1.f - t * t;
  }
  *fac = f;
  return s;
}

// acc (64 x 64) = A (64 rows x D) . B (64 rows x D)^T, both K-major tiles.
template <int D>
__device__ __forceinline__ void product_nt(float (&acc)[32], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma<0, 0>(acc, desc(a + off, 16, 1024), desc(b + off, 16, 1024));
  }
}

// acc (64 x D) += A (64 x 64, the bf16 fragments of a product tile) . B,
// B a 64-row tile read MN-major (64 along K, D along N).
template <int D>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2],
                                           const float (&a)[32], uint32_t b) {
  uint32_t f[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) pack_a(a, k, f[k]);
#pragma unroll
  for (int k = 0; k < 4; ++k) fence_regs(f[k]);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_rs<1>(acc, f[k][0], f[k][1], f[k][2], f[k][3],
                desc(b + k * 2048, kBoxBytes, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

__device__ __forceinline__ void mbar_setup(uint32_t bars, int stages,
                                           int empty_count) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);                              // the block's fixed tiles
    for (int i = 0; i < stages; ++i) {
      mbar_init(bars + 8 + 8 * i, 1);                // full
      mbar_init(bars + 8 + 8 * (stages + i), empty_count);   // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Loads one tile (D / 64 boxes, `box` bytes apart) of a 3-d map at
// (row, head).
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int row, int head,
                                          int box = kBoxBytes) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load3(dst + c * box, m, bar, c * 64, row, head);
}

// ---- forward ---------------------------------------------------------------

// One block per (b, h, 128-row q tile), the heaviest causal tiles first.
// Warpgroups 0 and 1 own 64 q rows each; warpgroup 2 loads Q once and
// streams K and V tiles of 64 keys through the ring with TMA.
template <int D>
__global__ void __launch_bounds__(128 * (kConsumers + 1), 1)
flash_tc_fwd(const __grid_constant__ CUtensorMap mq,
             const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv,
             const __grid_constant__ CUtensorMap mo, const TcArgs p) {
  using P = Plan<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;                          // 128 rows of Q
  const uint32_t ring = base + 2 * P::kTile;
  const uint32_t bars = ring + P::kStages * 2 * P::kTile;
  const uint32_t full = bars + 8, empty = full + 8 * P::kStages;
  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.x, h = bh % p.H, b = bh / p.H;
  const int bkv = b * p.KV + h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 2 * kRows;
  const int nk = (p.Sk + kRows - 1) / kRows;
  const int kt_end = p.causal ? min(nk, (q0 + 2 * kRows - 1) / kRows + 1) : nk;
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / kRows : 0;

  mbar_setup(bars, P::kStages, kConsumers);
  if (wg == kConsumers) {              // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bars, 2 * P::kTile);
      load_tile<D>(sq, &mq, bars, q0, bh, 2 * kBoxBytes);  // 128-row boxes
      int s = 0;
      uint32_t ph = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t st = ring + s * 2 * P::kTile;
        mbar_expect_tx(full + 8 * s, 2 * P::kTile);
        load_tile<D>(st, &mk, full + 8 * s, kt * kRows, bkv);
        load_tile<D>(st + P::kTile, &mv, full + 8 * s, kt * kRows, bkv);
        if (++s == P::kStages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int r0 = q0 + wg * kRows;      // this warpgroup's first row
  // its rows of Q: box c of the 128-row tile is 16 KB, its half 8 KB on
  const uint32_t qa = sq + wg * kRows * 128;
  int row[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = r0 + frag_row(i);
    m[i] = kNegInf;
    l[i] = 0.f;              // this thread's columns; the row's at the end
  }
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  mbar_wait(bars, 0);

  int s = 0;
  uint32_t ph = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kRows;
    mbar_wait(full + 8 * s, ph);
    const uint32_t kb = ring + s * 2 * P::kTile, vb = kb + P::kTile;
    // does a row of this warpgroup see a key of the tile; must it mask?
    const bool seen = r0 < p.Sq && (!p.causal || k0 <= r0 + kRows - 1) &&
                      (p.window <= 0 || k0 + kRows - 1 > r0 - p.window);
    if (seen) {
      const bool edge = (p.causal && k0 + kRows - 1 > r0) ||
                        (p.window > 0 && k0 <= r0 + kRows - 1 - p.window) ||
                        k0 + kRows > p.Sk;
      float sc[32];
      // S = Q K^T (Q's 128-row boxes are 16 KB apart)
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      fence_acc(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma<0, 0>(sc, desc(qa + (kk / 4) * 2 * kBoxBytes + off, 16, 1024),
                    desc(kb + (kk / 4) * kBoxBytes + off, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);

      // online softmax in the accumulator's registers; a row's four
      // threads agree on its max through two shuffles
      float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * j + 2 * i + c];
            float f;
            x = score(p, x, &f);
            if (edge && !visible(p, row[i], k0 + frag_col(j) + c))
              x = kNegInf;
            tmax[i] = fmaxf(tmax[i], x);
          }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
        const float mn = fmaxf(m[i], tmax[i]);
        corr[i] = fast_exp(m[i] - mn);
        m[i] = mn;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * j + 2 * i + c];
            x = fast_exp(x - m[i]);
            l[i] += x;
          }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * j + 2 * i] *= corr[i];
          o[4 * j + 2 * i + 1] *= corr[i];
        }
      // O += P V: P rounded to bf16 in registers (the RS form), V MN-major
      product_rs<D>(o, sc, vb);
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * s);
    if (++s == P::kStages) { s = 0; ph ^= 1; }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
    if (p.lse != nullptr && threadIdx.x % 4 == 0 && row[i] < p.Sq)
      p.lse[(size_t)bh * p.Sq + row[i]] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
  // O in bf16 through this warpgroup's (now free) rows of Q, in the
  // swizzled layout the map stores, then one TMA store a box; the 3-d map
  // drops rows past Sq
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = frag_row(i);
      const uint32_t at = qa + (j / 8) * 2 * kBoxBytes + r * 128 +
                          (((j % 8) ^ (r % 8)) << 4) + 4 * (threadIdx.x % 4);
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(at),
                   "r"(bf16x2(o[4 * j + 2 * i] * inv[i],
                              o[4 * j + 2 * i + 1] * inv[i]))
                   : "memory");
    }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  wg_sync(wg);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      tma_store3(&mo, qa + c * 2 * kBoxBytes, c * 64, r0, bh);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// ---- backward: dK and dV ------------------------------------------------

// One block per (b * KV + kv head, head split, 64-key tile), the key
// tiles that most q tiles see first.  It walks the q tiles of the heads of its
// split that can see its keys; warpgroup 2 keeps K and V and streams Q
// and dO tiles.  Per tile, warpgroup 0 forms S^T = K Q^T and
// P^T = exp(S^T - lse), hands P^T times ds/d(q.k) to warpgroup 1 through
// shared memory and adds P^T dO to dV; warpgroup 1 forms dP^T = V dO^T,
// dS^T = P^T (dP^T - delta) fac and adds dS^T Q to dK.  With one split
// dK and dV go out in bf16; with more, each split writes fp32 partials
// that flash_tc_combine adds in split order.
template <int D>
__global__ void __launch_bounds__(128 * (kConsumers + 1), 1)
flash_tc_dkdv(const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv,
              const __grid_constant__ CUtensorMap mdo, const TcArgs p) {
  using P = Plan<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t ks = base, vs = base + P::kTile;
  const uint32_t ring = base + 2 * P::kTile;
  const uint32_t pf = ring + P::kStages * 2 * P::kTile;
  float4* pfp = reinterpret_cast<float4*>(smem_raw + (pf - raw));
  const uint32_t bars = pf + P::kPf;
  const uint32_t full = bars + 8, empty = full + 8 * P::kStages;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int bkv = blockIdx.x, split = blockIdx.y;
  const int k0 = blockIdx.z * kRows;
  const int b = bkv / p.KV, kvh = bkv % p.KV, G = p.H / p.KV;
  const int g0 = split * G / p.splits, g1 = (split + 1) * G / p.splits;
  const int nq = (p.Sq + kRows - 1) / kRows;
  const int qt_begin = p.causal ? k0 / kRows : 0;
  const int qt_end =
      p.window > 0 ? min(nq, (k0 + kRows - 2 + p.window) / kRows + 1) : nq;
  const int nqt = max(0, qt_end - qt_begin);
  const int ntiles = (g1 - g0) * nqt;

  mbar_setup(bars, P::kStages, kConsumers);
  if (wg == kConsumers) {              // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bars, 2 * P::kTile);
      load_tile<D>(ks, &mk, bars, k0, bkv);
      load_tile<D>(vs, &mv, bars, k0, bkv);
      int s = 0;
      uint32_t ph = 0;
      for (int it = 0; it < ntiles; ++it) {
        const int hq = b * p.H + kvh * G + g0 + it / nqt;
        const int q0 = (qt_begin + it % nqt) * kRows;
        mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t st = ring + s * 2 * P::kTile;
        mbar_expect_tx(full + 8 * s, 2 * P::kTile);
        load_tile<D>(st, &mq, full + 8 * s, q0, hq);
        load_tile<D>(st + P::kTile, &mdo, full + 8 * s, q0, hq);
        if (++s == P::kStages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = k0 + frag_row(i);
  float acc[D / 2];                    // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(bars, 0);

  int s = 0;
  uint32_t ph = 0;
  for (int it = 0; it < ntiles; ++it) {
    const int hq = b * p.H + kvh * G + g0 + it / nqt;
    const int q0 = (qt_begin + it % nqt) * kRows;
    const float* rowstat = (wg == 0 ? p.lse : p.delta) + (size_t)hq * p.Sq;
    mbar_wait(full + 8 * s, ph);
    const uint32_t qs = ring + s * 2 * P::kTile, dos = qs + P::kTile;
    float tt[32];
    if (wg == 0) {
      product_nt<D>(tt, ks, qs);       // S^T = K Q^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(tt);
      if (it > 0) named_sync(4, 256);  // warpgroup 1 has read the last P^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pfv[4];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int q = q0 + frag_col(j) + c;
          const float lse = q < p.Sq ? rowstat[q] : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float& x = tt[4 * j + 2 * i + c];
            float f;
            const float sc = score(p, x, &f);
            x = visible(p, q, key[i]) ? fast_exp(sc - lse) : 0.f;
            pfv[2 * i + c] = x * f;
          }
        }
        pfp[j * 128 + t] = make_float4(pfv[0], pfv[1], pfv[2], pfv[3]);
      }
      named_arrive(3, 256);
      product_rs<D>(acc, tt, dos);     // dV += P^T dO
    } else {
      product_nt<D>(tt, vs, dos);      // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(tt);
      named_sync(3, 256);              // P^T fac is in shared memory
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pv = pfp[j * 128 + t];
        const float pfv[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int q = q0 + frag_col(j) + c;
          const float dl = q < p.Sq ? rowstat[q] : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float& x = tt[4 * j + 2 * i + c];
            x = pfv[2 * i + c] * (x - dl);
          }
        }
      }
      if (it + 1 < ntiles) named_arrive(4, 256);
      product_rs<D>(acc, tt, qs);      // dK += dS^T Q
    }
    if (t == 0) mbar_arrive(empty + 8 * s);
    if (++s == P::kStages) { s = 0; ph ^= 1; }
  }

  // rows past Sk are dropped; every other row is written (zeros when no
  // q tile sees it)
  const size_t n = (size_t)p.B * p.KV * p.Sk * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= p.Sk) continue;
    const size_t at0 = ((size_t)bkv * p.Sk + key[i]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = at0 + frag_col(j);
      const float x = acc[4 * j + 2 * i], y = acc[4 * j + 2 * i + 1];
      if (p.splits == 1) {
        __nv_bfloat16* out = wg == 0 ? p.dv : p.dk;
        *reinterpret_cast<__nv_bfloat162*>(out + at) =
            __floats2bfloat162_rn(x, y);
      } else {
        float* part = p.part + ((size_t)(wg == 0) * p.splits + split) * n;
        *reinterpret_cast<float2*>(part + at) = make_float2(x, y);
      }
    }
  }
}

// dK (part[0]) and dV (part[1]) as the sum of the splits' partials, in
// split order; n = B KV Sk D elements each, two a thread.
__global__ void flash_tc_combine(const float* __restrict__ part, int splits,
                                 long long n, __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv) {
  const long long i = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    float x = 0.f, y = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float2 v =
          *reinterpret_cast<const float2*>(part + (w * splits + s) * n + i);
      x += v.x;
      y += v.y;
    }
    *reinterpret_cast<__nv_bfloat162*>((w == 0 ? dk : dv) + i) =
        __floats2bfloat162_rn(x, y);
  }
}

// ---- backward: dQ --------------------------------------------------------

// One block per (b, h, 64-row q tile), the heaviest causal tiles first:
// one consumer warpgroup (which needs no more than the 255 registers a
// 256-thread block allows) and one producer warpgroup that loads Q and dO
// once and streams K and V tiles.  Per key tile: S = Q K^T and
// dP = dO V^T, dS = P (dP - delta) fac, dQ += dS K with K MN-major.
template <int D>
__global__ void __launch_bounds__(256, 1)
flash_tc_dq(const __grid_constant__ CUtensorMap mq,
            const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv,
            const __grid_constant__ CUtensorMap mdo, const TcArgs p) {
  using P = Plan<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qs = base, dos = base + P::kTile;
  const uint32_t ring = base + 2 * P::kTile;
  const uint32_t bars = ring + P::kStages * 2 * P::kTile;
  const uint32_t full = bars + 8, empty = full + 8 * P::kStages;
  const int bh = blockIdx.x, h = bh % p.H, b = bh / p.H;
  const int bkv = b * p.KV + h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int nk = (p.Sk + kRows - 1) / kRows;
  const int kt_end = p.causal ? min(nk, (q0 + kRows - 1) / kRows + 1) : nk;
  const int kt_begin = p.window > 0 ? max(0, q0 - p.window + 1) / kRows : 0;

  mbar_setup(bars, P::kStages, 1);
  if (threadIdx.x >= 128) {            // producer
    if (threadIdx.x == 128) {
      mbar_expect_tx(bars, 2 * P::kTile);
      load_tile<D>(qs, &mq, bars, q0, bh);
      load_tile<D>(dos, &mdo, bars, q0, bh);
      int s = 0;
      uint32_t ph = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t st = ring + s * 2 * P::kTile;
        mbar_expect_tx(full + 8 * s, 2 * P::kTile);
        load_tile<D>(st, &mk, full + 8 * s, kt * kRows, bkv);
        load_tile<D>(st + P::kTile, &mv, full + 8 * s, kt * kRows, bkv);
        if (++s == P::kStages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  int row[2];
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + frag_row(i);
    const bool in = row[i] < p.Sq;
    lse[i] = in ? p.lse[(size_t)bh * p.Sq + row[i]] : 0.f;
    dl[i] = in ? p.delta[(size_t)bh * p.Sq + row[i]] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(bars, 0);

  int s = 0;
  uint32_t ph = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kRows;
    mbar_wait(full + 8 * s, ph);
    const uint32_t kb = ring + s * 2 * P::kTile, vb = kb + P::kTile;
    float sc[32], dp[32];
    product_nt<D>(sc, qs, kb);         // S = Q K^T
    product_nt<D>(dp, dos, vb);        // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float f;
          const float x = score(p, sc[e], &f);
          const float pr = visible(p, row[i], k0 + frag_col(j) + c)
                               ? fast_exp(x - lse[i])
                               : 0.f;
          sc[e] = pr * (dp[e] - dl[i]) * f;
        }
    product_rs<D>(dq, sc, kb);         // dQ += dS K
    if (threadIdx.x == 0) mbar_arrive(empty + 8 * s);
    if (++s == P::kStages) { s = 0; ph ^= 1; }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.Sq) continue;
    __nv_bfloat16* out = p.dq + ((size_t)bh * p.Sq + row[i]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + frag_col(j)) =
          __floats2bfloat162_rn(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
  }
}

// ---- host ----------------------------------------------------------------

constexpr int kBadMap = (int)cudaErrorInvalidValue;

// A (heads, rows, D) bf16 tensor read or written in 64 x box_rows boxes.
bool make_map(CUtensorMap* map, const void* base, int D, int rows,
              int heads, int box_rows) {
  const long long dims[3] = {D, rows, heads};
  return make_map_bf16(map, base, 3, dims, box_rows);
}

template <typename K, typename... Maps>
int launch(K kernel, dim3 grid, int threads, int smem, const TcArgs& p,
           cudaStream_t st, const Maps&... maps) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, st>>>(maps..., p);
  return (int)cudaGetLastError();
}

template <int D>
int fwd(const Params& a, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, a.q, D, a.Sq, a.B * a.H, 2 * kRows) ||
      !make_map(&mk, a.k, D, a.Sk, a.B * a.KV, kRows) ||
      !make_map(&mv, a.v, D, a.Sk, a.B * a.KV, kRows) ||
      !make_map(&mo, a.o, D, a.Sq, a.B * a.H, kRows))
    return kBadMap;
  TcArgs p{};
  p.B = a.B;
  p.H = a.H;
  p.KV = a.KV;
  p.Sq = a.Sq;
  p.Sk = a.Sk;
  p.scale = a.scale;
  p.logit_cap = a.logit_cap;
  p.causal = a.causal;
  p.window = a.window;
  p.lse = a.lse;
  const dim3 grid(a.B * a.H, (a.Sq + 2 * kRows - 1) / (2 * kRows));
  return launch(flash_tc_fwd<D>, grid, 128 * (kConsumers + 1),
                Plan<D>::kFwdSmem, p, st, mq, mk, mv, mo);
}

template <int D>
int bwd(const BwdParams& q, float* part, int splits, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q.q, D, q.Sq, q.B * q.H, kRows) ||
      !make_map(&mk, q.k, D, q.Sk, q.B * q.KV, kRows) ||
      !make_map(&mv, q.v, D, q.Sk, q.B * q.KV, kRows) ||
      !make_map(&mdo, q.dout, D, q.Sq, q.B * q.H, kRows))
    return kBadMap;
  const long long rows = (long long)q.B * q.H * q.Sq;
  flash_bwd_delta<__nv_bfloat16>
      <<<(unsigned)((rows + 3) / 4), 128, 0, st>>>(q);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  TcArgs p{};
  p.B = q.B;
  p.H = q.H;
  p.KV = q.KV;
  p.Sq = q.Sq;
  p.Sk = q.Sk;
  p.scale = q.scale;
  p.logit_cap = q.logit_cap;
  p.causal = q.causal;
  p.window = q.window;
  p.lse = const_cast<float*>(q.lse);
  p.delta = q.delta;
  p.part = part;
  p.splits = splits;
  p.dq = static_cast<__nv_bfloat16*>(q.dq);
  p.dk = static_cast<__nv_bfloat16*>(q.dk);
  p.dv = static_cast<__nv_bfloat16*>(q.dv);
  const int nk = (q.Sk + kRows - 1) / kRows;
  e = launch(flash_tc_dkdv<D>, dim3(q.B * q.KV, splits, nk),
             128 * (kConsumers + 1), Plan<D>::kDkdvSmem, p, st, mq, mk, mv,
             mdo);
  if (e != 0) return e;
  if (splits > 1) {
    const long long n = (long long)q.B * q.KV * q.Sk * D;
    flash_tc_combine<<<(unsigned)((n / 2 + 255) / 256), 256, 0, st>>>(
        part, splits, n, p.dk, p.dv);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  const dim3 grid(q.B * q.H, (q.Sq + kRows - 1) / kRows);
  return launch(flash_tc_dq<D>, grid, 256, Plan<D>::kDqSmem, p, st, mq, mk,
                mv, mdo);
}

}  // namespace fa

}  // namespace

// `lse` may be null (no gradient wanted); otherwise (B, H, Sq) fp32.
// tc = 1: the tensor-core kernels (bf16, D 64 / 128 / 256 only).
extern "C" int flash_attention_launch(void* o, void* lse, const void* q,
                                      const void* k, const void* v, int B,
                                      int H, int KV, int Sq, int Sk, int D,
                                      float scale, int causal, int window,
                                      float logit_cap, int dtype, int tc,
                                      void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Params p{q, k, v, o, static_cast<float*>(lse), B, H, KV, Sq, Sk, D,
                 scale, logit_cap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (dtype != kBFloat16 || Sk == 0) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 64: return fa::fwd<64>(p, st);
      case 128: return fa::fwd<128>(p, st);
      case 256: return fa::fwd<256>(p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (dtype) {
    case kFloat32: return launch_d<float>(p, st);
    case kBFloat16: return launch_d<__nv_bfloat16>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dq (B,H,Sq,D), dk and dv (B,KV,Sk,D) in the inputs' type; lse and the
// scratch delta (B,H,Sq) fp32.  tc = 1: the tensor-core kernels, with
// `splits` head splits of the dK/dV kernel and, when splits > 1, the
// scratch `part` of 2 x splits x B x KV x Sk x D fp32.
extern "C" int flash_attention_bwd_launch(
    void* dq, void* dk, void* dv, void* delta, void* part, const void* q,
    const void* k, const void* v, const void* o, const void* lse,
    const void* dout, int B, int H, int KV, int Sq, int Sk, int D,
    float scale, int causal, int window, float logit_cap, int dtype, int tc,
    int splits, void* stream) {
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return 0;
  const BwdParams p{q, k, v, o, dout, static_cast<const float*>(lse),
                    static_cast<float*>(delta), dq, dk, dv, B, H, KV, Sq, Sk,
                    D, scale, logit_cap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (dtype != kBFloat16 || splits < 1 || splits > H / KV ||
        (splits > 1 && part == nullptr))
      return (int)cudaErrorInvalidValue;
    float* pt = static_cast<float*>(part);
    switch (D) {
      case 64: return fa::bwd<64>(p, pt, splits, st);
      case 128: return fa::bwd<128>(p, pt, splits, st);
      case 256: return fa::bwd<256>(p, pt, splits, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (dtype) {
    case kFloat32: return launch_bwd_d<float>(p, st);
    case kBFloat16: return launch_bwd_d<__nv_bfloat16>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
