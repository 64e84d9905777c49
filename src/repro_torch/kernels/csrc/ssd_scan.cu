// Mamba-2 SSD chunked scan (forward and backward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// `_kernel`).  For one (batch b, head h), with da = dt * a and cum the
// inclusive sum of da within a chunk of L rows:
//   y[l]  = sum_{s <= l} (C[l] . B[s]) exp(cum[l] - cum[s]) dt[s] x[s]
//         + exp(cum[l]) C[l] . state                     (state: P x N)
//   state <- exp(cum[L-1]) state + sum_s exp(cum[L-1] - cum[s]) dt[s] x[s] B[s]^T
// carried across the chunks in order.  Beyond the TPU kernel, which the
// model path wraps in `ssd_chunked`, the forward
//   * writes the final state (B, H, P, N) fp32, which serving's prefill
//     needs, and, when a gradient is wanted, the states at the start of
//     chunks 1 .. nc-1 for the backward;
//   * takes a ragged S: the last chunk is masked, not padded;
//   * takes exp(cum[l] - cum[s]) only where s <= l.  Above the diagonal the
//     exponent is positive and passes fp32's range at mamba2-2.7b's chunk
//     of 256 (dt ~ 0.8, a = -1: cum falls by ~200 a chunk); the JAX
//     reference exponentiates the whole tile and masks afterwards, whose
//     gradient is then 0 * inf = NaN.
// x, B and C are read in their own type (fp32 or bf16) and widened; dt, a,
// every sum and the state are fp32; y is written in x's type.
//
// Design.  The TPU runs the chunk axis of its grid in order and carries the
// state in VMEM scratch; Hopper has no carry between blocks.  So one block
// of 256 threads owns one (b, h) and loops over its chunks, with the P x N
// state (32 KB at P 64, N 128) in shared memory.  Inside a chunk the L x L
// work is tiled 64 query rows by 64 key rows; tiles above the diagonal are
// skipped.  Every product runs on the CUDA cores in fp32: a thread owns a
// 4 x 4 (or 4 x 8) register tile of rows ty + 16 i and columns tx + 16 j,
// and reads its operands from tiles staged in shared memory with odd row
// strides (65, 129 floats), so a tile is read along either axis without
// bank conflicts and stored straight from coalesced global loads.
//
// Bound: bytes at mamba2-2.7b's training shape (B 8, S 256, H 80, P 64,
// N 128, bf16): x, B, C and y move ~126 MB a layer, ~38 us at 3.35 TB/s,
// against ~21 GFLOP, ~22 us at the bf16 tensor-core rate.  This first
// version is simple and right, not fast: fp32 CUDA-core products at one
// block an SM (~135 KB of shared memory forward, ~208 KB backward) make it
// compute-bound far above that; mma/wgmma tiles are later work.
//
// Backward (no TPU counterpart: the JAX package trains through its plain
// path).  Given dy and d(final state) (null: zero), a block walks its
// chunks in reverse, carrying dstate (P x N fp32) in shared memory:
//   key tiles s:   dx = sum_l (G D dt)[l, s] dy[l] + dt[s] F[s],
//                  dB = sum_l (D dt dW)[l, s] C[l] + w[s] dt[s] x[s]^T dstate,
//   query tiles l: dC = sum_s (D dt dW)[l, s] B[s] + exp(cum[l]) dy[l] state,
// with G = C B^T, D the masked decay, dW = dy x^T, w[s] = exp(cum[L-1] -
// cum[s]) and F[s] = w[s] B[s] dstate^T; then d(cum) from every term,
// d(da) its reverse cumulative sum, ddt = (direct dt terms) + a d(da), and
// the chunk's dstate = exp(cum[L-1]) dstate + sum_l exp(cum[l]) dy[l] C[l]^T.
// da[h], a sum over B and S, is written as one partial per (b, h) and
// added over b in a fixed order by a second kernel: no atomics, so runs are
// deterministic.  dB and dC come out per head; the caller sums them over a
// group's heads.  A launch allocates nothing and returns cudaGetLastError().

#include <cstdint>

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int kT = 64;            // rows of a query or key tile
constexpr int kThreads = 256;     // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kMaxP = 64;         // head dim
constexpr int kMaxN = 128;        // state dim
constexpr int kMaxChunk = 256;
constexpr int kSP = kMaxP + 1;    // odd row strides: conflict-free both ways
constexpr int kSN = kMaxN + 1;
constexpr int kST = kT + 1;
constexpr int kWarps = kThreads / 32;

struct Dims {
  int B, S, H, P, N, chunk, nc;
};

// dst[r][c] = src[r * row_stride + c] * (rs ? rs[r] : 1) for r < nrows and
// c < width, and 0 elsewhere in the kT x cols tile.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ds, int cols,
                                          const T* __restrict__ src,
                                          long long row_stride, int nrows,
                                          int width, const float* rs) {
  for (int i = threadIdx.x; i < kT * cols; i += kThreads) {
    const int r = i / cols, c = i - r * cols;
    float v = 0.f;
    if (r < nrows && c < width) {
      v = to_float(src[r * row_stride + c]);
      if (rs != nullptr) v *= rs[r];
    }
    dst[r * ds + c] = v;
  }
}

// acc[i][j] += sum_k A[(ty + 16 i) * ar + k * ak] * B[(tx + 16 j) * br + k * bk]
// over shared-memory operands: a product of two tiles read along either
// axis (the strides pick the transposition).
template <int RI, int RJ>
__device__ __forceinline__ void gemm(float (&acc)[RI][RJ], const float* A,
                                     int ar, int ak, const float* Bm, int br,
                                     int bk, int K) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int k = 0; k < K; ++k) {
    float av[RI], bv[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = A[(ty + 16 * i) * ar + k * ak];
#pragma unroll
    for (int j = 0; j < RJ; ++j) bv[j] = Bm[(tx + 16 * j) * br + k * bk];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Sum over the 16 threads of a row group (same ty, tx = 0..15).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// In place, by warp 0: v[i] = sum_{k <= i} v[k] (reverse: sum_{k >= i}).
template <bool kReverse>
__device__ __forceinline__ void warp_scan(float* v, int len) {
  const int lane = threadIdx.x & 31;
  const int per = (len + 31) / 32;
  const int r0 = lane * per;
  float run = 0.f;
  for (int i = 0; i < per; ++i) {
    const int r = r0 + i;
    if (r < len) {
      const int at = kReverse ? len - 1 - r : r;
      run += v[at];
      v[at] = run;
    }
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += t;
  }
  const float before = inc - run;
  for (int i = 0; i < per; ++i) {
    const int r = r0 + i;
    if (r < len) v[kReverse ? len - 1 - r : r] += before;
  }
}

// Per-(b, h) pointers and strides of the (B, S, H, W) tensors.
struct Head {
  long long sx, sn;    // row strides of x/y (H P) and of B/C (H N)
  long long ox, on, od;  // offsets of row 0 for this (b, h)
  __device__ Head(const Dims& d, int b, int h) {
    sx = (long long)d.H * d.P;
    sn = (long long)d.H * d.N;
    ox = (long long)b * d.S * sx + (long long)h * d.P;
    on = (long long)b * d.S * sn + (long long)h * d.N;
    od = (long long)b * d.S * d.H + h;
  }
};

// Loads dt of the chunk into q, cum = inclusive sum of dt * a, and
// wend = exp(cum[len-1] - cum).  Ends with a barrier.
__device__ __forceinline__ void chunk_decay(float* q, float* cum, float* wend,
                                            const float* dt, long long stride,
                                            int len, float a) {
  for (int i = threadIdx.x; i < len; i += kThreads) {
    q[i] = dt[i * stride];
    cum[i] = q[i] * a;
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_scan<false>(cum, len);
  __syncthreads();
  const float last = cum[len - 1];
  for (int i = threadIdx.x; i < len; i += kThreads) wend[i] = expf(last - cum[i]);
  __syncthreads();
}

constexpr size_t kFwdSmem =
    sizeof(float) * (2 * kT * kSN + kMaxP * kSN + kT * kSP + kT * kST +
                     3 * kMaxChunk);

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(T* __restrict__ y, float* __restrict__ final_state,
               float* __restrict__ states, const T* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ a,
               const T* __restrict__ bm, const T* __restrict__ cm, Dims d) {
  extern __shared__ float sm[];
  float* Cs = sm;                      // [kT][kSN] C, query rows
  float* Bs = Cs + kT * kSN;           // [kT][kSN] B, key rows
  float* st = Bs + kT * kSN;           // [kMaxP][kSN] state (p, n)
  float* xs = st + kMaxP * kSN;        // [kT][kSP] x, key rows
  float* ws = xs + kT * kSP;           // [kT][kST] weights (l, s)
  float* q = ws + kT * kST;            // [kMaxChunk] dt
  float* cum = q + kMaxChunk;          // [kMaxChunk]
  float* wend = cum + kMaxChunk;       // [kMaxChunk] exp(cum[last] - cum)

  const int bh = blockIdx.x, b = bh / d.H, h = bh % d.H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const Head hd(d, b, h);
  const float ah = a[h];
  const long long pn = (long long)d.P * d.N;

  for (int i = threadIdx.x; i < kMaxP * kSN; i += kThreads) st[i] = 0.f;

  for (int c = 0; c < d.nc; ++c) {
    const int c0 = c * d.chunk;
    const int len = min(d.chunk, d.S - c0);
    const int nt = (len + kT - 1) / kT;
    __syncthreads();
    chunk_decay(q, cum, wend, dt + hd.od + (long long)c0 * d.H, d.H, len, ah);

    // 1. outputs, one query tile at a time, from the state at chunk start
    for (int lt = 0; lt < nt; ++lt) {
      const int l0 = lt * kT;
      load_tile(Cs, kSN, kMaxN, cm + hd.on + (long long)(c0 + l0) * hd.sn,
                hd.sn, len - l0, d.N, nullptr);
      __syncthreads();
      float acc[4][4] = {};
      if (c > 0) {
        gemm<4, 4>(acc, Cs, kSN, 1, st, kSN, 1, d.N);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty + 16 * i;
          const float e = l < len ? expf(cum[l]) : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] *= e;
        }
      }
      for (int stile = 0; stile <= lt; ++stile) {
        const int s0 = stile * kT;
        load_tile(Bs, kSN, kMaxN, bm + hd.on + (long long)(c0 + s0) * hd.sn,
                  hd.sn, len - s0, d.N, nullptr);
        load_tile(xs, kSP, kMaxP, x + hd.ox + (long long)(c0 + s0) * hd.sx,
                  hd.sx, len - s0, d.P, nullptr);
        __syncthreads();
        float g[4][4] = {};
        gemm<4, 4>(g, Cs, kSN, 1, Bs, kSN, 1, d.N);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            float w = 0.f;
            if (s <= l && l < len) w = g[i][j] * expf(cum[l] - cum[s]) * q[s];
            ws[(ty + 16 * i) * kST + tx + 16 * j] = w;
          }
        }
        __syncthreads();
        gemm<4, 4>(acc, ws, kST, 1, xs, 1, kSP, kT);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (l < len && p < d.P)
            y[hd.ox + (long long)(c0 + l) * hd.sx + p] = from_float<T>(acc[i][j]);
        }
      }
    }

    // 2. the state at the end of the chunk; thread owns p = ty + 16 i,
    // n = tx + 16 j
    float ns[4][8];
    const float el = expf(cum[len - 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ns[i][j] = st[(ty + 16 * i) * kSN + tx + 16 * j] * el;
    for (int i = threadIdx.x; i < len; i += kThreads) wend[i] *= q[i];
    __syncthreads();
    for (int stile = 0; stile < nt; ++stile) {
      const int s0 = stile * kT;
      load_tile(Bs, kSN, kMaxN, bm + hd.on + (long long)(c0 + s0) * hd.sn,
                hd.sn, len - s0, d.N, nullptr);
      load_tile(xs, kSP, kMaxP, x + hd.ox + (long long)(c0 + s0) * hd.sx,
                hd.sx, len - s0, d.P, wend + s0);
      __syncthreads();
      gemm<4, 8>(ns, xs, 1, kSP, Bs, 1, kSN, kT);
      __syncthreads();
    }
    float* out = c + 1 < d.nc
        ? (states ? states + ((long long)bh * (d.nc - 1) + c) * pn : nullptr)
        : final_state + (long long)bh * pn;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        st[p * kSN + n] = ns[i][j];
        if (out != nullptr && p < d.P && n < d.N) out[p * d.N + n] = ns[i][j];
      }
    }
  }
}

constexpr size_t kBwdSmem =
    sizeof(float) * (2 * kT * kSN + 2 * kMaxP * kSN + 2 * kT * kSP +
                     2 * kT * kST + 7 * kMaxChunk + kWarps * kT);

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(T* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ da_part, T* __restrict__ dbm,
               T* __restrict__ dcm, const T* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ a,
               const T* __restrict__ bm, const T* __restrict__ cm,
               const T* __restrict__ dy, const float* __restrict__ dfinal,
               const float* __restrict__ states, Dims d) {
  extern __shared__ float sm[];
  float* Cs = sm;                      // [kT][kSN] C, query rows
  float* Bs = Cs + kT * kSN;           // [kT][kSN] B, key rows
  float* dst = Bs + kT * kSN;          // [kMaxP][kSN] dstate (p, n)
  float* hst = dst + kMaxP * kSN;      // [kMaxP][kSN] state at chunk start
  float* xs = hst + kMaxP * kSN;       // [kT][kSP] x, key rows
  float* dys = xs + kT * kSP;          // [kT][kSP] dy, query rows
  float* a1 = dys + kT * kSP;          // [kT][kST] G D dt        (l, s)
  float* a2 = a1 + kT * kST;           // [kT][kST] D dt dW       (l, s)
  float* q = a2 + kT * kST;            // [kMaxChunk] dt
  float* cum = q + kMaxChunk;
  float* wend = cum + kMaxChunk;       // exp(cum[last] - cum)
  float* ecum = wend + kMaxChunk;      // exp(cum)
  float* colk = ecum + kMaxChunk;      // sum_l G D dW           (per s)
  float* vv = colk + kMaxChunk;        // w[s] x[s] . (dstate B[s]) (per s)
  float* dplus = vv + kMaxChunk;       // sum_s G D dt dW + R    (per l)
  float* scratch = dplus + kMaxChunk;  // [kWarps][kT]

  const int bh = blockIdx.x, b = bh / d.H, h = bh % d.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const Head hd(d, b, h);
  const float ah = a[h];
  const long long pn = (long long)d.P * d.N;
  float da_acc = 0.f;                  // warp 0, lane 0

  for (int i = tid; i < kMaxP * kSN; i += kThreads) {
    const int p = i / kSN, n = i - p * kSN;
    dst[i] = (dfinal != nullptr && p < d.P && n < d.N)
        ? dfinal[(long long)bh * pn + p * d.N + n] : 0.f;
  }

  for (int c = d.nc - 1; c >= 0; --c) {
    const int c0 = c * d.chunk;
    const int len = min(d.chunk, d.S - c0);
    const int nt = (len + kT - 1) / kT;
    __syncthreads();
    chunk_decay(q, cum, wend, dt + hd.od + (long long)c0 * d.H, d.H, len, ah);
    for (int i = tid; i < len; i += kThreads) {
      ecum[i] = expf(cum[i]);
      colk[i] = 0.f;
    }
    const float* hsrc = c > 0 ? states + ((long long)bh * (d.nc - 1) + c - 1) * pn
                              : nullptr;
    for (int i = tid; i < kMaxP * kSN; i += kThreads) {
      const int p = i / kSN, n = i - p * kSN;
      hst[i] = (hsrc != nullptr && p < d.P && n < d.N) ? hsrc[p * d.N + n] : 0.f;
    }
    const T* xc = x + hd.ox + (long long)c0 * hd.sx;
    const T* dyc = dy + hd.ox + (long long)c0 * hd.sx;
    const T* bc = bm + hd.on + (long long)c0 * hd.sn;
    const T* cc = cm + hd.on + (long long)c0 * hd.sn;

    // 1. key tiles: dx, dB, the direct dt terms
    for (int stile = 0; stile < nt; ++stile) {
      const int s0 = stile * kT;
      __syncthreads();
      load_tile(Bs, kSN, kMaxN, bc + s0 * hd.sn, hd.sn, len - s0, d.N, nullptr);
      load_tile(xs, kSP, kMaxP, xc + s0 * hd.sx, hd.sx, len - s0, d.P, nullptr);
      float dxa[4][4] = {}, dba[4][8] = {};
      for (int lt = stile; lt < nt; ++lt) {
        const int l0 = lt * kT;
        load_tile(Cs, kSN, kMaxN, cc + l0 * hd.sn, hd.sn, len - l0, d.N, nullptr);
        load_tile(dys, kSP, kMaxP, dyc + l0 * hd.sx, hd.sx, len - l0, d.P,
                  nullptr);
        __syncthreads();
        float g[4][4] = {}, dw[4][4] = {}, colp[4] = {};
        gemm<4, 4>(g, Cs, kSN, 1, Bs, kSN, 1, d.N);
        gemm<4, 4>(dw, dys, kSP, 1, xs, kSP, 1, d.P);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            float v1 = 0.f, v2 = 0.f;
            if (s <= l && l < len) {
              const float dd = expf(cum[l] - cum[s]);
              const float gd = g[i][j] * dd;
              v1 = gd * q[s];
              v2 = dd * q[s] * dw[i][j];
              colp[j] += gd * dw[i][j];
            }
            a1[(ty + 16 * i) * kST + tx + 16 * j] = v1;
            a2[(ty + 16 * i) * kST + tx + 16 * j] = v2;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = colp[j] + __shfl_xor_sync(0xffffffffu, colp[j], 16);
          if (lane < 16) scratch[warp * kT + tx + 16 * j] = v;
        }
        __syncthreads();
        if (tid < kT) {
          float sum = 0.f;
          for (int w = 0; w < kWarps; ++w) sum += scratch[w * kT + tid];
          if (s0 + tid < len) colk[s0 + tid] += sum;
        }
        gemm<4, 4>(dxa, a1, 1, kST, dys, 1, kSP, kT);
        gemm<4, 8>(dba, a2, 1, kST, Cs, 1, kSN, kT);
        __syncthreads();
      }
      // the carried dstate: F[s, p] = w[s] B[s] . dstate[p]
      float f[4][4] = {}, e2[4][8] = {};
      gemm<4, 4>(f, Bs, kSN, 1, dst, kSN, 1, d.N);
      gemm<4, 8>(e2, xs, kSP, 1, dst, 1, kSN, d.P);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, s = s0 + r;
        const float we = s < len ? wend[s] : 0.f;
        const float qs = s < len ? q[s] : 0.f;
        float rowv = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float fv = f[i][j] * we;
          rowv += xs[r * kSP + tx + 16 * j] * fv;
          dxa[i][j] += qs * fv;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) dba[i][j] += we * qs * e2[i][j];
        rowv = row_sum16(rowv);
        if (tx == 0 && s < len) vv[s] = rowv;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (s < len && p < d.P)
            dx[hd.ox + (long long)(c0 + s) * hd.sx + p] = from_float<T>(dxa[i][j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          if (s < len && n < d.N)
            dbm[hd.on + (long long)(c0 + s) * hd.sn + n] = from_float<T>(dba[i][j]);
        }
      }
    }

    // 2. query tiles: dC and the d(cum) terms of each query row
    for (int lt = 0; lt < nt; ++lt) {
      const int l0 = lt * kT;
      __syncthreads();
      load_tile(Cs, kSN, kMaxN, cc + l0 * hd.sn, hd.sn, len - l0, d.N, nullptr);
      load_tile(dys, kSP, kMaxP, dyc + l0 * hd.sx, hd.sx, len - l0, d.P, nullptr);
      float dca[4][8] = {}, rt[4] = {};
      for (int stile = 0; stile <= lt; ++stile) {
        const int s0 = stile * kT;
        load_tile(Bs, kSN, kMaxN, bc + s0 * hd.sn, hd.sn, len - s0, d.N, nullptr);
        load_tile(xs, kSP, kMaxP, xc + s0 * hd.sx, hd.sx, len - s0, d.P, nullptr);
        __syncthreads();
        float g[4][4] = {}, dw[4][4] = {};
        gemm<4, 4>(g, Cs, kSN, 1, Bs, kSN, 1, d.N);
        gemm<4, 4>(dw, dys, kSP, 1, xs, kSP, 1, d.P);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            float m = 0.f;
            if (s <= l && l < len) m = expf(cum[l] - cum[s]) * q[s] * dw[i][j];
            rt[i] += g[i][j] * m;
            a2[(ty + 16 * i) * kST + tx + 16 * j] = m;
          }
        }
        __syncthreads();
        gemm<4, 8>(dca, a2, kST, 1, Bs, 1, kSN, kT);
        __syncthreads();
      }
      // the state at chunk start: E[l, n] = exp(cum[l]) dy[l] . state[:, n]
      float e[4][8] = {};
      gemm<4, 8>(e, dys, kSP, 1, hst, 1, kSN, d.P);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, l = l0 + r;
        const float el = l < len ? ecum[l] : 0.f;
        float rv = rt[i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float ev = e[i][j] * el;
          dca[i][j] += ev;
          rv += Cs[r * kSN + tx + 16 * j] * ev;
        }
        rv = row_sum16(rv);
        if (tx == 0 && l < len) dplus[l] = rv;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          if (l < len && n < d.N)
            dcm[hd.on + (long long)(c0 + l) * hd.sn + n] = from_float<T>(dca[i][j]);
        }
      }
    }

    // 3. dstate at chunk start: exp(cum[last]) dstate + sum_l exp(cum[l]) dy[l] C[l]^T;
    // Z = exp(cum[last]) state . dstate
    const float el = expf(cum[len - 1]);
    float nd[4][8], zp = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int at = (ty + 16 * i) * kSN + tx + 16 * j;
        zp += hst[at] * dst[at];
        nd[i][j] = dst[at] * el;
      }
    for (int lt = 0; lt < nt; ++lt) {
      const int l0 = lt * kT;
      __syncthreads();
      load_tile(Cs, kSN, kMaxN, cc + l0 * hd.sn, hd.sn, len - l0, d.N, nullptr);
      load_tile(dys, kSP, kMaxP, dyc + l0 * hd.sx, hd.sx, len - l0, d.P,
                ecum + l0);
      __syncthreads();
      gemm<4, 8>(nd, dys, 1, kSP, Cs, 1, kSN, kT);
    }
    zp = warp_sum(zp);
    if (lane == 0) scratch[warp] = zp;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(ty + 16 * i) * kSN + tx + 16 * j] = nd[i][j];

    // 4. d(cum), d(da) = its reverse cumulative sum, ddt and da (warp 0)
    if (warp == 0) {
      float z = 0.f;
      for (int w = 0; w < kWarps; ++w) z += scratch[w];
      z *= el;
      float uv = 0.f;
      for (int i = lane; i < len; i += 32) {
        uv += q[i] * vv[i];
        dplus[i] -= q[i] * (colk[i] + vv[i]);
      }
      uv = warp_sum(uv);
      __syncwarp();
      if (lane == 0) dplus[len - 1] += z + uv;
      __syncwarp();
      warp_scan<true>(dplus, len);
      __syncwarp();
      float dap = 0.f;
      float* ddtc = ddt + hd.od + (long long)c0 * d.H;
      for (int i = lane; i < len; i += 32) {
        ddtc[(long long)i * d.H] = colk[i] + vv[i] + ah * dplus[i];
        dap += q[i] * dplus[i];
      }
      dap = warp_sum(dap);
      da_acc += dap;
    }
  }
  if (tid == 0) da_part[bh] = da_acc;
}

// da[h] = sum_b part[b * H + h], b in order.
__global__ void head_sum(float* __restrict__ da, const float* __restrict__ part,
                         int B, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[(long long)b * H + h];
  da[h] = s;
}

int check_dims(const Dims& d) {
  if (d.P < 1 || d.P > kMaxP || d.N < 1 || d.N > kMaxN || d.chunk < 1 ||
      d.chunk > kMaxChunk || d.S < 1 || d.B < 1 || d.H < 1 ||
      (long long)d.B * d.H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int launch_fwd(void* y, float* fin, float* states, const void* x,
               const float* dt, const float* a, const void* bm, const void* cm,
               const Dims& d, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_kernel<T><<<d.B * d.H, kThreads, kFwdSmem, stream>>>(
      static_cast<T*>(y), fin, states, static_cast<const T*>(x), dt, a,
      static_cast<const T*>(bm), static_cast<const T*>(cm), d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(void* dx, float* ddt, float* da, float* da_part, void* dbm,
               void* dcm, const void* x, const float* dt, const float* a,
               const void* bm, const void* cm, const void* dy,
               const float* dfinal, const float* states, const Dims& d,
               cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBwdSmem);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_kernel<T><<<d.B * d.H, kThreads, kBwdSmem, stream>>>(
      static_cast<T*>(dx), ddt, da_part, static_cast<T*>(dbm),
      static_cast<T*>(dcm), static_cast<const T*>(x), dt, a,
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(dy), dfinal, states, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  head_sum<<<(d.H + 127) / 128, 128, 0, stream>>>(da, da_part, d.B, d.H);
  return (int)cudaGetLastError();
}

Dims make_dims(int B, int S, int H, int P, int N, int chunk) {
  Dims d{B, S, H, P, N, chunk, 0};
  d.nc = chunk > 0 ? (S + chunk - 1) / chunk : 0;
  return d;
}

}  // namespace

// x, y: (B, S, H, P); dt: (B, S, H) fp32; a: (H,) fp32; bm, cm: (B, S, H, N);
// final_state: (B, H, P, N) fp32; states: null, or (B, H, nc - 1, P, N)
// fp32 for the backward (nc = ceil(S / chunk)).
extern "C" int ssd_scan_launch(void* y, void* final_state, void* states,
                               const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, int B, int S,
                               int H, int P, int N, int chunk, int dtype,
                               void* stream) {
  const Dims d = make_dims(B, S, H, P, N, chunk);
  if (const int bad = check_dims(d)) return bad;
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(a);
  float* fin = static_cast<float*>(final_state);
  float* sts = static_cast<float*>(states);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_fwd<float>(y, fin, sts, x, dtp, ap, bm, cm, d, st);
    case kBFloat16:
      return launch_fwd<__nv_bfloat16>(y, fin, sts, x, dtp, ap, bm, cm, d, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dx, dbm, dcm in the inputs' type; ddt (B, S, H) and da (H,) fp32;
// da_part: (B, H) fp32 scratch; dfinal: null (zero) or (B, H, P, N) fp32;
// states: as the forward wrote them (null when nc == 1).
extern "C" int ssd_scan_bwd_launch(void* dx, void* ddt, void* da,
                                   void* da_part, void* dbm, void* dcm,
                                   const void* x, const void* dt,
                                   const void* a, const void* bm,
                                   const void* cm, const void* dy,
                                   const void* dfinal, const void* states,
                                   int B, int S, int H, int P, int N,
                                   int chunk, int dtype, void* stream) {
  const Dims d = make_dims(B, S, H, P, N, chunk);
  if (const int bad = check_dims(d)) return bad;
  if (d.nc > 1 && states == nullptr) return (int)cudaErrorInvalidValue;
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(a);
  const float* dfp = static_cast<const float*>(dfinal);
  const float* sts = static_cast<const float*>(states);
  float* ddtp = static_cast<float*>(ddt);
  float* dap = static_cast<float*>(da);
  float* part = static_cast<float*>(da_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_bwd<float>(dx, ddtp, dap, part, dbm, dcm, x, dtp, ap, bm,
                               cm, dy, dfp, sts, d, st);
    case kBFloat16:
      return launch_bwd<__nv_bfloat16>(dx, ddtp, dap, part, dbm, dcm, x, dtp,
                                       ap, bm, cm, dy, dfp, sts, d, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
