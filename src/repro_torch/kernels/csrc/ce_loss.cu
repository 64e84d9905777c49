// Fused cross-entropy (forward and backward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ce_loss.py::ce_loss (body
// `_kernel`): per token t, the logits x[t] . W[v] in fp32 for every vocab
// row v, an online log-sum-exp over vocab tiles with padded vocab masked
// to the finite NEG_INF = -2**30, l clamped at 1e-30, and the gold logit
// gathered where v == label[t]; loss[t] = logZ[t] - gold[t].  The (T, V)
// logits never reach device memory in fp32.  The forward also writes
// logZ (T,) fp32 for the backward, which the TPU kernel does not have:
// there the JAX package trains through its plain path.  The backward
// forms P = g[t] (exp(logit - logZ[t]) - onehot(label[t])) and gives
// dx = P W in x's type and dW = P^T x in the table's type.  No atomics:
// every output element is summed by one block in a fixed order, so two
// runs are bitwise equal.
//
// Bound: operations.  2 T V d for the forward and 6 T V d for the
// backward (one recompute and two products) against T d + V d inputs:
// ~2,000 operations a byte at gemma-2b's training shape (T 2040,
// V 256000, d 2048), far above the card's ~295.
//
// bf16 (every main path): one tile engine on the tensor cores.  A block
// has two consumer warpgroups of 64 output rows and one producer
// warpgroup, one thread of which keeps a ring of stages full with TMA
// (each stage a 128 x 64 A tile and an N x 64 B tile, 128-byte swizzle;
// completion on mbarriers).  Each consumer runs wgmma.m64nNk16 (bf16 x
// bf16 -> fp32 in registers, N / 2 a thread) over the stages and
// releases each stage once the next one's products are issued.  N is 256
// (4 stages, 48 KB each; setmaxnreg gives the consumers 232 registers and
// the producer 40), or 128 for dx when 256-wide tiles would not fill one
// wave (5 stages of 32 KB).  The engine reads three operand layouts
// without a transposed copy, through wgmma's transpose bits:
//   * NT, S = x W^T: both K-major (rows along d);
//   * TN, dW = P^T x: K = T, both MN-major;
//   * NN, dx = P W: K = V, P K-major, W MN-major.
// The forward (ce_tc_fwd) gives each block a tile of 128 tokens and one of
// `splits` contiguous ranges of 256-row vocab tiles (the wrapper picks
// ~4 waves of blocks), walks its tiles with NT products over d, and keeps
// each row's running (max, sum, gold) in the accumulator's own registers;
// the four threads that share a row combine once at the end, and each
// (row, split) partial goes to (T, splits, 3).  ce_combine adds the
// splits in order into loss and logZ.  The backward walks the vocab in
// chunks of `chunk` rows (the wrapper bounds the bf16 P scratch) and runs,
// per chunk, in order on the stream: ce_tc_p (NT; P_c rounded to bf16
// into a (T, chunk) scratch, 0 past V), ce_tc_dw (TN; dW_c written once)
// and ce_tc_dx (NN; added to an fp32 (T, d) sum in chunk order, written
// in x's type by the last chunk).  The logits are computed once.  P and
// dW tiles leave through a swizzled shared-memory tile and a TMA store,
// so the next tile's products start while the store drains.  Blocks of
// the forward, P and dW walk several output tiles each (~4 waves of
// blocks), so the ring is refilled while a tile's epilogue runs.  TMA
// zero-fills reads past every edge (T, V, d, the chunk) and clips stores
// there; the epilogues mask logits past V to NEG_INF and P past V to 0.
// Needs d % 8 == 0 and 16-byte-aligned bases (TMA's stride rule).  The
// Hopper building blocks (mbarriers, TMA, the wgmma descriptor and
// products) come from hopper.cuh, shared with flash_attention.cu.
//
// fp32 (the parity checks only): the first, CUDA-core kernels, kept as
// they were: ce_fwd (a block of 16 token rows streams the vocab) and
// ce_bwd<kDW> (dx over token tiles, dW over vocab tiles, each recomputing
// the logits), fp32 products summed in fp32, so they hold the 2e-5
// forward tolerance that TF32 tensor cores would not.
//
// A launch allocates nothing (the wrapper passes the partials, the P
// scratch and the dx sum) and returns a CUDA error code.

#include "hopper.cuh"

using namespace repro_torch;

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA-core kernels
// ---------------------------------------------------------------------------


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


// ---------------------------------------------------------------------------
// bf16: one tensor-core tile engine (TMA ring + wgmma), four epilogues
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BM = 128;            // output rows a block: two warpgroups of 64
constexpr int BK = 64;             // depth a stage: 64 bf16 = one 128 B row
constexpr int kConsumers = 2;      // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);   // + one producer warpgroup
constexpr int kHalf = 64 * BK * 2;                 // one 64 x 64 bf16 box: 8 KB
constexpr int kStageOut = 4 * kHalf;   // two warpgroups' 64 x 128 bf16 staging

// A block's output tile is BM x N.  N = 256 halves the bytes each product
// asks of L2 per operation (the 128 x 128 tile needs ~15 TB/s of it at
// full rate).  dx has few tiles (M = T): it takes N = 256 when they fit
// in one wave and N = 128 otherwise.  A stage holds A (128 x 64) and
// B (N x 64).
template <int N>
struct Ring {
  static constexpr int kStageBytes = 2 * kHalf + N * BK * 2;
  static constexpr int kStages = N == 256 ? 4 : 5;
  static constexpr int kSmemBytes =
      kStages * kStageBytes + kStageOut + 1024 + 16 * kStages;
};
static_assert(Ring<256>::kSmemBytes <= 232448, "shared memory");

// The three operand layouts.  K-major: the operand's rows are along M (or
// N) and its contiguous axis is K; MN-major: the contiguous axis is M (N).
enum Layout : int { kNT = 0, kTN = 1, kNN = 2 };
// What a block computes; each kind has its own __global__ entry below.
enum Kind : int { kFwd, kP, kDW, kDX, kProduct };

struct Args {
  int m, n, k;             // product: out (m, n) = sum over k
  int rows, vocab, d;      // T, V, d
  int c0, vc;              // backward: this chunk's first vocab row, width
  int splits;              // ranges of N tiles (forward: vocab splits)
  int first, last;         // dx: first / last chunk
  const int* labels;
  const float* logz;
  const float* g;
  float* part;             // forward: (T, splits, 3) m, l, gold
  __nv_bfloat16* out;      // dx (P and dW are stored through tensor maps)
  float* acc;              // dx: fp32 (T, d) running sum over chunks
  float* out32;            // product: (m, n) fp32
};

__host__ __device__ constexpr Layout layout_of(Kind k, int product) {
  return k == kFwd || k == kP ? kNT
         : k == kDW           ? kTN
         : k == kDX           ? kNN
                              : (Layout)product;
}

__host__ __device__ constexpr int tile_n(Layout l) {
  return l == kNN ? 128 : 256;
}

// The producer: one thread keeps the ring full.  A stage holds A as two
// 64-row (K-major) or 64-column (MN-major) halves and B as N rows or N / 64
// column blocks, each block one 8 KB box, so every stage expects
// kStageBytes.
template <Layout L, int N>
__device__ __forceinline__ void load_stage(
    const CUtensorMap* ma, const CUtensorMap* mb, uint32_t a, uint32_t b,
    uint32_t bar, int am0, int bn0, int k0, int brow0) {
  mbar_expect_tx(bar, Ring<N>::kStageBytes);
  if (L == kTN) {                       // A = P^T: boxes {64 m, 64 k}
    tma_load(a, ma, bar, am0, k0);
    tma_load(a + kHalf, ma, bar, am0 + 64, k0);
  } else {                              // A K-major: box {64 k, 128 m}
    tma_load(a, ma, bar, k0, am0);
  }
  if (L == kNT) {                       // B K-major: box {64 k, N n}
    tma_load(b, mb, bar, k0, brow0 + bn0);
  } else {                              // B MN-major: boxes {64 n, 64 k}
#pragma unroll
    for (int h = 0; h < N / 64; ++h)
      tma_load(b + h * kHalf, mb, bar, bn0 + 64 * h, brow0 + k0);
  }
}

// One output tile's product over `ksteps` stages into this warpgroup's
// 64 x N accumulator.  `s` / `ph` walk the ring (shared by all tiles).
template <Layout L, int N>
__device__ __forceinline__ void mainloop(float (&acc)[N / 2], uint32_t base,
                                         uint32_t full, uint32_t empty,
                                         int wg, int ksteps, int& s,
                                         uint32_t& ph) {
  using R = Ring<N>;
  constexpr int kTA = L == kTN, kTB = L != kNT;
  const bool signal = threadIdx.x % 128 == 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);
  int prev = -1;
  for (int kb = 0; kb < ksteps; ++kb) {
    mbar_wait(full + 8 * s, ph);
    const uint32_t a = base + s * R::kStageBytes + wg * kHalf;
    const uint32_t b = base + s * R::kStageBytes + 2 * kHalf;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // K-major: the next 16 of K are 32 B along the swizzled row;
      // MN-major: 16 rows of 128 B further on.
      const uint64_t da = kTA ? desc(a + kk * 2048, kHalf, 1024)
                              : desc(a + kk * 32, 16, 1024);
      const uint64_t db = kTB ? desc(b + kk * 2048, kHalf, 1024)
                              : desc(b + kk * 32, 16, 1024);
      wgmma<kTA, kTB>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();                    // the previous stage is read
    if (prev >= 0 && signal) mbar_arrive(empty + 8 * prev);
    prev = s;
    if (++s == R::kStages) { s = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (prev >= 0 && signal) mbar_arrive(empty + 8 * prev);
}

// The rows of P a thread holds: label, logZ and upstream gradient.
struct PRows {
  int lbl[2];
  float lz[2], gt[2];
};

// Writes this warpgroup's 64 x N tile in bf16 through shared memory with
// TMA (the tensor map `mo` clips rows and columns past its edges), 128
// columns at a time: two 64-column boxes staged in the 128-byte swizzled
// layout the map stores, so neither the writes nor the store conflict.
// kP: the values are P = g (exp(S - logZ) - onehot), 0 at vocab columns
// v0 + col >= V; otherwise the accumulator itself.
template <bool kP, int A>
__device__ __forceinline__ void store_tile(const CUtensorMap* mo,
                                           uint32_t stage, int wg, int c0,
                                           int c1, const float (&acc)[A],
                                           const PRows& pr, int v0,
                                           int vocab) {
  const bool lead = threadIdx.x % 128 == 0;
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int gq = 0; gq < A / 64; ++gq) {
    // the previous store has read the staging buffer
    if (lead) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    wg_sync(wg);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = frag_row(i);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = 16 * gq + jj;
        float v[2] = {acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]};
        if (kP) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = v0 + frag_col(j) + c;
            v[c] = col < vocab ? pr.gt[i] * (fast_exp(v[c] - pr.lz[i]) -
                                             (col == pr.lbl[i] ? 1.f : 0.f))
                               : 0.f;
          }
        }
        const uint32_t at = stage + (jj / 8) * kHalf + r * 128 +
                            (((jj % 8) ^ (r % 8)) << 4) + 4 * q;
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(at),
                     "r"(bf16x2(v[0], v[1]))
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    wg_sync(wg);
    if (lead) {
      tma_store(mo, stage, c0 + 128 * gq, c1);
      tma_store(mo, stage + kHalf, c0 + 128 * gq + 64, c1);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
}

// N: the output tile's width, 128 or 256 (see Ring).
template <int kKind, int N, int kProductLayout = 0>
__device__ __forceinline__ void tc_body(const CUtensorMap* ma,
                                        const CUtensorMap* mb,
                                        const CUtensorMap* mo,
                                        const Args& p) {
  constexpr Layout L = layout_of((Kind)kKind, kProductLayout);
  constexpr int A = N / 2;
  using R = Ring<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;     // 128B swizzle: 1 KB
  const int wg = threadIdx.x / 128;
  const uint32_t ring_end = base + R::kStages * R::kStageBytes;
  const uint32_t out_stage = ring_end + wg * 2 * kHalf;
  const uint32_t full = ring_end + kStageOut;
  const uint32_t empty = full + 8 * R::kStages;

  // This block's output tiles: (mt, nt) for nt in [nt0, nt1), the
  // split-th of `splits` ranges of the nn tiles along N; the K extent and
  // where B's rows start.  Consecutive blocks share their B tiles
  // (forward, P) or their A tiles (dW, dx, the product) in L2.
  const bool m_on_x = kKind == kFwd || kKind == kP;
  const int mt = m_on_x ? blockIdx.x : blockIdx.y;
  const int split = m_on_x ? blockIdx.y : blockIdx.x;
  const int next = kKind == kFwd       ? p.vocab
                   : kKind == kP       ? p.vc
                   : kKind == kProduct ? p.n
                                       : p.d;
  const int nn = (next + N - 1) / N;
  const int nt0 = (int)((long long)split * nn / p.splits);
  const int nt1 = (int)((long long)(split + 1) * nn / p.splits);
  const int kext = kKind == kFwd || kKind == kP ? p.d
                   : kKind == kDW              ? p.rows
                   : kKind == kDX              ? p.vc
                                               : p.k;
  const int ksteps = (kext + BK - 1) / BK;
  const int brow0 = kKind == kP || kKind == kDX ? p.c0 : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < R::kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The producer needs few registers and the consumers' 64 x 256 fp32
  // accumulators many: move them (40 x 128 + 232 x 256 <= 65,536).  The
  // two paths never rejoin, so the compiler honours the split.
  if (wg == kConsumers) {               // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      int s = 0;
      uint32_t ph = 0;
      for (int nt = nt0; nt < nt1; ++nt)
        for (int kb = 0; kb < ksteps; ++kb) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          const uint32_t a = base + s * R::kStageBytes;
          load_stage<L, N>(ma, mb, a, a + 2 * kHalf, full + 8 * s, mt * BM,
                           nt * N, kb * BK, brow0);
          if (++s == R::kStages) { s = 0; ph ^= 1; }
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  float acc[A];
  int s = 0;
  uint32_t ph = 0;
  const int r0 = mt * BM + wg * 64;     // this warpgroup's first row

  if (kKind == kFwd) {
    // Online log-sum-exp over the split's vocabulary tiles.  Each thread
    // keeps (m, l, gold) for its two rows over its own columns; the four
    // threads of a row are combined once, at the end.
    int lbl[2];
    float m[2], l[2], gold[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + frag_row(i);
      lbl[i] = row < p.rows ? p.labels[row] : -1;
      m[i] = kNegInf;
      l[i] = 0.f;
      gold[i] = 0.f;
    }
    for (int nt = nt0; nt < nt1; ++nt) {
      mainloop<L, N>(acc, base, full, empty, wg, ksteps, s, ph);
      const int v0 = nt * N;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tmax = kNegInf;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int v = v0 + frag_col(j) + c;
            float& x = acc[4 * j + 2 * i + c];
            if (v >= p.vocab) x = kNegInf;
            if (v == lbl[i]) gold[i] += x;
            tmax = fmaxf(tmax, x);
          }
        const float mn = fmaxf(m[i], tmax);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (v0 + frag_col(j) + c < p.vocab)
              sum += fast_exp(acc[4 * j + 2 * i + c] - mn);
        l[i] = l[i] * fast_exp(m[i] - mn) + sum;
        m[i] = mn;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
        const float mn = fmaxf(m[i], mo);
        l[i] = l[i] * fast_exp(m[i] - mn) + lo * fast_exp(mo - mn);
        m[i] = mn;
        gold[i] += __shfl_xor_sync(0xffffffffu, gold[i], off);
      }
      const int row = r0 + frag_row(i);
      if (threadIdx.x % 4 == 0 && row < p.rows) {
        float* o = p.part + ((long long)row * p.splits + split) * 3;
        o[0] = m[i];
        o[1] = l[i];
        o[2] = gold[i];
      }
    }
    return;
  }

  PRows pr{{-1, -1}, {0.f, 0.f}, {0.f, 0.f}};   // P: this thread's rows
  if (kKind == kP) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + frag_row(i);
      if (row < p.rows) {
        pr.lbl[i] = p.labels[row];
        pr.lz[i] = p.logz[row];
        pr.gt[i] = p.g[row];
      }
    }
  }
  for (int nt = nt0; nt < nt1; ++nt) {
    mainloop<L, N>(acc, base, full, empty, wg, ksteps, s, ph);
    const int n0 = nt * N;

    // P (0 past V: the dW and dx products read those columns) and dW
    // leave through TMA, which drops rows past T (P) or V (dW)
    if (kKind == kP) {
      store_tile<true>(mo, out_stage, wg, n0, r0, acc, pr, p.c0 + n0,
                       p.vocab);
      continue;
    }
    if (kKind == kDW) {
      store_tile<false>(mo, out_stage, wg, n0, p.c0 + r0, acc, pr, 0, 0);
      continue;
    }

    // dx and the product: (row, col) pairs; d and n are even, so a pair
    // is in bounds whenever its first column is.
    const int nrows = kKind == kDX ? p.rows : p.m;
    const int ncols = kKind == kProduct ? p.n : p.d;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + frag_row(i);
      if (row >= nrows) continue;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = n0 + frag_col(j);
        if (col >= ncols) continue;
        float2 v = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        const long long at = (long long)row * ncols + col;
        if (kKind == kProduct) {
          *reinterpret_cast<float2*>(p.out32 + at) = v;
          continue;
        }
        if (kKind == kDX && !p.first) {
          const float2 a = *reinterpret_cast<const float2*>(p.acc + at);
          v.x += a.x;
          v.y += a.y;
        }
        if (kKind == kDX && !p.last)
          *reinterpret_cast<float2*>(p.acc + at) = v;
        else
          *reinterpret_cast<__nv_bfloat162*>(p.out + at) =
              __floats2bfloat162_rn(v.x, v.y);
      }
    }
  }
  if ((kKind == kP || kKind == kDW) && threadIdx.x % 128 == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace tc

// The four products of the cross-entropy and the engine alone, each its
// own entry so that a profile names them.
__global__ void __launch_bounds__(tc::kThreads, 1)
ce_tc_fwd(const __grid_constant__ CUtensorMap ma,
          const __grid_constant__ CUtensorMap mb, const tc::Args p) {
  tc::tc_body<tc::kFwd, 256>(&ma, &mb, nullptr, p);
}
__global__ void __launch_bounds__(tc::kThreads, 1)
ce_tc_p(const __grid_constant__ CUtensorMap ma,
        const __grid_constant__ CUtensorMap mb,
        const __grid_constant__ CUtensorMap mo, const tc::Args p) {
  tc::tc_body<tc::kP, 256>(&ma, &mb, &mo, p);
}
__global__ void __launch_bounds__(tc::kThreads, 1)
ce_tc_dw(const __grid_constant__ CUtensorMap ma,
         const __grid_constant__ CUtensorMap mb,
         const __grid_constant__ CUtensorMap mo, const tc::Args p) {
  tc::tc_body<tc::kDW, 256>(&ma, &mb, &mo, p);
}
template <int N>
__global__ void __launch_bounds__(tc::kThreads, 1)
ce_tc_dx(const __grid_constant__ CUtensorMap ma,
         const __grid_constant__ CUtensorMap mb, const tc::Args p) {
  tc::tc_body<tc::kDX, N>(&ma, &mb, nullptr, p);
}
template <int kLayout>
__global__ void __launch_bounds__(tc::kThreads, 1)
ce_tc_product(const __grid_constant__ CUtensorMap ma,
              const __grid_constant__ CUtensorMap mb, const tc::Args p) {
  tc::tc_body<tc::kProduct, tc::tile_n((tc::Layout)kLayout), kLayout>(
      &ma, &mb, nullptr, p);
}

// loss and logZ from the forward's per-split (m, l, gold), splits in
// order: one thread a row.
__global__ void ce_combine(const float* __restrict__ part, int splits,
                           float* __restrict__ loss, float* __restrict__ logz,
                           int rows) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float* q = part + (long long)row * splits * 3;
  float m = kNegInf;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, q[3 * s]);
  float l = 0.f, gold = 0.f;
  for (int s = 0; s < splits; ++s) {
    l += q[3 * s + 1] * tc::fast_exp(q[3 * s] - m);
    gold += q[3 * s + 2];
  }
  const float lz = logf(fmaxf(l, 1e-30f)) + m;
  logz[row] = lz;
  loss[row] = lz - gold;
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches
// ---------------------------------------------------------------------------

// A row-major (outer, inner) bf16 tensor, read in boxes of (box_outer,
// 64) with the 128-byte swizzle wgmma reads; zeros past the edges.
bool make_map(CUtensorMap* map, const void* base, long long inner,
              long long outer, int box_outer) {
  const long long dims[2] = {inner, outer};
  return hopper::make_map_bf16(map, base, 2, dims, box_outer);
}

constexpr int kBadMap = (int)cudaErrorInvalidValue;

// N: the kernel's output tile width.
template <int N, typename K, typename... Maps>
int launch_tc(K kernel, dim3 grid, const tc::Args& p, cudaStream_t st,
              const Maps&... maps) {
  constexpr int smem = tc::Ring<N>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, tc::kThreads, smem, st>>>(maps..., p);
  return (int)cudaGetLastError();
}

int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

// Ranges of N tiles a block walks, so that ~4 waves of blocks of `mtiles`
// M tiles are in flight and each walks at least one tile: a block that
// walks several refills its ring while it finishes a tile.
int sm_count() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

int splits_for(int mtiles, int ntiles) {
  const int s = (4 * sm_count() + mtiles / 2) / mtiles;
  return s < 1 ? 1 : s > ntiles ? ntiles : s;
}

int fwd_bf16(float* loss, float* logz, float* part, const void* x,
             const void* w, const int* labels, int rows, int vocab, int d,
             int splits, cudaStream_t st) {
  CUtensorMap mx, mw;
  if (!make_map(&mx, x, d, rows, 128) || !make_map(&mw, w, d, vocab, 256))
    return kBadMap;
  tc::Args p{};
  p.rows = rows;
  p.vocab = vocab;
  p.d = d;
  p.splits = splits;
  p.labels = labels;
  p.part = part;
  int e = launch_tc<256>(ce_tc_fwd, dim3(cdiv(rows, tc::BM), splits), p, st,
                         mx, mw);
  if (e != 0) return e;
  ce_combine<<<cdiv(rows, 256), 256, 0, st>>>(part, splits, loss, logz, rows);
  return (int)cudaGetLastError();
}

int bwd_bf16(void* dx, void* dw, void* pbuf, float* acc, const void* x,
             const void* w, const int* labels, const float* logz,
             const float* g, int rows, int vocab, int d, int chunk,
             cudaStream_t st) {
  // S = x W_c^T (K-major both), dW_c = P_c^T x (both MN-major; P and dW
  // are stored through MN maps too),
  // dx += P_c W_c (P K-major, W MN-major)
  CUtensorMap x_k, w_k, p_mn, x_mn, p_k, w_mn, dw_mn;
  if (!make_map(&x_k, x, d, rows, 128) || !make_map(&w_k, w, d, vocab, 256) ||
      !make_map(&p_mn, pbuf, chunk, rows, 64) ||
      !make_map(&x_mn, x, d, rows, 64) ||
      !make_map(&p_k, pbuf, chunk, rows, 128) ||
      !make_map(&w_mn, w, d, vocab, 64) ||
      !make_map(&dw_mn, dw, d, vocab, 64))
    return kBadMap;
  tc::Args p{};
  p.rows = rows;
  p.vocab = vocab;
  p.d = d;
  p.labels = labels;
  p.logz = logz;
  p.g = g;
  p.acc = acc;
  p.out = static_cast<__nv_bfloat16*>(dx);
  const int mt = cdiv(rows, tc::BM);
  for (int c0 = 0; c0 < vocab; c0 += chunk) {
    p.c0 = c0;
    p.vc = vocab - c0 < chunk ? vocab - c0 : chunk;
    p.first = c0 == 0;
    p.last = c0 + chunk >= vocab;
    const int vt = cdiv(p.vc, 256);     // P's N tiles
    p.splits = splits_for(mt, vt);
    int e = launch_tc<256>(ce_tc_p, dim3(mt, p.splits), p, st, x_k, w_k,
                           p_mn);
    if (e != 0) return e;
    const int vm = cdiv(p.vc, tc::BM), dt = cdiv(d, 256);   // dW's tiles
    p.splits = splits_for(vm, dt);
    e = launch_tc<256>(ce_tc_dw, dim3(p.splits, vm), p, st, p_mn, x_mn,
                       dw_mn);
    if (e != 0) return e;
    // dx: one tile a block (K = the chunk is long); 128 x 256 tiles when
    // they fit in one wave, else 128 x 128 (at mamba2-2.7b's d 2560,
    // 16 x 10 wide tiles would leave a second wave nearly empty)
    if (mt * cdiv(d, 256) <= sm_count()) {
      p.splits = cdiv(d, 256);
      e = launch_tc<256>(ce_tc_dx<256>, dim3(p.splits, mt), p, st, p_k, w_mn);
    } else {
      p.splits = cdiv(d, 128);
      e = launch_tc<128>(ce_tc_dx<128>, dim3(p.splits, mt), p, st, p_k, w_mn);
    }
    if (e != 0) return e;
  }
  return 0;
}

}  // namespace

extern "C" int ce_loss_fwd_launch(void* loss, void* logz, void* part,
                                  const void* x, const void* w,
                                  const void* labels, int rows, int vocab,
                                  int d, int splits, int dtype, void* stream) {
  if (rows == 0) return 0;
  if (vocab <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(labels);
  float* lo = static_cast<float*>(loss);
  float* lz = static_cast<float*>(logz);
  switch (dtype) {
    case kFloat32:
      ce_fwd<float><<<(unsigned)((rows + OM - 1) / OM), kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w), lb, lo,
          lz, rows, vocab, d);
      return (int)cudaGetLastError();
    case kBFloat16:
      if (d % 8 != 0 || splits < 1 || splits > (vocab + 255) / 256)
        return (int)cudaErrorInvalidValue;
      return fwd_bf16(lo, lz, static_cast<float*>(part), x, w, lb, rows,
                      vocab, d, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ce_loss_bwd_launch(void* dx, void* dw, void* pbuf, void* acc,
                                  const void* x, const void* w,
                                  const void* labels, const void* logz,
                                  const void* g, int rows, int vocab, int d,
                                  int chunk, int dtype, void* stream) {
  if (rows == 0 || vocab == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(labels);
  const float* lz = static_cast<const float*>(logz);
  const float* gg = static_cast<const float*>(g);
  switch (dtype) {
    case kFloat32:
      return launch_bwd_d<float>(dx, dw, x, w, lb, lz, gg, rows, vocab, d, st);
    case kBFloat16:
      if (d % 8 != 0 || chunk <= 0 || chunk % 128 != 0 ||
          (vocab > chunk && acc == nullptr))
        return (int)cudaErrorInvalidValue;
      return bwd_bf16(dx, dw, pbuf, static_cast<float*>(acc), x, w, lb, lz,
                      gg, rows, vocab, d, chunk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tile engine alone, for its tests: out (m, n) fp32 = A B in bf16 with
// layout 0 (NT: a (m, k), b (n, k)), 1 (TN: a (k, m), b (k, n)) or 2 (NN:
// a (m, k), b (k, n)).  m, n, k > 0; k and the contiguous extents % 8 == 0.
extern "C" int ce_tile_product_launch(void* out, const void* a, const void* b,
                                      int m, int n, int k, int layout,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap ma, mb;
  bool ok;
  switch (layout) {
    case tc::kNT:
      ok = make_map(&ma, a, k, m, 128) && make_map(&mb, b, k, n, 256);
      break;
    case tc::kTN:
      ok = make_map(&ma, a, m, k, 64) && make_map(&mb, b, n, k, 64);
      break;
    case tc::kNN:
      ok = make_map(&ma, a, k, m, 128) && make_map(&mb, b, n, k, 64);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (!ok || n % 2 != 0) return kBadMap;
  tc::Args p{};
  p.m = m;
  p.n = n;
  p.k = k;
  p.out32 = static_cast<float*>(out);
  // N tiles as the kernels of each layout take them: 256 (NT, TN), 128 (NN)
  p.splits = cdiv(n, layout == tc::kNN ? 128 : 256);
  const dim3 grid(p.splits, cdiv(m, tc::BM));
  switch (layout) {
    case tc::kNT:
      return launch_tc<256>(ce_tc_product<tc::kNT>, grid, p, st, ma, mb);
    case tc::kTN:
      return launch_tc<256>(ce_tc_product<tc::kTN>, grid, p, st, ma, mb);
    default:
      return launch_tc<128>(ce_tc_product<tc::kNN>, grid, p, st, ma, mb);
  }
}
