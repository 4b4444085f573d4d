// The Mamba-2 SSD chunk scan for Hopper (sm_90a), on the tensor cores.
//
// Replaces the JAX package's Pallas kernel
//   src/repro/kernels/ssd/kernel.py  ssd_fwd  (:79, pallas_call :89)
//
// Inputs x (B, S, H, P) in f32 or bf16; dt (B, S, H) >= 0, A (H,) < 0,
// Bm / Cm (B, S, N) (one group) and D (H,), all f32.  Outputs y (B, S, H,
// P) in x's type and the final state h (B, H, N, P) f32.  The sequence is
// cut into chunks of Q <= 128 tokens; per chunk, with cum the inclusive
// cumsum of dt*A over the chunk:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//         + exp(cum_i) C_i . h                                      (inter)
//         + D x_i                                                   (skip)
//   h    <- exp(cum_last) h + sum_j B_j (x) exp(cum_last - cum_j) dt_j x_j
// which is the math of the reference's ssd_chunked.  Rows at or past S
// are the wrapper's padding rule (dt = 0, x = B = C = 0): loaded as
// zeros, never written, so they leave the recurrence unchanged.
//
// What bounds it.  The function's products (per chunk and batch row the
// causal half of C.B^T, per head the state, the inter term and the intra
// product; 2.71 GFLOP at mamba2-1.3b's (B 2, S 512, H 64, P 64, N 128))
// on 39.1 MB it must move: at the tensor cores' TF32 rate (495 TFLOP/s)
// the bytes bind (0.0117 ms); at the f32 rate without tensor cores (67
// TFLOP/s) the operations would (0.0404 ms).  The products run on the
// tensor cores at about f32 accuracy by splitting (as in
// flash_attention.cu): every f32 operand x becomes hi = cvt.rna.tf32(x)
// and lo = cvt.rna.tf32(x - hi), and a.b = hi_a.lo_b + lo_a.hi_b +
// hi_a.hi_b, small terms first; a bf16 x is exact in TF32 and takes two
// products.  The split's own ceiling is three TF32 products per f32
// product (0.0164 ms at 495 TFLOP/s; mma.sync reaches about a third of
// that rate on this card, tools/flash_sweep.py), and those products on
// mma.sync set the kernels' pace.
//
// Design: the Mamba-2 paper's state-passing decomposition (arXiv:2405.21060
// sections 6-7), four launches, no atomics (the same bits on every run):
//  0. ssd_cb_kernel, one CTA per (batch row, chunk, 16 rows, 32 columns):
//     C.B^T once per (batch row, chunk), causal half only, into `cb`
//     (B, nc, Q, Q): every head's scan reads it.  (A launch of its own: in
//     the state launch its CTAs would push that launch past one wave.)
//  1. ssd_state_kernel, one CTA per (batch row, chunk, head, 128 state
//     rows, 64 head-dim columns): the chunk's dt, the cumsum of dt*A in
//     the plain version's order (blocks of 16: the plain version's bits,
//     so the decays are taken of the same exponents; written to `cum` for
//     the later steps),
//     w_j = dt_j exp(cum_last - cum_j), and the chunk's own state
//     S_c = B^T (w x), an (N x Q).(Q x P) product, into `st`
//     (B, nc, H, N, P).
//  2. ssd_pass_kernel, elementwise over (B, H, N*P), sequential over the
//     chunks: st[c] <- h (the state before chunk c, c > 0); h <-
//     exp(cum_last[c]) h + S_c; the final h to h_out.
//  3. ssd_scan_kernel, one CTA per (batch row, chunk, head, 64 columns):
//     y = exp(cum_i) (C . h_prev) + ((C.B^T) o L o dt_j + D I) . x with
//     L_ij = exp(cum_i - cum_j) evaluated only where j <= i (the other half
//     overflows, and inf * 0 would be NaN); the skip D x rides on the
//     intra product's diagonal.  Chunk 0 skips C . h_prev (h_prev = 0).
// Each CTA is 4 warps; a warp owns two 16-row mma tiles (in the scan rows
// 16w and 16(7 - w), so that the causal work is even across the warps)
// and 64 columns, and runs m16n8k8 mma.sync on operands staged by 16-byte
// cp.async copies in a two-stage ring of 32-wide k tiles (27 KB a stage:
// four CTAs an SM).  Shared-memory rows are padded so that both fragment
// patterns read without bank conflicts.  Whole k-steps of 8 rows past S
// (the padding) are skipped, and so are mma row tiles past S and, in the
// intra product, k-steps above the tile's diagonal: they add exact zeros.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int;
// x_dtype 0 = float32, 1 = bfloat16 (x and y).  The wrapper allocates the
// scratch: st (B, nc, H, N, P), cum (B, nc, H, Q), cb (B, nc, Q, Q), f32,
// nc = ceil(S / Q).  Returns the first nonzero cudaGetLastError() after
// a launch, or 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxQ = 128;
constexpr int kCumBlock = 16;          // the cumsum's block (ssd/ref.py)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKC = 32;                // k rows (or columns) per stage
constexpr int kRowsN = 128;            // state rows per state CTA
constexpr int kColsP = 64;             // head-dim columns per CTA
constexpr int kNT = kColsP / 8;        // mma column tiles per warp
// padded tile rows, in elements: ld % 32 == 4 for a tile read along its
// rows (row operand: lanes g, t at g * ld + t), ld % 32 == 8 for one read
// down its columns (lanes at t * ld + g)
constexpr int kLdK = kKC + 4;          // (rows x 32 k): C, C.B^T, B in C.B^T
constexpr int kLdN = kRowsN + 8;       // (32 k x 128 n): B in the state
constexpr int kLdP = kColsP + 8;       // (32 k x 64 p): x, h_prev
constexpr int kTileA = (kMaxQ * kLdK > kKC * kLdN) ? kMaxQ * kLdK : kKC * kLdN;
constexpr int kTileB = kKC * kLdP;
constexpr int kStage = kTileA + kTileB;                  // floats
constexpr size_t kSmem = 2 * kStage * sizeof(float);     // 55,296 B
constexpr int kCbK = 128;              // C.B^T: k (N) per load
constexpr int kLdCb = kCbK + 4;
constexpr size_t kCbSmem = (16 + kKC) * kLdCb * sizeof(float);   // 25,344 B
static_assert(kThreads == kMaxQ, "one thread per chunk row in the cumsum");
static_assert(kKC == 8 * kWarps, "C.B^T: a warp per 8 of the CTA's columns");

struct Params {
  const void* x;
  const float *dt, *A, *Bm, *Cm, *D;
  void* y;
  float *h_out, *st, *cum, *cb;
  int Bsz, S, H, P, N, Q, nc, n_nt, n_pt, n_mt, n_c32;
  // 16-byte cp.async allowed for x, for Bm / Cm, for st and for cb
  bool x_vec, bc_vec, st_vec, cb_vec;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ __forceinline__ int round16(int a) { return cdiv(a, 16) * 16; }

// ---------------------------------------------------------------------------
// Split-TF32 products (the helpers of flash_attention.cu)
// ---------------------------------------------------------------------------

// cvt.rna.tf32.f32 to the bit for every non-NaN x (round to nearest, ties
// away from zero, on the low 13 bits), in two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Tf {
  uint32_t hi, lo;
};

// An operand as (hi, lo) TF32 parts; EXACT: x is a TF32 value (bf16), so
// hi = x and lo is never used.
template <bool EXACT>
__device__ __forceinline__ Tf split(float x) {
  Tf t;
  if constexpr (EXACT) {
    t.hi = __float_as_uint(x);
    t.lo = 0u;
  } else {
    t.hi = tf32_rna(x);
    t.lo = tf32_rna(x - __uint_as_float(t.hi));
  }
  return t;
}

__device__ __forceinline__ void mma_tf32(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b (a 16 x 8, b 8 x 8, mma fragment order) by the split: the
// cross terms first, the hi.hi term last; a term whose small operand is an
// exact part (BE) is 0 and dropped.
template <bool BE>
__device__ __forceinline__ void mma_split(float c[4], const Tf a[4],
                                          const Tf b[2]) {
  if constexpr (!BE)
    mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// ---------------------------------------------------------------------------
// Staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one group (the tile in flight) is pending.
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [0, nr) x columns [0, min(w, round16(cv))) of a tile (row r at
// dst + r * ld) from src (row r at src + r * rs): the element where
// r < rv and column < cv, zero elsewhere.  VEC: 16-byte cp.async copies
// (src and rs in whole chunks; a chunk is copied whole where its first
// column is below cv, so a cv inside a chunk brings the chunk's tail
// too); else plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src, size_t rs,
                                           int nr, int w, int rv, int cv,
                                           bool vec) {
  const int ncols = min(w, round16(cv));
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = ncols / E;
    for (int e = threadIdx.x; e < nr * cpr; e += kThreads) {
      const int r = e / cpr, c = (e - r * cpr) * E;
      const bool ok = r < rv && c < cv;
      cp16(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < nr * ncols; e += kThreads) {
      const int r = e / ncols, c = e - r * ncols;
      dst[r * ld + c] = (r < rv && c < cv) ? src[r * rs + c] : from_f32<T>(0.f);
    }
  }
}

// Two adjacent outputs (row i, columns p, p + 1) of row-major rows of
// length P; p + 1 is stored only where ok1.  Paired where P is even.
__device__ __forceinline__ void store2(float* o, float a, float b, bool ok1, bool even) {
  if (ok1 && even) {
    *reinterpret_cast<float2*>(o) = make_float2(a, b);
  } else {
    o[0] = a;
    if (ok1) o[1] = b;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b, bool ok1,
                                       bool even) {
  if (ok1 && even) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
  } else {
    o[0] = __float2bfloat16(a);
    if (ok1) o[1] = __float2bfloat16(b);
  }
}

// ---------------------------------------------------------------------------
// Step 0: C.B^T once per (batch row, chunk)
// ---------------------------------------------------------------------------

// cb[i][j] = C_i . B_j for the CTA's 16 rows i < r and its 32 columns
// j <= i, j < r; warp w takes the 8 columns 8w.  The k index (N) is
// loaded whole (kCbK at a time) and multiplied at once: this launch's
// time is the latency of its CTAs, not its work.  Each k-step's three
// products are summed from zero and the sum is added in f32: the tensor
// cores truncate each sum they accumulate, and C.B^T (entries to ~40 at
// N 128, multiplied by dt x in the intra term) would otherwise carry
// several times the f32 sums' error into y.
__global__ void __launch_bounds__(kThreads) ssd_cb_kernel(Params p) {
  extern __shared__ __align__(16) float cbs[];
  float* Cs = cbs;                     // (16, kLdCb)
  float* Bs = cbs + 16 * kLdCb;        // (32, kLdCb)
  int id = blockIdx.x;
  const int ct = id % p.n_c32;
  id /= p.n_c32;
  const int mt = id % p.n_mt;
  id /= p.n_mt;
  const int c = id % p.nc, b = id / p.nc;
  const int s0 = c * p.Q, r = min(p.Q, p.S - s0), i0 = 16 * mt, j0 = kKC * ct;
  const int ncol = min(i0 + 16, r);
  if (i0 >= r || j0 >= ncol) return;   // rows past S, columns past the diagonal
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool on = j0 + 8 * warp < ncol;
  const float* Crow = p.Cm + (static_cast<size_t>(b) * p.S + s0 + i0) * p.N;
  const float* Brow = p.Bm + (static_cast<size_t>(b) * p.S + s0 + j0) * p.N;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < p.N; n0 += kCbK) {
    stage_tile<float>(Cs, kLdCb, Crow + n0, p.N, 16, kCbK, r - i0, p.N - n0, p.bc_vec);
    stage_tile<float>(Bs, kLdCb, Brow + n0, p.N, kKC, kCbK, ncol - j0, p.N - n0, p.bc_vec);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    if (on) {
#pragma unroll 4
      for (int k0 = 0; k0 < kCbK; k0 += 8) {
        if (n0 + k0 >= p.N) break;
        Tf a[4], bb[2];
        a[0] = split<false>(Cs[g * kLdCb + k0 + t]);
        a[1] = split<false>(Cs[(g + 8) * kLdCb + k0 + t]);
        a[2] = split<false>(Cs[g * kLdCb + k0 + t + 4]);
        a[3] = split<false>(Cs[(g + 8) * kLdCb + k0 + t + 4]);
        bb[0] = split<false>(Bs[(8 * warp + g) * kLdCb + k0 + t]);
        bb[1] = split<false>(Bs[(8 * warp + g) * kLdCb + k0 + t + 4]);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_split<false>(part, a, bb);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += part[e];
      }
    }
    __syncthreads();                   // the tiles are reloaded next
  }
  if (!on) return;
  float* out = p.cb + (static_cast<size_t>(b) * p.nc + c) * p.Q * p.Q;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = i0 + g + 8 * hr, j = j0 + 8 * warp + 2 * t;
    if (i < r && j < ncol)
      store2(out + static_cast<size_t>(i) * p.Q + j, acc[2 * hr], acc[2 * hr + 1],
             j + 1 < ncol, (p.Q & 1) == 0);
  }
}

// ---------------------------------------------------------------------------
// Step 1: the chunk states
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 4) ssd_state_kernel(Params p) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float dts[kMaxQ], cum[kMaxQ], w[kMaxQ];
  __shared__ float blk_pre[kMaxQ / kCumBlock];
  // chunk slowest: the short last chunk's CTAs are dispatched last, so
  // that the full chunks' spread over the SMs
  int id = blockIdx.x;
  const int pt = id % p.n_pt;
  id /= p.n_pt;
  const int nt = id % p.n_nt;
  id /= p.n_nt;
  const int hd = id % p.H;
  id /= p.H;
  const int b = id % p.Bsz, c = id / p.Bsz;
  const int s0 = c * p.Q, r = min(p.Q, p.S - s0), Q = p.Q;
  const int n0 = nt * kRowsN, p0 = pt * kColsP;
  const int tid = threadIdx.x;
  const T* x = static_cast<const T*>(p.x);
  constexpr bool kExact = sizeof(T) == 2;

  // S_c = B^T (w x): rows n (the warp's two 16-row tiles), columns p,
  // k = the chunk's rows j < r in stages of kKC
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int nrows = min(kRowsN, p.N - n0), ncols = min(kColsP, p.P - p0);
  const int n_ct = cdiv(ncols, 8);
  const float* Brow = p.Bm + (static_cast<size_t>(b) * p.S + s0) * p.N + n0;
  const T* xrow = x + ((static_cast<size_t>(b) * p.S + s0) * p.H + hd) * p.P + p0;
  const size_t xrs = static_cast<size_t>(p.H) * p.P;
  auto stage = [&](int kc, int s) {
    const int j0 = kc * kKC;
    float* Bs = ring + s * kStage;
    T* Xs = reinterpret_cast<T*>(Bs + kTileA);
    stage_tile<float>(Bs, kLdN, Brow + static_cast<size_t>(j0) * p.N, p.N, kKC, kRowsN,
                      r - j0, nrows, p.bc_vec);
    stage_tile<T>(Xs, kLdP, xrow + j0 * xrs, xrs, kKC, kColsP, r - j0, ncols, p.x_vec);
  };
  stage(0, 0);                         // in flight while the prologue runs
  cp_commit();

  // dt and the inclusive cumsum of dt*A in the plain version's order, to
  // the bit: sequential inside blocks of kCumBlock, then each block's
  // exclusive prefix of block totals added (no FMA contraction anywhere)
  {
    const float a = p.A[hd];
    const float d = tid < r ? p.dt[(static_cast<size_t>(b) * p.S + s0 + tid) * p.H + hd]
                            : 0.f;
    dts[tid] = d;
    cum[tid] = __fmul_rn(d, a);
  }
  __syncthreads();
  const int nb = cdiv(Q, kCumBlock);
  if (tid < nb) {
    const int i1 = min((tid + 1) * kCumBlock, Q);
    float run = cum[tid * kCumBlock];
    for (int i = tid * kCumBlock + 1; i < i1; ++i) {
      run = __fadd_rn(run, cum[i]);
      cum[i] = run;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float pre = 0.f;
    blk_pre[0] = 0.f;
    for (int bi = 1; bi < nb; ++bi) {
      pre = __fadd_rn(pre, cum[bi * kCumBlock - 1]);
      blk_pre[bi] = pre;
    }
  }
  __syncthreads();
  if (tid >= kCumBlock && tid < Q) cum[tid] = __fadd_rn(cum[tid], blk_pre[tid / kCumBlock]);
  __syncthreads();
  const float last = cum[Q - 1];
  w[tid] = tid < Q ? dts[tid] * expf(last - cum[tid]) : 0.f;
  if (nt == 0 && pt == 0 && tid < Q)
    p.cum[((static_cast<size_t>(b) * p.nc + c) * p.H + hd) * Q + tid] = cum[tid];

  bool act[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) act[mi] = 32 * warp + 16 * mi < nrows;
  float acc[2][kNT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int nk = cdiv(r, kKC);
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc & 1;
    if (kc + 1 < nk) stage(kc + 1, s ^ 1);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const float* Bs = ring + s * kStage;
    const T* Xs = reinterpret_cast<const T*>(Bs + kTileA);
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      const int k0 = 8 * ks, j = kc * kKC + k0;
      if (j >= r || !act[0]) break;    // padding rows: exact zeros
      const float w0 = w[j + t], w1 = w[j + t + 4];
      Tf a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (!act[mi]) continue;
        const int m = 32 * warp + 16 * mi + g;
        a[mi][0] = split<false>(Bs[(k0 + t) * kLdN + m] * w0);
        a[mi][1] = split<false>(Bs[(k0 + t) * kLdN + m + 8] * w0);
        a[mi][2] = split<false>(Bs[(k0 + t + 4) * kLdN + m] * w1);
        a[mi][3] = split<false>(Bs[(k0 + t + 4) * kLdN + m + 8] * w1);
      }
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        if (ni >= n_ct) break;
        Tf bb[2];
        bb[0] = split<kExact>(to_f32(Xs[(k0 + t) * kLdP + 8 * ni + g]));
        bb[1] = split<kExact>(to_f32(Xs[(k0 + t + 4) * kLdP + 8 * ni + g]));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          if (act[mi]) mma_split<kExact>(acc[mi][ni], a[mi], bb);
      }
    }
    __syncthreads();                   // the stage is refilled next iteration
  }
  float* out = p.st + ((static_cast<size_t>(b) * p.nc + c) * p.H + hd) * p.N * p.P;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    if (!act[mi]) continue;
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      if (ni >= n_ct) break;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int n = 32 * warp + 16 * mi + g + 8 * hr, q = 8 * ni + 2 * t;
        if (n < nrows && q < ncols)
          store2(out + static_cast<size_t>(n0 + n) * p.P + p0 + q, acc[mi][ni][2 * hr],
                 acc[mi][ni][2 * hr + 1], q + 1 < ncols, (p.P & 1) == 0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Step 2: state passing
// ---------------------------------------------------------------------------

template <int V> struct Vec;
template <> struct Vec<1> {
  using type = float;
  static __device__ __forceinline__ float step(float d, float h, float s) {
    return __fadd_rn(__fmul_rn(d, h), s);
  }
  static __device__ __forceinline__ float zero() { return 0.f; }
};
template <> struct Vec<4> {
  using type = float4;
  static __device__ __forceinline__ float4 step(float d, float4 h, float4 s) {
    return make_float4(__fadd_rn(__fmul_rn(d, h.x), s.x), __fadd_rn(__fmul_rn(d, h.y), s.y),
                       __fadd_rn(__fmul_rn(d, h.z), s.z), __fadd_rn(__fmul_rn(d, h.w), s.w));
  }
  static __device__ __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};

// One thread per V consecutive state elements of one (batch row, head):
// st[c] <- h, h <- exp(cum_last[c]) h + S_c (the plain version's product
// then sum), chunk by chunk, the next chunk's S_c loaded ahead; h_out <- h.
// st[0] (zero) is not written: the scan does not read it.
template <int V>
__global__ void __launch_bounds__(256) ssd_pass_kernel(Params p) {
  using VT = typename Vec<V>::type;
  const size_t np = static_cast<size_t>(p.N) * p.P;
  const size_t e = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  const size_t bh = e / np;
  if (bh >= static_cast<size_t>(p.Bsz) * p.H) return;
  const size_t el = e - bh * np;
  const int b = static_cast<int>(bh / p.H), hd = static_cast<int>(bh % p.H);
  const size_t cstride = static_cast<size_t>(p.H) * np;
  VT* base = reinterpret_cast<VT*>(
      p.st + (static_cast<size_t>(b) * p.nc * p.H + hd) * np + el);
  const float* cl = p.cum + (static_cast<size_t>(b) * p.nc * p.H + hd) * p.Q + p.Q - 1;
  VT h = Vec<V>::zero();
  VT nxt = base[0];
  for (int c = 0; c < p.nc; ++c) {
    const VT s = nxt;
    if (c + 1 < p.nc) nxt = base[(c + 1) * cstride / V];
    const float d = expf(cl[static_cast<size_t>(c) * p.H * p.Q]);
    if (c > 0) base[c * cstride / V] = h;
    h = Vec<V>::step(d, h, s);
  }
  *reinterpret_cast<VT*>(p.h_out + bh * np + el) = h;
}

// ---------------------------------------------------------------------------
// Step 3: the chunk scan
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 4) ssd_scan_kernel(Params p) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float dts[kMaxQ], cum[kMaxQ], ecum[kMaxQ];
  // chunk slowest and last chunk first: chunk 0 (no inter term) is
  // dispatched last, so that the longer CTAs spread over the SMs
  int id = blockIdx.x;
  const int pt = id % p.n_pt;
  id /= p.n_pt;
  const int hd = id % p.H;
  id /= p.H;
  const int b = id % p.Bsz, c = p.nc - 1 - id / p.Bsz;
  const int s0 = c * p.Q, r = min(p.Q, p.S - s0), Q = p.Q;
  const int p0 = pt * kColsP, ncols = min(kColsP, p.P - p0), n_ct = cdiv(ncols, 8);
  const int rows = round16(r);
  const int tid = threadIdx.x;
  const T* x = static_cast<const T*>(p.x);
  constexpr bool kExact = sizeof(T) == 2;
  const int na = c > 0 ? cdiv(p.N, kKC) : 0;        // chunk 0: h_prev = 0
  const int nk = na + cdiv(r, kKC);
  const float* Crow = p.Cm + (static_cast<size_t>(b) * p.S + s0) * p.N;
  const float* hp = p.st + ((static_cast<size_t>(b) * p.nc + c) * p.H + hd) * p.N * p.P + p0;
  const float* cbc = p.cb + (static_cast<size_t>(b) * p.nc + c) * Q * Q;
  const T* xrow = x + ((static_cast<size_t>(b) * p.S + s0) * p.H + hd) * p.P + p0;
  const size_t xrs = static_cast<size_t>(p.H) * p.P;
  auto stage = [&](int kc, int s) {
    float* As = ring + s * kStage;
    float* Bs = As + kTileA;
    if (kc < na) {                     // C (rows x 32 n), h_prev (32 n x 64 p)
      const int n0 = kc * kKC;
      stage_tile<float>(As, kLdK, Crow + n0, p.N, rows, kKC, r, p.N - n0, p.bc_vec);
      stage_tile<float>(Bs, kLdP, hp + static_cast<size_t>(n0) * p.P, p.P, kKC, kColsP,
                        p.N - n0, ncols, p.st_vec);
    } else {                           // C.B^T (rows j0.. x 32 j), x (32 j x 64 p);
                                       // C.B^T's columns j >= r, never written,
                                       // are masked by j <= i with i < r
      const int j0 = (kc - na) * kKC;
      stage_tile<float>(As + j0 * kLdK, kLdK, cbc + static_cast<size_t>(j0) * Q + j0, Q,
                        rows - j0, kKC, r - j0, r - j0, p.cb_vec);
      stage_tile<T>(reinterpret_cast<T*>(Bs), kLdP, xrow + j0 * xrs, xrs, kKC, kColsP,
                    r - j0, ncols, p.x_vec);
    }
  };

  stage(0, 0);                         // in flight while the prologue loads
  cp_commit();
  {
    const float* cs = p.cum + ((static_cast<size_t>(b) * p.nc + c) * p.H + hd) * Q;
    const float cv = tid < Q ? cs[tid] : 0.f;
    cum[tid] = cv;
    ecum[tid] = expf(cv);
    dts[tid] = tid < r ? p.dt[(static_cast<size_t>(b) * p.S + s0 + tid) * p.H + hd] : 0.f;
  }
  const float dskip = p.D[hd];

  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  int m0[2];
  bool act[2];
  m0[0] = 16 * warp;
  m0[1] = 16 * (2 * kWarps - 1 - warp);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) act[mi] = m0[mi] < r;
  float acc[2][kNT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc & 1;
    if (kc + 1 < nk) stage(kc + 1, s ^ 1);
    cp_commit();
    cp_wait_one();
    __syncthreads();                   // also publishes dts, cum, ecum
    const float* As = ring + s * kStage;
    const float* Bs = As + kTileA;
    if (!act[0]) {
      // no row of this warp is below S
    } else if (kc < na) {
      // inter: acc += C . h_prev
      const int n0 = kc * kKC;
#pragma unroll
      for (int ks = 0; ks < kKC / 8; ++ks) {
        const int k0 = 8 * ks;
        if (n0 + k0 >= p.N) break;
        Tf a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (!act[mi]) continue;
          const int m = m0[mi] + g;
          a[mi][0] = split<false>(As[m * kLdK + k0 + t]);
          a[mi][1] = split<false>(As[(m + 8) * kLdK + k0 + t]);
          a[mi][2] = split<false>(As[m * kLdK + k0 + t + 4]);
          a[mi][3] = split<false>(As[(m + 8) * kLdK + k0 + t + 4]);
        }
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          if (ni >= n_ct) break;
          Tf bb[2];
          bb[0] = split<false>(Bs[(k0 + t) * kLdP + 8 * ni + g]);
          bb[1] = split<false>(Bs[(k0 + t + 4) * kLdP + 8 * ni + g]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            if (act[mi]) mma_split<false>(acc[mi][ni], a[mi], bb);
        }
      }
    } else {
      const int j0 = (kc - na) * kKC;
      if (kc == na && na > 0) {
        // the inter term times exp(cum_i), before the intra term is added
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float e0 = ecum[m0[mi] + g], e1 = ecum[m0[mi] + g + 8];
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni) {
            acc[mi][ni][0] *= e0;
            acc[mi][ni][1] *= e0;
            acc[mi][ni][2] *= e1;
            acc[mi][ni][3] *= e1;
          }
        }
      }
      // intra and skip: acc += ((C.B^T) o L o dt_j + D I) . x, j <= i
      const T* Xs = reinterpret_cast<const T*>(Bs);
#pragma unroll
      for (int ks = 0; ks < kKC / 8; ++ks) {
        const int k0 = 8 * ks, jk = j0 + k0;
        if (jk >= r) break;            // padding rows: exact zeros
        bool on[2];
        Tf a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          on[mi] = act[mi] && jk <= m0[mi] + 15;   // not above the diagonal
          if (!on[mi]) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = m0[mi] + g + 8 * (e & 1), kk = k0 + t + 4 * (e >> 1);
            const int j = j0 + kk;
            float v = 0.f;
            if (j <= i) {
              // exp(d) as exp2(d log2 e), d taken exactly first: its
              // error is relative to d, small where L is near 1
              v = As[i * kLdK + kk] * exp2f((cum[i] - cum[j]) * kLog2e) * dts[j];
              if (j == i) v += dskip;
            }
            a[mi][e] = split<false>(v);
          }
        }
        if (!on[0] && !on[1]) continue;
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          if (ni >= n_ct) break;
          Tf bb[2];
          bb[0] = split<kExact>(to_f32(Xs[(k0 + t) * kLdP + 8 * ni + g]));
          bb[1] = split<kExact>(to_f32(Xs[(k0 + t + 4) * kLdP + 8 * ni + g]));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            if (on[mi]) mma_split<kExact>(acc[mi][ni], a[mi], bb);
        }
      }
    }
    __syncthreads();                   // the stage is refilled next iteration
  }

  // y, rows < r only
  T* yrow = static_cast<T*>(p.y) + ((static_cast<size_t>(b) * p.S + s0) * p.H + hd) * p.P + p0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    if (!act[mi]) continue;
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      if (ni >= n_ct) break;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = m0[mi] + g + 8 * hr, q = 8 * ni + 2 * t;
        if (i >= r || q >= ncols) continue;
        store2(yrow + i * xrs + q, acc[mi][ni][2 * hr], acc[mi][ni][2 * hr + 1],
               q + 1 < ncols, (p.P & 1) == 0);
      }
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// The ring's dynamic shared memory, and the carveout that holds four
// CTAs an SM.
template <typename K>
cudaError_t ring_smem(K kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch(Params p, cudaStream_t st) {
  cudaError_t err;
  if ((err = ring_smem(ssd_state_kernel<T>)) != cudaSuccess ||
      (err = ring_smem(ssd_scan_kernel<T>)) != cudaSuccess)
    return static_cast<int>(err);
  constexpr int E = 16 / sizeof(T);
  p.x_vec = aligned16(p.x) && p.P % E == 0;
  const int Bsz = p.Bsz;
  ssd_cb_kernel<<<Bsz * p.nc * p.n_mt * p.n_c32, kThreads, kCbSmem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_kernel<T><<<Bsz * p.nc * p.H * p.n_nt * p.n_pt, kThreads, kSmem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t np = static_cast<size_t>(p.N) * p.P;
  const size_t threads = static_cast<size_t>(Bsz) * p.H * np / (np % 4 == 0 ? 4 : 1);
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  if (np % 4 == 0)
    ssd_pass_kernel<4><<<blocks, 256, 0, st>>>(p);
  else
    ssd_pass_kernel<1><<<blocks, 256, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<Bsz * p.nc * p.H * p.n_pt, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_ssd(int x_dtype, const void* x, const void* dt, const void* A,
              const void* Bm, const void* Cm, const void* D, void* y, void* h,
              void* st, void* cum, void* cb, int Bsz, int S, int H, int P,
              int N, int Q, void* stream) {
  if (Q < 1 || Q > kMaxQ || Q > S || Bsz < 1 || H < 1 || P < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.Bsz = Bsz;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = static_cast<const float*>(Bm);
  p.Cm = static_cast<const float*>(Cm);
  p.D = static_cast<const float*>(D);
  p.y = y;
  p.h_out = static_cast<float*>(h);
  p.st = static_cast<float*>(st);
  p.cum = static_cast<float*>(cum);
  p.cb = static_cast<float*>(cb);
  p.S = S;
  p.H = H;
  p.P = P;
  p.N = N;
  p.Q = Q;
  p.nc = cdiv(S, Q);
  p.n_nt = cdiv(N, kRowsN);
  p.n_pt = cdiv(P, kColsP);
  p.n_mt = cdiv(Q, 16);
  p.n_c32 = cdiv(Q, kKC);
  p.bc_vec = aligned16(Bm) && aligned16(Cm) && N % 4 == 0;
  p.st_vec = aligned16(st) && P % 4 == 0;
  p.cb_vec = aligned16(cb) && Q % 4 == 0;
  p.x_vec = false;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch<float>(p, s);
  if (x_dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
