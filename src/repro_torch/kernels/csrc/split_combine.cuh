// Split-key ("flash-decoding") attention for Hopper (sm_90a): the parts
// shared by the paged kernels (paged_attention.cu) and the ring-buffer
// decode kernel (ring_attention.cu).
//
// Each query row's keys are cut into fixed chunks of key positions, and
// each chunk goes to a CTA of its own, so a long cache is walked by many
// CTAs at once instead of by one.  A CTA stages its R query rows once,
// then walks its chunk's key tiles through a ring of kStages shared-
// memory buffers filled by cp.async (the next tile's copy is in flight
// while the current one computes), and folds each tile into a running
// f32 (m, l, acc) per row (online softmax).  It ends with one partial
// state per (row, chunk); a second kernel merges a row's partials in
// ascending chunk order, divides by l once and rounds to q's type once.
// With one chunk the first kernel writes the output itself, through the
// same final division (`finish`).
//
// Invariants (each kernel's header states how it keeps them):
// 1. Row independence.  A row's partial for chunk c is a function of its
//    q row, the keys of chunk c and its own position limits only: every
//    pass below computes a row's values with the same instructions in
//    the same order whatever R is and whichever threads run them, and a
//    tile all of whose keys are masked for a row is an exact identity on
//    that row's state (alpha = 1, p = 0).  The combine order is fixed.
// 2. Masking.  A masked key contributes exactly zero.  An empty partial
//    (m = -inf) has weight zero in the combine and adds nothing (its l and
//    acc are not used), so a skipped chunk and a chunk of masked keys give
//    the same bits.  A row with no attendable key comes out as zeros.
// 3. Accumulation in f32 throughout; the output is rounded once.
//
// Work mapping.  Score and convert passes put 8 lanes on a key row, each
// lane on the float4 columns lane, lane + 8, ... of the row (8 lanes read
// 128 contiguous bytes: no bank conflicts), reduced with 3 shuffles; the
// softmax fold takes one warp per row; P.V one thread per float4 of the
// head dim and two rows at a time.  No loop over keys divides: copies
// advance their (row, piece) index by addition (`Walk`).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace split {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;                    // lanes per key row
constexpr int kGroups = kThreads / kLanes;   // key rows per pass
constexpr int kMaxSmem = 227 * 1024;
// Two tile buffers: one being folded, one in flight (a deeper ring fits
// fewer CTAs on an SM).
constexpr int kStages = 2;
constexpr float kFp8Max = 448.f;             // float8_e4m3fn saturation
constexpr float kScaleEps = 1e-12f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A quantized payload carries per-(token, head) scales.
template <typename T> struct Quantized : std::false_type {};
template <> struct Quantized<int8_t> : std::true_type {};
template <> struct Quantized<__nv_fp8_e4m3> : std::true_type {};
template <> struct Quantized<__nv_fp8_e5m2> : std::true_type {};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Over the kLanes lanes of one key row (every lane of the warp calls it).
__device__ __forceinline__ float group_sum(float v) {
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float group_max(float v) {
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// (a, b) = divmod(i, n), then advanced by `step` with additions only.
struct Walk {
  int a, b, n, da, db;
  __device__ Walk(int i, int step, int n_) : n(n_) {
    a = i / n;
    b = i - a * n;
    da = step / n;
    db = step - da * n;
  }
  __device__ __forceinline__ void next() {
    a += da;
    b += db;
    if (b >= n) {
      b -= n;
      ++a;
    }
  }
};

// ---------------------------------------------------------------------------
// cp.async: global -> shared copies that do not hold registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async(void* dst, const void* src, int w) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (w == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else if (w == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// `rows` rows of `rowbytes` bytes at src + j * stride into dst (packed),
// in w-byte pieces (4, 8 or 16; w divides rowbytes, stride and both base
// addresses).  Asynchronous: commit and wait before reading dst.
__device__ __forceinline__ void copy_rows(char* dst, const char* src, int rows,
                                          int rowbytes, size_t stride, int w) {
  for (Walk i(threadIdx.x, kThreads, rowbytes / w); i.a < rows; i.next())
    cp_async(dst + static_cast<size_t>(i.a) * rowbytes + i.b * w,
             src + i.a * stride + static_cast<size_t>(i.b) * w, w);
}

// The widest cp.async piece (16, 8 or 4 bytes) that divides the row and
// the base addresses; 0 when none does.
inline int copy_width(size_t rowbytes, const void* a, const void* b) {
  const uintptr_t bits = rowbytes | reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  for (int w = 16; w >= 4; w >>= 1)
    if (bits % w == 0) return w;
  return 0;
}

// ---------------------------------------------------------------------------
// Shared memory of one CTA
// ---------------------------------------------------------------------------

// A ring of kStages raw tile stages (K tile, V tile and, for quantized
// pools, their row scales, in the pool's own type), f32 staging tiles
// (unless the raw f32 tile is read directly), and the per-row state.
// Stage pointers are computed, not indexed, so the struct stays in
// registers.
struct Smem {
  char* stages;
  int stage_bytes, tile_bytes, sc_bytes;
  float *kf, *vf, *k_sc;              // staged tile in f32, fp8 K row scales
  float *qs, *acc, *ps;               // q rows, accumulators, scores
  float *m, *l, *alpha, *q_sc;        // per row
  int *lo, *hi, *flags;               // per-row key limits, per-key flags

  __device__ __forceinline__ char* raw_k(int s) const { return stages + s * stage_bytes; }
  __device__ __forceinline__ char* raw_v(int s) const { return raw_k(s) + tile_bytes; }
  __device__ __forceinline__ float* sc_k(int s) const {
    return reinterpret_cast<float*>(raw_v(s) + tile_bytes);
  }
  __device__ __forceinline__ float* sc_v(int s) const {
    return reinterpret_cast<float*>(raw_v(s) + tile_bytes + sc_bytes);
  }
};

// The raw tile is read as it lands when it is f32 under f32 queries and
// no fp8 QK^T; otherwise it is converted into the f32 staging tiles.
template <typename TQ, typename TP, bool FP8>
constexpr bool kDirect = std::is_same<TP, float>::value &&
                         std::is_same<TQ, float>::value && !FP8;

// Lays out `sm` from `base` (null: sizes only) for R query rows of D, nk
// keys per tile and nflags per-key ints; returns the bytes.
template <typename TQ, typename TP, bool FP8>
__host__ __device__ size_t lay_out(Smem& sm, char* base, int R, int D, int nk,
                                   int nflags) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 15) & ~static_cast<size_t>(15);
    return p;
  };
  const size_t tile = static_cast<size_t>(nk) * D;
  const size_t staged = kDirect<TQ, TP, FP8> ? 0 : tile * 4;
  sm.tile_bytes = static_cast<int>((tile * sizeof(TP) + 15) & ~static_cast<size_t>(15));
  sm.sc_bytes = Quantized<TP>::value ? (nk * 4 + 15) & ~15 : 0;
  sm.stage_bytes = 2 * sm.tile_bytes + 2 * sm.sc_bytes;
  sm.stages = take(static_cast<size_t>(kStages) * sm.stage_bytes);
  sm.kf = reinterpret_cast<float*>(take(staged));
  sm.vf = reinterpret_cast<float*>(take(staged));
  sm.k_sc = reinterpret_cast<float*>(take(nk * 4));
  sm.qs = reinterpret_cast<float*>(take(static_cast<size_t>(R) * D * 4));
  sm.acc = reinterpret_cast<float*>(take(static_cast<size_t>(R) * D * 4));
  sm.ps = reinterpret_cast<float*>(take(static_cast<size_t>(R) * nk * 4));
  sm.m = reinterpret_cast<float*>(take(R * 4));
  sm.l = reinterpret_cast<float*>(take(R * 4));
  sm.alpha = reinterpret_cast<float*>(take(R * 4));
  sm.q_sc = reinterpret_cast<float*>(take(R * 4));
  sm.lo = reinterpret_cast<int*>(take(R * 4));
  sm.hi = reinterpret_cast<int*>(take(R * 4));
  sm.flags = reinterpret_cast<int*>(take(nflags * 4));
  return off;
}

// ---------------------------------------------------------------------------
// The passes of one CTA
// ---------------------------------------------------------------------------

template <typename TP>
__device__ __forceinline__ float4 load4(const TP* p) {
  if constexpr (sizeof(TP) == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else if constexpr (sizeof(TP) == 2) {
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(p);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    return make_float4(a.x, a.y, b.x, b.y);
  } else {
    return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
  }
}

template <typename TQ>
__device__ __forceinline__ float through(float x) {
  return to_f32(from_f32<TQ>(x));
}

// x (in f32) -> the f32 value of its e4m3 code under scale s:
// qk_dot_fp8's order, true division, clip, round-to-nearest-even cast.
__device__ __forceinline__ float fp8_code(float x, float s) {
  const float y = fminf(fmaxf(x / s, -kFp8Max), kFp8Max);
  return static_cast<float>(__nv_fp8_e4m3(y));
}

// Each of the CTA's R query rows (global row row_of(r), D wide) into
// shared memory as f32, with the fp8 QK^T as its e4m3 codes under the
// row's amax scale (q_sc); zeroes the accumulators, m = -inf, l = 0.  One
// warp per row.
template <typename TQ, bool FP8, typename RowOf>
__device__ void load_q_rows(const Smem& sm, const TQ* __restrict__ q, int R,
                            int D, RowOf row_of) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += kWarps) {
    const TQ* src = q + row_of(r) * D;
    float* dst = sm.qs + static_cast<size_t>(r) * D;
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float x = to_f32(src[d]);
      dst[d] = x;
      amax = fmaxf(amax, fabsf(x));
      sm.acc[static_cast<size_t>(r) * D + d] = 0.f;
    }
    if constexpr (FP8) {
      const float s = fmaxf(warp_max(amax), kScaleEps) / kFp8Max;
      for (int d = lane; d < D; d += 32) dst[d] = fp8_code(dst[d], s);
      if (lane == 0) sm.q_sc[r] = s;
    }
    if (lane == 0) {
      sm.m[r] = -INFINITY;
      sm.l[r] = 0.f;
    }
  }
}

// nk staged rows of D pool values -> f32 rows: dequantized by their row
// scale (quantized pools), rounded through q's type, and with FP8 replaced
// by their e4m3 codes under the row's amax scale (sc).
template <typename TQ, typename TP, bool FP8>
__device__ void convert_rows(float* dst, float* sc, const TP* raw,
                             const float* row_scale, int nk, int D) {
  const int g = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;
  const int D4 = D / 4;
  for (int j0 = 0; j0 < nk; j0 += kGroups) {
    const int j = j0 + g;
    const bool on = j < nk;
    float amax = 0.f;
    if (on) {
      const float rs = Quantized<TP>::value ? row_scale[j] : 1.f;
      for (int f = sub; f < D4; f += kLanes) {
        float4 x = load4(raw + static_cast<size_t>(j) * D + 4 * f);
        if constexpr (Quantized<TP>::value) {
          x.x *= rs; x.y *= rs; x.z *= rs; x.w *= rs;
        }
        x = make_float4(through<TQ>(x.x), through<TQ>(x.y), through<TQ>(x.z),
                        through<TQ>(x.w));
        reinterpret_cast<float4*>(dst + static_cast<size_t>(j) * D)[f] = x;
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)),
                                 fmaxf(fabsf(x.z), fabsf(x.w))));
      }
    }
    if constexpr (FP8) {
      amax = group_max(amax);
      if (on) {
        const float s = fmaxf(amax, kScaleEps) / kFp8Max;
        float4* row = reinterpret_cast<float4*>(dst + static_cast<size_t>(j) * D);
        for (int f = sub; f < D4; f += kLanes) {
          const float4 x = row[f];
          row[f] = make_float4(fp8_code(x.x, s), fp8_code(x.y, s),
                               fp8_code(x.z, s), fp8_code(x.w, s));
        }
        if (sub == 0) sc[j] = s;
      }
    }
  }
}

// ps[r * ldp + j] = ok(r, j) ? q_r . k_j (x q_sc x k_sc) x scale : -inf.
// A group of 8 lanes takes key j and kRows rows at a time (independent
// chains); each dot sums its float4 columns in four running sums, then
// across the group, the same for every (row, key).
template <bool FP8, typename Ok>
__device__ void score_pass(const Smem& sm, const float* ks, int R, int nk,
                           int ldp, int D, float scale, Ok ok) {
  constexpr int kRows = 8;
  const int g = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;
  const int D4 = D / 4;
  for (int j0 = 0; j0 < nk; j0 += kGroups) {
    const int j = j0 + g;
    const bool on = j < nk;
    const float4* k4 = reinterpret_cast<const float4*>(ks + static_cast<size_t>(on ? j : 0) * D);
    for (int r0 = 0; r0 < R; r0 += kRows) {
      float4 d4[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) d4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (on) {
        for (int f = sub; f < D4; f += kLanes) {
          const float4 b = k4[f];
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            if (r0 + u < R) {
              const float4 a = reinterpret_cast<const float4*>(
                  sm.qs + static_cast<size_t>(r0 + u) * D)[f];
              d4[u].x = fmaf(a.x, b.x, d4[u].x);
              d4[u].y = fmaf(a.y, b.y, d4[u].y);
              d4[u].z = fmaf(a.z, b.z, d4[u].z);
              d4[u].w = fmaf(a.w, b.w, d4[u].w);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = r0 + u;
        if (r < R) {                                    // uniform in the CTA
          float dot = group_sum((d4[u].x + d4[u].y) + (d4[u].z + d4[u].w));
          if (on && sub == 0) {
            if constexpr (FP8) dot = dot * sm.q_sc[r] * sm.k_sc[j];
            sm.ps[r * ldp + j] = ok(r, j) ? dot * scale : -INFINITY;
          }
        }
      }
    }
  }
}

// Online softmax over one tile: per row the new max, p = exp(s - m) (0
// where masked), alpha = exp(m_old - m_new) (1 where the max holds), l.
__device__ inline void softmax_fold(const Smem& sm, int R, int nk, int ldp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += kWarps) {
    float* row = sm.ps + r * ldp;
    float mx = -INFINITY;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    const float m_old = sm.m[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float s = row[j];
      const float p = s == -INFINITY ? 0.f : expf(s - m_new);
      row[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = m_new == m_old ? 1.f : expf(m_old - m_new);
      sm.alpha[r] = a;
      sm.l[r] = sm.l[r] * a + sum;
      sm.m[r] = m_new;
    }
  }
}

// acc = acc * alpha + P V.  A thread owns one float4 of the head dim
// (D / 4 <= kThreads) and the rows r_first, r_first + step, ... (step =
// kThreads / (D / 4)), two rows at a time on the same V loads.
__device__ inline void pv_fold(const Smem& sm, const float* vs, int R, int nk,
                               int ldp, int D) {
  const int D4 = D / 4, step = kThreads / D4;
  const int f = threadIdx.x % D4, r_first = threadIdx.x / D4;
  if (r_first >= step) return;
  const float4* v4 = reinterpret_cast<const float4*>(vs) + f;
  for (int r = r_first; r < R; r += 2 * step) {
    const int r2 = r + step < R ? r + step : r;         // a second row
    float4* a4 = reinterpret_cast<float4*>(sm.acc + static_cast<size_t>(r) * D) + f;
    float4* b4 = reinterpret_cast<float4*>(sm.acc + static_cast<size_t>(r2) * D) + f;
    const float al = sm.alpha[r], bl = sm.alpha[r2];
    float4 a = *a4, b = *b4;
    a.x *= al; a.y *= al; a.z *= al; a.w *= al;
    b.x *= bl; b.y *= bl; b.z *= bl; b.w *= bl;
    const float* p = sm.ps + r * ldp;
    const float* p2 = sm.ps + r2 * ldp;
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const float4 v = v4[static_cast<size_t>(j) * D4];
      const float pj = p[j], qj = p2[j];
      a.x = fmaf(pj, v.x, a.x);
      a.y = fmaf(pj, v.y, a.y);
      a.z = fmaf(pj, v.z, a.z);
      a.w = fmaf(pj, v.w, a.w);
      b.x = fmaf(qj, v.x, b.x);
      b.y = fmaf(qj, v.y, b.y);
      b.z = fmaf(qj, v.z, b.z);
      b.w = fmaf(qj, v.w, b.w);
    }
    if (r2 != r) *b4 = b;
    *a4 = a;
  }
}

// Fold the tile landed in `stage` (nk keys; scores stride ldp) into the
// rows' state.
template <typename TQ, typename TP, bool FP8, typename Ok>
__device__ void fold_tile(const Smem& sm, int stage, int R, int nk, int ldp,
                          int D, float scale, Ok ok) {
  const float *ks, *vs;
  if constexpr (kDirect<TQ, TP, FP8>) {
    ks = reinterpret_cast<const float*>(sm.raw_k(stage));
    vs = reinterpret_cast<const float*>(sm.raw_v(stage));
  } else {
    convert_rows<TQ, TP, FP8>(sm.kf, sm.k_sc,
                              reinterpret_cast<const TP*>(sm.raw_k(stage)),
                              sm.sc_k(stage), nk, D);
    convert_rows<TQ, TP, false>(sm.vf, nullptr,
                                reinterpret_cast<const TP*>(sm.raw_v(stage)),
                                sm.sc_v(stage), nk, D);
    __syncthreads();
    ks = sm.kf;
    vs = sm.vf;
  }
  score_pass<FP8>(sm, ks, R, nk, ldp, D, scale, ok);
  __syncthreads();
  softmax_fold(sm, R, nk, ldp);
  __syncthreads();
  pv_fold(sm, vs, R, nk, ldp, D);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Partials and the combine
// ---------------------------------------------------------------------------

// A row's output from its merged state: acc / l, zeros when no key (m =
// -inf), rounded to the output's type once.
template <typename TO>
__device__ __forceinline__ TO finish(float acc, float l, float m) {
  return from_f32<TO>(m == -INFINITY ? 0.f : acc / l);
}

// The CTA's state of chunk c for its R rows: partials (m, l, acc) at
// index row_of(r) * nc + c, or with nc == 1 the finished output rows
// (unless `partials`: a caller that merges the partials itself, also of
// one chunk).
template <typename TO, typename RowOf>
__device__ void write_rows(const Smem& sm, TO* __restrict__ out, float* pm,
                           float* pl, float* pacc, int R, int D, int c, int nc,
                           RowOf row_of, bool partials = false) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += kWarps) {
    const size_t row = row_of(r);
    const float* a = sm.acc + static_cast<size_t>(r) * D;
    if (nc == 1 && !partials) {
      for (int d = lane; d < D; d += 32) out[row * D + d] = finish<TO>(a[d], sm.l[r], sm.m[r]);
    } else {
      const size_t i = row * nc + c;
      if (lane == 0) {
        pm[i] = sm.m[r];
        pl[i] = sm.l[r];
      }
      for (int d = lane; d < D; d += 32) pacc[i * D + d] = a[d];
    }
  }
}

// A chunk with no key for any of the CTA's rows: m = -inf (l and acc are
// never read), or with nc == 1 zero output rows (unless `partials`).
template <typename TO, typename RowOf>
__device__ void write_empty(TO* __restrict__ out, float* pm, int R, int D,
                            int c, int nc, RowOf row_of, bool partials = false) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += kWarps) {
    const size_t row = row_of(r);
    if (nc == 1 && !partials) {
      for (int d = lane; d < D; d += 32) out[row * D + d] = from_f32<TO>(0.f);
    } else if (lane == 0) {
      pm[row * nc + c] = -INFINITY;
    }
  }
}

// A chunk's weight in the combine: 0 when empty, 1 for the max's chunk.
__device__ __forceinline__ float chunk_weight(float mc, float M) {
  return mc == -INFINITY ? 0.f : (mc == M ? 1.f : expf(mc - M));
}

// Merge each row's nc partials in ascending chunk order: one warp a row,
// each lane on the columns d = lane, lane + 32, ...  The kernel is bound
// by the latency of dependent loads, so a batch of kBatch chunks x kCols
// column rounds of partials is loaded together with the chunks' m and l,
// before the weights that need the max over all chunks; lane c holds
// chunk c's weight (in rounds of 32 chunks).
template <typename TO>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
               const float* __restrict__ pacc, TO* __restrict__ out, int rows,
               int nc, int D) {
  constexpr int kBatch = 8, kCols = 4;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* m = pm + static_cast<size_t>(row) * nc;
  const float* l = pl + static_cast<size_t>(row) * nc;
  const float* acc = pacc + static_cast<size_t>(row) * nc * D;
  const auto load = [&](float (&x)[kBatch][kCols], int c0, int d0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = c0 + j, d = d0 + 32 * u + lane;
        x[j][u] = c < nc && d < D ? acc[static_cast<size_t>(c) * D + d] : 0.f;
      }
  };
  float x[kBatch][kCols];
  load(x, 0, 0);                                        // with m and l
  const float m_own = lane < nc ? m[lane] : -INFINITY;
  const float l_own = lane < nc ? l[lane] : 0.f;
  float M = m_own;
  for (int c = lane + 32; c < nc; c += 32) M = fmaxf(M, m[c]);
  M = warp_max(M);
  const auto weight = [&](int c32) {                    // chunk c32 + lane
    const int c = c32 + lane;
    return c < 32 ? chunk_weight(m_own, M) : (c < nc ? chunk_weight(m[c], M) : 0.f);
  };
  float L = 0.f;
  for (int c32 = 0; c32 < nc; c32 += 32) {
    const float w = weight(c32);
    const float lw = w != 0.f ? (c32 == 0 ? l_own : l[c32 + lane]) * w : 0.f;
    for (int j = 0; j < min(32, nc - c32); ++j) L += __shfl_sync(0xffffffffu, lw, j);
  }
  for (int d0 = 0; d0 < D; d0 += 32 * kCols) {
    float a[kCols] = {};
    for (int c0 = 0; c0 < nc; c0 += kBatch) {
      if (c0 > 0 || d0 > 0) load(x, c0, d0);
      const float w = weight(c0 & ~31);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, (c0 + j) & 31);
#pragma unroll
        for (int u = 0; u < kCols; ++u)             // an empty chunk adds 0
          if (c0 + j < nc) a[u] += wj != 0.f ? x[j][u] * wj : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int d = d0 + 32 * u + lane;
      if (d < D) out[static_cast<size_t>(row) * D + d] = finish<TO>(a[u], L, M);
    }
  }
}

template <typename TO>
inline void launch_combine(const float* pm, const float* pl, const float* pacc,
                           void* out, int rows, int nc, int D,
                           cudaStream_t st) {
  combine_kernel<TO><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      pm, pl, pacc, static_cast<TO*>(out), rows, nc, D);
}

// Opts a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

}  // namespace split
