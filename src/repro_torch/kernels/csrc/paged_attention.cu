// Paged decode and paged verify attention for Hopper (sm_90a), over plain
// or quantized KV pools, with an optional fp8 QK^T.
//
// Replaces the JAX package's Pallas kernels
//   src/repro/kernels/decode_attention/kernel.py
//     paged_decode_attention_fwd          (:424, pallas_call :468)
//     paged_verify_attention_fwd          (:275, pallas_call :317)
//     paged_decode_attention_dequant_fwd  (:376, pallas_call :416)
//     paged_verify_attention_dequant_fwd  (:325, pallas_call :367)
//   and, inside the first two, src/repro/kernels/common.py:31 qk_dot_fp8
//   (their fp8=True variants).
//
// Every variant reads a shared pool of fixed-size KV blocks, k_pool/v_pool
// (NB, bs, KV, D), through a per-slot block table (S, MB) int32 (-1 =
// unmapped).  Logical position i of slot s lives at offset i % bs of
// physical block table[s, i / bs], so validity is positional: a key at
// position p is attended by a query at position qp iff the block is
// mapped, p <= qp and, with a window w > 0, qp - p < w.  Decode has one
// query token per slot, verify T.
//
// Pools.  The pool's element type is a template parameter of its own,
// apart from q's (f32 or bf16): f32, bf16, or a quantized 1-byte payload
// (int8, __nv_fp8_e4m3, __nv_fp8_e5m2) with (NB, bs, KV) f32 per-token-
// per-head scales.  A quantized row is dequantized after its tile lands
// (payload times its (token, head) scale, in f32).  Every loaded value is
// then rounded through q's type, as the JAX package casts its pool to q's
// dtype before attending, and staged in shared memory as f32; the rest of
// the kernel does not know which pool it read.
//
// fp8 QK^T (FP8_QK, plain pools only, as in the reference: a quantized
// pool keeps the f32 contraction).  qk_dot_fp8's numerics with the
// narrow_dot=False contraction the reference's interpreter runs: each Q
// row is quantized over D to e4m3 with its own amax scale (scale =
// max(amax, 1e-12) / 448, clip to +-448, then a round-to-nearest-even
// cast), and per K tile each key row the same way once the tile has
// landed; the score is the f32 dot of the upcast codes times q_scale times
// k_scale times 1/sqrt(D).  The codes are staged as f32 (no tensor cores:
// wgmma e4m3 is later speed work).
//
// What bounds it: bytes.  Each live key and value row is read once and
// used for G (decode) or T*G (verify) dot products of length D; at T*G <=
// a few tens of rows that is far below the card's ratio of operations to
// bytes, so the least time is the live K/V bytes (payload plus scales)
// over 3.35 TB/s.  A 1-byte pool moves about a quarter of an f32 pool's
// bytes.
//
// Design: split keys (split_combine.cuh).  The TPU kernel's sequential
// grid axis over blocks, which carried (m, l, acc) in VMEM, becomes a grid
// of (slot, KV head) x chunk CTAs, a chunk being `cb` whole blocks (the
// wrapper's CHUNK_KEYS key positions), and a second kernel that merges
// the chunks.  A CTA walks the blocks of its chunk from the first one the
// window can reach to the one holding the slot's last query position
// (blocks past the query and unmapped ones are never loaded; a chunk with
// none writes an empty partial and exits), with the next blocks' K/V
// tiles copied by cp.async while the current one computes.  The chunk's
// table entries are read together with the slot's position, so a CTA
// waits for one round trip before its first tile copy.  All T*G query
// rows of a slot share each tile loaded once.
//
// Verify == decode, bit for bit.  Decode and verify run one kernel
// (n_tokens null = decode, T = 1).  A row's position limits are its own
// (lo, hi); a block the CTA walks for another row is all masked for this
// one, an exact identity on its state; a chunk past its position is an
// empty partial, as a skipped chunk is; the chunk count comes from the
// table's shape alone, and the combine runs in ascending chunk order.  So
// verify row t equals decode at position start + t on every pool.  Masked
// keys contribute exactly zero (not exp(0) as with the finite -1e30 of the
// TPU kernel), so a row with no attendable key comes out as zeros; those
// rows (inactive slots, padding tokens) are garbage the caller ignores in
// both implementations.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// q_dtype 0 = float32, 1 = bfloat16 (q and the output); pool_dtype 0 =
// float32, 1 = bfloat16, 2 = int8, 3 = fp8_e4m3, 4 = fp8_e5m2; k_scale /
// v_scale are null for plain pools and required for quantized ones; fp8 =
// 1 asks for the fp8 QK^T (plain pools only).  chunk_blocks: blocks per
// chunk; with nc = ceil(MB / chunk_blocks) > 1 chunks, part_m / part_l
// (rows * nc floats) and part_acc (rows * nc * D floats) are the
// caller's f32 scratch, rows = S * T * KV * G (null when nc == 1).  D must
// be a multiple of 4, at most 512.  Each entry returns cudaGetLastError()
// after its launches.

#include "split_combine.cuh"

namespace {

using namespace split;

template <typename TQ, typename TP, bool FP8_QK>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pool,
                   const TP* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ table,
                   const int* __restrict__ start_pos,
                   const int* __restrict__ n_tokens, TQ* __restrict__ out,
                   float* pm, float* pl, float* pacc, int Tq, int KV, int G,
                   int D, int NB, int bs, int MB, int window, int cb, int nc,
                   int w, float scale) {
  extern __shared__ __align__(16) char smem_raw[];
  const int s = blockIdx.x / KV, h = blockIdx.x - s * KV, c = blockIdx.y;
  const int ib0 = c * cb, nb = min(cb, MB - ib0);       // the chunk's blocks
  const int R = Tq * G;
  Smem sm;
  lay_out<TQ, TP, FP8_QK>(sm, smem_raw, R, D, bs, cb);
  // the slot's position and the chunk's table entries, read together
  const int start = start_pos[s];
  const int n_tok = n_tokens != nullptr ? n_tokens[s] : 1;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    const int blk = table[static_cast<size_t>(s) * MB + ib0 + i];
    sm.flags[i] = blk >= 0 && blk < NB ? blk : -1;      // -1: unmapped
  }
  const int live = start >= 0 ? min(n_tok, Tq) : 0;
  // q/out row of query row r = t*G + g: (((s*T + t)*KV + h)*G + g)
  const auto row_of = [=](int r) {
    const int t = r / G;
    return ((static_cast<size_t>(s) * Tq + t) * KV + h) * G + (r - t * G);
  };
  // blocks from the first the window reaches to the last query's
  int b0 = ib0;
  if (window > 0) b0 = max(b0, max(start - window + 1, 0) / bs);
  const int b1 = live > 0 ? min(ib0 + nb - 1, (start + live - 1) / bs) : -1;
  if (b0 > b1) {
    write_empty<TQ>(out, pm, R, D, c, nc, row_of);
    return;
  }

  const int rowbytes = D * static_cast<int>(sizeof(TP));
  const size_t stride = static_cast<size_t>(KV) * rowbytes;
  const auto fetch = [&](int ib, int st) {              // tile (blk, :, h, :)
    const int blk = sm.flags[ib - ib0];
    if (blk < 0) return;
    const size_t row0 = static_cast<size_t>(blk) * bs * KV + h;
    copy_rows(sm.raw_k(st), reinterpret_cast<const char*>(k_pool + row0 * D), bs,
              rowbytes, stride, w);
    copy_rows(sm.raw_v(st), reinterpret_cast<const char*>(v_pool + row0 * D), bs,
              rowbytes, stride, w);
    if constexpr (Quantized<TP>::value) {
      copy_rows(reinterpret_cast<char*>(sm.sc_k(st)),
                reinterpret_cast<const char*>(k_scale + row0), bs, 4, KV * 4, 4);
      copy_rows(reinterpret_cast<char*>(sm.sc_v(st)),
                reinterpret_cast<const char*>(v_scale + row0), bs, 4, KV * 4, 4);
    }
  };

  __syncthreads();                                      // block ids visible
  for (int k = 0; k < kStages - 1; ++k) {
    if (b0 + k <= b1) fetch(b0 + k, k);
    cp_commit();
  }
  load_q_rows<TQ, FP8_QK>(sm, q, R, D, row_of);
  for (int r = threadIdx.x; r < R; r += kThreads) {    // each row's own limits
    const int t = r / G;
    const int hi = t < live ? start + t : -1;
    sm.hi[r] = hi;
    sm.lo[r] = window > 0 ? hi - window + 1 : 0;
  }
  for (int ib = b0, it = 0; ib <= b1; ++ib, ++it) {
    const int st = it % kStages;
    const int ahead = ib + kStages - 1;
    if (ahead <= b1) fetch(ahead, (it + kStages - 1) % kStages);
    cp_commit();
    cp_wait<kStages - 1>();
    __syncthreads();
    if (sm.flags[ib - ib0] >= 0) {                      // unmapped: all masked
      const int kp0 = ib * bs;
      fold_tile<TQ, TP, FP8_QK>(sm, st, R, bs, bs, D, scale, [&](int r, int j) {
        const int kp = kp0 + j;
        return kp >= sm.lo[r] && kp <= sm.hi[r];
      });
    }
  }
  write_rows<TQ>(sm, out, pm, pl, pacc, R, D, c, nc, row_of);
}

// The operands of one call, untyped; Tq = 1 and n_tokens = null for
// decode, where start holds q_pos.
struct Args {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int *table, *start, *n_tokens;
  void* out;
  float *pm, *pl, *pacc;
  int S, Tq, KV, G, D, NB, bs, MB, window, cb;
  cudaStream_t st;
};

template <typename TQ, typename TP, bool FP8_QK>
int launch(const Args& a) {
  if (a.D % 4 != 0 || a.D > 4 * kThreads || a.cb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = max(1, (a.MB + a.cb - 1) / a.cb);
  const int rows = a.S * a.Tq * a.KV * a.G;
  if (nc > 1 && (a.pm == nullptr || a.pl == nullptr || a.pacc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = copy_width(static_cast<size_t>(a.D) * sizeof(TP), a.k_pool, a.v_pool);
  if (w == 0) return static_cast<int>(cudaErrorMisalignedAddress);
  Smem sizes;
  const size_t smem = lay_out<TQ, TP, FP8_QK>(sizes, nullptr, a.Tq * a.G, a.D, a.bs, a.cb);
  const auto kernel = paged_split_kernel<TQ, TP, FP8_QK>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.0f / sqrtf(static_cast<float>(a.D));
  kernel<<<dim3(a.S * a.KV, nc), kThreads, smem, a.st>>>(
      static_cast<const TQ*>(a.q), static_cast<const TP*>(a.k_pool),
      static_cast<const TP*>(a.v_pool), a.k_scale, a.v_scale, a.table, a.start,
      a.n_tokens, static_cast<TQ*>(a.out), a.pm, a.pl, a.pacc, a.Tq, a.KV, a.G,
      a.D, a.NB, a.bs, a.MB, a.window, a.cb, nc, w, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 1) return static_cast<int>(err);
  launch_combine<TQ>(a.pm, a.pl, a.pacc, a.out, rows, nc, a.D, a.st);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_pool(int pool_dtype, int fp8, const Args& a) {
  const bool scaled = a.k_scale != nullptr && a.v_scale != nullptr;
  if (pool_dtype <= 1) {                                 // plain pools
    if (a.k_scale != nullptr || a.v_scale != nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (pool_dtype == 0)
      return fp8 ? launch<TQ, float, true>(a) : launch<TQ, float, false>(a);
    return fp8 ? launch<TQ, __nv_bfloat16, true>(a)
               : launch<TQ, __nv_bfloat16, false>(a);
  }
  if (fp8 || !scaled) return static_cast<int>(cudaErrorInvalidValue);
  if (pool_dtype == 2) return launch<TQ, int8_t, false>(a);
  if (pool_dtype == 3) return launch<TQ, __nv_fp8_e4m3, false>(a);
  if (pool_dtype == 4) return launch<TQ, __nv_fp8_e5m2, false>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_any(int q_dtype, int pool_dtype, int fp8, const Args& a) {
  if (q_dtype == 0) return launch_pool<float>(pool_dtype, fp8, a);
  if (q_dtype == 1) return launch_pool<__nv_bfloat16>(pool_dtype, fp8, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_paged_decode(int q_dtype, int pool_dtype, int fp8, const void* q,
                       const void* k_pool, const void* v_pool,
                       const void* k_scale, const void* v_scale,
                       const void* table, const void* q_pos, void* out,
                       void* part_m, void* part_l, void* part_acc, int S,
                       int KV, int G, int D, int NB, int bs, int MB,
                       int window, int chunk_blocks, void* stream) {
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(table),
               static_cast<const int*>(q_pos), nullptr, out,
               static_cast<float*>(part_m), static_cast<float*>(part_l),
               static_cast<float*>(part_acc), S, 1, KV, G, D, NB, bs, MB,
               window, chunk_blocks, static_cast<cudaStream_t>(stream)};
  return launch_any(q_dtype, pool_dtype, fp8, a);
}

int repro_paged_verify(int q_dtype, int pool_dtype, int fp8, const void* q,
                       const void* k_pool, const void* v_pool,
                       const void* k_scale, const void* v_scale,
                       const void* table, const void* start_pos,
                       const void* n_tokens, void* out, void* part_m,
                       void* part_l, void* part_acc, int S, int Tq, int KV,
                       int G, int D, int NB, int bs, int MB, int window,
                       int chunk_blocks, void* stream) {
  if (n_tokens == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(table),
               static_cast<const int*>(start_pos),
               static_cast<const int*>(n_tokens), out,
               static_cast<float*>(part_m), static_cast<float*>(part_l),
               static_cast<float*>(part_acc), S, Tq, KV, G, D, NB, bs, MB,
               window, chunk_blocks, static_cast<cudaStream_t>(stream)};
  return launch_any(q_dtype, pool_dtype, fp8, a);
}

}  // extern "C"
