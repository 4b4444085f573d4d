// Single-token decode attention over a ring-buffer KV cache, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas kernel
//   src/repro/kernels/decode_attention/kernel.py
//     decode_attention_fwd  (:476, pallas_call :489)
//
// One query token per batch row, grouped query heads: q (B, KV, G, D);
// the cache k / v (B, KV, S, D) in q's type (f32 or bf16), with a per-slot
// position array pos (B, S) int32 (-1 = empty slot) and the query's
// position q_pos (B,) int32.  Slot j of row b is live iff pos >= 0,
// pos <= q_pos and, with a window w > 0, q_pos - pos < w: the causal gate
// and the window gate of the static serving path's mask.  Which slot holds
// which position does not matter (the ring wraps), only pos does.  Output
// (B, KV, G, D) in q's type.
//
// What bounds it: bytes.  Each live key and value row is read once and
// used for G dot products of length D, far below the card's ratio of
// operations to bytes; the least time is the live K/V rows (plus q, the
// output and pos) over 3.35 TB/s.
//
// Design: split keys (split_combine.cuh), as the paged kernels.  The TPU
// kernel's sequential grid axis over key blocks becomes a grid of (batch
// row, KV head) x chunk CTAs, a chunk being `chunk` consecutive slots, and
// a second kernel that merges the chunks in ascending order.  A CTA first
// reads its chunk's positions and decides which slots are live (a chunk
// with none writes an empty partial and exits), then walks the chunk in
// tiles of 16 slots, copying only tiles with a live slot, the next ones by
// cp.async while the current one computes.  The G query heads of a KV head
// share each tile loaded once.  Dead slots contribute exactly zero (the
// TPU kernel's finite -1e30 mask gives exp(0) to every slot of a row with
// nothing live), so a row with no live key (a query at position -1, a
// left-pad token of the static prefill) comes out as zeros; that row is
// garbage the caller never reads, in both implementations.
//
// Sequence-parallel decode (the `kv_seq` layout of a model axis): each
// rank holds a contiguous run of the ring's slots.  Two more entries split
// the work of repro_ring_decode between the ranks: the split kernel over
// the rank's slots with every chunk's partial state written out (also when
// there is one chunk), and the combine kernel alone over partials the
// caller gathered from the ranks in ascending slot order.  With the rank's
// slot count a multiple of `chunk`, its chunks are the one-process
// kernel's chunks, so the gathered partials and their combine are the
// one-process call's, bit for bit.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int;
// dtype 0 = float32, 1 = bfloat16 (q, k, v and the output).  With nc =
// ceil(S / chunk) > 1 chunks, part_m / part_l (B * KV * G * nc floats) and
// part_acc (B * KV * G * nc * D floats) are the caller's f32 scratch (null
// when nc == 1).  D must be a multiple of 4, at most 512.  Returns
// cudaGetLastError() after the launches.
//
//   repro_ring_decode_partials: the same arguments without `out`; the
//     partials are written for every nc, (B * KV * G, nc) m and l and
//     (B * KV * G, nc, D) acc, an empty chunk as m = -inf (its l and acc
//     unwritten);
//   repro_ring_combine: partials of `rows` rows over nc chunks in that
//     layout -> out (rows, D) in the dtype.

#include "split_combine.cuh"

namespace {

using namespace split;

constexpr int kTile = 16;                    // slots per tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ pos,
                  const int* __restrict__ q_pos, T* __restrict__ out,
                  float* pm, float* pl, float* pacc, int KV, int G, int S,
                  int D, int window, int chunk, int nc, int w, float scale,
                  bool partials) {
  extern __shared__ __align__(16) char smem_raw[];
  const int bh = blockIdx.x, b = bh / KV, c = blockIdx.y;
  const int j_lo = c * chunk;
  const int n = min(chunk, S - j_lo);                   // slots of this chunk
  const int qp = q_pos[b];
  const auto row_of = [=](int r) { return static_cast<size_t>(bh) * G + r; };

  Smem sm;
  lay_out<T, T, false>(sm, smem_raw, G, D, kTile, chunk);
  int mine = 0;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int p = pos[static_cast<size_t>(b) * S + j_lo + j];
    const int ok = p >= 0 && p <= qp && (window <= 0 || qp - p < window);
    sm.flags[j] = ok;
    mine |= ok;
  }
  if (!__syncthreads_or(mine)) {                        // no live slot
    write_empty<T>(out, pm, G, D, c, nc, row_of, partials);
    return;
  }

  const int rowbytes = D * static_cast<int>(sizeof(T));
  const size_t base = (static_cast<size_t>(bh) * S + j_lo) * D;
  const auto live_tile = [&](int t0) {
    int any = 0;
    for (int j = t0; j < min(t0 + kTile, n); ++j) any |= sm.flags[j];
    return any != 0;
  };
  const auto fetch = [&](int t0, int st) {              // slots t0 .. t0+15
    const int nk = min(kTile, n - t0);
    copy_rows(sm.raw_k(st), reinterpret_cast<const char*>(k + base + t0 * D), nk,
              rowbytes, rowbytes, w);
    copy_rows(sm.raw_v(st), reinterpret_cast<const char*>(v + base + t0 * D), nk,
              rowbytes, rowbytes, w);
  };

  for (int k = 0; k < kStages - 1; ++k) {
    if (k * kTile < n && live_tile(k * kTile)) fetch(k * kTile, k);
    cp_commit();
  }
  load_q_rows<T, false>(sm, q, G, D, row_of);
  for (int t0 = 0, it = 0; t0 < n; t0 += kTile, ++it) {
    const int ahead = t0 + (kStages - 1) * kTile;
    if (ahead < n && live_tile(ahead)) fetch(ahead, (it + kStages - 1) % kStages);
    cp_commit();
    cp_wait<kStages - 1>();
    __syncthreads();
    if (live_tile(t0)) {                                // dead tile: skipped
      const int* live = sm.flags + t0;
      fold_tile<T, T, false>(sm, it % kStages, G, min(kTile, n - t0), kTile, D,
                             scale, [&](int, int j) { return live[j] != 0; });
    }
  }
  write_rows<T>(sm, out, pm, pl, pacc, G, D, c, nc, row_of, partials);
}

// The split kernel, then (unless `partials`, or with one chunk) the
// combine.
template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           const int* q_pos, void* out, float* pm, float* pl, float* pacc,
           int B, int KV, int G, int S, int D, int window, int chunk,
           bool partials, cudaStream_t st) {
  const int nc = (S + chunk - 1) / chunk;
  if ((nc > 1 || partials) && (pm == nullptr || pl == nullptr || pacc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = copy_width(static_cast<size_t>(D) * sizeof(T), k, v);
  if (w == 0) return static_cast<int>(cudaErrorMisalignedAddress);
  Smem sizes;
  const size_t smem = lay_out<T, T, false>(sizes, nullptr, G, D, kTile, chunk);
  const auto kernel = ring_split_kernel<T>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kernel<<<dim3(B * KV, nc), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      q_pos, static_cast<T*>(out), pm, pl, pacc, KV, G, S, D, window, chunk, nc, w,
      scale, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 1 || partials) return static_cast<int>(err);
  launch_combine<T>(pm, pl, pacc, out, B * KV * G, nc, D, st);
  return static_cast<int>(cudaGetLastError());
}

int ring_entry(int dtype, const void* q, const void* k, const void* v,
               const void* pos, const void* q_pos, void* out, void* part_m,
               void* part_l, void* part_acc, int B, int KV, int G, int S, int D,
               int window, int chunk, bool partials, void* stream) {
  if (B < 1 || KV < 1 || G < 1 || S < 1 || D < 1 || D % 4 != 0 || D > 4 * kThreads ||
      chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const int*>(pos);
  const auto* qp = static_cast<const int*>(q_pos);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, p, qp, out, pm, pl, pa, B, KV, G, S, D, window, chunk,
                         partials, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, p, qp, out, pm, pl, pa, B, KV, G, S, D, window,
                                 chunk, partials, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_ring_decode(int dtype, const void* q, const void* k, const void* v,
                      const void* pos, const void* q_pos, void* out,
                      void* part_m, void* part_l, void* part_acc, int B,
                      int KV, int G, int S, int D, int window, int chunk,
                      void* stream) {
  return ring_entry(dtype, q, k, v, pos, q_pos, out, part_m, part_l, part_acc, B, KV, G,
                    S, D, window, chunk, false, stream);
}

int repro_ring_decode_partials(int dtype, const void* q, const void* k,
                               const void* v, const void* pos,
                               const void* q_pos, void* part_m, void* part_l,
                               void* part_acc, int B, int KV, int G, int S,
                               int D, int window, int chunk, void* stream) {
  return ring_entry(dtype, q, k, v, pos, q_pos, nullptr, part_m, part_l, part_acc, B, KV,
                    G, S, D, window, chunk, true, stream);
}

int repro_ring_combine(int dtype, const void* part_m, const void* part_l,
                       const void* part_acc, void* out, int rows, int nc, int D,
                       void* stream) {
  if (rows < 1 || nc < 1 || D < 1 || part_m == nullptr || part_l == nullptr ||
      part_acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pm = static_cast<const float*>(part_m);
  const auto* pl = static_cast<const float*>(part_l);
  const auto* pa = static_cast<const float*>(part_acc);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    split::launch_combine<float>(pm, pl, pa, out, rows, nc, D, st);
  else if (dtype == 1)
    split::launch_combine<__nv_bfloat16>(pm, pl, pa, out, rows, nc, D, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
