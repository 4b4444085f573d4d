"""Grouped-query attention: the training path (``attention``, through the
flash attention kernel) and the serving path against a paged KV pool.

Training: the JAX package picks one of three jnp score paths per call
(``_direct``, ``_blocked``, ``_banded``); all three compute causal softmax
attention with an optional window, so here all map onto the one flash
function (``repro_torch.kernels.flash_attention``), whose backward is a
kernel too.  Nothing of size (B, H, S, S) is kept for autograd.

Paged serving: GQA is computed grouped: queries are shaped (S, T, KV, G, hd),
so KV heads are never repeated.  The fresh K/V of every live token are
written into the pool IN PLACE before the attention reads it (the JAX package returns
a new pool; here the caller's pool tensors are updated), then the paged
kernels (``repro_torch.kernels.decode_attention``) read it through the
block table: the decode kernel for T = 1 token per slot, the verify kernel
for T > 1.

The pool's storage follows ``cfg.kv_cache_dtype`` (``kv_pool_dtype``):
the compute dtype, bf16 or f32 (plain pools, read in the compute dtype),
or int8 / fp8 / fp8_e5m2 (quantized pools: a 1-byte payload plus f32
per-token-per-head scale planes).  A quantized pool is written through
``kernels.quantize.quantize_axis`` over the head dim of the RoPE'd K and
the V (quantize on scatter) and read by the dequant kernels (dequant on
load).  ``cfg.fp8_matmul`` runs the plain-pool kernels' QK^T on per-row
fp8 tiles; the dequant kernels keep the f32 contraction, as in the JAX
package.

Static serving (``decode_attention``): one token per row against a
fixed-capacity ring cache (``init_cache``) of k / v (B, KV, cap, hd), a
per-slot position array pos (B, cap) (-1 = empty) and one shared write
index ``idx``; the new K/V go to slot ``idx % cap`` IN PLACE
(``_cache_insert``), then the ring decode kernel
(``kernels.decode_attention.decode_attention``) attends the live slots:
the JAX package's ``_mask_bias`` gates (slot filled, causal, window).
The cache keeps the kernel's (B, KV, cap, hd) layout, not the JAX
package's (B, cap, KV, hd), so no step transposes it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import decode_attention as attn_kernels
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.quantize import quantize_axis, target_dtype
from repro_torch.models.layers import (apply_rope, cast, rope_cos_sin,
                                       token_matmul, torch_dtype)

# ``ModelConfig.kv_cache_dtype`` spellings -> quantize target names, and
# the plain spellings -> dtype names ("" = the compute dtype)
KV_QUANT_TARGETS = {"int8": "int8", "fp8": "fp8_e4m3",
                    "fp8_e4m3": "fp8_e4m3", "fp8_e5m2": "fp8_e5m2"}
_KV_PLAIN = {"": None, "bf16": "bfloat16", "bfloat16": "bfloat16",
             "f32": "float32", "float32": "float32"}


def kv_quant_dtype(cfg: ModelConfig) -> Optional[str]:
    """The quantize target the config's KV pool uses, or None for a plain
    pool.  Raises ``ValueError`` on an unknown spelling."""
    s = cfg.kv_cache_dtype
    if s in _KV_PLAIN:
        return None
    if s not in KV_QUANT_TARGETS:
        raise ValueError(f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r}; "
                         f"expected one of {sorted(_KV_PLAIN)} or "
                         f"{sorted(KV_QUANT_TARGETS)}")
    return KV_QUANT_TARGETS[s]


def serving_matmul(cfg: ModelConfig):
    """The matrix product of a serving forward.  Where the attention
    quantizes K and V (a quantized pool) or Q and K (``fp8_matmul``), a
    last-bit difference can move a value across a rounding boundary, a
    whole quantum, and greedy speculative decoding would part from
    sequential decoding: there every GEMM runs per token column
    (``token_matmul``), so a verify forward computes what decode forwards
    do to the bit.  Elsewhere one GEMM per projection, whose last-bit
    differences stay last-bit."""
    if kv_quant_dtype(cfg) is not None or cfg.fp8_matmul:
        return token_matmul
    return torch.matmul


def kv_pool_dtype(cfg: ModelConfig) -> torch.dtype:
    """Storage dtype of the paged pool's k/v."""
    qd = kv_quant_dtype(cfg)
    if qd is not None:
        return target_dtype(qd)
    return torch_dtype(_KV_PLAIN[cfg.kv_cache_dtype] or cfg.compute_dtype)


class PagedInputs(NamedTuple):
    """Per-forward facts every layer shares, derived once from the step's
    positions (S, T) and block table (S, MB)."""
    cos: torch.Tensor        # (S, T, 1, hd/2) rotary tables at max(pos, 0)
    sin: torch.Tensor
    rows: torch.Tensor       # (n,) int64: flat (S*T) rows whose K/V are kept
    dest: torch.Tensor       # (n,) int64: their flat pool rows blk*bs + off
    q_pos: torch.Tensor      # (S,) int32: position of token 0, −1 inactive
    n_tok: torch.Tensor      # (S,) int32: live tokens per slot


def scatter_plan(positions: np.ndarray, block_table: np.ndarray,
                 block_size: int) -> np.ndarray:
    """Which fresh K/V rows a forward writes, and where, worked out on the
    host from numpy ``positions`` (S, T) and ``block_table`` (S, MB).

    Returns (2, n) int64: the flat (S*T) rows whose K/V are kept and their
    flat pool rows ``blk*bs + off``.  A token is kept iff it is live and
    its logical block is mapped (and inside the table); everything else is
    dropped, as the JAX package's out-of-bounds scatter drops it."""
    MB = block_table.shape[1]
    posc = np.maximum(positions, 0)
    col = posc // block_size
    blk = np.take_along_axis(block_table, np.minimum(col, MB - 1), axis=1)
    keep = ((positions >= 0) & (col < MB) & (blk >= 0)).reshape(-1)
    rows = np.nonzero(keep)[0]
    dest = (blk.astype(np.int64) * block_size
            + posc % block_size).reshape(-1)[rows]
    return np.stack([rows.astype(np.int64), dest])


def paged_inputs(positions: torch.Tensor, block_table: torch.Tensor,
                 cfg: ModelConfig, block_size: int,
                 scatter: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> PagedInputs:
    """positions: (S, T) int32, −1 for a padding token or inactive slot;
    live positions of a slot must be a contiguous prefix of its row.

    ``scatter``: the (rows, dest) int64 tensors of :func:`scatter_plan`,
    computed by a caller that holds the positions and tables on the host
    (the engine does).  Without it the kept rows are selected here, with
    the same rule, which reads one count back from the device."""
    MB = block_table.shape[1]
    active = positions >= 0
    posc = positions.clamp(min=0)
    if scatter is None:
        col = torch.div(posc, block_size, rounding_mode="floor")
        blk = torch.gather(block_table, 1, col.clamp(max=MB - 1).long())
        keep = (active & (col < MB) & (blk >= 0)).reshape(-1)
        flat = (blk.long() * block_size + posc % block_size).reshape(-1)
        rows = torch.nonzero(keep).squeeze(1)
        scatter = (rows, flat[rows])
    cos, sin = rope_cos_sin(posc, cfg.resolved_head_dim(), cfg.rope_theta)
    q_pos = torch.where(active[:, 0], positions[:, 0],
                        torch.full_like(positions[:, 0], -1))
    n_tok = active.sum(dim=1, dtype=torch.int32)
    return PagedInputs(cos, sin, scatter[0], scatter[1], q_pos.contiguous(),
                       n_tok)


def project_qkv(p, x: torch.Tensor, cfg: ModelConfig, mm=torch.matmul):
    """x: (S, T, d) -> q (S, T, KV, G, hd), k/v (S, T, KV, hd) (for
    training, (B, S, d) in, the same shapes with B, S); ``mm`` is the
    matrix product (``serving_matmul`` when serving)."""
    dt = x.dtype
    hd = cfg.resolved_head_dim()
    q = mm(x, cast(p["wq"], dt))
    k = mm(x, cast(p["wk"], dt))
    v = mm(x, cast(p["wv"], dt))
    if "bq" in p:
        q = q + cast(p["bq"], dt)
        k = k + cast(p["bk"], dt)
        v = v + cast(p["bv"], dt)
    S, T = x.shape[:2]
    KV = cfg.num_kv_heads
    return (q.reshape(S, T, KV, cfg.num_heads // KV, hd),
            k.reshape(S, T, KV, hd), v.reshape(S, T, KV, hd))


def attention(p, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor,
              window: Optional[int] = None) -> torch.Tensor:
    """Training / prefill self-attention over a full causal sequence.
    x: (B, S, d); positions: (S,) — the JAX package's ``attention`` with
    ``memory`` None.  Returns y (B, S, d)."""
    B, S = x.shape[:2]
    H, hd = cfg.num_heads, cfg.resolved_head_dim()
    q, k, v = project_qkv(p, x, cfg)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q.reshape(B, S, H, hd), cos, sin)
    k = apply_rope(k, cos, sin)
    out = flash_attention(q, k, v.contiguous(), causal=True,
                          window=window or None)
    return out.reshape(B, S, H * hd) @ cast(p["wo"], x.dtype)


def _scatter(pool: torch.Tensor, rows: torch.Tensor,
             dest: torch.Tensor) -> None:
    """pool (NB, bs, KV, hd).view(NB*bs, KV, hd)[dest] = rows, in place;
    1-byte payloads are written as bytes (no fp8 ``index_copy_``)."""
    NB, bs = pool.shape[:2]
    flat = pool.view(NB * bs, *pool.shape[2:])
    rows = rows.to(pool.dtype)
    if pool.element_size() == 1:
        flat, rows = flat.view(torch.uint8), rows.view(torch.uint8)
    flat.index_copy_(0, dest, rows)


def paged_decode_attention(p, x: torch.Tensor, cfg: ModelConfig,
                           k_pool: torch.Tensor, v_pool: torch.Tensor,
                           inputs: PagedInputs, block_table: torch.Tensor,
                           window: Optional[int] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Decode / verify attention for T fresh tokens per slot.

    x: (S, T, d); k_pool/v_pool: (NB, bs, KV, hd), updated in place with
    the fresh K/V: a plain pool in any float dtype (read in x's), or a
    quantized payload with ``k_scale`` / ``v_scale`` (NB, bs, KV) f32,
    updated in place with it; block_table: (S, MB) int32.  Returns
    y (S, T, d); rows of inactive slots and padding tokens are garbage the
    caller ignores."""
    S, T = x.shape[:2]
    hd = cfg.resolved_head_dim()
    KV = cfg.num_kv_heads
    quantized = k_scale is not None
    mm = serving_matmul(cfg)
    q, k_new, v_new = project_qkv(p, x, cfg, mm=mm)
    q = apply_rope(q.reshape(S, T, cfg.num_heads, hd), inputs.cos,
                   inputs.sin).reshape(q.shape)
    k_new = apply_rope(k_new, inputs.cos, inputs.sin)

    k_rows = k_new.reshape(S * T, KV, hd).index_select(0, inputs.rows)
    v_rows = v_new.reshape(S * T, KV, hd).index_select(0, inputs.rows)
    if quantized:               # quantize on scatter, one scale per row
        qd = kv_quant_dtype(cfg)
        k_rows, k_s = quantize_axis(k_rows, axis=-1, dtype=qd)
        v_rows, v_s = quantize_axis(v_rows, axis=-1, dtype=qd)
        NB, bs = k_scale.shape[:2]
        k_scale.view(NB * bs, KV).index_copy_(0, inputs.dest, k_s[..., 0])
        v_scale.view(NB * bs, KV).index_copy_(0, inputs.dest, v_s[..., 0])
    _scatter(k_pool, k_rows, inputs.dest)
    _scatter(v_pool, v_rows, inputs.dest)

    w = int(window or 0)
    if T == 1:
        q0 = q[:, 0].contiguous()
        if quantized:
            out = attn_kernels.paged_decode_attention_dequant(
                q0, k_pool, v_pool, k_scale, v_scale, block_table,
                inputs.q_pos, window=w)
        else:
            out = attn_kernels.paged_decode_attention(
                q0, k_pool, v_pool, block_table, inputs.q_pos, window=w,
                fp8=cfg.fp8_matmul)
        out = out[:, None]
    elif quantized:
        out = attn_kernels.paged_verify_attention_dequant(
            q.contiguous(), k_pool, v_pool, k_scale, v_scale, block_table,
            inputs.q_pos, inputs.n_tok, window=w)
    else:
        out = attn_kernels.paged_verify_attention(
            q.contiguous(), k_pool, v_pool, block_table, inputs.q_pos,
            inputs.n_tok, window=w, fp8=cfg.fp8_matmul)
    out = out.reshape(S, T, cfg.num_heads * hd)
    return mm(out, cast(p["wo"], x.dtype))


# ---------------------------------------------------------------------------
# Ring KV cache (the static-bucket serving path)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, capacity: int, *, dtype=None,
               device="cpu", stack: Tuple[int, ...] = ()) -> dict:
    """A fixed-capacity cache: {"k", "v": stack + (B, KV, cap, hd) in
    ``dtype`` (default the compute dtype), "pos": stack + (B, cap) int32
    filled with -1, "idx": 0, the next write slot (mod cap), shared by
    every layer of a stack}."""
    hd = cfg.resolved_head_dim()
    dt = dtype or torch_dtype(cfg.compute_dtype)
    shape = stack + (batch, cfg.num_kv_heads, capacity, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.full(stack + (batch, capacity), -1,
                              dtype=torch.int32, device=device),
            "idx": 0}


def _cache_insert(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                  pos_new: torch.Tensor) -> dict:
    """Write S_new entries (k_new / v_new (B, S_new, KV, hd), pos_new (B,
    S_new)) at slot ``idx mod cap`` IN PLACE.  Decode writes one position,
    so a write never crosses the ring's end.  Returns the cache dict with
    ``idx`` advanced (the same tensors)."""
    cap = cache["k"].shape[2]
    s_new = k_new.shape[1]
    slot = cache["idx"] % cap
    cache["k"][:, :, slot:slot + s_new] = k_new.transpose(1, 2)
    cache["v"][:, :, slot:slot + s_new] = v_new.transpose(1, 2)
    cache["pos"][:, slot:slot + s_new] = pos_new
    return dict(cache, idx=cache["idx"] + s_new)


def decode_attention(p, x: torch.Tensor, cfg: ModelConfig, cache: dict, *,
                     position: torch.Tensor, window: int = 0,
                     memory_cache=None, rope=None):
    """One-token self-attention decode against a ring cache (one layer's
    {"k", "v", "pos", "idx"}).  x: (B, 1, d); position: (B,) int32
    absolute position of the new token (-1 for a left-pad token, whose row
    is garbage nothing reads); window: 0 = none.  ``rope``: the (cos, sin)
    tables of ``position``, when the caller shares them across layers.
    Returns (y (B, 1, d), cache with idx advanced), the tensors updated in
    place.  Cross-attention (``memory_cache``) waits for the
    encoder-decoder slice."""
    if memory_cache is not None:
        raise NotImplementedError("cross-attention decode (encoder-decoder "
                                  "archs) is not ported")
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.resolved_head_dim()
    q, k_new, v_new = project_qkv(p, x, cfg)
    cos, sin = rope if rope is not None else rope_cos_sin(
        position[:, None], hd, cfg.rope_theta)
    q = apply_rope(q.reshape(B, 1, H, hd), cos, sin).reshape(q.shape)
    k_new = apply_rope(k_new, cos, sin)
    cache = _cache_insert(cache, k_new, v_new, position[:, None])
    out = attn_kernels.decode_attention(
        q[:, 0].contiguous(), cache["k"], cache["v"], cache["pos"],
        position, window=int(window or 0))
    return out.reshape(B, 1, H * hd) @ cast(p["wo"], x.dtype), cache
