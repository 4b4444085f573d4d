"""The decoder-only LM, dense or mamba-2 (``arch_type="ssm"``): the
full-sequence forward and loss, the paged serving steps (dense), and the
one-token decode step of the static-bucket serving path (both archs).

Parameters are a nested dict of tensors with the JAX package's tree and
leaf layout (``embed/table``, ``layers/attn/wq``, ...): per-layer leaves
are stacked on a leading ``(L, ...)`` axis and the layer loop indexes
them, where the JAX package scans.  Paths are those of the JAX package's
checkpoint manifest, so ``repro_torch.checkpoint.params_from_numpy`` maps
a JAX checkpoint onto this tree with no transposes.

Norm placement: the first ``ln1`` is a plain RMSNorm; every later norm
(``ln2``, the next layer's ``ln1``, the final norm) follows a residual
add and runs as the fused RMSNorm + residual kernel, ``2L + 1`` norm
launches per forward (``L + 1`` for the SSM block, ``h + mamba(norm(h))``,
which has no MLP).  In float32 that is the same math as the JAX
package's ``h = h + a; x = norm(h)``.

Training (``forward_hidden``, ``lm_loss``) differentiates through the
kernels' ``autograd.Function``s.  The stacked leaves are split into their
L layers once per forward with ``unbind``, whose backward stacks the L
layer gradients in one op.

Rematerialisation.  With ``cfg.remat`` (the default, as in the JAX
package, which wraps each layer in ``jax.checkpoint``) each layer runs
under ``torch.utils.checkpoint``: only its inputs are kept, and its
forward runs again in the backward.  Because every residual add is fused
with the NEXT norm, one unit runs from ``(x_i, h_i)`` (layer i's normed
input and its residual stream) to ``(x_{i+1}, h_{i+1})`` and takes the
next norm's scale as an input; the reference's unit carries ``h`` alone.
The kernels give the same bits on a second call, so remat on and off give
the same loss and gradients bit for bit.  It applies only when the
forward builds a graph: the evals and serving run under ``no_grad`` and
do not pay for the recompute.

The KV pool is updated IN PLACE: ``decode_step_paged`` and
``verify_step_paged`` return the same pool dict they were given, payload
and (for a quantized ``kv_cache_dtype``) scale planes alike.  So is the
static path's cache (``init_decode_cache``): ``decode_step_lm`` writes
the ring cache's slot, or the SSM conv ring and state, into the tensors
it was given.

``cfg.fp8_matmul`` reaches the paged serving kernels only (fp8 QK^T).
The JAX package's training attention has no fp8 path, so the training
forward ignores the flag, as the reference does.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import kv_pool_dtype
from repro_torch.models.layers import (apply_mlp, apply_norm,
                                       apply_norm_residual, embed,
                                       softmax_ce_sums,
                                       rope_cos_sin, softmax_cross_entropy,
                                       torch_dtype, unembed)

Params = Dict[str, object]


def _require_supported(cfg: ModelConfig) -> None:
    """The port runs the dense decoder and the mamba-2 decoder; MoE,
    hybrid, encoder-decoder and VLM archs raise."""
    if (cfg.arch_type not in ("dense", "ssm") or cfg.num_experts
            or cfg.hybrid or cfg.is_encoder_decoder or cfg.num_image_tokens
            or (cfg.arch_type == "dense") == bool(cfg.ssm_state_size)):
        raise NotImplementedError(
            f"arch {cfg.arch_type!r}: the port runs the dense and the ssm "
            f"(mamba-2) decoders only")


def _require_uniform_window(cfg: ModelConfig) -> None:
    if cfg.window_pattern:
        raise NotImplementedError("per-layer window_pattern is not ported")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Checkpoint-manifest path -> shape of every parameter leaf.  The SSM
    block has ``ln1`` and ``mamba`` and no ``attn``, ``ln2`` or ``mlp``."""
    _require_supported(cfg)
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim()
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    V = cfg.padded_vocab()
    shapes = {"embed/table": (V, d), "final_norm/scale": (d,),
              "layers/ln1/scale": (L, d)}
    if cfg.arch_type == "ssm":
        shapes.update({f"layers/mamba/{k}": (L,) + v for k, v in
                       ssm_mod.mamba_param_shapes(cfg).items()})
    else:
        shapes.update({
            "layers/ln2/scale": (L, d),
            "layers/attn/wq": (L, d, nq), "layers/attn/wk": (L, d, nkv),
            "layers/attn/wv": (L, d, nkv), "layers/attn/wo": (L, nq, d),
            "layers/mlp/w_up": (L, d, f), "layers/mlp/w_gate": (L, d, f),
            "layers/mlp/w_down": (L, f, d)})
    if not cfg.tie_embeddings:
        shapes["embed/unembed"] = (d, V)
    if cfg.qkv_bias and cfg.arch_type != "ssm":
        shapes.update({"layers/attn/bq": (L, nq), "layers/attn/bk": (L, nkv),
                       "layers/attn/bv": (L, nkv)})
    return shapes


def unflatten(flat: Dict[str, torch.Tensor]) -> Params:
    """{"a/b/c": t} -> {"a": {"b": {"c": t}}}."""
    tree: Params = {}
    for path, leaf in flat.items():
        node = tree
        *heads, last = path.split("/")
        for k in heads:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def flatten(tree: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Inverse of :func:`unflatten`."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cpu") -> Params:
    """Random parameters from ``seed`` with the JAX package's init rules
    (truncated-normal fan-in matrices, N(0, 0.02) embedding, unit norm
    scales, zero biases; the mamba leaves as ``ssm.init_mamba``), drawn
    from a ``torch.Generator`` on ``device``.
    The numbers differ from the JAX package's (another generator); tests
    that compare the two load one set of parameters into both."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dt = torch_dtype(cfg.param_dtype)
    L, f = cfg.num_layers, cfg.d_ff
    nq = cfg.num_heads * cfg.resolved_head_dim()
    special_scale = {"layers/attn/wo": 1.0 / math.sqrt(2 * max(L, 1) * nq),
                     "layers/mlp/w_down": 1.0 / math.sqrt(max(f, 1))}
    flat = {}
    for path, shape in param_shapes(cfg).items():
        if path.startswith("layers/mamba/"):
            continue
        leaf = path.rsplit("/", 1)[1]
        t = torch.empty(shape, dtype=dt, device=device)
        if leaf == "scale":
            t.fill_(1.0)
        elif leaf in ("bq", "bk", "bv"):
            t.zero_()
        elif leaf == "table":
            t.normal_(0.0, 0.02, generator=g)
        else:
            fan_in = shape[-2]
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=g)
            t.mul_(special_scale.get(path, 1.0 / math.sqrt(fan_in)))
        flat[path] = t
    if cfg.arch_type == "ssm":
        flat.update({f"layers/mamba/{k}": v for k, v in ssm_mod.init_mamba(
            g, cfg, stack=(L,), dtype=dt, device=device).items()})
    return unflatten(flat)


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------

def _unstack(tree: Params, n: int) -> List[Params]:
    """The n per-layer trees of a stacked (L, ...) subtree, by ``unbind``."""
    per_leaf = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def _run_layers(params: Params, h: torch.Tensor, cfg: ModelConfig,
                mix, mm=torch.matmul) -> torch.Tensor:
    """Every block and the final norm; returns the final-normed hidden.
    ``mix(i, layer_params, x)`` is layer i's mixer output on its normed
    input (attention; the mamba block for ``arch_type="ssm"``, which has
    no MLP); ``mm`` the MLP's matrix product.  The first ``ln1`` is a
    plain RMSNorm, every later norm is fused with the residual add before
    it.  With ``cfg.remat``, and only when the forward builds a graph,
    each unit runs under ``torch.utils.checkpoint``."""
    _require_supported(cfg)
    _require_uniform_window(cfg)
    L = cfg.num_layers
    ssm = cfg.arch_type == "ssm"
    layers = _unstack(params["layers"], L)

    def block(i, lp, nxt, x, h):
        y = mix(i, lp, x)
        if not ssm:
            x, h = apply_norm_residual(lp["ln2"], y, h, cfg)
            y = apply_mlp(lp["mlp"], x, cfg, mm=mm)
        return apply_norm_residual(nxt, y, h, cfg)

    remat = cfg.remat and _needs_grad(params, h)
    x = apply_norm(layers[0]["ln1"], h, cfg)
    for i, lp in enumerate(layers):
        nxt = layers[i + 1]["ln1"] if i + 1 < L else params["final_norm"]
        if remat:
            # the forward is deterministic and draws no random numbers,
            # so the recompute gives the saved tensors' bits again
            x, h = checkpoint(block, i, lp, nxt, x, h, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, h = block(i, lp, nxt, x, h)
    return x


def _needs_grad(params: Params, h: torch.Tensor) -> bool:
    """Whether this forward builds a graph: grad mode on and a parameter
    or the input requiring grad.  The evals and serving build none."""
    if not torch.is_grad_enabled():
        return False
    return h.requires_grad or any(
        t.requires_grad for t in flatten(params).values())


def forward_hidden(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward up to the final norm.  batch["tokens"]:
    (B, S) int.  Returns (h (B, S, d), aux_loss) — aux is 0: neither the
    dense nor the SSM decoder has a router loss."""
    h = embed(params["embed"], batch["tokens"], cfg)
    if cfg.arch_type == "ssm":
        x = _run_layers(params, h, cfg, lambda i, p, x: ssm_mod.apply_mamba(
            p["mamba"], x, cfg))
    else:
        positions = torch.arange(h.shape[1], device=h.device)
        window = cfg.window or None
        x = _run_layers(params, h, cfg, lambda i, p, x: attn.attention(
            p["attn"], x, cfg, positions=positions, window=window))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_lm(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B, S, V), aux_loss)."""
    h, aux = forward_hidden(params, batch, cfg)
    return unembed(params["embed"], h, cfg), aux


def _chunk_ce_sums(embed_p, h, labels, cfg: ModelConfig):
    """CE sum and valid count of one sequence chunk (see
    ``softmax_ce_sums``)."""
    return softmax_ce_sums(unembed(embed_p, h, cfg), labels,
                           z_loss=cfg.z_loss)


def _chunked_ce(params: Params, h: torch.Tensor, labels: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Cross-entropy without keeping the full (B, S, V) logits: the
    sequence is cut into ``cfg.loss_chunk`` chunks, each projected to the
    vocab on its own, in order, and rematerialised in the backward
    (``torch.utils.checkpoint``), so at most one chunk's logits live at a
    time.  The JAX package scans the same chunks."""
    B, S, _ = h.shape
    C = min(cfg.loss_chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, C):
        t, c = checkpoint(_chunk_ce_sums, params["embed"], h[:, i:i + C],
                          labels[:, i:i + C], cfg, use_reentrant=False)
        tot = tot + t
        cnt = cnt + c
    return tot / cnt.clamp(min=1.0)


def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token CE of ``batch`` {"tokens", "labels"} (B, S).
    Returns (loss, {"ce", "aux"})."""
    if cfg.loss_chunk:
        h, aux = forward_hidden(params, batch, cfg)
        ce = _chunked_ce(params, h, batch["labels"], cfg)
    else:
        logits, aux = forward_lm(params, batch, cfg)
        ce = softmax_cross_entropy(logits, batch["labels"],
                                   z_loss=cfg.z_loss)
    return ce, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------

def paged_cache_supported(cfg: ModelConfig) -> bool:
    """The paged pool stores attention K/V only: ssm/hybrid and
    encoder-decoder archs cannot be position-gated."""
    return (cfg.arch_type != "ssm" and not cfg.hybrid
            and not cfg.is_encoder_decoder)


def paged_block_bytes(cfg: ModelConfig, block_size: int) -> int:
    """Bytes one physical KV block costs across ALL layers: the payload,
    plus the f32 per-token-per-head scale planes of a quantized pool."""
    hd = cfg.resolved_head_dim()
    item = torch.empty((), dtype=kv_pool_dtype(cfg)).element_size()
    per_layer = 2 * block_size * cfg.num_kv_heads * hd * item
    if attn.kv_quant_dtype(cfg) is not None:
        per_layer += 2 * block_size * cfg.num_kv_heads * 4
    return cfg.num_layers * per_layer


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """A zeroed pool of ``num_blocks`` KV blocks shared by all slots,
    stacked over layers: {"k", "v"} each (L, NB, bs, KV, hd) in
    ``kv_pool_dtype(cfg)``, plus {"k_scale", "v_scale"} (L, NB, bs, KV)
    f32 for a quantized pool."""
    if not paged_cache_supported(cfg):
        raise NotImplementedError(
            f"paged KV cache unsupported for arch {cfg.arch_type!r}")
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim())
    dt = kv_pool_dtype(cfg)
    pool = {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
    if attn.kv_quant_dtype(cfg) is not None:
        pool.update({k: torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=device)
                     for k in ("k_scale", "v_scale")})
    return pool


# ---------------------------------------------------------------------------
# Paged decode / verify steps
# ---------------------------------------------------------------------------

def _paged_layers(params: Params, h: torch.Tensor, pool, cfg: ModelConfig,
                  positions: torch.Tensor, block_table: torch.Tensor,
                  scatter=None) -> torch.Tensor:
    """Run every layer over the paged pool and apply the final norm.
    h: (S, T, d); positions: (S, T); scatter: optional host-made (rows,
    dest), see ``attention.paged_inputs``.  Returns the final-normed
    hidden."""
    inputs = attn.paged_inputs(positions, block_table, cfg,
                               pool["k"].shape[2], scatter)
    quantized = "k_scale" in pool
    return _run_layers(params, h, cfg, lambda i, p, x:
                       attn.paged_decode_attention(
                           p["attn"], x, cfg, pool["k"][i], pool["v"][i],
                           inputs,
                           block_table, window=cfg.window,
                           k_scale=pool["k_scale"][i] if quantized else None,
                           v_scale=pool["v_scale"][i] if quantized else None),
                       mm=attn.serving_matmul(cfg))


def decode_step_paged(params: Params, pool, batch,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step over the slot set.  batch: {"token": (S, 1) int32,
    "position": (S,) int32 (−1 = inactive slot), "block_table": (S, MB)
    int32}, and optionally "kv_scatter": the (rows, dest) int64 tensors of
    ``attention.scatter_plan`` — without them the step reads one count back
    from the device.  Returns (logits (S, 1, V), pool), the pool updated in
    place."""
    h = embed(params["embed"], batch["token"], cfg)
    x = _paged_layers(params, h, pool, cfg, batch["position"][:, None],
                      batch["block_table"], batch.get("kv_scatter"))
    logits = unembed(params["embed"], x, cfg, mm=attn.serving_matmul(cfg))
    return logits, pool


def verify_step_paged(params: Params, pool, batch,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """Multi-token step (speculative verification / chunked prefill):
    batch: {"tokens": (S, T) int32, "positions": (S, T) int32 — −1 for
    padding tokens and inactive slots, live positions a contiguous prefix
    of each row — "block_table": (S, MB) int32}, and optionally
    "kv_scatter" as in :func:`decode_step_paged`.  Returns (logits
    (S, T, V), pool), the pool updated in place."""
    h = embed(params["embed"], batch["tokens"], cfg)
    x = _paged_layers(params, h, pool, cfg, batch["positions"],
                      batch["block_table"], batch.get("kv_scatter"))
    logits = unembed(params["embed"], x, cfg, mm=attn.serving_matmul(cfg))
    return logits, pool


# ---------------------------------------------------------------------------
# Static-path decode (ring cache / SSM state)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int, *,
                      dtype=None, device="cpu") -> dict:
    """Stacked (L, ...) decode caches of the static path.  Dense: the ring
    cache of ``attention.init_cache`` with ``capacity`` slots per row (in
    the compute dtype by default) and one shared write index; SSM:
    {"mamba": {"conv", "ssm"}} (float32 by default), whose size does not
    depend on ``capacity``."""
    _require_supported(cfg)
    _require_uniform_window(cfg)
    L = cfg.num_layers
    if cfg.arch_type == "ssm":
        return {"mamba": ssm_mod.init_mamba_cache(
            cfg, batch, dtype=dtype or torch.float32, device=device,
            stack=(L,))}
    return {"attn": attn.init_cache(cfg, batch, capacity, dtype=dtype,
                                    device=device, stack=(L,))}


def _block_decode(i: int, lp: Params, x: torch.Tensor, cfg: ModelConfig,
                  cache: dict, position: torch.Tensor, rope) -> torch.Tensor:
    """Layer i's one-token mixer on its normed input x (B, 1, d), the
    mixer half of the JAX package's ``_block_decode`` (the norms, the
    residual adds and the MLP are ``_run_layers``'): the mamba step on
    layer i's conv ring and state, or self-attention on its ring cache
    with the config's uniform window (0 = none), both updated in place."""
    if cfg.arch_type == "ssm":
        mc = cache["mamba"]
        y, _ = ssm_mod.decode_mamba(lp["mamba"], x, cfg, {
            "conv": mc["conv"][i], "ssm": mc["ssm"][i]})
        return y
    ac = cache["attn"]
    y, _ = attn.decode_attention(
        lp["attn"], x, cfg, {"k": ac["k"][i], "v": ac["v"][i],
                             "pos": ac["pos"][i], "idx": ac["idx"]},
        position=position, window=cfg.window, rope=rope)
    return y


def decode_step_lm(params: Params, cache: dict, batch,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step of the static path.  batch: {"token": (B, 1) int,
    "position": (B,) int32 tensor or an int for every row} — the absolute
    position of the token, -1 for a left-pad token.  Returns (logits
    (B, 1, V), cache), the cache updated in place (its ring index
    advanced)."""
    token = batch["token"]
    B = token.shape[0]
    position = batch["position"]
    if not torch.is_tensor(position):
        position = torch.full((B,), int(position), dtype=torch.int32)
    position = position.to(device=token.device,
                           dtype=torch.int32).reshape(-1).expand(B)
    position = position.contiguous()
    h = embed(params["embed"], token, cfg)
    rope = None
    if cfg.arch_type != "ssm":
        rope = rope_cos_sin(position[:, None], cfg.resolved_head_dim(),
                            cfg.rope_theta)
    x = _run_layers(params, h, cfg, lambda i, p, x: _block_decode(
        i, p, x, cfg, cache, position, rope))
    if "attn" in cache:
        cache["attn"]["idx"] += 1
    return unembed(params["embed"], x, cfg), cache
