"""The LM — dense, MoE, mamba-2 (``arch_type="ssm"``), hybrid (hymba:
attention and SSM heads side by side in every block), the VLM (image
patches before the text) and the encoder-decoder: the full-sequence
forward and loss, the paged serving steps (dense, MoE and the VLM's
text), and the one-token decode step of the static-bucket serving path
(every arch).

VLM (``num_image_tokens``): ``batch["patches"]`` (B, n, d), projected
patch embeddings, go before the embedded tokens; the layers run over
positions 0 .. n + S - 1 under one causal mask, and the patch rows are cut
off after the final norm, so logits and loss are the text's (B, S).
Decode, paged and static, is text-only, as the reference's.

Encoder-decoder (``is_encoder_decoder``): ``encode`` runs the
``encoder`` stack over ``batch["frames"]`` (B, Se, d), bidirectional and
without RoPE, then ``enc_norm``; each decoder block is ln1 ->
self-attention -> add -> ``cross/ln`` -> cross-attention over the
encoder's output -> add -> ln2 -> MLP -> add (every add fused with the
next norm as below).  Its decode reads the per-layer cross K / V of
``init_decode_cache``'s ``cross`` entry: zeros unless the caller fills it
with ``attention.precompute_cross_cache``, as the reference's engine
serves it.  These configs use LayerNorm and a gelu MLP
(``models.layers``).

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
package's ``h = h + a; x = norm(h)``.  A hybrid block's mixer output,
``0.5 (chan_norm(a) mix_a + chan_norm(s) mix_s)``, is what ``ln2``'s
fused kernel adds to the residual.

Windows: each layer attends with its own window (``layer_windows``:
``window_pattern`` cycled over the layers, else the uniform ``window``;
0 = global), a Python int handed to the flash, paged and ring kernels.

MoE blocks (``models.moe``) put the routed experts where the MLP is; the
full forward sums their router losses and ``lm_loss`` adds
``router_aux_coef`` times the sum, as the reference does.

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

Tensor parallelism.  Under an active model axis
(``models.tensor_parallel.use``) with this rank's shards of the dense
decoder's leaves, ``forward_hidden``, ``_chunked_ce`` and ``lm_loss``
run Megatron-style through the layers (``models.layers``,
``models.attention``): the residual stream and the RMSNorm kernels stay
whole on every rank; the logits ``forward_lm`` returns are this rank's
vocab columns (``mesh.model_all_gather(logits, -1)`` joins them).
Per-layer remat recomputes each layer's forward, all-reduces included.
``decode_step_lm`` serves the dense decoder the same way, on the rank's
part of the ring cache (``init_decode_cache(..., mesh=)``; head-parallel
or ``kv_seq``, ``models.sharding.serve_layout``), its logits this rank's
vocab columns.  The other families refuse a model axis, by name, and so
do the paged steps, which serve the ``Engine``: the reference's engine
runs on no mesh (``_require_supported``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import fsdp
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.attention import kv_pool_dtype
from repro_torch.models.layers import (apply_mlp, apply_norm,
                                       apply_norm_residual, cast, embed,
                                       softmax_ce_sums,
                                       rope_cos_sin, softmax_cross_entropy,
                                       torch_dtype, unembed, vocab_split)
from repro_torch.models.sharding import (require_tp_family, serve_layout,
                                         tp_kv_repeat)

Params = Dict[str, object]


ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _require_supported(cfg: ModelConfig, paged: bool = False) -> None:
    """The port runs every arch type the reference's configs use; an
    encoder-decoder's blocks are attention blocks (no SSM, hybrid or
    experts), as the reference's.  Under an active model axis
    (``tensor_parallel.use``) it trains and serves (the static serve
    step) the dense decoder only, each other family refused by name, and
    runs no paged step (``paged``): the paged pool serves the ``Engine``,
    which runs on no mesh, as the reference's."""
    if tp.active() is not None or fsdp.active() is not None:
        if paged:
            raise NotImplementedError(
                "the paged serving steps under a model axis > 1: the paged "
                "pool is the Engine's, and the Engine runs on no mesh, as "
                "the reference's does; serve over a model axis through "
                "launch.steps.make_serve_step (the static ring cache)")
        require_tp_family(cfg, "tensor parallelism over the model axis"
                          if tp.active() is not None
                          else "fsdp over the data axis")
    if cfg.arch_type not in ARCH_TYPES:
        raise NotImplementedError(f"arch {cfg.arch_type!r}: the port runs "
                                  f"{', '.join(ARCH_TYPES)}")
    if cfg.is_encoder_decoder and (cfg.arch_type == "ssm" or cfg.hybrid
                                   or cfg.num_experts):
        raise NotImplementedError("an encoder-decoder's blocks are dense "
                                  "attention blocks")


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer attention windows (0 = global): ``window_pattern``
    cycled over the layers, else the uniform ``window``."""
    if cfg.window_pattern:
        pat = list(cfg.window_pattern)
        return [int(pat[i % len(pat)]) for i in range(cfg.num_layers)]
    return [int(cfg.window)] * cfg.num_layers


def hybrid_inner(cfg: ModelConfig) -> int:
    """The hybrid block's SSM width: as wide as its attention heads."""
    return cfg.num_heads * cfg.resolved_head_dim()


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _norm_shapes(path: str, stack: Tuple[int, ...], cfg: ModelConfig):
    """A norm's leaves: ``scale``, and a LayerNorm's ``bias``."""
    d = cfg.d_model
    out = {f"{path}/scale": stack + (d,)}
    if cfg.norm == "layernorm":
        out[f"{path}/bias"] = stack + (d,)
    return out


def _attn_shapes(path: str, L: int, cfg: ModelConfig, cross: bool = False):
    """An attention stack's projections (and its qkv bias, which the
    reference gives no cross-attention)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    out = {f"{path}/wq": (L, d, nq), f"{path}/wk": (L, d, nkv),
           f"{path}/wv": (L, d, nkv), f"{path}/wo": (L, nq, d)}
    if cfg.qkv_bias and not cross:
        out.update({f"{path}/bq": (L, nq), f"{path}/bk": (L, nkv),
                    f"{path}/bv": (L, nkv)})
    return out


def _mlp_shapes(path: str, L: int, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    out = {f"{path}/w_up": (L, d, f)}
    if cfg.mlp_activation == "swiglu":
        out[f"{path}/w_gate"] = (L, d, f)
    out[f"{path}/w_down"] = (L, f, d)
    return out


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Checkpoint-manifest path -> shape of every parameter leaf.  The SSM
    block has ``ln1`` and ``mamba`` and no ``attn``, ``ln2`` or ``mlp``;
    a hybrid block adds ``mamba`` (``hybrid_inner`` wide), ``mix_a`` and
    ``mix_s`` to the attention block; an MoE block has ``moe`` in place of
    ``mlp``; an MLP without a gate (``relu2``, ``gelu``) has no
    ``w_gate``; a LayerNorm has a ``bias`` beside its ``scale``.  An
    encoder-decoder adds the ``encoder`` stack (``ln1``, ``attn``,
    ``ln2``, ``mlp``; ``num_encoder_layers`` deep), ``enc_norm`` and the
    ``cross`` stack (``ln`` and an ``attn`` without qkv bias, one per
    decoder layer)."""
    _require_supported(cfg)
    L, d = cfg.num_layers, cfg.d_model
    V = cfg.padded_vocab()
    shapes = {"embed/table": (V, d)}
    shapes.update(_norm_shapes("final_norm", (), cfg))
    shapes.update(_norm_shapes("layers/ln1", (L,), cfg))
    if cfg.arch_type == "ssm":
        shapes.update({f"layers/mamba/{k}": (L,) + v for k, v in
                       ssm_mod.mamba_param_shapes(cfg).items()})
    else:
        shapes.update(_norm_shapes("layers/ln2", (L,), cfg))
        shapes.update(_attn_shapes("layers/attn", L, cfg))
        if cfg.hybrid:
            shapes.update({f"layers/mamba/{k}": (L,) + v for k, v in
                           ssm_mod.mamba_param_shapes(
                               cfg, hybrid_inner(cfg)).items()})
            shapes.update({"layers/mix_a": (L, d), "layers/mix_s": (L, d)})
        if cfg.num_experts:
            shapes.update({f"layers/moe/{k}": (L,) + v for k, v in
                           moe_mod.moe_param_shapes(cfg).items()})
        else:
            shapes.update(_mlp_shapes("layers/mlp", L, cfg))
    if not cfg.tie_embeddings:
        shapes["embed/unembed"] = (d, V)
    if cfg.is_encoder_decoder:
        Le = cfg.num_encoder_layers
        shapes.update(_norm_shapes("encoder/ln1", (Le,), cfg))
        shapes.update(_attn_shapes("encoder/attn", Le, cfg))
        shapes.update(_norm_shapes("encoder/ln2", (Le,), cfg))
        shapes.update(_mlp_shapes("encoder/mlp", Le, cfg))
        shapes.update(_norm_shapes("enc_norm", (), cfg))
        shapes.update(_norm_shapes("cross/ln", (L,), cfg))
        shapes.update(_attn_shapes("cross/attn", L, cfg, cross=True))
    return shapes


# logical dim names of the leaves that shard (the reference's annotations
# in its ``init_lm``), by the last two parts of the path; a stacked leaf
# (under ``layers``, ``encoder`` or ``cross``) has "stack" before them, and
# every other dim is unsharded (None)
_LEAF_NAMES = {
    "attn/wq": ("fsdp", "heads"), "attn/wk": ("fsdp", "kv_heads"),
    "attn/wv": ("fsdp", "kv_heads"), "attn/wo": ("heads", "fsdp"),
    "mlp/w_up": ("fsdp", "ffn"), "mlp/w_gate": ("fsdp", "ffn"),
    "mlp/w_down": ("ffn", "fsdp"),
    "moe/router": ("fsdp", None), "moe/shared_up": ("fsdp", "ffn"),
    "moe/shared_gate": ("fsdp", "ffn"), "moe/shared_down": ("ffn", "fsdp"),
    "moe/w_up": ("expert", "fsdp", "ffn"),
    "moe/w_gate": ("expert", "fsdp", "ffn"),
    "moe/w_down": ("expert", "ffn", "fsdp"),
    "mamba/in_proj": ("fsdp", "heads"), "mamba/out_proj": ("heads", "fsdp"),
    "mamba/conv_w": (None, "heads"),
    "embed/table": ("vocab", "fsdp"), "embed/unembed": ("fsdp", "vocab"),
}


def param_names(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Checkpoint-manifest path -> the logical name of each dim of that
    leaf (``models.sharding`` resolves them to mesh axes), the names the
    reference's ``abstract_params`` gives the same leaf."""
    out = {}
    for path, shape in param_shapes(cfg).items():
        parts = path.split("/")
        stacked = parts[0] in ("layers", "encoder", "cross")
        names = ("stack",) if stacked else ()
        rest = _LEAF_NAMES.get("/".join(parts[-2:]),
                               (None,) * (len(shape) - len(names)))
        out[path] = names + rest
    return out


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
    (truncated-normal fan-in matrices, every attention's ``wo`` at
    1/sqrt(2 L H hd) and every ``w_down`` at 1/sqrt(d_ff), the router's
    at scale 0.02, N(0, 0.02) embedding, unit norm scales and hybrid
    mixes, zero biases; the mamba leaves as ``ssm.init_mamba``), drawn
    from a ``torch.Generator`` on ``device``.
    The numbers differ from the JAX package's (another generator); tests
    that compare the two load one set of parameters into both."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dt = torch_dtype(cfg.param_dtype)
    L, f = cfg.num_layers, cfg.d_ff
    nq = cfg.num_heads * cfg.resolved_head_dim()
    # by the path's last two parts: the decoder's, the encoder's and the
    # cross stack's alike (the reference's ``init_attention`` scales every
    # ``wo`` by the decoder's depth)
    special_scale = {"attn/wo": 1.0 / math.sqrt(2 * max(L, 1) * nq),
                     "mlp/w_down": 1.0 / math.sqrt(max(f, 1)),
                     "moe/router": 0.02}
    flat = {}
    for path, shape in param_shapes(cfg).items():
        if path.startswith("layers/mamba/"):
            continue
        leaf = path.rsplit("/", 1)[1]
        t = torch.empty(shape, dtype=dt, device=device)
        if leaf in ("scale", "mix_a", "mix_s"):
            t.fill_(1.0)
        elif leaf in ("bq", "bk", "bv", "bias"):
            t.zero_()
        elif leaf == "table":
            t.normal_(0.0, 0.02, generator=g)
        else:
            fan_in = shape[-2]
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=g)
            t.mul_(special_scale.get("/".join(path.split("/")[-2:]),
                                     1.0 / math.sqrt(fan_in)))
        flat[path] = t
    if cfg.arch_type == "ssm" or cfg.hybrid:
        d_inner = hybrid_inner(cfg) if cfg.hybrid else None
        flat.update({f"layers/mamba/{k}": v for k, v in ssm_mod.init_mamba(
            g, cfg, d_inner, stack=(L,), dtype=dt, device=device).items()})
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
                mix, mm=torch.matmul, cross=None, stack: str = "layers",
                final: str = "final_norm"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every block of ``params[stack]`` and the norm ``params[final]``;
    returns (the final-normed hidden, the sum of the layers' router
    losses).  ``mix(i, layer_params, x)`` is layer i's mixer output on its
    normed input (attention, mixed with the SSM heads on a hybrid block;
    the mamba block for ``arch_type="ssm"``, which has no MLP); ``mm`` the
    MLP's, or the router's and shared experts', matrix product.
    ``cross(i, cross_params, x)``: an encoder-decoder's cross-attention on
    its normed input, between the mixer and the MLP, with layer i of
    ``params["cross"]``.  The first ``ln1`` is a plain norm, every later
    norm is fused with the residual add before it.  With ``cfg.remat``,
    and only when the forward builds a graph, each unit runs under
    ``torch.utils.checkpoint`` (the encoder's as well: ``stack="encoder"``,
    ``final="enc_norm"``).  Under an ``fsdp`` mesh each unit gathers its
    layer's weights first and runs under the checkpoint whatever
    ``cfg.remat`` says (``models.fsdp``)."""
    _require_supported(cfg)
    L = cfg.num_encoder_layers if stack == "encoder" else cfg.num_layers
    ssm = cfg.arch_type == "ssm"
    layers = _unstack(params[stack], L)
    crosses = _unstack(params["cross"], L) if cross is not None \
        else [None] * L
    zero = torch.zeros((), dtype=torch.float32, device=h.device)

    def block(i, lp, cp, nxt, x, h):
        lp = fsdp.gathered(lp, stack)
        y = mix(i, lp, x)
        aux = zero
        if cp is not None:
            x, h = apply_norm_residual(cp["ln"], y, h, cfg)
            y = cross(i, cp, x)
        if not ssm:
            x, h = apply_norm_residual(lp["ln2"], y, h, cfg)
            if cfg.num_experts:
                y, aux = moe_mod.apply_moe(lp["moe"], x, cfg, mm=mm)
            else:
                y = apply_mlp(lp["mlp"], x, cfg, mm=mm)
        x, h = apply_norm_residual(nxt, y, h, cfg)
        return x, h, aux

    remat = ((cfg.remat or fsdp.active() is not None)
             and _needs_grad(params, h))
    x = apply_norm(layers[0]["ln1"], h, cfg)
    aux = zero
    for i, (lp, cp) in enumerate(zip(layers, crosses)):
        nxt = layers[i + 1]["ln1"] if i + 1 < L else params[final]
        if remat:
            # the forward is deterministic and draws no random numbers,
            # so the recompute gives the saved tensors' bits again
            x, h, a = checkpoint(block, i, lp, cp, nxt, x, h,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            x, h, a = block(i, lp, cp, nxt, x, h)
        aux = aux + a
    return x, aux


def _chan_norm(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Scale-free RMS over the channels, in f32, back in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype)


def _hybrid_mix(lp: Params, a: torch.Tensor, s: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """The hybrid block's mixer: the attention heads' output ``a`` and
    the SSM heads' ``s``, each RMS-normalised, weighted and averaged."""
    dt = a.dtype
    return 0.5 * (_chan_norm(a, cfg) * cast(lp["mix_a"], dt)
                  + _chan_norm(s, cfg) * cast(lp["mix_s"], dt))


def _needs_grad(params: Params, h: torch.Tensor) -> bool:
    """Whether this forward builds a graph: grad mode on and a parameter
    or the input requiring grad.  The evals and serving build none."""
    if not torch.is_grad_enabled():
        return False
    return h.requires_grad or any(
        t.requires_grad for t in flatten(params).values())


def encode(params: Params, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """The encoder over frame embeddings (B, Se, d): bidirectional
    attention without RoPE and the MLP in every layer, then ``enc_norm``
    (the reference's ``encode``).  Returns the memory (B, Se, d) in the
    compute dtype."""
    h = frames.to(torch_dtype(cfg.compute_dtype))
    x, _ = _run_layers(params, h, cfg, lambda i, p, x:
                       attn.encoder_attention(p["attn"], x, cfg),
                       stack="encoder", final="enc_norm")
    return x


def _gather_embed(params: Params) -> Params:
    """``params`` with the embedding subtree's data shards joined (an
    active ``fsdp`` mesh), once for the lookup and the logits, so a tied
    table's two gradients are summed before their one reduce-scatter;
    ``params`` itself otherwise."""
    if fsdp.active() is None:
        return params
    return dict(params, embed=fsdp.gathered(params["embed"], "embed"))


def forward_hidden(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward up to the final norm.  batch["tokens"]:
    (B, S) int; with ``num_image_tokens`` also "patches" (B, n, d), with
    an encoder "frames" (B, Se, d).  Returns (h (B, S, d), aux_loss): aux
    is the layers' summed router loss (0 without experts); a VLM's patch
    rows are cut off."""
    return _forward_hidden(_gather_embed(params), batch, cfg)


def _forward_hidden(params: Params, batch: Dict[str, torch.Tensor],
                    cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """``forward_hidden`` on parameters whose embedding is whole (or this
    rank's model shards: ``_gather_embed`` ran)."""
    _require_supported(cfg)
    h = embed(params["embed"], batch["tokens"], cfg)
    if cfg.arch_type == "ssm":
        return _run_layers(params, h, cfg, lambda i, p, x:
                           ssm_mod.apply_mamba(p["mamba"], x, cfg))
    memory = encode(params, batch["frames"], cfg) \
        if cfg.is_encoder_decoder else None
    n_img = cfg.num_image_tokens
    if n_img:
        h = torch.cat([batch["patches"].to(h.dtype), h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)
    windows = layer_windows(cfg)

    def mix(i, p, x):
        a = attn.attention(p["attn"], x, cfg, positions=positions,
                           window=windows[i] or None)
        if cfg.hybrid:
            a = _hybrid_mix(p, a, ssm_mod.apply_mamba(
                p["mamba"], x, cfg, d_inner=hybrid_inner(cfg)), cfg)
        return a

    cross = None
    if memory is not None:
        def cross(i, cp, x):
            return attn.attention(cp["attn"], x, cfg, positions=positions,
                                  memory=memory)

    x, aux = _run_layers(params, h, cfg, mix, cross=cross)
    return (x[:, n_img:] if n_img else x), aux


def forward_lm(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B, S, V), aux_loss); with
    a split vocab, this rank's (B, S, V / model) columns."""
    params = _gather_embed(params)
    h, aux = _forward_hidden(params, batch, cfg)
    return unembed(params["embed"], h, cfg), aux


def _chunk_ce_sums(embed_p, h, labels, cfg: ModelConfig):
    """CE sum and valid count of one sequence chunk (see
    ``softmax_ce_sums``)."""
    return softmax_ce_sums(unembed(embed_p, h, cfg), labels,
                           z_loss=cfg.z_loss,
                           vocab_parallel=vocab_split(embed_p, cfg))


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
    """Mean next-token CE of ``batch`` {"tokens", "labels"} (B, S), plus
    ``router_aux_coef`` times the router loss with experts.  Returns
    (loss, {"ce", "aux"})."""
    if cfg.loss_chunk:
        params = _gather_embed(params)
        h, aux = _forward_hidden(params, batch, cfg)
        ce = _chunked_ce(params, h, batch["labels"], cfg)
    else:
        logits, aux = forward_lm(params, batch, cfg)
        ce = softmax_cross_entropy(
            logits, batch["labels"], z_loss=cfg.z_loss,
            vocab_parallel=vocab_split(params["embed"], cfg))
    loss = ce + cfg.router_aux_coef * aux if cfg.num_experts else ce
    return loss, {"ce": ce, "aux": aux}


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
    dest), see ``attention.paged_inputs``.  Each layer attends with its
    own window (``layer_windows``); an MoE's capacity is taken over each
    slot's T tokens.  Returns the final-normed hidden."""
    _require_supported(cfg, paged=True)
    inputs = attn.paged_inputs(positions, block_table, cfg,
                               pool["k"].shape[2], scatter)
    quantized = "k_scale" in pool
    windows = layer_windows(cfg)
    x, _ = _run_layers(
        params, h, cfg, lambda i, p, x: attn.paged_decode_attention(
            p["attn"], x, cfg, pool["k"][i], pool["v"][i], inputs,
            block_table, window=windows[i],
            k_scale=pool["k_scale"][i] if quantized else None,
            v_scale=pool["v_scale"][i] if quantized else None),
        mm=attn.serving_matmul(cfg))
    return x


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
                      dtype=None, device="cpu", mesh=None) -> dict:
    """Stacked (L, ...) decode caches of the static path.  Attention
    archs: the ring cache of ``attention.init_cache`` with ``capacity``
    slots per row (in the compute dtype by default) and one shared write
    index; SSM: {"mamba": {"conv", "ssm"}} (float32 by default), whose
    size does not depend on ``capacity``; hybrid: both, the mamba cache
    ``hybrid_inner`` wide; encoder-decoder: the ring cache and "cross",
    {"k", "v"} zeros (L, B, KV, encoder_seq_len, hd), each layer's cross
    K / V in the ring kernel's layout (the reference's is (L, B, Se, KV,
    hd)), to be filled from ``attention.precompute_cross_cache``.

    ``mesh`` (a process mesh of ``model`` > 1): one model rank's part of
    the dense decoder's ring cache, in ``serve_layout``'s layout of
    ``cfg`` (the config the ranks serve, after ``tp_kv_repeat``): its KV
    heads, or (``kv_seq``) its ``capacity / model`` slots, with
    ``"kv_seq"`` the rank count."""
    _require_supported(cfg)
    L = cfg.num_layers
    model = 1 if mesh is None else mesh.model
    if model > 1:
        require_tp_family(cfg)
        if tp_kv_repeat(cfg, model) != cfg:
            raise ValueError(f"{cfg.name or 'this config'}: serve "
                             f"tp_kv_repeat(cfg, {model}) over {model} "
                             f"model ranks, with repeat_kv_heads' "
                             f"parameters")
        if serve_layout(cfg, model)[0] == "heads":
            return {"attn": attn.init_cache(
                cfg, batch, capacity, dtype=dtype, device=device,
                stack=(L,), kv_heads=cfg.num_kv_heads // model)}
        if capacity % model:
            raise ValueError(f"a kv_seq cache of {capacity} slots does not "
                             f"split over {model} model ranks")
        return {"attn": dict(attn.init_cache(
            cfg, batch, capacity // model, dtype=dtype, device=device,
            stack=(L,)), kv_seq=model)}
    if cfg.arch_type == "ssm":
        return {"mamba": ssm_mod.init_mamba_cache(
            cfg, batch, dtype=dtype or torch.float32, device=device,
            stack=(L,))}
    cache = {"attn": attn.init_cache(cfg, batch, capacity, dtype=dtype,
                                     device=device, stack=(L,))}
    if cfg.hybrid:
        cache["mamba"] = ssm_mod.init_mamba_cache(
            cfg, batch, hybrid_inner(cfg), dtype=dtype or torch.float32,
            device=device, stack=(L,))
    if cfg.is_encoder_decoder:
        shape = (L, batch, cfg.num_kv_heads, cfg.encoder_seq_len,
                 cfg.resolved_head_dim())
        dt = dtype or torch_dtype(cfg.compute_dtype)
        cache["cross"] = {k: torch.zeros(shape, dtype=dt, device=device)
                          for k in ("k", "v")}
    return cache


def _block_decode(i: int, lp: Params, x: torch.Tensor, cfg: ModelConfig,
                  cache: dict, position: torch.Tensor, rope,
                  window: int) -> torch.Tensor:
    """Layer i's one-token mixer on its normed input x (B, 1, d), the
    mixer half of the JAX package's ``_block_decode`` (the norms, the
    residual adds and the MLP or MoE are ``_run_layers``'): the mamba
    step on layer i's conv ring and state, or self-attention on its ring
    cache with the layer's ``window`` (0 = none), mixed with the SSM
    heads' step on a hybrid block; caches updated in place."""
    def mamba_step(d_inner=None):
        mc = cache["mamba"]
        y, _ = ssm_mod.decode_mamba(lp["mamba"], x, cfg, {
            "conv": mc["conv"][i], "ssm": mc["ssm"][i]}, d_inner=d_inner)
        return y

    if cfg.arch_type == "ssm":
        return mamba_step()
    ac = cache["attn"]
    y, _ = attn.decode_attention(
        lp["attn"], x, cfg, {"k": ac["k"][i], "v": ac["v"][i],
                             "pos": ac["pos"][i], "idx": ac["idx"],
                             "kv_seq": ac.get("kv_seq", 1)},
        position=position, window=window, rope=rope)
    if cfg.hybrid:
        y = _hybrid_mix(lp, y, mamba_step(hybrid_inner(cfg)), cfg)
    return y


def _check_cache_part(params: Params, cache: dict, cfg: ModelConfig) -> None:
    """Raise unless the ring cache is the part the leaves' layout reads:
    a ``kv_seq`` part (its rank count the model axis's) exactly where a
    model axis is active and attention's leaves are whole."""
    if "attn" not in cache:
        return
    mesh = tp.active()
    whole = params["layers"]["attn"]["wq"].shape[-1] == \
        cfg.num_heads * cfg.resolved_head_dim()
    want = mesh.model if mesh is not None and whole else 1
    got = cache["attn"].get("kv_seq", 1)
    if got != want:
        raise ValueError(
            f"the ring cache is split over {got} ranks' slots where "
            f"{want} is served: under a model axis with whole attention "
            f"(kv_seq) pass the rank's part, init_decode_cache(..., "
            f"mesh=); otherwise the cache of the rank's heads")


def decode_step_lm(params: Params, cache: dict, batch,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step of the static path.  batch: {"token": (B, 1) int,
    "position": (B,) int32 tensor or an int for every row} — the absolute
    position of the token, -1 for a left-pad token.  An encoder-decoder's
    blocks also attend to the cache's "cross" K / V, every memory key
    (the ring kernel once a layer).  Returns (logits (B, 1, V), cache),
    the cache updated in place (its ring index advanced).  Under a model
    axis: this rank's shards and part of the cache
    (``init_decode_cache(..., mesh=)``), and this rank's (B, 1, V / model)
    vocab columns."""
    _require_supported(cfg)
    _check_cache_part(params, cache, cfg)
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
    windows = layer_windows(cfg)
    cross = None
    if "cross" in cache:
        cc = cache["cross"]

        def cross(i, cp, x):
            return attn.decode_attention(
                cp["attn"], x, cfg, None, position=position,
                memory_cache={"k": cc["k"][i], "v": cc["v"][i]})[0]

    x, _ = _run_layers(params, h, cfg, lambda i, p, x: _block_decode(
        i, p, x, cfg, cache, position, rope, windows[i]), cross=cross)
    if "attn" in cache:
        cache["attn"]["idx"] += 1
    return unembed(params["embed"], x, cfg), cache
