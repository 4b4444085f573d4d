"""The encoder-decoder (seamless-m4t-medium: LayerNorm, a tanh-gelu MLP,
a bidirectional encoder over frame embeddings, a cross-attention block in
every decoder layer) against the JAX package on the CPU, with the
reference's parameters carried across through ``params_from_numpy`` and
seeded numpy inputs: LayerNorm and gelu against the reference's; the
two-length non-causal flash plain version against the JAX flash kernel
in interpret mode, its jnp oracle and ``_direct``; the config copy and
parameter trees; ``encode``, the forward, ``lm_loss`` and every gradient
with frames; one ``nanochat_optimizer`` step; the step-wise decode over a
cross cache built as ``tests/test_models.py`` builds it, and over the zero
cross cache the reference's engine serves; the engine's static path
against the JAX engine's; remat on == off bit for bit; the CLIs' handling
of the id.  On the tiny audio config and seamless's reduced one.
Tolerances: logits atol 1e-4, the loss rtol 1e-6, gradients atol 1e-6 x
the leaf's max / rtol 1e-4, parameters after one update atol 1e-6
(``test_torch_archs.py``'s and ``test_torch_train.py``'s); attention
outputs atol 1e-5 and gradients 1e-5 (``test_torch_kernels.py``'s flash
tolerances)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from helpers import tiny_cfg
from repro.checkpoint.checkpoint import _path_str
from repro.configs import registry as jax_registry
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import reference_attention
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models.transformer import abstract_params, build_model
from repro.models.transformer import encode as jax_encode
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import nanochat_optimizer as jax_nanochat_optimizer
from repro.serving import Engine as JaxEngine
from repro_torch import Engine
from repro_torch.configs import OptimizerConfig, get_config, get_reduced
from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                 flash_bwd, flash_fwd)
from repro_torch.launch import serve, train
from repro_torch.models import (decode_step_lm, forward_lm,
                                init_decode_cache, lm_loss, param_shapes)
from repro_torch.models.attention import precompute_cross_cache
from repro_torch.models.layers import apply_mlp, apply_norm
from repro_torch.models.transformer import (encode, flatten,
                                            paged_cache_supported, unflatten)
from repro_torch.optim import nanochat_optimizer
from torch_parity import RAGGED, jax_flat, port_cfg, port_params

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
# the tiny audio config (the reference's tests': RMSNorm, SwiGLU) with
# seamless's LayerNorm and gelu
LN_GELU = tiny_cfg("audio", norm="layernorm", mlp_activation="gelu")


@pytest.fixture(scope="module", params=["tiny", "reduced"])
def model(request):
    """The tiny audio config (RMSNorm, SwiGLU) and seamless's reduced one
    (LayerNorm, gelu, tied)."""
    cfg = tiny_cfg("audio") if request.param == "tiny" else \
        jax_registry.get_reduced(ARCH)
    params, _ = jax_init(cfg, jax.random.key(0))
    return cfg, build_model(cfg), params, port_params(cfg, params)


def _batch(seed, cfg, B=2, S=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model))
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy(),
            "frames": (0.3 * frames).astype(np.float32)}


def _shapes(tree):
    return {_path_str(p): tuple(leaf.shape) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# LayerNorm, gelu, and the flash function at two lengths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_the_reference(dtype):
    """``apply_norm`` of a LayerNorm config against the reference's, op
    for op in f32 (atol 1e-6 in f32; bf16 rounds the result once, so the
    two agree to the bit unless an f32 value sits on a rounding
    boundary: at most one bf16 step)."""
    cfg = LN_GELU
    assert cfg.norm == "layernorm"
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((4, 7, cfg.d_model)) + 0.5).astype(
        np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(cfg.d_model)).astype(
        np.float32),
        "bias": (0.1 * rng.standard_normal(cfg.d_model)).astype(np.float32)}
    want = np.asarray(jax_layers.apply_norm(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x).astype(dtype), cfg).astype(jnp.float32))
    got = apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x).to(getattr(torch, dtype)),
                     port_cfg(cfg)).float().numpy()
    tol = 1e-6 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_gelu_mlp_is_jax_nn_gelu_the_tanh_approximation():
    """``jax.nn.gelu``'s default is the tanh approximation, and so is the
    port's MLP: against it within 1e-6 over [-8, 8]; PyTorch's default
    (exact erf) differs by more, so the choice is pinned."""
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4
    cfg = LN_GELU
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(s).astype(np.float32) / 8 for k, s in
         (("w_up", (cfg.d_model, cfg.d_ff)),
          ("w_down", (cfg.d_ff, cfg.d_model)))}
    h = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = np.asarray(jax_layers.apply_mlp(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h), cfg))
    got = apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(h), port_cfg(cfg)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("Sq,Sk,H,KV", [(12, 20, 4, 4), (16, 8, 4, 2),
                                        (8, 32, 2, 1)])
def test_two_length_plain_flash_matches_jax(Sq, Sk, H, KV):
    """Non-causal at Sq != Sk: the forward against the JAX Pallas kernel in
    interpret mode (two query and two key tiles), its jnp oracle and
    ``_direct`` with no mask (the reference's cross-attention), the
    backward against
    ``jax.vjp`` of the oracle; lse against the log-sum-exp of the
    scores."""
    rng = np.random.default_rng(Sq * Sk)
    B, D = 2, 16
    q, do = (rng.standard_normal((B, Sq, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_fwd(tq, tk, tv, causal=False)
    assert o.shape == (B, Sq, H, D) and lse.shape == (B, H, Sq)
    jq, jk, jv = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v))
    pallas = flash_attention_fwd(jq, jk, jv, causal=False, bq=Sq // 2,
                                 bk=Sk // 2, interpret=True)
    pallas = pallas.transpose(0, 2, 1, 3)
    oracle = jax.jit(lambda a, b, c: reference_attention(a, b, c,
                                                         causal=False))
    direct = jax_attn._direct(
        jnp.asarray(q).reshape(B, Sq, KV, H // KV, D), jnp.asarray(k),
        jnp.asarray(v), None).reshape(B, Sq, H, D)
    for want in (pallas, oracle(jq, jk, jv).transpose(0, 2, 1, 3), direct):
        np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    s = np.einsum("bqkgd,bskd->bkgqs", q.reshape(B, Sq, KV, H // KV, D),
                  k) / np.sqrt(D)
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))
    np.testing.assert_allclose(lse.numpy(), want_lse.reshape(B, H, Sq),
                               atol=1e-5, rtol=0)
    vjp = jax.jit(lambda *a: jax.vjp(oracle, *a[:3])[1](a[3]))
    grads = vjp(jq, jk, jv, jnp.asarray(do).transpose(0, 2, 1, 3))
    want = [np.asarray(g).transpose(0, 2, 1, 3) for g in grads]
    got = flash_bwd(tq, tk, tv, o, lse, tdo, causal=False)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=False, window=4)])
def test_flash_refuses_masks_at_two_lengths(kw):
    """The causal mask and the window compare query and key indices as
    positions of one sequence: refused at Sq != Sk, on the CPU too."""
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 6, 2, 16))
    with pytest.raises(ValueError, match="only with causal=False"):
        flash_fwd(q, k, k, **kw)
    with pytest.raises(ValueError, match="only with causal=False"):
        flash_bwd(q, k, k, q, torch.zeros((1, 2, 4)), q, **kw)
    o, _ = flash_attention_plain(q, q, q, causal=True)   # Sq == Sk is fine
    assert o.shape == q.shape


# ---------------------------------------------------------------------------
# The model against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_copy_and_parameter_tree(size):
    """Field for field; the reference's leaf paths and shapes: LayerNorm
    biases, the encoder stack, ``enc_norm``, the cross stack without qkv
    bias, no ``w_gate`` (gelu), tied embeddings.  ``param_count`` is the
    reference's estimate, which leaves the LayerNorm biases out, and is
    not held to the tree."""
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jax_registry.get_config(ARCH))
    assert get_reduced(ARCH) == port_cfg(jax_registry.get_reduced(ARCH))
    cfg = (jax_registry.get_config if size == "full" else
           jax_registry.get_reduced)(ARCH)
    shapes = param_shapes(port_cfg(cfg))
    assert shapes == _shapes(abstract_params(cfg)[0])
    for path in ("enc_norm/bias", "cross/ln/bias", "encoder/mlp/w_up",
                 "cross/attn/wq", "final_norm/bias"):
        assert path in shapes, path
    assert "layers/mlp/w_gate" not in shapes
    assert not paged_cache_supported(port_cfg(cfg))


def test_encode_matches_jax(model):
    cfg, _, params, tparams = model
    frames = _batch(1, cfg)["frames"]
    want = jax_encode(params, jnp.asarray(frames), cfg)
    with torch.no_grad():
        got = encode(tparams, torch.from_numpy(frames), port_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_forward_with_frames_matches_jax(model):
    cfg, m, params, tparams = model
    batch = _batch(0, cfg)
    del batch["labels"]
    want, _ = m.forward(params, {k: jnp.asarray(v) for k, v in
                                 batch.items()})
    with torch.no_grad():
        got, _ = forward_lm(tparams, {k: torch.from_numpy(v) for k, v in
                                      batch.items()}, port_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("loss_chunk", [0, 5])
def test_lm_loss_and_every_gradient_match_jax(model, loss_chunk):
    """Frames through the encoder, an ignored label, the chunked CE (the
    tied 256206-row vocabulary's path) as well: every leaf's gradient,
    the encoder's and the cross stack's included."""
    cfg, _, params, tparams = model
    cfg = cfg.with_(loss_chunk=loss_chunk)
    batch = _batch(3, cfg)
    batch["labels"][1, 4] = -1
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, cfg), has_aux=True))(params)
    leaves = {k: v.clone().requires_grad_() for k, v in
              flatten(tparams).items()}
    loss, _ = lm_loss(unflatten(leaves), {k: torch.from_numpy(v) for k, v
                                          in batch.items()}, port_cfg(cfg))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    want = jax_flat(jgrads)
    assert set(want) == set(leaves)
    for k, g in zip(leaves, grads):
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-6 * scale,
                                   rtol=1e-4, err_msg=k)


def test_remat_on_equals_off_bit_for_bit(model):
    """The encoder's units are rematerialised too: the loss and every
    gradient the same bits with ``remat`` on and off."""
    cfg, _, _, tparams = model
    batch = {k: torch.from_numpy(v) for k, v in _batch(4, cfg).items()}
    out = []
    for remat in (False, True):
        leaves = {k: v.clone().requires_grad_() for k, v in
                  flatten(tparams).items()}
        loss, _ = lm_loss(unflatten(leaves), batch,
                          port_cfg(cfg).with_(remat=remat))
        out.append([loss] + list(torch.autograd.grad(
            loss, list(leaves.values()))))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_nanochat_optimizer_step_matches_jax():
    """``test_configs_smoke.py``'s train step on the reduced config, as
    ``test_torch_vlm.py`` takes it: the JAX gradients to both optimizers,
    then the port's own step."""
    cfg = jax_registry.get_reduced(ARCH)
    m = build_model(cfg)
    params, _ = jax_init(cfg, jax.random.key(0))
    tparams = port_params(cfg, params)
    batch = _batch(7, cfg)
    kw = dict(total_steps=10, warmup_steps=0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(m.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    jopt = jax_nanochat_optimizer(JaxOptimizerConfig(**kw))
    upd, _ = jax.jit(jopt.update)(jgrads, jopt.init(params), params,
                                  jnp.int32(0))
    want = jax_flat(jax_apply_updates(params, upd))
    opt = nanochat_optimizer(OptimizerConfig(**kw))
    p = {k: v.clone() for k, v in flatten(tparams).items()}
    g = {k: torch.from_numpy(v.copy()) for k, v in jax_flat(jgrads).items()}
    step = torch.tensor(0, dtype=torch.int32)
    u, _ = opt.update(g, opt.init(p), p, step)
    for k in want:
        np.testing.assert_allclose((p[k] + u[k]).numpy(), want[k],
                                   atol=1e-6, rtol=0, err_msg=k)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    loss, _ = lm_loss(unflatten(leaves), {k: torch.from_numpy(v) for k, v
                                          in batch.items()}, port_cfg(cfg))
    own = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    u, _ = opt.update(own, opt.init(p), p, step)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert any(float(u[k].abs().max()) > 0 for k in u)


def _cross_caches(cfg, params, tparams, frames):
    """The reference's cross cache, built as ``tests/test_models.py``
    builds it (``encode``, then ``precompute_cross_cache`` per layer), and
    the port's from its own ``encode`` (its (B, KV, Se, hd) layout)."""
    memory = jax_encode(params, jnp.asarray(frames), cfg)
    crosses = [jax_attn.precompute_cross_cache(
        jax.tree.map(lambda x: x[i], params["cross"])["attn"], memory, cfg)
        for i in range(cfg.num_layers)]
    jcross = {k: jnp.stack([c[k] for c in crosses]) for k in ("k", "v")}
    pc = port_cfg(cfg)
    with torch.no_grad():
        mem = encode(tparams, torch.from_numpy(frames), pc)
        ours = [precompute_cross_cache(
            {k: v[i] for k, v in tparams["cross"]["attn"].items()}, mem, pc)
            for i in range(cfg.num_layers)]
    tcross = {k: torch.stack([c[k] for c in ours]) for k in ("k", "v")}
    return jcross, tcross


@pytest.mark.parametrize("cross", ["encoded", "zeros"])
def test_stepwise_decode_with_the_cross_cache_matches_jax(model, cross):
    """12 static decode steps, a left-pad token in row 0, over the cross
    cache of the encoded frames or the zero one ``init_decode_cache``
    makes (what the engine serves): logits of live rows (atol 1e-4); the
    cross K / V against the reference's, transposed (atol 1e-5)."""
    cfg, m, params, tparams = model
    pc = port_cfg(cfg)
    B, T = 2, 12
    batch = _batch(5, cfg, B=B, S=T)
    toks = batch["tokens"]
    jcache = m.init_cache(B, T)
    tcache = init_decode_cache(pc, B, T)
    assert tuple(tcache["cross"]["k"].shape) == (
        cfg.num_layers, B, cfg.num_kv_heads, cfg.encoder_seq_len,
        cfg.resolved_head_dim())
    if cross == "encoded":
        jcache["cross"], tcache["cross"] = _cross_caches(
            cfg, params, tparams, batch["frames"])
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tcache["cross"][key].numpy(),
                np.asarray(jcache["cross"][key]).transpose(0, 1, 3, 2, 4),
                atol=1e-5, rtol=0)
    jstep = jax.jit(m.decode_step)
    for t in range(T):
        pos = np.maximum(np.array([t - 1, t], np.int32), -1)
        jl, jcache = jstep(params, jcache, {
            "token": jnp.asarray(toks[:, t:t + 1]),
            "position": jnp.asarray(pos)})
        with torch.no_grad():
            tl, tcache = decode_step_lm(tparams, tcache, {
                "token": torch.from_numpy(toks[:, t:t + 1].copy()),
                "position": torch.from_numpy(pos)}, pc)
        rows = pos >= 0
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   atol=1e-4, rtol=0)


def test_decode_matches_forward():
    """The reference's ``test_decode_matches_forward_encdec`` in the port:
    12 one-token steps over the encoded cross cache against one forward
    with the frames (atol 3e-3, the reference's; the port sits far
    inside it)."""
    jcfg = tiny_cfg("audio")
    cfg = port_cfg(jcfg)
    tparams = port_params(jcfg, jax_init(jcfg, jax.random.key(1))[0])
    batch = _batch(2, jcfg)
    toks = torch.from_numpy(batch["tokens"])
    frames = torch.from_numpy(batch["frames"])
    with torch.no_grad():
        full, _ = forward_lm(tparams, {"tokens": toks, "frames": frames},
                             cfg)
        mem = encode(tparams, frames, cfg)
        cache = init_decode_cache(cfg, 2, 12)
        crosses = [precompute_cross_cache(
            {k: v[i] for k, v in tparams["cross"]["attn"].items()}, mem, cfg)
            for i in range(cfg.num_layers)]
        cache["cross"] = {k: torch.stack([c[k] for c in crosses])
                          for k in ("k", "v")}
        outs = []
        for t in range(12):
            lg, cache = decode_step_lm(tparams, cache, {
                "token": toks[:, t:t + 1], "position": t}, cfg)
            outs.append(lg[:, 0])
    assert float((torch.stack(outs, 1) - full).abs().max()) < 1e-4


def test_engine_static_path_matches_the_jax_engine(model):
    """The encoder-decoder has no paged pool, in the reference's engine as
    in the port's: ``generate`` takes the static path over the zero cross
    cache; greedy tokens equal the JAX engine's."""
    cfg, m, params, tparams = model
    kw = dict(num_slots=4, max_len=64, block_size=8)
    jeng = JaxEngine(m, params, **kw)
    eng = Engine(port_cfg(cfg), tparams, device="cpu", **kw)
    assert not eng.continuous and not jeng.continuous
    prompts = RAGGED[:5]
    want = np.asarray(jeng.generate(prompts, max_new=6))
    np.testing.assert_array_equal(np.asarray(eng.generate(prompts,
                                                          max_new=6)), want)
    np.testing.assert_array_equal(
        eng.generate_ids_static(prompts, max_new=6),
        np.asarray(jeng.generate_ids_static(prompts, max_new=6)))


def test_clis_build_the_reduced_config_and_the_pipeline_refuses_it():
    """``serve --config seamless-m4t-medium`` builds the reduced config,
    as the JAX launcher does; the pipeline's text data has no frames, so
    ``run_pipeline`` refuses the id by name."""
    want = get_reduced(ARCH).with_(vocab_size=512)
    assert serve.make_config(ARCH, 512) == want
    assert train.make_model(ARCH, True, 512) == want
    with pytest.raises(NotImplementedError, match=ARCH):
        train.run_pipeline("diloco", arch=ARCH, steps={"base": 1, "mid": 1,
                                                       "sft": 1},
                           device="cpu")
