"""The VLM (internvl2-26b: projected image patches before the text, one
causal mask over both, the patch rows cut after the final norm) against
the JAX package on the CPU, with the reference's parameters carried
across through ``params_from_numpy`` and seeded numpy inputs: the config
copy and parameter trees, the forward with patches, ``lm_loss`` and every
gradient, one ``nanochat_optimizer`` step, the text-only decode (static
and paged), and the engine's greedy tokens (static and continuous) against
the JAX engine's, on the tiny VLM and internvl2's reduced config; the
CLIs' handling of the id.  Tolerances: logits atol 1e-4, the loss rtol
1e-6, gradients atol 1e-6 x the leaf's max / rtol 1e-4, parameters after
one update atol 1e-6 (``test_torch_archs.py``'s and
``test_torch_train.py``'s)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.checkpoint.checkpoint import _path_str
from repro.configs import registry as jax_registry
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.models.transformer import abstract_params, build_model
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import nanochat_optimizer as jax_nanochat_optimizer
from repro.serving import Engine as JaxEngine
from repro_torch import Engine
from repro_torch.configs import OptimizerConfig, get_config, get_reduced
from repro_torch.launch import serve, train
from repro_torch.models import (decode_step_lm, decode_step_paged,
                                forward_lm, init_decode_cache, lm_loss,
                                param_shapes)
from repro_torch.models.transformer import flatten, unflatten
from repro_torch.optim import nanochat_optimizer
from torch_cases import paged_tables
from torch_parity import RAGGED, jax_flat, port_cfg, port_params

torch.set_num_threads(1)

ARCH = "internvl2-26b"


@pytest.fixture(scope="module", params=["tiny", "reduced"])
def model(request):
    cfg = tiny_cfg("vlm") if request.param == "tiny" else \
        jax_registry.get_reduced(ARCH)
    params, _ = jax_init(cfg, jax.random.key(0))
    return cfg, build_model(cfg), params, port_params(cfg, params)


def _batch(seed, cfg, B=2, S=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.num_image_tokens, cfg.d_model))
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy(),
            "patches": patches.astype(np.float32)}


def _shapes(tree):
    return {_path_str(p): tuple(leaf.shape) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_copy_and_parameter_tree(size):
    """Field for field; the dense tree (untied, SwiGLU) with the
    reference's leaf paths and shapes, and ``param_count`` equal to it."""
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jax_registry.get_config(ARCH))
    assert get_reduced(ARCH) == port_cfg(jax_registry.get_reduced(ARCH))
    cfg = (jax_registry.get_config if size == "full" else
           jax_registry.get_reduced)(ARCH)
    shapes = param_shapes(port_cfg(cfg))
    assert shapes == _shapes(abstract_params(cfg)[0])
    assert sum(int(np.prod(s)) for s in shapes.values()) == \
        cfg.param_count()


def test_forward_with_patches_matches_jax(model):
    """Logits of the text rows only (B, S, V), the patches before them."""
    cfg, m, params, tparams = model
    batch = _batch(0, cfg)
    del batch["labels"]
    want, _ = m.forward(params, {k: jnp.asarray(v) for k, v in
                                 batch.items()})
    with torch.no_grad():
        got, _ = forward_lm(tparams, {k: torch.from_numpy(v) for k, v in
                                      batch.items()}, port_cfg(cfg))
    assert got.shape == (2, 12, cfg.padded_vocab())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("loss_chunk", [0, 5])
def test_lm_loss_and_every_gradient_match_jax(model, loss_chunk):
    """Patches included; an ignored label; the chunked CE as well.  The
    patches' own rows never reach the loss, but their keys do: every
    leaf's gradient against ``jax.value_and_grad``."""
    cfg, _, params, tparams = model
    cfg = cfg.with_(loss_chunk=loss_chunk)
    batch = _batch(3, cfg)
    batch["labels"][0, 2] = -1
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


def test_nanochat_optimizer_step_matches_jax():
    """``test_configs_smoke.py``'s train step on the reduced config: loss,
    gradients and one Muon + AdamW update (total 10, no warmup), the JAX
    gradients given to both optimizers (AdamW's first step would turn a
    gradient that is zero up to rounding into +-lr, either sign); the
    port's own step changes the parameters and keeps the loss finite."""
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
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert any(float(u[k].abs().max()) > 0 for k in u)


def test_text_only_decode_matches_jax(model):
    """The static path's decode ignores the patches, as the reference's:
    10 steps from a fresh ring cache, a left-pad token in row 0, logits of
    live rows (atol 1e-4)."""
    cfg, m, params, tparams = model
    pc = port_cfg(cfg)
    B, cap, T = 3, 12, 10
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    jcache = m.init_cache(B, cap)
    tcache = init_decode_cache(pc, B, cap)
    jstep = jax.jit(m.decode_step)
    for t in range(T):
        pos = np.maximum(np.array([t - 1, t, t + 2], np.int32), -1)
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


def test_text_only_paged_decode_matches_jax(model):
    """One paged decode step over a random pool: the text-only serving
    path the continuous engine runs."""
    cfg, m, params, tparams = model
    rng = np.random.default_rng(9)
    S, NB, bs, MB = 4, 16, 4, 4
    tables, start, _, live = paged_tables(rng, S, NB, bs, MB)
    shape = (cfg.num_layers, NB, bs, cfg.num_kv_heads,
             cfg.resolved_head_dim())
    pool = {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}
    jb = {"token": rng.integers(0, cfg.vocab_size, (S, 1)).astype(np.int32),
          "position": start, "block_table": tables}
    want, _ = m.decode_step_paged(params, {k: jnp.asarray(v) for k, v in
                                           pool.items()},
                                  {k: jnp.asarray(v) for k, v in jb.items()})
    with torch.no_grad():
        got, _ = decode_step_paged(
            tparams, {k: torch.from_numpy(v.copy()) for k, v in pool.items()},
            {k: torch.from_numpy(v) for k, v in jb.items()}, port_cfg(cfg))
    live = live[:, 0]
    assert live.sum() >= 2
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=0)


def test_engine_serves_text_like_the_jax_engine(model):
    """The VLM serves text on the continuous path, as the reference's
    engine does: greedy tokens of the scheduler (spec_k 0 and 4) and of
    the static path equal the JAX engine's."""
    cfg, m, params, tparams = model
    kw = dict(num_slots=4, max_len=64, block_size=8)
    prompts = RAGGED[:6]
    want = np.asarray(JaxEngine(m, params, **kw).generate_ids(prompts,
                                                              max_new=6))
    eng = Engine(port_cfg(cfg), tparams, device="cpu", **kw)
    assert eng.continuous
    np.testing.assert_array_equal(eng.generate_ids(prompts, max_new=6), want)
    np.testing.assert_array_equal(
        eng.generate_ids_static(prompts, max_new=6), want)
    spec = Engine(port_cfg(cfg), tparams, device="cpu", spec_k=4, **kw)
    np.testing.assert_array_equal(spec.generate_ids(prompts, max_new=6), want)


def test_clis_build_the_reduced_vlm_and_the_pipeline_refuses_it():
    """``serve --config internvl2-26b`` builds the reduced config, as the
    JAX launcher does; the pipeline's text data has no patches, so
    ``run_pipeline`` refuses the id by name (the reference's fails
    reading ``batch["patches"]``)."""
    want = get_reduced(ARCH).with_(vocab_size=512)
    assert serve.make_config(ARCH, 512) == want
    assert train.make_model(ARCH, True, 512) == want
    with pytest.raises(NotImplementedError, match=ARCH):
        train.run_pipeline("diloco", arch=ARCH, steps={"base": 1, "mid": 1,
                                                       "sft": 1},
                           device="cpu")
