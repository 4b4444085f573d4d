"""The hybrid block (hymba-1.5b: attention heads and SSM heads side by
side, each output RMS-normalised and mixed) against the JAX package on
the CPU, with the reference's parameters carried across and seeded numpy
inputs: the config copy and parameter trees, the full forward, ``lm_loss``
and its gradients, the static decode with its ring and mamba caches, and
the engine's static path and scoring against the JAX engine's, on the
tiny hybrid (``window_pattern`` (0, 8)) and hymba's reduced config; the
checkpoint round trip and the optimizer split; in the port, the
reference's decode == forward.  Tolerances: logits atol 1e-4, caches
atol 1e-5, the loss rtol 1e-6, gradients atol 1e-6 / rtol 1e-4 and
scores atol 1e-4 (``test_torch_train.py``'s and
``test_torch_ssm.py``'s)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.checkpoint import save_pytree
from repro.checkpoint.checkpoint import _path_str
from repro.configs import registry as jax_registry
from repro.models.transformer import abstract_params, build_model
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim.combined import partition_label as jax_partition_label
from repro.serving import Engine as JaxEngine
from repro_torch import Engine
from repro_torch.checkpoint import load_pytree, params_to_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import (decode_step_lm, forward_lm,
                                init_decode_cache, lm_loss, param_shapes)
from repro_torch.models.transformer import (flatten, paged_cache_supported,
                                            unflatten)
from repro_torch.optim import partition_label
from torch_parity import RAGGED, jax_flat, port_cfg, port_params

torch.set_num_threads(1)

ARCH = "hymba-1.5b"


@pytest.fixture(scope="module", params=["tiny", "reduced"])
def model(request):
    cfg = tiny_cfg("hybrid") if request.param == "tiny" else \
        jax_registry.get_reduced(ARCH)
    params, _ = jax_init(cfg, jax.random.key(0))
    return cfg, build_model(cfg), params, port_params(cfg, params)


def _tokens(seed, cfg, B=2, S=20):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)


def _shapes(tree):
    return {_path_str(p): tuple(leaf.shape) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_copy_and_parameter_tree(size):
    """Field for field; leaf paths and shapes (the mamba leaves as wide
    as the attention heads, mix_a / mix_s).  ``param_count`` is the
    reference's estimate for hybrid blocks and not held to the tree."""
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jax_registry.get_config(ARCH))
    assert get_reduced(ARCH) == port_cfg(jax_registry.get_reduced(ARCH))
    cfg = (jax_registry.get_config if size == "full" else
           jax_registry.get_reduced)(ARCH)
    shapes = param_shapes(port_cfg(cfg))
    assert shapes == _shapes(abstract_params(cfg)[0])
    assert shapes["layers/mix_a"] == (cfg.num_layers, cfg.d_model)
    assert not paged_cache_supported(port_cfg(cfg))


def test_checkpoint_round_trip_and_optimizer_split(model, tmp_path):
    cfg, _, params, tparams = model
    path = str(tmp_path / "ckpt")
    save_pytree(params, path)
    flat = load_pytree(path)
    got = params_to_numpy(tparams)
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v)
    jlabels = {_path_str(p): jax_partition_label(p, leaf) for p, leaf in
               jax.tree_util.tree_flatten_with_path(params)[0]}
    labels = {k: partition_label(k, v) for k, v in flatten(tparams).items()}
    assert labels == jlabels
    assert labels["layers/mix_a"] == labels["layers/mamba/A_log"] == "adamw"


def test_forward_logits_match_jax(model):
    cfg, m, params, tparams = model
    toks = _tokens(0, cfg)[:, :-1]
    want, _ = m.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = forward_lm(tparams, {"tokens": torch.from_numpy(toks)},
                            port_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_lm_loss_and_grads_match_jax(model):
    """The SSM heads' gradient runs through the SSD autograd route."""
    cfg, _, params, tparams = model
    toks = _tokens(3, cfg)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
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


def test_static_decode_and_caches_match_jax(model):
    """14 static decode steps through a 10-slot ring (it wraps past the
    tiny config's window of 8), a left-pad token in row 0: logits of rows
    with a live key (atol 1e-4); the ring K/V and the mamba conv ring and
    state (atol 1e-5)."""
    cfg, m, params, tparams = model
    pc = port_cfg(cfg)
    B, cap, T = 3, 10, 14
    toks = _tokens(5, cfg, B=B, S=T)
    jcache = m.init_cache(B, cap)
    tcache = init_decode_cache(pc, B, cap)
    jstep = jax.jit(m.decode_step)
    for t in range(T):
        pos = np.maximum(np.array([t - 1, t, t + 2], np.int32), -1)
        jl, jcache = jstep(params, jcache, {
            "token": jnp.asarray(toks[:, t:t + 1]),
            "position": jnp.asarray(pos)})
        tl, tcache = decode_step_lm(tparams, tcache, {
            "token": torch.from_numpy(toks[:, t:t + 1].copy()),
            "position": torch.from_numpy(pos)}, pc)
        rows = pos >= 0
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   atol=1e-4, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            tcache["attn"][key].numpy(),
            np.asarray(jcache["attn"][key]).transpose(0, 1, 3, 2, 4),
            atol=1e-5, rtol=0)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(tcache["mamba"][key].numpy(),
                                   np.asarray(jcache["mamba"][key]),
                                   atol=1e-5, rtol=0)


def test_engine_static_path_and_scores_match_jax_engine(model):
    """A hybrid engine has no paged pool: ``generate`` takes the static
    path; greedy tokens equal the JAX engine's and scores within 1e-4."""
    cfg, m, params, tparams = model
    kw = dict(num_slots=4, max_len=64, block_size=8)
    jeng = JaxEngine(m, params, **kw)
    eng = Engine(port_cfg(cfg), tparams, device="cpu", **kw)
    assert not eng.continuous
    prompts = [p for p in RAGGED[:4]]
    np.testing.assert_array_equal(
        np.asarray(eng.generate(prompts, max_new=6)),
        np.asarray(jeng.generate(prompts, max_new=6)))
    rows = [(p, RAGGED[(i + 1) % 8][:4]) for i, p in enumerate(RAGGED[:5])]
    np.testing.assert_allclose(eng.score_continuations_batch(rows),
                               jeng.score_continuations_batch(rows),
                               atol=1e-4, rtol=0)


def test_decode_matches_forward():
    """The reference's ``test_decode_matches_forward`` for hybrid: 24
    one-token static decode steps against one full forward (atol 3e-3,
    the reference's; the port sits far inside it)."""
    jcfg = tiny_cfg("hybrid")
    cfg = port_cfg(jcfg)
    tparams = port_params(jcfg, jax_init(jcfg, jax.random.key(1))[0])
    S = 24
    toks = torch.from_numpy(_tokens(2, cfg, S=S)[:, :S].copy())
    with torch.no_grad():
        full, _ = forward_lm(tparams, {"tokens": toks}, cfg)
        cache = init_decode_cache(cfg, 2, S)
        outs = []
        for t in range(S):
            lg, cache = decode_step_lm(tparams, cache, {
                "token": toks[:, t:t + 1], "position": t}, cfg)
            outs.append(lg[:, 0])
    assert float((torch.stack(outs, 1) - full).abs().max()) < 1e-4
