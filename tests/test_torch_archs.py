"""The dense architectures the port runs besides nanochat-d20 —
qwen1.5-0.5b (QKV bias, tied, MHA), command-r-plus-104b and
mistral-large-123b (GQA groups of 12), nemotron-4-15b (the squared-ReLU
MLP, no ``w_gate``) — against the JAX package, on the CPU: each config
copy field for field, the parameter tree at full size and reduced, the
checkpoint round trip and the optimizer split; on ``get_reduced`` with
the reference's parameters carried across, ``forward_lm`` logits, a
paged decode and verify step, and ``lm_loss`` with its gradients, with
the tolerances of ``test_torch_model.py`` / ``test_torch_train.py``;
the CLIs' configs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree
from repro.checkpoint.checkpoint import _path_str
from repro.configs import registry as jax_registry
from repro.models.transformer import abstract_params, build_model
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim.combined import partition_label as jax_partition_label
from repro_torch.checkpoint import load_pytree, params_to_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import serve, train
from repro_torch.models import (decode_step_paged, forward_lm,
                                init_paged_cache, lm_loss, param_shapes,
                                verify_step_paged)
from repro_torch.models.transformer import flatten, unflatten
from repro_torch.optim import partition_label
from torch_cases import paged_tables
from torch_parity import jax_flat, port_cfg, port_params

# tiny shapes: intra-op threads would only contend with the other test
# workers on the same cores
torch.set_num_threads(1)

ARCHS = ["qwen1.5-0.5b", "command-r-plus-104b", "mistral-large-123b",
         "nemotron-4-15b"]


@pytest.fixture(scope="module", params=ARCHS)
def reduced(request):
    cfg = jax_registry.get_reduced(request.param)
    params, _ = jax_init(cfg, jax.random.key(0))
    return cfg, build_model(cfg), params, port_params(cfg, params)


def _shapes(tree):
    return {_path_str(p): tuple(leaf.shape) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# Configs, parameter trees, checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_the_reference_field_for_field(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jax_registry.get_config(arch))
    assert get_reduced(arch) == port_cfg(jax_registry.get_reduced(arch))
    assert get_config(arch).param_count() == \
        jax_registry.get_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_param_shapes_match_the_jax_tree(arch, size):
    """Same leaf paths and shapes as the reference's tree (full size
    traced abstractly: no weights); relu2 has no w_gate."""
    get = jax_registry.get_config if size == "full" else \
        jax_registry.get_reduced
    cfg = get(arch)
    sds, _ = abstract_params(cfg)
    shapes = param_shapes(port_cfg(cfg))
    assert shapes == _shapes(sds)
    gated = cfg.mlp_activation == "swiglu"
    assert ("layers/mlp/w_gate" in shapes) == gated
    assert sum(int(np.prod(s)) for s in shapes.values()) == \
        cfg.param_count()


def test_checkpoint_round_trip_and_optimizer_split(reduced, tmp_path):
    """A checkpoint the JAX package writes loads into the port and comes
    back out leaf for leaf; each leaf goes to the reference's optimizer
    (Muon or AdamW)."""
    cfg, _, params, tparams = reduced
    path = str(tmp_path / "ckpt")
    save_pytree(params, path)
    flat = load_pytree(path)
    got = params_to_numpy(port_params(cfg, params))
    assert sorted(got) == sorted(flat) == sorted(jax_flat(params))
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v)
    jlabels = {_path_str(p): jax_partition_label(p, leaf) for p, leaf in
               jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {k: partition_label(k, v) for k, v in flatten(tparams).items()} \
        == jlabels


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_configs_are_the_reduced_configs(arch):
    want = get_reduced(arch).with_(vocab_size=512)
    assert serve.make_config(arch, 512) == want
    assert train.make_model(arch, True, 512) == want
    assert train.make_model(arch, False, 512) == \
        get_config(arch).with_(vocab_size=512)


def test_serve_make_config_names_the_new_configs():
    with pytest.raises(NotImplementedError, match="nemotron-4-15b"):
        serve.make_config("hymba", 512)


# ---------------------------------------------------------------------------
# The reduced models against the JAX package
# ---------------------------------------------------------------------------

def _tokens(seed, cfg, B=2, S=13):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)


def test_forward_logits_match_jax(reduced):
    cfg, m, params, tparams = reduced
    toks = _tokens(0, cfg)[:, :-1]
    want, _ = m.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = forward_lm(tparams, {"tokens": torch.from_numpy(toks)},
                            port_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("T", [1, 4])
def test_paged_decode_and_verify_step_match_jax(reduced, T):
    """One decode (T 1) or verify (T 4) step over a random pool with
    ragged tables, unmapped blocks and an inactive slot: the live rows'
    logits (atol 1e-4) and the updated pool (atol 1e-5)."""
    cfg, m, params, tparams = reduced
    rng = np.random.default_rng(T)
    S, bs, MB = 5, 8, 4
    NB = S * MB + 3
    tables, start, n_tok, live = paged_tables(rng, S, NB, bs, MB, T=T)
    shape = (cfg.num_layers, NB, bs, cfg.num_kv_heads,
             cfg.resolved_head_dim())
    pool = {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}
    tokens = rng.integers(0, cfg.vocab_size, (S, T)).astype(np.int32)
    t = np.arange(T)[None, :]
    pos = np.where((start[:, None] >= 0) & (t < n_tok[:, None]),
                   start[:, None] + t, -1).astype(np.int32)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    if T == 1:
        jb = {"token": tokens, "position": pos[:, 0], "block_table": tables}
        want, jpool = m.decode_step_paged(
            params, jpool, {k: jnp.asarray(v) for k, v in jb.items()})
        step = decode_step_paged
    else:
        jb = {"tokens": tokens, "positions": pos, "block_table": tables}
        want, jpool = m.verify_step_paged(
            params, jpool, {k: jnp.asarray(v) for k, v in jb.items()})
        step = verify_step_paged
    got, tpool2 = step(tparams, tpool, {k: torch.from_numpy(
        np.ascontiguousarray(v)) for k, v in jb.items()}, port_cfg(cfg))
    assert tpool2 is tpool
    assert live.sum() >= 2
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(tpool[k].numpy(), np.asarray(jpool[k]),
                                   atol=1e-5, rtol=0)
    assert init_paged_cache(port_cfg(cfg), NB, bs)["k"].shape == shape


def test_lm_loss_and_grads_match_jax_value_and_grad(reduced):
    """Loss (rtol 1e-6) and every gradient leaf (atol 1e-6, rtol 1e-4),
    one label ignored.  The atol is in units of the leaf's largest
    gradient where that exceeds 1: f32 rounding is relative, and at these
    widths an untied embedding's gradient reaches 1.47 (mistral reduced),
    where the port and the JAX package each sit ~2e-6 from a float64
    computation of the same gradient."""
    cfg, _, params, tparams = reduced
    toks = _tokens(3, cfg)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    batch["labels"][1, 4] = -1
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_lm_loss(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, cfg), has_aux=True)(params)
    leaves = flatten(tparams)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in leaves.items()}
    loss, _ = lm_loss(unflatten(leaves), {k: torch.from_numpy(v)
                                          for k, v in batch.items()},
                      port_cfg(cfg))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    want = jax_flat(jgrads)
    assert set(want) == set(leaves)
    for k, g in zip(leaves, grads):
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-6 * scale,
                                   rtol=1e-4, err_msg=k)
