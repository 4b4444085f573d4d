"""Per-layer rematerialisation in the port (``cfg.remat``, through
``torch.utils.checkpoint`` in ``models/transformer.py _run_layers``) on
the CPU: remat on equals remat off bit for bit in the loss and every
gradient (and through ``DistTrainer``), remat on against
``jax.value_and_grad`` of the JAX ``lm_loss`` with ``cfg.remat=True``
(loss rtol 1e-6, gradients atol 1e-6 / rtol 1e-4, as the training
tests hold the port), and no recompute when the forward builds no graph.
Sizes are ``tests/helpers.py``'s tiny configs; inputs made with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.core import DistTrainer, make_strategy
from repro_torch.models import forward_lm, lm_loss
from repro_torch.models import transformer
from repro_torch.models.transformer import flatten, unflatten
from torch_parity import jax_flat, port_cfg, port_params

torch.set_num_threads(1)

CASES = {"dense": ("dense", {}), "loss_chunk": ("dense", {"loss_chunk": 5}),
         "window": ("dense", {"window": 6}), "ssm": ("ssm", {}),
         "moe": ("moe", {}), "hybrid": ("hybrid", {})}


def _batch(cfg, seed=3, B=2, S=16):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def _loss_and_grads(cfg, flat, batch):
    leaves = {k: v.clone().requires_grad_() for k, v in flat.items()}
    loss, _ = lm_loss(unflatten(leaves), {k: torch.from_numpy(v) for k, v
                                          in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_on_equals_off_bit_for_bit(case):
    kind, kw = CASES[case]
    jcfg = tiny_cfg(kind, **kw)
    flat = flatten(port_params(jcfg, jax_init(jcfg, jax.random.key(0))[0]))
    batch = _batch(jcfg)
    l_off, g_off = _loss_and_grads(port_cfg(jcfg).with_(remat=False), flat,
                                   batch)
    l_on, g_on = _loss_and_grads(port_cfg(jcfg).with_(remat=True), flat,
                                 batch)
    assert torch.equal(l_on, l_off)
    for k in g_off:
        assert torch.equal(g_on[k], g_off[k]), k


@pytest.mark.parametrize("case", ["dense", "loss_chunk", "moe"])
def test_remat_loss_and_grads_match_jax_remat(case):
    kind, kw = CASES[case]
    jcfg = tiny_cfg(kind, remat=True, **kw)
    params = jax_init(jcfg, jax.random.key(1))[0]
    batch = _batch(jcfg, seed=5)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_lm_loss(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jcfg), has_aux=True)(params)
    cfg = port_cfg(jcfg)
    assert cfg.remat
    loss, grads = _loss_and_grads(cfg, flatten(port_params(jcfg, params)),
                                  batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    want = jax_flat(jgrads)
    assert set(grads) == set(want)
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k], atol=1e-6,
                                   rtol=1e-4, err_msg=k)


def _count_checkpoints(monkeypatch):
    calls = []
    real = transformer.checkpoint

    def counted(fn, *args, **kw):
        calls.append(1)
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counted)
    return calls


def test_remat_wraps_each_layer_only_when_a_graph_is_built(monkeypatch):
    """One checkpoint per layer for a training forward; none under
    no_grad, none when nothing requires grad (serving), none with remat
    off."""
    jcfg = tiny_cfg("dense")
    cfg = port_cfg(jcfg)
    flat = flatten(port_params(jcfg, jax_init(jcfg, jax.random.key(0))[0]))
    batch = _batch(jcfg)
    calls = _count_checkpoints(monkeypatch)
    _loss_and_grads(cfg, flat, batch)
    assert len(calls) == cfg.num_layers
    calls.clear()
    tokens = {"tokens": torch.from_numpy(batch["tokens"])}
    with torch.no_grad():
        forward_lm(unflatten(flat), tokens, cfg)
    forward_lm(unflatten(flat), tokens, cfg)
    _loss_and_grads(cfg.with_(remat=False), flat, batch)
    assert calls == []


def test_remat_dist_trainer_on_equals_off():
    """Three DiLoCo steps (K 2, H 2) through DistTrainer: the same state
    and losses bit for bit with remat on and off."""
    jcfg = tiny_cfg("dense")
    params = port_params(jcfg, jax_init(jcfg, jax.random.key(0))[0])
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jcfg.vocab_size, (3, 2, 2, 17)).astype(np.int32)
    data = lambda s: {"tokens": toks[s, ..., :-1], "labels": toks[s, ..., 1:]}
    out = {}
    for remat in (False, True):
        cfg = port_cfg(jcfg).with_(remat=remat)
        dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=2)
        dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg),
                         OptimizerConfig(total_steps=4, warmup_steps=1),
                         dcfg, make_strategy(dcfg))
        out[remat] = dt.run(dt.init(params), data, 3)
    (s0, h0), (s1, h1) = out[False], out[True]
    assert h0["loss"] == h1["loss"]
    for k in s0.global_params:
        assert torch.equal(s0.global_params[k], s1.global_params[k]), k
        for w0, w1 in zip(s0.worker_params, s1.worker_params):
            assert torch.equal(w0[k], w1[k]), k
