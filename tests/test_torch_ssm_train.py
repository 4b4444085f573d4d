"""Training through the SSD scan (``kernels/ssd/ops.py`` ``_SSDGrad``:
the scan's forward, the plain ``ssd_chunked``'s gradient from the saved
inputs) and ``run_stage`` of the decoder-only families the port added
last — ssm (mamba2-1.3b), hybrid (hymba-1.5b) and moe (mixtral-8x7b) —
against the JAX package, on the CPU, where the forward is the plain scan
too.  The route's gradients of every operand against ``jax.vjp`` of the
reference's ``ssd_chunked`` (atol 1e-5 in units of the largest gradient,
rtol 1e-4) and bit for bit against autograd through ``ssd_chunked``;
``lm_loss`` gradients of the tiny ssm and mamba2 reduced (atol 1e-6 /
rtol 1e-4); one DiLoCo stage (K 2, H 2, 4 steps, f32 wire) of each
family's tiny config against the JAX ``run_stage`` (losses rtol 1e-5,
parameters atol 2e-5, ``test_torch_strategies.py``'s); the CLIs take
the new ids."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs import registry as jax_registry
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.data.pipeline import PackedDataset as JaxPackedDataset
from repro.launch.train import run_stage as jax_run_stage
from repro.models import build_model
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro_torch.checkpoint import params_to_numpy
from repro_torch.configs import DiLoCoConfig, OptimizerConfig, get_config
from repro_torch.data import PackedDataset
from repro_torch.kernels.ssd import ssd, ssd_chunked
from repro_torch.launch import train
from repro_torch.models import lm_loss
from repro_torch.models.transformer import flatten, unflatten
from torch_cases import ssd_inputs
from torch_parity import jax_flat, port_cfg, port_params

torch.set_num_threads(1)

NEW_IDS = ["mamba2-1.3b", "hymba-1.5b", "mixtral-8x7b",
           "llama4-scout-17b-a16e"]


def _weights(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 16, 2, 8, 4, 8), (1, 21, 3, 16, 8, 8), (2, 64, 2, 16, 32, 32)])
def test_ssd_gradient_matches_jax_vjp(B, S, H, P, N, chunk):
    """d/d(x, dt, A, Bm, Cm, D) of <y, gy> + <h, gh> through the route
    against ``jax.vjp`` of the reference's scan (S 21: a padded chunk)."""
    args = ssd_inputs(B, B, S, H, P, N, D_val=0.5)
    gy, gh = _weights([(B, S, H, P), (B, H, N, P)], seed=S)

    @jax.jit
    def vjp(*a):
        _, back = jax.vjp(lambda *b: jax_ssd_chunked(*b, chunk), *a)
        return back((jnp.asarray(gy), jnp.asarray(gh)))

    want = vjp(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    y, h = ssd(*ts, chunk=chunk)
    assert type(y.grad_fn).__name__ == "_SSDGradBackward"
    got = torch.autograd.grad((y, h), ts, (torch.from_numpy(gy),
                                           torch.from_numpy(gh)))
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm", "D"), got, want):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * scale,
                                   rtol=1e-4, err_msg=name)


def test_ssd_route_equals_autograd_through_the_plain_scan():
    """Forward and every gradient bit for bit; the route is taken only
    for operands that need a gradient (no graph, no ``_SSDGrad``), and a
    gradient flows only to those."""
    args = ssd_inputs(3, 2, 24, 2, 8, 4)
    gy = torch.from_numpy(_weights([(2, 24, 2, 8)], 1)[0])
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    y, h = ssd(*ts, chunk=8)
    g_route = torch.autograd.grad(y, ts, gy)
    ts2 = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    y2, h2 = ssd_chunked(*ts2, 8)
    g_plain = torch.autograd.grad(y2, ts2, gy)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    for a, b in zip(g_route, g_plain):
        assert torch.equal(a, b)
    with torch.no_grad():
        y3, _ = ssd(*ts, chunk=8)
    assert y3.grad_fn is None and torch.equal(y3, y)
    part = [torch.from_numpy(a.copy()) for a in args]
    part[0].requires_grad_()
    y4, _ = ssd(*part, chunk=8)
    (gx,) = torch.autograd.grad(y4, [part[0]], gy)
    assert torch.equal(gx, g_route[0])


@pytest.mark.parametrize("which", ["tiny", "mamba2-1.3b"])
def test_ssm_lm_loss_and_grads_match_jax(which):
    cfg = tiny_cfg("ssm") if which == "tiny" else \
        jax_registry.get_reduced(which)
    params, _ = jax_init(cfg, jax.random.key(0))
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, cfg), has_aux=True))(params)
    leaves = {k: v.clone().requires_grad_() for k, v in
              flatten(port_params(cfg, params)).items()}
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


OPT = dict(total_steps=4, warmup_steps=1, learning_rate=0.02, adam_lr=1e-3)


@pytest.mark.parametrize("family", ["ssm", "hybrid", "moe"])
def test_diloco_stage_matches_jax_run_stage(family):
    """``run_stage("diloco")``, K 2, H 2, 4 steps, f32 wire, from one
    set of parameters on one token stream: the per-step losses, the
    syncs and the final global parameters."""
    cfg = tiny_cfg(family)
    jparams, _ = jax_init(cfg, jax.random.key(0))
    tokens = np.random.default_rng(5).integers(0, 97, 3000).astype(np.int32)
    kw = dict(steps=4, workers=2, per_worker_batch=2, h=2, seed=0)
    jout, jhist = jax_run_stage(
        "diloco", build_model(cfg), jparams, JaxPackedDataset(tokens, 16),
        opt_cfg=JaxOptimizerConfig(**OPT), diloco_cfg=JaxDiLoCoConfig(),
        **kw)
    out, hist = train.run_stage(
        "diloco", port_cfg(cfg), port_params(cfg, jparams),
        PackedDataset(tokens.copy(), 16), opt_cfg=OptimizerConfig(**OPT),
        diloco_cfg=DiLoCoConfig(), **kw)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    assert hist["sync_steps"] == jhist["sync_steps"] == [1, 3]
    got, want = params_to_numpy(out), jax_flat(jout)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("arch", NEW_IDS)
def test_train_cli_builds_the_new_configs(arch):
    assert train.make_model(arch, True, 512) == \
        port_cfg(jax_registry.get_reduced(arch)).with_(vocab_size=512)
    assert train.make_model(arch, False, 512) == \
        get_config(arch).with_(vocab_size=512)


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """A chunk of 32 at dt 1 and A -16: the within-chunk decays reach
    e^-496, and the reference's masked upper triangle, exp(+496), is inf,
    so its dt and A gradients are NaN (0 x inf).  The port masks the
    exponent instead: every gradient finite, y and the x gradient equal
    to the reference's (rtol 1e-5)."""
    rng = np.random.default_rng(0)
    B, S, H, P, N = 1, 32, 2, 4, 4
    args = [rng.standard_normal((B, S, H, P)).astype(np.float32),
            np.ones((B, S, H), np.float32), np.full((H,), -16.0, np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            np.ones((H,), np.float32)]
    jy, _ = jax_ssd_chunked(*map(jnp.asarray, args), 32)
    jg = jax.grad(lambda *a: jnp.sum(jax_ssd_chunked(*a, 32)[0]),
                  argnums=(0, 1, 2))(*map(jnp.asarray, args))
    assert not np.isnan(np.asarray(jg[0])).any()
    assert np.isnan(np.asarray(jg[1])).any() and np.isnan(
        np.asarray(jg[2])).any()
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    y, _ = ssd(*ts, chunk=32)
    grads = torch.autograd.grad(y.sum(), ts)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg[0]),
                               rtol=1e-5, atol=1e-6)
