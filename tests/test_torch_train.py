"""The port's training slice against the JAX package, on the CPU: the
loss and every gradient against ``jax.value_and_grad(lm_loss)``, the
optimizers given identical gradients, DiLoCo and DDP through
``run_stage`` / ``DistTrainer`` against the JAX ``DistTrainer`` on the
same ``worker_batches``; and inside the port, chunked == per-step and
the CLI.  (Fault injection is held to the reference in
``test_torch_faults.py``.)

Sizes are ``tests/helpers.py``'s tiny dense config (2 layers, d 64, 4
heads over 2 KV heads, vocab 97); inputs are made with numpy from a seed
and handed to both packages.  All in float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.data.pipeline import PackedDataset as JaxPackedDataset
from repro.launch.train import run_stage as jax_run_stage
from repro.models import build_model
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import nanochat_optimizer as jax_nanochat_optimizer
from repro_torch.checkpoint import params_to_numpy
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.core import (DDPTrainer, DiLoCoSync, DistTrainer,
                              make_strategy)
from repro_torch.data import PackedDataset
from repro_torch.launch import train
from repro_torch.models import lm_loss
from repro_torch.models.transformer import flatten
from repro_torch.optim import nanochat_optimizer, partition_label
from torch_parity import jax_flat, port_cfg, port_params

# tiny shapes: intra-op threads would only contend with the other test
# workers on the same cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jparams():
    return jax_init(tiny_cfg("dense"), jax.random.key(0))[0]


def _batch(rng, B, S, V):
    toks = rng.integers(0, V, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def _close_trees(got: dict, want: dict, atol, rtol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"loss_chunk": 5}, {"window": 6},
                                {"num_kv_heads": 4}])
def test_lm_loss_and_grads_match_jax_value_and_grad(jparams, kw):
    """Loss (rtol 1e-6) and every gradient leaf (atol 1e-6, rtol 1e-4)
    against jax.value_and_grad of the JAX lm_loss (the jnp attention
    path), with and without chunked CE, a window, and G = 1."""
    cfg = tiny_cfg("dense", **kw)
    params = jparams
    if "num_kv_heads" in kw:
        params = jax_init(cfg, jax.random.key(1))[0]
    batch = _batch(np.random.default_rng(3), 2, 16, cfg.vocab_size)
    # one label ignored (-1), as padding would be
    batch["labels"][1, 4] = -1
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_lm_loss(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, cfg), has_aux=True)(params)
    tree = port_params(cfg, params)
    leaves = flatten(tree)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, metrics = lm_loss(tree, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, port_cfg(cfg))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert metrics["ce"] is loss
    _close_trees({k: g.numpy() for k, g in zip(leaves, grads)},
                 jax_flat(jgrads), atol=1e-6, rtol=1e-4)


# ---------------------------------------------------------------------------
# Optimizers, given identical gradients
# ---------------------------------------------------------------------------

def test_partition_label_sends_embeddings_and_scales_to_adamw(jparams):
    labels = {k: partition_label(k, torch.from_numpy(v.copy()))
              for k, v in jax_flat(jparams).items()}
    assert {k for k, v in labels.items() if v == "adamw"} == {
        "embed/table", "final_norm/scale", "layers/ln1/scale",
        "layers/ln2/scale"}
    assert all(v == "muon" for k, v in labels.items()
               if k.startswith(("layers/attn", "layers/mlp")))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("schedule", ["wsd", "cosine"])
def test_nanochat_optimizer_matches_jax_over_updates(jparams, fused,
                                                     schedule):
    """One and four updates of Muon + AdamW (with global-norm clipping,
    warmup and decay) from identical gradients: parameters agree to
    atol 1e-6 after the first update and 1e-5 after four (Newton-Schulz
    runs its five products in another summation order)."""
    kw = dict(total_steps=4, warmup_steps=1, final_lr_frac=0.1,
              schedule=schedule, grad_clip=1.0, fused_adamw=fused,
              weight_decay=0.01, adam_lr=1e-2)
    jopt = jax_nanochat_optimizer(JaxOptimizerConfig(**kw))
    opt = nanochat_optimizer(OptimizerConfig(**kw))
    jp = jparams
    jstate = jopt.init(jp)
    p = {k: torch.from_numpy(v.copy()) for k, v in jax_flat(jp).items()}
    state = opt.init(p)
    rng = np.random.default_rng(0)
    for step in range(4):
        g = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in sorted(jax_flat(jp).items())}
        jg = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(
                g["/".join(getattr(q, "key", "") for q in path)]), jp)
        upd, jstate = jopt.update(jg, jstate, jp, jnp.int32(step))
        jp = jax_apply_updates(jp, upd)
        tstep = torch.tensor(step, dtype=torch.int32)
        upd_t, state = opt.update({k: torch.from_numpy(v) for k, v in
                                   g.items()}, state, p, tstep)
        for k in p:
            p[k] += upd_t[k]
        _close_trees({k: v.numpy() for k, v in p.items()}, jax_flat(jp),
                     atol=1e-6 if step == 0 else 1e-5, rtol=0)


# ---------------------------------------------------------------------------
# DiLoCo and DDP: the port's run_stage against the JAX run_stage
# ---------------------------------------------------------------------------

OPT = dict(total_steps=8, warmup_steps=2, schedule="wsd",
           learning_rate=0.02, adam_lr=1e-3)


def _datasets(seq_len=16, n=4000):
    tokens = np.random.default_rng(5).integers(0, 97, n).astype(np.int32)
    return (JaxPackedDataset(tokens, seq_len),
            PackedDataset(tokens.copy(), seq_len))


@pytest.mark.parametrize("method,fused", [("diloco", True), ("ddp", False)])
def test_run_stage_matches_jax_dist_trainer(jparams, method, fused):
    """DiLoCo (K=2, H=2, two outer rounds) and DDP (K=1 on the global
    batch of 4), 4 inner steps each, from the same parameters on the same
    worker_batches / batch.  Loss histories agree to rtol 1e-5, sync steps
    exactly, and the final global parameters to atol 2e-5 (Muon's
    Newton-Schulz, the outer Nesterov step and 4 steps of f32 rounding in
    another summation order)."""
    cfg = tiny_cfg("dense")
    jds, ds = _datasets()
    kw = dict(steps=4, workers=2, per_worker_batch=2, h=2, seed=0)
    jparams_out, jhist = jax_run_stage(
        method, build_model(cfg), jparams, jds,
        opt_cfg=JaxOptimizerConfig(fused_adamw=fused, **OPT),
        diloco_cfg=JaxDiLoCoConfig(), **kw)
    params, hist = train.run_stage(
        method, port_cfg(cfg), port_params(cfg, jparams), ds,
        opt_cfg=OptimizerConfig(fused_adamw=fused, **OPT),
        diloco_cfg=DiLoCoConfig(), **kw)
    assert set(hist) == set(jhist)
    assert hist["step"] == jhist["step"] == [0, 1, 2, 3]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    assert hist["sync_steps"] == jhist["sync_steps"]
    assert hist["sync_steps"] == ([1, 3] if method == "diloco"
                                  else [0, 1, 2, 3])
    _close_trees(params_to_numpy(params), jax_flat(jparams_out), atol=2e-5,
                 rtol=0)


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------

def _trainer(cfg, k=2, h=2, **opt):
    dcfg = DiLoCoConfig(num_workers=k, h_inner_steps=h)
    return DistTrainer(lambda p, b: lm_loss(p, b, cfg),
                       OptimizerConfig(**dict(OPT, **opt)), dcfg,
                       make_strategy(dcfg))


@pytest.mark.parametrize("h", [2, 3])
def test_chunked_equals_per_step_bitwise(jparams, h):
    """The chunked loop (one read of the losses per chunk) and the
    per-step loop give the same losses and parameters bit for bit; with
    H=3 over 5 steps the last, partial round is synced by finalize."""
    cfg = port_cfg(tiny_cfg("dense"))
    _, ds = _datasets()
    data = lambda s: ds.worker_batches(s, 2, 2)
    runs = []
    for chunked in (True, False):
        dt = _trainer(cfg, h=h, fused_adamw=True)
        state, hist = dt.run(dt.init(port_params(tiny_cfg("dense"),
                                                 jparams)),
                             data, 5, chunked=chunked)
        runs.append((state, hist))
    (sa, ha), (sb, hb) = runs
    assert ha["loss"] == hb["loss"]
    assert ha["sync_steps"] == hb["sync_steps"] == ([1, 3, 4] if h == 2
                                                    else [2, 4])
    for k, v in sa.global_params.items():
        assert torch.equal(v, sb.global_params[k]), k
    for wa, wb in zip(sa.worker_params, sb.worker_params):
        for k in wa:
            assert torch.equal(wa[k], wb[k]), k


def test_workers_hold_the_anchor_after_each_sync(jparams):
    cfg = port_cfg(tiny_cfg("dense"))
    _, ds = _datasets()
    dt = _trainer(cfg)
    state, _ = dt.run(dt.init(port_params(tiny_cfg("dense"), jparams)),
                      lambda s: ds.worker_batches(s, 2, 2), 2)
    for w in state.worker_params:
        for k, v in state.global_params.items():
            assert torch.equal(w[k], v)
    assert int(state.outer.t) == 1 and int(state.inner_step) == 2


def test_ddp_trainer_step_equals_k1_dist_trainer(jparams):
    """DDPTrainer.train_step is the DistTrainer DDP step (same worker step,
    K=1): same loss and parameters bit for bit."""
    cfg = port_cfg(tiny_cfg("dense"))
    _, ds = _datasets()
    loss_fn = lambda p, b: lm_loss(p, b, cfg)
    opt = OptimizerConfig(**OPT)
    ddp = DDPTrainer(loss_fn, opt)
    st = ddp.init(port_params(tiny_cfg("dense"), jparams))
    losses = []
    for s in range(3):
        st, loss = ddp.train_step(st, {k: torch.from_numpy(v) for k, v in
                                       ds.batch(s, 4).items()})
        losses.append(float(loss))
    dcfg = DiLoCoConfig(num_workers=1, h_inner_steps=1, outer_lr=1.0,
                        outer_momentum=0.0, nesterov=False, strategy="ddp")
    dt = DistTrainer(loss_fn, opt, dcfg, make_strategy(dcfg))
    state, hist = dt.run(dt.init(port_params(tiny_cfg("dense"), jparams)),
                         lambda s: {k: v[None] for k, v in
                                    ds.batch(s, 4).items()}, 3)
    assert hist["loss"] == losses
    for k, v in st.params.items():
        assert torch.equal(v, state.global_params[k]), k


def test_train_cli_runs_on_cpu(capsys):
    """The CLI runs the three stages (3, 1 and 1 steps at H 1) and prints
    one line per stage."""
    res = train.main(["--device", "cpu", "--method", "diloco", "--steps",
                      "3", "--workers", "2", "--fused-adamw"])
    out = capsys.readouterr().out
    for stage, n in (("base", 3), ("mid", 1), ("sft", 1)):
        assert (f"[diloco:{stage}] tiny-nanochat device=cpu kernels=plain"
                in out)
        e = res["stages"][stage]
        assert e["port"]["syncs"] == n and len(e["losses"]) == n
        assert all(np.isfinite(e["losses"]))


def test_train_cli_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--steps", "1"])


def test_ddp_sync_rejects_multiple_workers(jparams):
    cfg = port_cfg(tiny_cfg("dense"))
    dcfg = DiLoCoConfig(num_workers=2, strategy="ddp")
    dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg), OptimizerConfig(),
                     dcfg, make_strategy(dcfg))
    with pytest.raises(ValueError, match="num_workers"):
        dt.run(dt.init(port_params(tiny_cfg("dense"), jparams)), None, 1)


def test_unknown_strategy_is_a_value_error():
    from repro.core.sync import strategy_names as jax_strategy_names
    from repro_torch.core import strategy_names
    with pytest.raises(ValueError, match="unknown strategy"):
        make_strategy(DiLoCoConfig(strategy="nope"))
    assert isinstance(make_strategy(DiLoCoConfig()), DiLoCoSync)
    # the reference's registry, in its order
    assert strategy_names() == jax_strategy_names()


def test_train_cli_runs_gossip_on_cpu(capsys):
    """``--method gossip --topology random --workers 4``: the three stages
    under gossip, each round's records one per worker, the wire bytes
    (int8 codes and the peers' f32 anchors and momentum) on each line."""
    res = train.main(["--device", "cpu", "--method", "gossip",
                      "--topology", "random", "--workers", "4", "--steps",
                      "6", "--delta-dtype", "int8"])
    out = capsys.readouterr().out
    for stage in ("base", "mid", "sft"):
        assert (f"[gossip:{stage}] tiny-nanochat device=cpu kernels=plain"
                in out)
        e = res["stages"][stage]
        assert e["method"] == "gossip" and all(np.isfinite(e["losses"]))
        assert set(e["port"]["wire_bytes"]) == {"int8", "f32"}
    assert res["stages"]["base"]["port"]["syncs"] == 3
    assert "comm_model" not in res


def test_train_cli_worker_speeds_adds_the_comm_report(capsys):
    """``--worker-speeds 1,1.5`` replays the base stage's schedule through
    the comm simulator at its measured step seconds and prints the
    modeled wall-clock beside the link it assumed."""
    res = train.main(["--device", "cpu", "--steps", "3", "--workers", "2",
                      "--worker-speeds", "1,1.5"])
    out = capsys.readouterr().out
    rep = res["comm_model"]
    assert rep["worker_speeds"] == [1.0, 1.5]
    assert rep["step_time_s"] == res["stages"]["base"]["step_seconds"]
    assert rep["link_bytes_per_s"] == 12.5e9
    assert (rep["heterogeneous"]["wall_clock_s"]
            > rep["homogeneous"]["wall_clock_s"])
    assert "[comm:diloco/float32] bytes=" in out and "link=1.25e+10B/s" in out
    with pytest.raises(ValueError, match="one multiplier per worker"):
        train.run_pipeline(method="diloco", device="cpu", workers=2,
                           worker_speeds=(1.0, 1.5, 2.0))
