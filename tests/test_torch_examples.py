"""The port's counterparts of the JAX package's examples
(``examples/torch_{quickstart,adaptive_h,serve_batch,grpo_arith}.py``) on
the CPU with their steps cut, printing the reference examples' lines;
and the wrappers they stand on, ``run_diloco`` / ``run_ddp`` /
``run_streaming_diloco`` and ``DiLoCoTrainer.bytes_per_sync`` /
``ddp_bytes_per_step``, against the JAX package's on the tiny dense
config: loss histories rtol 1e-5, sync records exactly, final parameters
atol 2e-5 (as ``test_torch_train.py`` holds ``run_stage``), byte counts
equal."""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core import AdaptiveH as JaxAdaptiveH
from repro.core import DDPTrainer as JaxDDPTrainer
from repro.core import DiLoCoTrainer as JaxDiLoCoTrainer
from repro.core import StreamingDiLoCoTrainer as JaxStreamingTrainer
from repro.core import run_ddp as jax_run_ddp
from repro.core import run_diloco as jax_run_diloco
from repro.core import run_streaming_diloco as jax_run_streaming
from repro.data.pipeline import PackedDataset as JaxPackedDataset
from repro.models import build_model
from repro.models.transformer import init_params as jax_init
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.core import (AdaptiveH, DDPTrainer, DiLoCoTrainer,
                              StreamingDiLoCoTrainer, run_ddp, run_diloco,
                              run_streaming_diloco)
from repro_torch.data import PackedDataset
from repro_torch.models import lm_loss
from torch_parity import jax_flat, port_cfg, port_params

# tiny shapes: intra-op threads would only contend with the other test
# workers on the same cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
OPT = dict(total_steps=6, warmup_steps=1, schedule="wsd",
           learning_rate=0.02, adam_lr=1e-3)


def _load(name):
    path = REPO / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# The examples, steps cut, on the CPU
# ---------------------------------------------------------------------------

NUM = r"-?\d+\.\d+"
EXAMPLES = {
    # example: (module constants cut, arguments, the reference's lines)
    "torch_quickstart": ({"STEPS": 3}, [], [
        r"tokenizer vocab=512, corpus=\d+ tokens",
        rf"loss {NUM} -> {NUM} \(1 outer syncs, {NUM} MB per sync vs "
        rf"{NUM} MB/step under DDP\)",
        r"'<\|bos\|>the color of ent3 is' -> '.*'",
        r"'<\|bos\|>12 \+ 7 =' -> '.*'"]),
    "torch_serve_batch": ({"STEPS": 3}, [], [
        rf"train loss {NUM} -> {NUM}",
        r"Q: what is the color of ent\d+ \?"] + [r"A: .*"] * 5),
    "torch_adaptive_h": ({}, ["--steps", "3"], [
        rf"fixed H=20   final loss={NUM} syncs=1 comm={NUM} MB",
        rf"fixed H=40   final loss={NUM} syncs=1 comm={NUM} MB",
        rf"adaptive     final loss={NUM} syncs=1 comm={NUM} MB"]),
    "torch_grpo_arith": ({}, ["--iters", "2", "--sft-steps", "3"], [
        rf"SFT loss {NUM} -> {NUM}",
        rf"iter  0 loss [+-]{NUM} mean_reward {NUM}",
        rf"iter  1 loss [+-]{NUM} mean_reward {NUM}"]),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_cpu_and_prints_the_reference_lines(
        name, monkeypatch, capsys):
    consts, args, patterns = EXAMPLES[name]
    mod = _load(name)
    for k, v in consts.items():
        assert hasattr(mod, k), k
        monkeypatch.setattr(mod, k, v)
    mod.main(["--device", "cpu"] + args)
    lines = capsys.readouterr().out.splitlines()
    for pat in patterns:
        assert any(re.fullmatch(pat, line) for line in lines), (pat, lines)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_defaults_to_the_card(name, monkeypatch):
    """The default device is cuda, which raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load(name).main([])


# ---------------------------------------------------------------------------
# run_diloco / run_ddp / run_streaming_diloco and the byte counts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    return jax_init(tiny_cfg("dense"), jax.random.key(0))[0]


def _datasets(seq_len=16, n=4000):
    tokens = np.random.default_rng(5).integers(0, 97, n).astype(np.int32)
    return (JaxPackedDataset(tokens, seq_len),
            PackedDataset(tokens.copy(), seq_len))


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=2e-5,
                                   rtol=0, err_msg=k)


def _same_history(hist, jhist, keys):
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    for k in keys:
        assert hist[k] == jhist[k], k


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_run_diloco_matches_jax(jparams, adaptive):
    """K 2, H 2 over 5 steps (a trailing partial round), the eval hook
    every 2 steps and records every 2; or AdaptiveH."""
    cfg = tiny_cfg("dense")
    jds, ds = _datasets()
    dkw = dict(num_workers=2, h_inner_steps=2)
    hs = dict(h0=2, h_min=1, h_max=4) if adaptive else None
    jtr = JaxDiLoCoTrainer(build_model(cfg).loss, JaxOptimizerConfig(**OPT),
                           JaxDiLoCoConfig(**dkw))
    jst, jhist = jax_run_diloco(
        jtr, jtr.init(jparams), lambda s: _to_jax(jds.worker_batches(s, 2, 2)),
        5, h_schedule=JaxAdaptiveH(**hs) if hs else None, record_every=2,
        eval_fn=lambda gp: 0.0, eval_every=2)
    pcfg = port_cfg(cfg)
    tr = DiLoCoTrainer(lambda p, b: lm_loss(p, b, pcfg),
                       OptimizerConfig(**OPT), DiLoCoConfig(**dkw))
    st, hist = run_diloco(
        tr, tr.init(port_params(cfg, jparams)),
        lambda s: ds.worker_batches(s, 2, 2), 5,
        h_schedule=AdaptiveH(**hs) if hs else None, record_every=2,
        eval_fn=lambda gp: 0.0, eval_every=2)
    _same_history(hist, jhist, ("step", "sync_steps", "evals"))
    assert hist["step"] == [0, 2, 4] and hist["evals"]
    assert len(hist["sync_steps"]) >= 2
    _close(st.global_params, jax_flat(jst.global_params))


def test_run_ddp_matches_jax_and_returns_the_trained_state(jparams):
    """K = 1 on the global batch, 4 steps: the lowered DDPState holds the
    trained parameters (the worker's tensors, trained in place), its
    optimizer state and step."""
    cfg = tiny_cfg("dense")
    jds, ds = _datasets()
    jtr = JaxDDPTrainer(build_model(cfg).loss, JaxOptimizerConfig(**OPT))
    jst, jhist = jax_run_ddp(jtr, jtr.init(jparams),
                             lambda s: _to_jax(jds.batch(s, 4)), 4)
    pcfg = port_cfg(cfg)
    tr = DDPTrainer(lambda p, b: lm_loss(p, b, pcfg), OptimizerConfig(**OPT))
    start = tr.init(port_params(cfg, jparams))
    st, hist = run_ddp(tr, start, lambda s: ds.batch(s, 4), 4)
    _same_history(hist, jhist, ("step", "sync_steps"))
    assert hist["sync_steps"] == [0, 1, 2, 3]
    assert int(st.step) == int(jst.step) == 4
    _close(st.params, jax_flat(jst.params))
    # one more step from the lowered state continues the run
    st2, loss = tr.train_step(st, {k: torch.from_numpy(v) for k, v in
                                   ds.batch(4, 4).items()})
    assert int(st2.step) == 5 and np.isfinite(float(loss))


def test_run_streaming_diloco_matches_jax(jparams):
    """K 2, H 4, two fragments: a fragment syncs every 2 steps."""
    cfg = tiny_cfg("dense")
    jds, ds = _datasets()
    dkw = dict(num_workers=2, h_inner_steps=4)
    jtr = JaxStreamingTrainer(build_model(cfg).loss,
                              JaxOptimizerConfig(**OPT),
                              JaxDiLoCoConfig(**dkw), num_fragments=2)
    jst, jhist = jax_run_streaming(
        jtr, jtr.init(jparams), lambda s: _to_jax(jds.worker_batches(s, 2, 2)),
        6)
    pcfg = port_cfg(cfg)
    tr = StreamingDiLoCoTrainer(lambda p, b: lm_loss(p, b, pcfg),
                                OptimizerConfig(**OPT), DiLoCoConfig(**dkw),
                                num_fragments=2)
    st, hist = run_streaming_diloco(
        tr, tr.init(port_params(cfg, jparams)),
        lambda s: ds.worker_batches(s, 2, 2), 6)
    _same_history(hist, jhist, ("step", "sync_steps", "frag_syncs"))
    assert len(hist["frag_syncs"]) >= 3
    _close(st.global_params, jax_flat(jst.global_params))


@pytest.mark.parametrize("delta_dtype", ["float32", "bfloat16", "int8",
                                         "fp8"])
def test_bytes_per_sync_and_ddp_bytes_match_jax(jparams, delta_dtype):
    cfg = tiny_cfg("dense")
    jtr = JaxDiLoCoTrainer(build_model(cfg).loss, JaxOptimizerConfig(),
                           JaxDiLoCoConfig(delta_dtype=delta_dtype))
    tr = DiLoCoTrainer(None, OptimizerConfig(),
                       DiLoCoConfig(delta_dtype=delta_dtype))
    tparams = port_params(cfg, jparams)
    assert tr.bytes_per_sync(tparams) == jtr.bytes_per_sync(jparams)
    assert tr.ddp_bytes_per_step(tparams) == jtr.ddp_bytes_per_step(jparams)
    assert tr.ddp_bytes_per_step(tparams) == 4 * cfg.param_count()
