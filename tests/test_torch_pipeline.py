"""The port's three-stage pipeline against the JAX package, on the CPU:
``run_pipeline`` for diloco, ddp and hybrid on the tiny model from the
same initial parameters (stage by stage: losses, methods, final
parameters), the H schedules (``AdaptiveH`` decision for decision, a
``run_stage`` under it, chunked == per-step under it), checkpoints in
both directions, the copies of the synthetic generators and of
``build_pipeline`` / ``make_model``, and the CLI.

Sizes are the reference's own pipeline test (``tests/test_system.py``):
tiny (4 layers, d 128), steps 8 / 4 / 4, K 2, per-worker batch 2,
seq_len 64, all in float32."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.checkpoint import load_config as jax_load_config
from repro.checkpoint import load_pytree as jax_load_pytree
from repro.checkpoint import save_config as jax_save_config
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core.schedule import AdaptiveH as JaxAdaptiveH
from repro.core.schedule import StagedH as JaxStagedH
from repro.data import synthetic as jax_synthetic
from repro.data.pipeline import PackedDataset as JaxPackedDataset
from repro.launch import train as jax_train
from repro.models import build_model
from repro.models.transformer import init_params as jax_init
from repro_torch.checkpoint import (load_config, load_pytree, save_config,
                                    save_pytree)
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.core import (AdaptiveH, DistTrainer, StagedH,
                              make_strategy)
from repro_torch.data import PackedDataset, synthetic
from repro_torch.launch import train
from repro_torch.models import lm_loss
from repro_torch.models.transformer import flatten
from torch_parity import jax_flat, port_cfg, port_params

torch.set_num_threads(1)

STEPS = {"base": 8, "mid": 4, "sft": 4}
PIPE = dict(arch="tiny", steps=STEPS, workers=2, per_worker_batch=2,
            seq_len=64, eval_after_each_stage=False)
OPT = dict(total_steps=16, warmup_steps=2, schedule="wsd",
           learning_rate=0.02, adam_lr=1e-3)


@pytest.fixture(scope="module")
def vocab():
    return train.build_pipeline(seq_len=64)[1].vocab_size


@pytest.fixture(scope="module")
def tiny(vocab):
    """The JAX launcher's tiny config and its initial parameters (seed 0),
    as the JAX ``run_pipeline`` draws them."""
    jcfg, _ = jax_train.make_model("tiny", True, vocab)
    return jcfg, jax_init(jcfg, jax.random.key(0))[0]


def _start_from(monkeypatch, jcfg, jparams):
    """Make the port's ``run_pipeline`` start from the JAX parameters."""
    def init(cfg, seed=0, device="cpu"):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        return port_params(jcfg, jparams)
    monkeypatch.setattr(train, "init_params", init)


@pytest.mark.parametrize("method", ["diloco", "ddp", "hybrid"])
def test_run_pipeline_matches_jax(tiny, monkeypatch, tmp_path, method):
    """Stage by stage from the same initial parameters: the methods equal,
    every loss within rtol 1e-5, and the final parameters that
    ``out_dir`` holds within atol 1e-4 (16 steps of Muon's Newton-Schulz
    and of the outer Nesterov step in another summation order)."""
    jcfg, jparams = tiny
    jres = jax_train.run_pipeline(method, out_dir=str(tmp_path / "jax"),
                                  **PIPE)
    _start_from(monkeypatch, jcfg, jparams)
    res = train.run_pipeline(method, out_dir=str(tmp_path / "port"),
                             device="cpu", **PIPE)
    assert res["arch"] == jres["arch"] and res["method"] == method
    for stage in ("base", "mid", "sft"):
        got, want = res["stages"][stage], jres["stages"][stage]
        assert got["method"] == want["method"]
        assert len(got["losses"]) == STEPS[stage]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(
            [got["loss_first"], got["loss_last"]],
            [want["loss_first"], want["loss_last"]], rtol=1e-5)
    want_methods = {"diloco": ["diloco"] * 3, "ddp": ["ddp"] * 3,
                    "hybrid": ["diloco", "ddp", "ddp"]}[method]
    assert [res["stages"][s]["method"] for s in STEPS] == want_methods
    final = load_pytree(str(tmp_path / "port" / f"{method}_final"))
    jfinal = load_pytree(str(tmp_path / "jax" / f"{method}_final"))
    assert set(final) == set(jfinal)
    for k in final:
        np.testing.assert_allclose(final[k], jfinal[k], atol=1e-4, err_msg=k)
    metrics = json.loads((tmp_path / "port" /
                          f"{method}_metrics.json").read_text())
    assert metrics["stages"]["sft"]["loss_last"] == \
        res["stages"]["sft"]["loss_last"]


# ---------------------------------------------------------------------------
# H schedules
# ---------------------------------------------------------------------------

def _scripted(kind, n=120):
    rng = np.random.default_rng(len(kind))
    x = np.arange(n)
    if kind == "steep":
        return list(6.0 - 0.02 * x)
    if kind == "flat":
        return list(3.0 + 1e-5 * rng.standard_normal(n))
    if kind == "phases":     # steep descent, then a plateau, then a drop
        y = np.where(x < 40, 6.0 - 0.02 * x, 5.2)
        return list(np.where(x > 90, y - 0.01 * (x - 90), y))
    return list(4.0 + 0.01 * rng.standard_normal(n))        # noisy


@pytest.mark.parametrize("kind", ["steep", "flat", "phases", "noisy"])
@pytest.mark.parametrize("kw", [dict(), dict(h0=2, window=4),
                                dict(h0=16, h_min=4, h_max=40, window=8,
                                     hi=1e-2, lo=1e-3)])
def test_adaptive_h_decides_as_the_reference(kind, kw):
    """On a scripted loss sequence the port's ``AdaptiveH`` syncs at the
    same steps and holds the same H as the JAX package's at every step."""
    port, ref = AdaptiveH(**kw), JaxAdaptiveH(**kw)
    since = 0
    for step, loss in enumerate(_scripted(kind)):
        since += 1
        a = port.should_sync(step, since, float(loss))
        b = ref.should_sync(step, since, float(loss))
        assert a == b and port.current_h == ref.current_h, step
        if a:
            since = 0
    staged, jstaged = StagedH(30), JaxStagedH(30)
    assert [staged.should_sync(0, s, 0.0) for s in range(40)] == \
        [jstaged.should_sync(0, s, 0.0) for s in range(40)]


def _tiny_ds(seq_len=16, n=4000):
    tokens = np.random.default_rng(5).integers(0, 97, n).astype(np.int32)
    return (JaxPackedDataset(tokens, seq_len),
            PackedDataset(tokens.copy(), seq_len))


def test_run_stage_with_adaptive_h_matches_jax():
    """``run_stage("diloco")`` under ``AdaptiveH(h0=2, window=4)``: syncs
    at H 2 (steps 1, 3, 5, 7) until the slope at step 7 is steep and H
    jumps to its floor h_min 10, past the end of the run, so the last
    sync is the trailing one at 15.  Losses within rtol 1e-5 and
    ``sync_steps`` equal to the JAX ``run_stage``'s."""
    cfg = tiny_cfg("dense")
    jparams = jax_init(cfg, jax.random.key(0))[0]
    jds, ds = _tiny_ds()
    kw = dict(steps=16, workers=2, per_worker_batch=2, h=2, seed=0)
    _, jhist = jax_train.run_stage(
        "diloco", build_model(cfg), jparams, jds,
        opt_cfg=JaxOptimizerConfig(**OPT), diloco_cfg=JaxDiLoCoConfig(),
        h_schedule=JaxAdaptiveH(h0=2, window=4), **kw)
    _, hist = train.run_stage(
        "diloco", port_cfg(cfg), port_params(cfg, jparams), ds,
        opt_cfg=OptimizerConfig(**OPT), diloco_cfg=DiLoCoConfig(),
        h_schedule=AdaptiveH(h0=2, window=4), **kw)
    assert hist["sync_steps"] == jhist["sync_steps"] == [1, 3, 5, 7, 15]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)


def test_chunked_equals_per_step_under_adaptive_h():
    """The chunked loop (inner steps up to the next sync, one read per
    chunk) and the per-step loop give the same losses, sync steps and
    parameters bit for bit under ``AdaptiveH``: H changes only at a
    sync, so ``next_event`` holds."""
    cfg = tiny_cfg("dense")
    params = port_params(cfg, jax_init(cfg, jax.random.key(1))[0])
    pcfg = port_cfg(cfg)
    _, ds = _tiny_ds()
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=2)
    runs = []
    for chunked in (True, False):
        dt = DistTrainer(lambda p, b: lm_loss(p, b, pcfg),
                         OptimizerConfig(**OPT), dcfg,
                         make_strategy(dcfg, h_schedule=AdaptiveH(
                             h0=2, h_min=3, window=4)))
        state, hist = dt.run(
            dt.init({k: v.clone() for k, v in flatten(params).items()}),
            lambda s: ds.worker_batches(s, 2, 2, seed=0), 16,
            chunked=chunked)
        runs.append((state.global_params, hist))
    (p1, h1), (p2, h2) = runs
    assert h1["loss"] == h2["loss"] and h1["sync_steps"] == h2["sync_steps"]
    assert len(h1["sync_steps"]) >= 3
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


def test_make_strategy_passes_the_h_schedule_to_diloco_only():
    hs = AdaptiveH(h0=4)
    assert make_strategy(DiLoCoConfig(), h_schedule=hs).h_schedule is hs
    for name in ("ddp", "streaming", "overlapped", "pipelined"):
        strat = make_strategy(DiLoCoConfig(strategy=name), h_schedule=hs)
        assert not hasattr(strat, "h_schedule"), name


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_port_checkpoint_loads_in_jax(tiny, tmp_path):
    """The port's ``save_pytree`` / ``save_config`` write what the JAX
    package writes: the same manifest, and the JAX ``load_pytree`` /
    ``load_config`` read them back leaf for leaf."""
    jcfg, jparams = tiny
    path, jpath = str(tmp_path / "port"), str(tmp_path / "jax")
    save_pytree(port_params(jcfg, jparams), path)
    save_config(port_cfg(jcfg), path)
    jax_save_pytree(jparams, jpath)
    with open(path + ".json") as f, open(jpath + ".json") as g:
        assert json.load(f) == json.load(g)
    back = jax_load_pytree(jparams, path)
    for k, v in jax_flat(back).items():
        np.testing.assert_array_equal(v, jax_flat(jparams)[k], err_msg=k)
    assert jax_load_config(path) == jcfg
    assert not [p for p in tmp_path.iterdir() if ".tmp." in p.name]


def test_jax_checkpoint_loads_in_port(tiny, tmp_path):
    jcfg, jparams = tiny
    path = str(tmp_path / "ck")
    jax_save_pytree(jparams, path)
    jax_save_config(jcfg, path)
    flat = load_pytree(path)
    want = jax_flat(jparams)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    assert load_config(path) == port_cfg(jcfg)


def test_port_checkpoint_round_trips_in_the_port(tiny, tmp_path):
    jcfg, jparams = tiny
    params = port_params(jcfg, jparams)
    path = str(tmp_path / "ck")
    save_pytree(params, path)
    save_config(port_cfg(jcfg), path)
    back = load_pytree(path)
    for k, v in flatten(params).items():
        assert np.array_equal(back[k], v.numpy()), k
    assert load_config(path) == port_cfg(jcfg)


# ---------------------------------------------------------------------------
# Copies of the data generators, build_pipeline and make_model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("gen_pretrain_texts", (300, 0)), ("gen_dialogue_texts", (300, 1)),
    ("gen_sft_texts", (300, 2)), ("gen_mc_eval", (32, 7)),
    ("gen_mc_eval_heldout", (32, 7)), ("gen_arith_eval", (32, 8)),
    ("gen_pattern_eval", (32, 9))])
def test_synthetic_generators_copy_the_reference(name, args):
    world = synthetic.World.make(40, seed=1234)
    jworld = jax_synthetic.World.make(40, seed=1234)
    kw = {}
    if name == "gen_mc_eval_heldout":
        name, kw = "gen_mc_eval", dict(heldout=True)
    port, ref = getattr(synthetic, name), getattr(jax_synthetic, name)
    if name in ("gen_arith_eval", "gen_pattern_eval"):
        assert port(*args) == ref(*args)
    else:
        assert port(world, *args, **kw) == ref(jworld, *args, **kw)


def test_build_pipeline_copies_the_reference():
    """The three stages' token streams, the tokenizer and the eval suites
    equal the JAX ``build_pipeline``'s."""
    _, tok, stages, suites = train.build_pipeline(seq_len=64)
    _, jtok, jstages, jsuites = jax_train.build_pipeline(seq_len=64)
    assert tok.vocab_size == jtok.vocab_size and tok.merges == jtok.merges
    assert set(stages) == set(jstages) == {"base", "mid", "sft"}
    for k in stages:
        np.testing.assert_array_equal(stages[k].tokens, jstages[k].tokens)
    assert suites == jsuites


@pytest.mark.parametrize("arch,reduced", [
    ("tiny", True), ("nanochat-d20", True), ("nanochat-d20", False),
    ("mamba2-1.3b", True)])
def test_make_model_follows_the_reference(vocab, arch, reduced):
    """The JAX launcher's config, field for field: the tokenizer's vocab
    replaces nanochat-d20's 65536, and ``reduced`` takes the reduced
    variant."""
    cfg = train.make_model(arch, reduced, vocab)
    jcfg, _ = jax_train.make_model(arch, reduced, vocab)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.vocab_size == vocab


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_train_cli_runs_hybrid_with_adaptive_h(tmp_path, capsys):
    res = train.main(["--device", "cpu", "--method", "hybrid", "--steps",
                      "4", "--workers", "2", "--adaptive-h", "--out-dir",
                      str(tmp_path)])
    out = capsys.readouterr().out
    for stage in ("base", "mid", "sft"):
        assert f"[hybrid:{stage}] tiny-nanochat device=cpu kernels=plain" \
            in out
        assert np.isfinite(res["stages"][stage]["loss_last"])
        assert all(0.0 <= v <= 1.0
                   for v in res["stages"][stage]["tasks"].values())
    assert [res["stages"][s]["method"] for s in STEPS] == \
        ["diloco", "ddp", "ddp"]
    for name in ("hybrid_final.npz", "hybrid_final.json",
                 "hybrid_final.cfg.json", "hybrid_metrics.json"):
        assert (tmp_path / name).exists(), name
