"""Run checkpoints and resume in the port, on the CPU.

The run-checkpoint API (``repro_torch.checkpoint``) writes the JAX
package's layout: the same file names and manifest keys, read back by the
JAX package's readers and the other way round; a torn write falls back
to the previous checkpoint, as ``tests/test_faults.py`` pins for the
JAX package.  Inside the port, as the JAX package pins inside itself: a
run resumed from a checkpoint equals the uninterrupted run bit for bit
(every state leaf, the runner's error-feedback residual, the recorded
history) for every ported strategy, through ``DistTrainer.run`` and
through ``run_pipeline(..., checkpoint_dir, resume)``.  Sizes are
``tests/helpers.py``'s tiny dense config; batches are made with numpy."""
import os

import jax
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.checkpoint import latest_run_checkpoint as jax_latest
from repro.checkpoint import list_run_checkpoints as jax_list
from repro.checkpoint import load_run_checkpoint as jax_load
from repro.checkpoint import save_run_checkpoint as jax_save
from repro.models.transformer import init_params as jax_init
from repro_torch.checkpoint import (latest_run_checkpoint,
                                    list_run_checkpoints,
                                    load_run_checkpoint, save_run_checkpoint)
from repro_torch.checkpoint.checkpoint import _atomic_bytes, _leaves
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.core import (DistTrainer, compressed_ddp_config,
                              make_strategy)
from repro_torch.launch import train
from repro_torch.models import lm_loss
from torch_parity import port_cfg, port_params

torch.set_num_threads(1)

CFG = tiny_cfg("dense")
PCFG = port_cfg(CFG)
OPT = OptimizerConfig(total_steps=20, warmup_steps=2, learning_rate=0.02,
                      adam_lr=1e-3)


@pytest.fixture(scope="module")
def params():
    return port_params(CFG, jax_init(CFG, jax.random.key(0))[0])


def _data(k):
    def data(step):
        toks = np.random.default_rng(1000 + step).integers(
            0, CFG.vocab_size, (k, 2, 17)).astype(np.int32)
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    return data


class _KeepRunner:
    """Hands out the runner ``DistTrainer.run`` binds, so the tests can
    read its residual."""

    def __init__(self, strategy):
        self.strategy, self.runner = strategy, None

    def bind(self, engine, params):
        self.runner = self.strategy.bind(engine, params)
        return self.runner

    def __getattr__(self, name):
        return getattr(self.strategy, name)


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


# ---------------------------------------------------------------------------
# The run-checkpoint API
# ---------------------------------------------------------------------------

def _state_like(seed=0):
    """A tree of the shapes the port's training state takes: a NamedTuple
    of flat dicts, lists of K dicts, nested optimizer dicts, None, a 0-d
    int32 counter and a bf16 leaf."""
    from repro_torch.core.diloco import DiLoCoState
    from repro_torch.core.outer_opt import OuterState
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    return DiLoCoState(
        global_params={"a/w": r(3, 4), "b": r(5)},
        outer=OuterState(v={"a/w": r(3, 4), "b": r(5)},
                         t=torch.tensor(3, dtype=torch.int32)),
        worker_params=[{"a/w": r(3, 4), "b": r(5).bfloat16()}
                       for _ in range(2)],
        inner_opt=[{"adamw": {"m": {"b": r(5)}, "v": {"b": r(5)}},
                    "muon": {"mu": {"a/w": r(3, 4)}}, "none": None}
                   for _ in range(2)],
        inner_step=torch.tensor(7, dtype=torch.int32))


def test_run_checkpoint_round_trip_restores_exact_dtypes(tmp_path):
    d = str(tmp_path)
    state = _state_like(0)
    res = {"residual": {"a/w": torch.randn(2, 3, 4)}}
    path = save_run_checkpoint(d, 12, state, extras_arrays=res,
                               extras_meta={"round": 2},
                               history={"loss": [1.5], "frag_syncs": [(1, 0)]},
                               meta={"num_steps": 20})
    assert path.endswith("ckpt_00000012.manifest.json")
    assert sorted(os.listdir(d)) == [
        f"ckpt_00000012.{p}" for p in ("extras.json", "extras.npz",
                                       "manifest.json", "state.json",
                                       "state.npz")]
    man = latest_run_checkpoint(d)
    assert man["format"] == 1 and man["step"] == man["data_cursor"] == 12
    assert man["extras_meta"] == {"round": 2}
    assert man["history"] == {"loss": [1.5], "frag_syncs": [[1, 0]]}
    template = _state_like(1)
    got, extras = load_run_checkpoint(man, template,
                                      {"residual": {"a/w": torch.zeros(
                                          2, 3, 4)}})
    _assert_trees_equal(got, state)
    _assert_trees_equal(extras, res)
    assert got.inner_opt[0]["none"] is None
    assert got.worker_params[0]["b"].dtype == torch.bfloat16
    assert got.inner_step.dtype == torch.int32 and got.inner_step.dim() == 0
    for (_, x), (_, t) in zip(_leaves(got), _leaves(template)):
        assert x.data_ptr() != t.data_ptr()   # fresh tensors
    # no extras file without tensors; the extras template is then unused
    save_run_checkpoint(d, 14, state, extras_arrays={"residual": None})
    man = latest_run_checkpoint(d)
    assert "extras" not in man["files"]
    assert load_run_checkpoint(man, template, {"residual": None})[1] is None


def test_run_checkpoints_read_both_ways_with_the_jax_package(tmp_path):
    """The same file names and manifest keys as the JAX package: its
    readers load what the port writes, and the port's what it writes."""
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    save_run_checkpoint(pdir, 4, {"p": {"w": torch.from_numpy(w)}},
                        extras_arrays={"r": torch.ones(2)},
                        history={"loss": [0.5]})
    jax_save(jdir, 4, {"p": {"w": w}}, extras_arrays={"r": np.ones(2,
                                                                    np.float32)},
             history={"loss": [0.5]})
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    pm, jm = latest_run_checkpoint(pdir), jax_latest(jdir)
    assert {k: v for k, v in pm.items() if k != "_dir"} == \
        {k: v for k, v in jm.items() if k != "_dir"}
    assert [s for s, _ in jax_list(pdir)] == [4]
    st, ex = jax_load(jax_latest(pdir), {"p": {"w": np.zeros((3, 4),
                                                             np.float32)}},
                      {"r": np.zeros(2, np.float32)})
    np.testing.assert_array_equal(st["p"]["w"], w)
    np.testing.assert_array_equal(ex["r"], np.ones(2))
    st, ex = load_run_checkpoint(latest_run_checkpoint(jdir),
                                 {"p": {"w": torch.zeros(3, 4)}},
                                 {"r": torch.zeros(2)})
    assert torch.equal(st["p"]["w"], torch.from_numpy(w))
    assert torch.equal(ex["r"], torch.ones(2))


def test_torn_checkpoint_falls_back_to_previous(tmp_path):
    d = str(tmp_path)
    s1 = {"w": torch.arange(4, dtype=torch.float32)}
    s2 = {"w": torch.arange(4, dtype=torch.float32) * 2}
    save_run_checkpoint(d, 2, s1, history={"loss": [1.0]})
    save_run_checkpoint(d, 4, s2)
    assert [s for s, _ in list_run_checkpoints(d)] == [2, 4]
    # torn write: the newest state file vanished mid-crash -> its
    # manifest is incomplete and the reader degrades to the previous step
    os.remove(os.path.join(d, "ckpt_00000004.state.npz"))
    assert [s for s, _ in list_run_checkpoints(d)] == [2]
    man = latest_run_checkpoint(d)
    assert man["step"] == 2 and man["history"] == {"loss": [1.0]}
    state, _ = load_run_checkpoint(man, {"w": torch.zeros(4)})
    assert torch.equal(state["w"], s1["w"])
    # garbage manifest (torn json): skipped, not fatal
    with open(os.path.join(d, "ckpt_00000006.manifest.json"), "w") as f:
        f.write('{"step": 6, "files": {')
    assert [s for s, _ in list_run_checkpoints(d)] == [2]
    assert latest_run_checkpoint(str(tmp_path / "none")) is None


def test_atomic_write_crash_leaves_old_file_and_no_tmp(tmp_path):
    p = str(tmp_path / "manifest.json")
    _atomic_bytes(p, lambda f: f.write(b"old"))

    def boom(f):
        f.write(b"torn")
        raise RuntimeError("crash mid-write")

    with pytest.raises(RuntimeError, match="mid-write"):
        _atomic_bytes(p, boom)
    with open(p, "rb") as f:
        assert f.read() == b"old"
    assert os.listdir(str(tmp_path)) == ["manifest.json"]


# ---------------------------------------------------------------------------
# Resume == uninterrupted, per strategy
# ---------------------------------------------------------------------------

# name: (K, DiLoCoConfig fields, steps, checkpoint_every, resume-from)
RESUME = {
    "ddp": (1, dict(h_inner_steps=1, outer_lr=1.0, outer_momentum=0.0,
                    nesterov=False, strategy="ddp"), 7, 3, 3),
    "ddp_compressed_int8": (2, "compressed", 5, 2, 2),
    "diloco": (2, dict(h_inner_steps=3), 8, 3, 3),
    "diloco_int8": (2, dict(h_inner_steps=3, delta_dtype="int8"), 8, 3, 3),
    "diloco_fp8": (2, dict(h_inner_steps=2, delta_dtype="fp8"), 7, 2, 4),
    "streaming_int8": (2, dict(h_inner_steps=4, strategy="streaming",
                               num_fragments=2, delta_dtype="int8"), 9, 3, 3),
    "overlapped_int8": (3, dict(h_inner_steps=4, strategy="overlapped",
                                sync_delay=1, h_jitter=2, sync_seed=3,
                                delta_dtype="int8"), 12, 2, 5),
    "pipelined_int8": (2, dict(h_inner_steps=2, strategy="pipelined",
                               num_fragments=2, sync_delay=1,
                               delta_dtype="int8"), 8, 2, 3),
}


def _run(params, k, dkw, steps, **kw):
    if dkw == "compressed":
        dcfg = compressed_ddp_config(DiLoCoConfig(num_workers=k,
                                                  grad_compress="int8"))
    else:
        dcfg = DiLoCoConfig(num_workers=k, **dkw)
    keep = _KeepRunner(make_strategy(dcfg))
    dt = DistTrainer(lambda p, b: lm_loss(p, b, PCFG), OPT, dcfg, keep)
    state, hist = dt.run(dt.init(params), _data(k), steps, **kw)
    return state, keep.runner, hist


@pytest.mark.parametrize("name", sorted(RESUME))
def test_resume_equals_uninterrupted_bit_for_bit(params, tmp_path, name):
    """Checkpoints every ``c`` steps, then a run resumed (into fresh state)
    from the checkpoint at ``r`` (the later manifests removed): the final
    state, the residual and the history equal the uninterrupted run's.
    Overlapped (jitter 2) and pipelined (delay 1) defer checkpoints that
    land while a snapshot is in flight."""
    k, dkw, steps, every, start = RESUME[name]
    d = str(tmp_path)
    a_state, a_run, a_hist = _run(params, k, dkw, steps, checkpoint_dir=d,
                                  checkpoint_every=every)
    written = list_run_checkpoints(d)
    assert start in [s for s, _ in written]
    for s, man in written:
        if s > start:
            os.remove(man)
    b_state, b_run, b_hist = _run(params, k, dkw, steps, checkpoint_dir=d,
                                  resume=True)
    _assert_trees_equal(b_state, a_state)
    if name in ("ddp", "diloco"):
        assert getattr(a_run, "residual", None) is None
        assert getattr(b_run, "residual", None) is None
    else:
        _assert_trees_equal(b_run.residual, a_run.residual)
    for key in ("step", "loss", "sync_steps", "frag_syncs", "evals"):
        assert b_hist[key] == a_hist[key], key


def test_deferred_checkpoints_land_at_the_next_clean_boundary(params,
                                                              tmp_path):
    """Pipelined, H 2, delay 1: a fragment is in flight at every even
    boundary, so each checkpoint lands one step later; DiLoCo writes a
    checkpoint only at its outer boundaries (since == 0)."""
    d = str(tmp_path / "p")
    _run(params, 2, RESUME["pipelined_int8"][1], 8, checkpoint_dir=d,
         checkpoint_every=2)
    assert [s for s, _ in list_run_checkpoints(d)] == [3, 5, 7]
    d = str(tmp_path / "d")
    _run(params, 2, dict(h_inner_steps=3), 8, checkpoint_dir=d,
         checkpoint_every=2)
    assert [s for s, _ in list_run_checkpoints(d)] == [3, 6]


def test_resume_from_an_empty_directory_is_a_fresh_run(params, tmp_path):
    """No checkpoint yet: resume starts at step 0 and leaves the caller's
    state alone until the run consumes it, as a plain run does."""
    a, _, ha = _run(params, 2, dict(h_inner_steps=2), 4)
    b, _, hb = _run(params, 2, dict(h_inner_steps=2), 4,
                    checkpoint_dir=str(tmp_path), resume=True)
    _assert_trees_equal(b, a)
    assert ha["loss"] == hb["loss"]


def test_resume_loads_into_fresh_tensors(params, tmp_path):
    """A resumed run never writes into the tensors of the state it was
    given: those stay the initial state."""
    d = str(tmp_path)
    _run(params, 2, dict(h_inner_steps=2), 4, checkpoint_dir=d,
         checkpoint_every=2)
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=2)
    dt = DistTrainer(lambda p, b: lm_loss(p, b, PCFG), OPT, dcfg,
                     make_strategy(dcfg))
    given = dt.init(params)
    before = {k: v.clone() for k, v in given.worker_params[0].items()}
    dt.run(given, _data(2), 6, checkpoint_dir=d, resume=True)
    for k, v in before.items():
        assert torch.equal(given.worker_params[0][k], v), k


@pytest.mark.parametrize("kw,match", [
    (dict(resume=True), "requires checkpoint_dir"),
    (dict(chunked=False, prefetch=2), "prefetch requires"),
    (dict(chunked=False, checkpoint_dir="x", checkpoint_every=1),
     "chunked loop"),
    (dict(chunked=False, checkpoint_dir="x", resume=True), "chunked loop")])
def test_run_rejects_what_the_reference_rejects(params, kw, match):
    with pytest.raises(ValueError, match=match):
        _run(params, 2, dict(h_inner_steps=2), 2, **kw)


# ---------------------------------------------------------------------------
# Through run_pipeline and the CLI
# ---------------------------------------------------------------------------

def test_run_pipeline_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """run_pipeline on the tiny model (base 4, mid 2, SFT 2; K 2, no
    evals): checkpoints every 2 base steps, then a rerun resumed from the
    step-2 checkpoint gives the same losses and final parameters bit for
    bit; checkpoints apply to the base stage only."""
    from repro_torch.checkpoint import load_pytree
    kw = dict(method="diloco", steps={"base": 4, "mid": 2, "sft": 2},
              workers=2, per_worker_batch=2, seq_len=16,
              eval_after_each_stage=False, device="cpu", prefetch=2)
    ck = str(tmp_path / "ckpt")
    a = train.run_pipeline(out_dir=str(tmp_path / "a"), checkpoint_dir=ck,
                           checkpoint_every=2, **kw)
    assert [s for s, _ in list_run_checkpoints(ck)] == [2, 4]
    os.remove(list_run_checkpoints(ck)[1][1])
    b = train.run_pipeline(out_dir=str(tmp_path / "b"), checkpoint_dir=ck,
                           resume=True, **kw)
    for stage in ("base", "mid", "sft"):
        assert a["stages"][stage]["losses"] == b["stages"][stage]["losses"]
    pa = load_pytree(str(tmp_path / "a" / "diloco_final"))
    pb = load_pytree(str(tmp_path / "b" / "diloco_final"))
    assert set(pa) == set(pb)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def test_train_cli_takes_prefetch_and_checkpoint_flags(monkeypatch):
    """--prefetch, --checkpoint-dir, --checkpoint-every and --resume reach
    run_pipeline (defaults 0, None, 0, False)."""
    seen = []
    monkeypatch.setattr(train, "run_pipeline", lambda **kw: seen.append(kw))
    train.main(["--device", "cpu", "--steps", "2"])
    train.main(["--device", "cpu", "--steps", "2", "--prefetch", "3",
                "--checkpoint-dir", "ck", "--checkpoint-every", "5",
                "--resume"])
    keys = ("prefetch", "checkpoint_dir", "checkpoint_every", "resume")
    assert [tuple(kw[k] for k in keys) for kw in seen] == [
        (0, None, 0, False), (3, "ck", 5, True)]
