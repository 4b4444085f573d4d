"""Whole faulted runs in the port against the JAX package, on the CPU: the
reference's ``test_faults.py`` scenarios (crash, rejoin, dropped and
corrupted payloads, slowdowns, a ``min_quorum`` skip with a rejoin
adopting at the skipped round, a ``corrupt x2`` count-out) through both
packages' ``run_stage`` for diloco, ddp_compressed, streaming, pipelined
and gossip, from the same parameters on the same ``worker_batches``.

The ``fault``, ``quorum``, ``quorum_skip``, ``sync_steps``,
``frag_syncs`` and ``gossip_syncs`` records and each rejoin record's
(step, worker) are equal; the losses and the final parameters are held
as ``test_torch_strategies.py`` holds that strategy (rtol 1e-5; 2e-5,
plus one quantum where an int8 code moved across a rounding boundary);
the rejoin drift's norm within rtol 1e-4 and its cosine within rtol 1e-4
or 1e-5 absolute (a cosine near 0, as a rejoiner's to a fleet that moved
one step a round, has no relative scale).

Sizes are ``tests/helpers.py``'s tiny dense config, all in float32."""
import jax
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core.faults import FaultSchedule as JaxFaultSchedule
from repro.data.pipeline import PackedDataset as JaxPackedDataset
from repro.launch.train import run_stage as jax_run_stage
from repro.models import build_model
from repro.models.transformer import init_params as jax_init
from repro_torch.checkpoint import params_to_numpy
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.core import FaultSchedule, transport
from repro_torch.data import PackedDataset
from repro_torch.launch import train
from torch_parity import jax_flat, port_cfg, port_params

torch.set_num_threads(1)

CFG = tiny_cfg("dense")
OPT = dict(total_steps=12, warmup_steps=2, schedule="wsd",
           learning_rate=0.02, adam_lr=1e-3)
CODE_STEP = {"int8": 1 / 127}

# (method, DiLoCoConfig fields, K, H, steps, schedule, min_quorum)
CASES = {
    "diloco-crash-rejoin-drop-slow": (
        "diloco", {}, 4, 3, 12,
        "slow:3@2x1.5,crash:2@4,drop:1@5,rejoin:2@10", 1),
    "diloco-min-quorum-skip": ("diloco", {}, 2, 3, 9, "crash:1@2", 2),
    "diloco-corrupt-x2-count-out": ("diloco", {}, 2, 4, 8,
                                    "corrupt:1@3x2", 1),
    "ddp-compressed-int8-crash-rejoin": (
        "ddp", dict(grad_compress="int8"), 4, 2, 5, "crash:1@1,rejoin:1@3",
        1),
    "streaming-f2-int8-crash-rejoin-drop": (
        "streaming", dict(num_fragments=2, delta_dtype="int8"), 4, 4, 12,
        "crash:1@3,rejoin:1@6,drop:0@5", 1),
    "pipelined-f2-delay1-crash-rejoin-corrupt-x2": (
        "pipelined", dict(num_fragments=2, sync_delay=1), 4, 2, 12,
        "crash:1@3,rejoin:1@6,corrupt:0@5x2", 1),
    "gossip-ring-crash-rejoin-drop-x2": (
        "gossip", {}, 4, 2, 12, "crash:1@3,rejoin:1@6,drop:0@5x2", 1),
    "gossip-random-min-quorum-skip-rejoin": (
        "gossip", dict(topology="random", sync_seed=3), 4, 2, 8,
        "crash:1@0,rejoin:1@2", 4),
}


@pytest.fixture(scope="module")
def jparams():
    return jax_init(CFG, jax.random.key(0))[0]


def _record_quanta(monkeypatch):
    """Per leaf, the widest int8 code step of the run."""
    quanta = {}
    orig = transport.QuantizedCodec.encode

    def encode(self, delta, residual=None, **kw):
        for k, d in delta.items():
            e = d if residual is None else d + residual[k]
            if e.numel():
                q = float(e.abs().max()) * CODE_STEP[self.name]
                quanta[k] = max(quanta.get(k, 0.0), q)
        return orig(self, delta, residual, **kw)

    monkeypatch.setattr(transport.QuantizedCodec, "encode", encode)
    return quanta


def _tuples(v):
    return [tuple(x) if isinstance(x, (list, tuple)) else x for x in v]


@pytest.mark.parametrize("case", list(CASES))
def test_faulted_run_stage_matches_jax(jparams, monkeypatch, case):
    method, dkw, k, h, steps, spec, min_quorum = CASES[case]
    tokens = np.random.default_rng(5).integers(0, 97, 4000).astype(np.int32)
    jds, ds = JaxPackedDataset(tokens, 16), PackedDataset(tokens.copy(), 16)
    kw = dict(steps=steps, workers=k, per_worker_batch=2, h=h, seed=0,
              min_quorum=min_quorum)
    jout, jhist = jax_run_stage(
        method, build_model(CFG), jparams, jds,
        opt_cfg=JaxOptimizerConfig(**OPT),
        diloco_cfg=JaxDiLoCoConfig(**dkw),
        faults=JaxFaultSchedule.from_spec(spec), **kw)
    quanta = _record_quanta(monkeypatch)
    dcfg = DiLoCoConfig(**dkw)
    out, hist = train.run_stage(
        method, port_cfg(CFG), port_params(CFG, jparams), ds,
        opt_cfg=OptimizerConfig(**OPT), diloco_cfg=dcfg,
        faults=FaultSchedule.from_spec(spec), **kw)
    for key in ("fault", "quorum", "quorum_skip", "sync_steps",
                "frag_syncs", "gossip_syncs"):
        assert hist.get(key) == _tuples(jhist[key]) if key in jhist \
            else key not in hist, key
    assert hist["quorum"]
    rejoin, jrejoin = hist.get("rejoin_drift", []), \
        jhist.get("rejoin_drift", [])
    assert [r[:2] for r in rejoin] == [tuple(r[:2]) for r in jrejoin]
    if rejoin:
        np.testing.assert_allclose([r[2] for r in rejoin],
                                   [r[2] for r in jrejoin], rtol=1e-4)
        np.testing.assert_allclose([r[3] for r in rejoin],
                                   [r[3] for r in jrejoin], rtol=1e-4,
                                   atol=1e-5)
    assert hist["step"] == jhist["step"] == list(range(steps))
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    eta, mu = ((1.0, 0.0) if method == "ddp" else
               (dcfg.outer_lr, dcfg.outer_momentum))
    got, want = params_to_numpy(out), jax_flat(jout)
    for name in want:
        err = np.abs(got[name] - want[name])
        over = err > 2e-5
        np.testing.assert_array_less(
            err[over], 2e-5 + quanta.get(name, 0.0) * eta * (1 + mu),
            err_msg=name)
