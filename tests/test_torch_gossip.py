"""Gossip and async gossip in the port against the JAX package, on the CPU.

Against the reference: ``gossip_peers`` (K 2–9, rounds 0–20, both peer
topologies, three seeds), ``payload_schedule`` and ``gossip_rounds`` of
both strategies on the f32, int8 and fp8 wires, and ``run_stage`` of
gossip (ring int8 K 4, random f32 K 4, ring K 3 with one solo worker a
round) and of async gossip (jitter 1, bound 2, int8, K 4), each against
the JAX ``run_stage`` at ``test_run_stage_matches_jax``'s tolerance.
Inside the port, bit for bit, as the reference pins inside itself: gossip
at K 2 == DiLoCo, the full topology == DiLoCo at K 4, async gossip with
jitter 0 and bound 0 == gossip, chunked == per-step, resume ==
uninterrupted for both runners, a worker that is not due keeps its bits;
the raw pair math at K 2 within 1e-5 of DiLoCo; the wire bytes counted per
round against the schedule.  Sizes are ``tests/helpers.py``'s tiny dense
config, all in float32; batches are made with numpy."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core.sync import AsyncGossipSync as JaxAsyncGossipSync
from repro.core.sync import GossipSync as JaxGossipSync
from repro.core.sync import gossip_peers as jax_gossip_peers
from repro.data.pipeline import PackedDataset as JaxPackedDataset
from repro.launch.train import run_stage as jax_run_stage
from repro.models import build_model
from repro.models.transformer import init_params as jax_init
from repro_torch.checkpoint import params_to_numpy
from repro_torch.checkpoint.checkpoint import _leaves
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.core import (AsyncGossipSync, DiLoCoSync, DistTrainer,
                              GossipSync, gossip_peers, make_strategy,
                              transport)
from repro_torch.core import sync as port_sync
from repro_torch.data import PackedDataset
from repro_torch.launch import train
from repro_torch.models import lm_loss
from repro_torch.models.transformer import flatten
from torch_parity import jax_flat, port_cfg, port_params

torch.set_num_threads(1)

CFG = tiny_cfg("dense")
PCFG = port_cfg(CFG)
OPT = dict(total_steps=12, warmup_steps=2, schedule="wsd",
           learning_rate=0.02, adam_lr=1e-3)
# wire codec -> its widest code step in units of amax (int8 1/127; fp8
# the spacing of the top binade over QMAX)
CODE_STEP = {"int8": 1 / 127, "fp8": 32 / 448, "fp8_e5m2": 8192 / 57344}


@pytest.fixture(scope="module")
def jparams():
    return jax_init(CFG, jax.random.key(0))[0]


@pytest.fixture
def params(jparams):
    return lambda: port_params(CFG, jparams)


def _datasets(seq_len=16, n=4000):
    tokens = np.random.default_rng(5).integers(0, 97, n).astype(np.int32)
    return (JaxPackedDataset(tokens, seq_len),
            PackedDataset(tokens.copy(), seq_len))


# ---------------------------------------------------------------------------
# Schedules against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topology", ["ring", "random"])
def test_gossip_peers_match_the_reference(topology):
    for seed in (0, 5, 123):
        for k in range(2, 10):
            for r in range(21):
                peers = gossip_peers(k, r, topology, seed)
                assert peers == jax_gossip_peers(k, r, topology, seed)
                assert all(peers[peers[i]] == i for i in range(k))
    assert gossip_peers(8, 0, "full") is None
    with pytest.raises(ValueError, match="topology"):
        gossip_peers(8, 0, "torus")


def _strategies(port: bool):
    g, a = (GossipSync, AsyncGossipSync) if port else (JaxGossipSync,
                                                       JaxAsyncGossipSync)
    return {"ring": g(), "random": g(topology="random", seed=3),
            "full": g(topology="full"),
            "async": a(jitter=2, staleness_bound=1, seed=7),
            "async_random": a(topology="random", jitter=1,
                              staleness_bound=0, seed=2)}


@pytest.mark.parametrize("codec", ["float32", "int8", "fp8"])
@pytest.mark.parametrize("name", list(_strategies(True)))
def test_schedules_match_the_reference(codec, name):
    port, ref = _strategies(True)[name], _strategies(False)[name]
    for k in (3, 4, 8):
        cfg = DiLoCoConfig(num_workers=k, h_inner_steps=4, delta_dtype=codec)
        jcfg = JaxDiLoCoConfig(num_workers=k, h_inner_steps=4,
                               delta_dtype=codec)
        got = port.payload_schedule(123_457, 26, cfg)
        want = ref.payload_schedule(123_457, 26, jcfg)
        assert got and ([dataclasses.astuple(e) for e in got]
                        == [dataclasses.astuple(e) for e in want])
        got = port.gossip_rounds(123_457, 26, cfg)
        want = ref.gossip_rounds(123_457, 26, jcfg)
        assert got and ([dataclasses.astuple(r) for r in got]
                        == [dataclasses.astuple(r) for r in want])


# ---------------------------------------------------------------------------
# run_stage against the reference
# ---------------------------------------------------------------------------

# (method, DiLoCoConfig fields, K, h, steps)
CASES = {
    "gossip-ring-int8-k4": ("gossip", dict(delta_dtype="int8"), 4, 2, 6),
    "gossip-random-f32-k4": ("gossip", dict(topology="random", sync_seed=3),
                             4, 2, 6),
    "gossip-ring-k3": ("gossip", dict(), 3, 2, 6),
    "async-jitter1-bound2-int8-k4": (
        "async_gossip", dict(delta_dtype="int8", h_jitter=1,
                             staleness_bound=2, sync_seed=1), 4, 2, 7),
}


def _record_quanta(monkeypatch):
    """Wrap the quantized codecs' encode to record, per leaf, the widest
    code step of the run: amax(|delta + residual|) times ``CODE_STEP``."""
    quanta = {}
    orig = transport.QuantizedCodec.encode

    def encode(self, delta, residual=None, **kw):
        for k, d in delta.items():
            e = d if residual is None else d + residual[k]
            q = float(e.abs().max()) * CODE_STEP[self.name]
            quanta[k] = max(quanta.get(k, 0.0), q)
        return orig(self, delta, residual, **kw)

    monkeypatch.setattr(transport.QuantizedCodec, "encode", encode)
    return quanta


@pytest.mark.parametrize("case", list(CASES))
def test_run_stage_matches_jax(jparams, monkeypatch, case):
    """The port's run_stage against the JAX run_stage (per-worker batch 2)
    from the same parameters on the same worker_batches: losses within
    rtol 1e-5, ``gossip_syncs`` and ``sync_steps`` exactly, final
    parameters within 2e-5 plus, where an inner-step difference moved a
    code across a rounding boundary, one quantum (the leaf's widest code
    step x outer_lr x (1 + mu)), as ``test_run_stage_matches_jax`` of
    the other strategies holds them."""
    method, dkw, k, h, steps = CASES[case]
    jds, ds = _datasets()
    kw = dict(steps=steps, workers=k, per_worker_batch=2, h=h, seed=0)
    jout, jhist = jax_run_stage(
        method, build_model(CFG), jparams, jds,
        opt_cfg=JaxOptimizerConfig(**OPT),
        diloco_cfg=JaxDiLoCoConfig(**dkw), **kw)
    quanta = _record_quanta(monkeypatch)
    dcfg = DiLoCoConfig(**dkw)
    out, hist = train.run_stage(
        method, PCFG, port_params(CFG, jparams), ds,
        opt_cfg=OptimizerConfig(**OPT), diloco_cfg=dcfg, **kw)
    assert hist["step"] == jhist["step"] == list(range(steps))
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    assert hist["gossip_syncs"] == [tuple(r) for r in jhist["gossip_syncs"]]
    assert hist["sync_steps"] == jhist["sync_steps"]
    assert hist["gossip_syncs"]
    eta, mu = dcfg.outer_lr, dcfg.outer_momentum
    got, want = params_to_numpy(out), jax_flat(jout)
    flipped = 0
    for name in want:
        err = np.abs(got[name] - want[name])
        over = err > 2e-5
        flipped += int(over.sum())
        np.testing.assert_array_less(
            err[over], 2e-5 + quanta.get(name, 0.0) * eta * (1 + mu),
            err_msg=name)
    print(f"{case}: {flipped} elements beyond 2e-5 (flipped codes)")


# ---------------------------------------------------------------------------
# The reference's invariants, inside the port
# ---------------------------------------------------------------------------

class _KeepRunner:
    """Hands out the runner ``DistTrainer.run`` binds, so the tests can
    read its anchors, momentum, residual and boards."""

    def __init__(self, strategy):
        self.strategy, self.runner = strategy, None

    def bind(self, engine, params):
        self.runner = self.strategy.bind(engine, params)
        return self.runner

    def __getattr__(self, name):
        return getattr(self.strategy, name)


def _run(params, dcfg, strategy, steps, chunked=True, **kw):
    _, ds = _datasets()
    keep = _KeepRunner(strategy)
    dt = DistTrainer(lambda p, b: lm_loss(p, b, PCFG),
                     OptimizerConfig(**OPT), dcfg, keep)
    state, hist = dt.run(
        dt.init(params()),
        lambda s: ds.worker_batches(s, dcfg.num_workers, 2), steps,
        chunked=chunked, **kw)
    return state, keep.runner, hist


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def _extras(runner):
    return runner.checkpoint_extras()[0]


@pytest.mark.parametrize("strategy", [
    GossipSync(), GossipSync(topology="random", seed=3), AsyncGossipSync()],
    ids=["gossip-ring", "gossip-random", "async"])
def test_k2_is_diloco_bit_for_bit(params, strategy):
    """With two workers the one pair IS the fleet: K 2 binds the DiLoCo
    runner, as in the reference, so the run is DiLoCo's bit for bit."""
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=4, delta_dtype="int8")
    sa, _, ha = _run(params, dcfg, DiLoCoSync(), 12)
    sb, rb, hb = _run(params, dcfg, strategy, 12)
    assert type(rb) is port_sync._DiLoCoRunner
    assert ha["sync_steps"] == hb["sync_steps"] == [3, 7, 11]
    assert ha["loss"] == hb["loss"]
    _assert_trees_equal(sa, sb)


def test_full_topology_is_diloco_at_k4(params):
    dcfg = DiLoCoConfig(num_workers=4, h_inner_steps=4)
    sa, _, ha = _run(params, dcfg, DiLoCoSync(), 8)
    sb, _, hb = _run(params, dcfg, GossipSync(topology="full"), 8)
    assert hb["sync_steps"] == [3, 7] and ha["loss"] == hb["loss"]
    _assert_trees_equal(sa, sb)


@pytest.mark.parametrize("steps", [12, 10], ids=["whole", "trailing"])
def test_async_jitter0_bound0_is_gossip_at_k4(params, steps):
    """Equal clocks and bound 0: every worker is co-due every H at
    staleness 0 and the apply runs gossip's pair function — the same
    state, runner extras, losses and records bit for bit, on the int8
    wire; a run ending mid-window flushes one trailing round in both."""
    dcfg = DiLoCoConfig(num_workers=4, h_inner_steps=4, delta_dtype="int8")
    sa, ra, ha = _run(params, dcfg, GossipSync(), steps)
    sb, rb, hb = _run(params, dcfg, AsyncGossipSync(), steps)
    assert type(ra) is port_sync._GossipRunner
    assert type(rb) is port_sync._AsyncGossipRunner and rb.fully_sync
    assert ha["sync_steps"] == hb["sync_steps"] == (
        [3, 7, 11] if steps == 12 else [3, 7, 9])
    assert ha["gossip_syncs"] == hb["gossip_syncs"]
    assert all(s == 0 for *_, s in hb["gossip_syncs"])
    assert ha["loss"] == hb["loss"]
    _assert_trees_equal(sa, sb)
    _assert_trees_equal(_extras(ra), _extras(rb))


def test_async_jittered_leaves_records_and_trains(params):
    dcfg = DiLoCoConfig(num_workers=4, h_inner_steps=4)
    _, _, hist = _run(params, dcfg, AsyncGossipSync(
        jitter=2, staleness_bound=3, seed=7), 13)
    assert np.isfinite(hist["loss"]).all()
    recs = hist["gossip_syncs"]
    assert any(s > 0 for *_, s in recs)
    for _, w, p, s in recs:
        assert 0 <= w < 4 and 0 <= p < 4 and (s == -1 or s >= 0)
    # finalize flushed the workers whose period does not divide 13
    assert {w for _, w, _, _ in recs} == set(range(4))


class _RawPairGossip(GossipSync):
    """Bypasses the K 2 delegation: always the pair runner."""

    def bind(self, engine, params):
        return port_sync._GossipRunner(
            engine, params, self.h or engine.cfg.h_inner_steps,
            self.topology, self.seed)


def test_raw_pair_math_at_k2_is_diloco_within_1e5(params):
    """The pair function itself at K 2 — pair-averaged anchors, momentum
    and deltas over two rows of one anchor — computes the DiLoCo mean
    (the 2-row mean and the pair mean round differently in the last
    bit), as the reference's ``test_raw_pair_math_matches_diloco_k2``
    holds its own."""
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=4)
    sa, _, _ = _run(params, dcfg, DiLoCoSync(), 8)
    sb, rb, _ = _run(params, dcfg, _RawPairGossip(), 8)
    assert type(rb) is port_sync._GossipRunner
    for k, v in sa.global_params.items():
        np.testing.assert_allclose(sb.global_params[k].numpy(), v.numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    for wa, wb in zip(sa.worker_params, sb.worker_params):
        for k in wa:
            np.testing.assert_allclose(wb[k].numpy(), wa[k].numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("strategy,dkw", [
    (GossipSync(topology="random", seed=1), dict(delta_dtype="int8")),
    (AsyncGossipSync(jitter=2, staleness_bound=2, seed=3),
     dict(delta_dtype="fp8"))], ids=["gossip", "async"])
def test_chunked_equals_per_step(params, strategy, dkw):
    dcfg = DiLoCoConfig(num_workers=4, h_inner_steps=3, **dkw)
    (sa, ra, ha), (sb, rb, hb) = [_run(params, dcfg, strategy, 8,
                                       chunked=c) for c in (True, False)]
    assert ha["loss"] == hb["loss"] and ha["gossip_syncs"]
    assert ha["gossip_syncs"] == hb["gossip_syncs"]
    assert ha["sync_steps"] == hb["sync_steps"]
    _assert_trees_equal(sa, sb)
    _assert_trees_equal(_extras(ra), _extras(rb))


@pytest.mark.parametrize("strategy,steps,start", [
    (GossipSync(), 9, 4),
    (AsyncGossipSync(jitter=2, staleness_bound=2, seed=7), 11, 4)],
    ids=["gossip", "async"])
def test_resume_equals_uninterrupted_bit_for_bit(params, tmp_path, strategy,
                                                 steps, start):
    """Checkpoints every 2 steps (gossip defers to its round boundaries),
    then a run resumed into fresh state from the one at ``start``: the
    state, the runner's anchors, momentum, residual and boards (in the
    reference's layout, (K, ...) per leaf), and the history equal the
    uninterrupted run's."""
    from repro_torch.checkpoint import list_run_checkpoints
    d = str(tmp_path)
    dcfg = DiLoCoConfig(num_workers=4, h_inner_steps=2, delta_dtype="int8")
    sa, ra, ha = _run(params, dcfg, strategy, steps, checkpoint_dir=d,
                      checkpoint_every=2)
    written = list_run_checkpoints(d)
    assert start in [s for s, _ in written]
    for s, man in written:
        if s > start:
            os.remove(man)
    sb, rb, hb = _run(params, dcfg, strategy, steps, checkpoint_dir=d,
                      resume=True)
    _assert_trees_equal(sa, sb)
    extras = _extras(ra)
    assert extras["anchors"]["embed/table"].shape[0] == 4
    _assert_trees_equal(extras, _extras(rb))
    for key in ("step", "loss", "sync_steps", "gossip_syncs"):
        assert hb[key] == ha[key], key


def test_a_worker_that_is_not_due_keeps_its_bits(params):
    """At every async apply where only some workers are due, the others'
    parameters, anchors, momentum, residual and publications keep their
    bits."""
    checked = []

    class Spy(AsyncGossipSync):
        def bind(self, engine, params):
            runner = super().bind(engine, params)
            orig = runner.after_step

            def after_step(state, step, loss):
                due = [w for w in range(4)
                       if (step + 1) % runner.periods[w] == 0]
                idle = [w for w in range(4) if due and w not in due]
                before = [_row(runner, state, w) for w in idle]
                state, recs = orig(state, step, loss)
                for w, b in zip(idle, before):
                    _assert_trees_equal(b, _row(runner, state, w))
                checked.extend(idle)
                return state, recs

            runner.after_step = after_step
            return runner

    def _row(runner, state, w):
        boards = {n: getattr(runner, n) for n in
                  ("anchors", "outer_v", "residual", "pub", "pub_anch",
                   "pub_v")}
        return {"params": {k: v.clone() for k, v in
                           state.worker_params[w].items()},
                **{n: {k: v[w].clone() for k, v in b.items()}
                   for n, b in boards.items()}}

    dcfg = DiLoCoConfig(num_workers=4, h_inner_steps=2, delta_dtype="int8")
    _run(params, dcfg, Spy(jitter=1, staleness_bound=1, seed=1), 9)
    assert checked


def _flat_sizes(params):
    flat = flatten(params())
    return sum(v.numel() for v in flat.values()), len(flat)


@pytest.mark.parametrize("codec", ["float32", "int8"])
def test_gossip_wire_bytes_per_round_are_the_schedule(params, codec):
    """Gossip at K 4 counts, per worker per round, one peer payload (the
    codes and, for int8, one 4-byte scale a leaf, which
    ``payload_schedule`` does not count) and the peer's f32 anchors and
    momentum: ``payload_schedule``'s bytes plus the scales."""
    n, n_leaves = _flat_sizes(params)
    dcfg = DiLoCoConfig(num_workers=4, h_inner_steps=2, delta_dtype=codec)
    transport.reset_shipped()
    _, _, hist = _run(params, dcfg, GossipSync(topology="random"), 6)
    rounds = len(hist["sync_steps"])
    sched = GossipSync(topology="random").payload_schedule(n, 6, dcfg)
    scales = 4 * n_leaves if codec == "int8" else 0
    name = transport.make_codec(codec).name
    width = transport.make_codec(codec).width
    assert rounds == len(sched) == 3
    want = {name: 4 * rounds * (width * n + scales)}
    want["f32"] = want.get("f32", 0) + 4 * rounds * 8 * n
    assert dict(transport.shipped) == want
    assert (sum(want.values()) / 4 / rounds
            == sched[0].bytes_per_worker + scales)


@pytest.mark.parametrize("k,strategy", [
    (3, GossipSync()), (4, AsyncGossipSync(jitter=1, staleness_bound=1))],
    ids=["gossip-k3", "async"])
def test_only_reads_that_cross_a_link_are_counted(params, k, strategy):
    """A self-paired worker (odd K) reads nothing; async gossip reads only
    the contributions it consumes (another worker's, staleness 0 to the
    bound): the count is the records' reads times one payload."""
    n, n_leaves = _flat_sizes(params)
    dcfg = DiLoCoConfig(num_workers=k, h_inner_steps=2, delta_dtype="int8")
    transport.reset_shipped()
    _, _, hist = _run(params, dcfg, strategy, 7)
    bound = getattr(strategy, "staleness_bound", 0)
    reads = sum(1 for _, w, p, s in hist["gossip_syncs"]
                if p != w and 0 <= s <= bound)
    assert 0 < reads < len(hist["gossip_syncs"])
    assert dict(transport.shipped) == {"int8": reads * (n + 4 * n_leaves),
                                       "f32": reads * 8 * n}


@pytest.mark.parametrize("strategy,match", [
    (GossipSync(topology="torus"), "topology"),
    (AsyncGossipSync(topology="full"), "full"),
    (AsyncGossipSync(jitter=-1), "jitter"),
    (AsyncGossipSync(staleness_bound=-1), "staleness_bound")])
def test_runners_reject_what_the_reference_rejects(params, strategy, match):
    with pytest.raises(ValueError, match=match):
        _run(params, DiLoCoConfig(num_workers=4, h_inner_steps=2), strategy,
             1)


def test_make_strategy_builds_the_gossip_strategies():
    g = make_strategy(DiLoCoConfig(strategy="gossip", topology="random",
                                   sync_seed=5))
    a = make_strategy(DiLoCoConfig(strategy="async_gossip", h_jitter=2,
                                   staleness_bound=3, sync_seed=1))
    assert g == GossipSync(topology="random", seed=5)
    assert a == AsyncGossipSync(jitter=2, staleness_bound=3, seed=1)
