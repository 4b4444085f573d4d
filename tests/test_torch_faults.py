"""The fault layer in the port against the JAX package, on the CPU.

Against the reference: the port's copy of ``core/faults.py`` (schedules
from specs, JSON both ways, seeded draws, chunk limits, a ``FleetTracker``
over a scripted walk, ``sim_timeline`` and ``retry_counts``); the masked
average, plain and drift-aware; the quorum outer step, the fragment
quorum step and the adoption step on the f32 and int8 wires (residual
included); the comm simulators' fault overlay and ``comm_report``.

Inside the port, bit for bit: an all-live mask is the unmasked average
and one dead row the survivors' mean; a non-contributor's residual row,
a dead row's parameters and optimizer state and an adopter's optimizer
state keep their bits, and a rejoiner's optimizer state is ``init`` of
its new parameters; an empty schedule and a one-attempt drop give the
fault-free run; a K 4 fleet with one worker dead from step 0 is the K 3
fleet of the others; kill -> resume is the uninterrupted run; a round
below ``min_quorum`` leaves the anchor at its init.  What the reference
rejects, the port rejects; the train CLI writes the fault records.
(``test_torch_faults_e2e.py`` holds whole faulted runs to the reference.)

Sizes are ``tests/helpers.py``'s tiny dense config, all in float32."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core import faults as jax_faults
from repro.core import outer_opt as jax_outer_opt
from repro.core.diloco import DiLoCoTrainer as JaxDiLoCoTrainer
from repro.core.streaming import StreamingDiLoCoTrainer as JaxStreaming
from repro.core.streaming import fragment_masks as jax_fragment_masks
from repro.core.sync import GossipSync as JaxGossipSync
from repro.launch import comm_sim as jax_comm_sim
from repro.launch.train import comm_report as jax_comm_report
from repro.models.transformer import init_params as jax_init
from repro_torch.checkpoint import list_run_checkpoints
from repro_torch.checkpoint.checkpoint import _leaves
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.core import (AsyncGossipSync, DDPSync, DistTrainer,
                              FaultEvent, FaultSchedule, FleetTracker,
                              GossipSync, OverlappedSync, SimulatedCrash,
                              faults, make_strategy, outer_opt,
                              sync as port_sync)
from repro_torch.core.streaming import (StreamingDiLoCoTrainer,
                                        fragment_masks)
from repro_torch.launch import comm_sim, train
from repro_torch.models import lm_loss
from repro_torch.models.transformer import flatten
from repro_torch.optim import nanochat_optimizer
from torch_parity import jax_flat, port_cfg, port_params

torch.set_num_threads(1)

CFG = tiny_cfg("dense")
PCFG = port_cfg(CFG)
OPT = dict(total_steps=12, warmup_steps=2, schedule="wsd",
           learning_rate=0.02, adam_lr=1e-3)

SPECS = ["crash:2@10,rejoin:2@20,slow:1@5x1.5,drop:3@9x2,kill@30",
         "slow:3@1x1.5,crash:2@2,drop:1@3,corrupt:0@5x2,rejoin:2@6",
         "crash:0@3,rejoin:0@6,crash:1@4,drop:2@5,corrupt:3@5x3",
         "crash:1@0,rejoin:1@2,crash:1@7,rejoin:1@9,kill@11",
         "rejoin:2@1,crash:2@4,rejoin:2@4,drop:2@7", "kill@7", ""]


@pytest.fixture(scope="module")
def jparams():
    return jax_init(CFG, jax.random.key(0))[0]


@pytest.fixture
def params(jparams):
    return lambda: port_params(CFG, jparams)


# ---------------------------------------------------------------------------
# The copy of core/faults.py against the original
# ---------------------------------------------------------------------------

def _events(fs):
    return [dataclasses.astuple(e) for e in fs.events]


@pytest.mark.parametrize("spec", SPECS)
def test_schedule_copy_matches_the_reference(spec):
    ours, ref = FaultSchedule.from_spec(spec), \
        jax_faults.FaultSchedule.from_spec(spec)
    assert _events(ours) == _events(ref)
    assert ours.empty == ref.empty == (spec == "")
    assert ([dataclasses.astuple(e) for e in ours.worker_events()]
            == [dataclasses.astuple(e) for e in ref.worker_events()])
    for s in range(40):
        assert ours.chunk_limit(s) == ref.chunk_limit(s)
    for k in range(1, 6):
        outcome = []
        for fs in (ours, ref):
            try:
                fs.validate(k)
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e).split(" names")[1])
        assert outcome[0] == outcome[1]


def test_schedule_json_both_ways_and_bad_events(tmp_path):
    spec = SPECS[0]
    FaultSchedule.from_spec(spec).save(str(tmp_path / "port.json"))
    jax_faults.FaultSchedule.from_spec(spec).save(str(tmp_path / "ref.json"))
    assert ((tmp_path / "port.json").read_text()
            == (tmp_path / "ref.json").read_text())
    assert (_events(jax_faults.FaultSchedule.load(str(tmp_path / "port.json")))
            == _events(FaultSchedule.from_spec(str(tmp_path / "ref.json"))))
    for bad in (dict(step=1, kind="melt", worker=0),
                dict(step=-1, kind="crash", worker=0),
                dict(step=1, kind="crash"),
                dict(step=1, kind="slow", worker=0, factor=0.0),
                dict(step=1, kind="drop", worker=0, attempts=0)):
        with pytest.raises(ValueError) as ours:
            FaultEvent(**bad)
        with pytest.raises(ValueError) as ref:
            jax_faults.FaultEvent(**bad)
        assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("k,n,crashes,rejoin_after",
                         [(8, 48, 2, 10), (4, 12, 1, None), (3, 5, 4, 2),
                          (2, 2, 1, 1)])
def test_random_schedules_match_the_reference(k, n, crashes, rejoin_after):
    for seed in range(6):
        assert (_events(FaultSchedule.random(k, n, seed, crashes,
                                             rejoin_after))
                == _events(jax_faults.FaultSchedule.random(
                    k, n, seed, crashes, rejoin_after)))


def _round(info):
    return (info.contrib, info.adopt, info.reset, info.live, info.skip,
            info.retries, info.records)


@pytest.mark.parametrize("k,h,min_quorum", [(4, 2, 1), (4, 3, 3),
                                            (5, 1, 2)])
@pytest.mark.parametrize("spec", SPECS[:5])
def test_tracker_walk_matches_the_reference(spec, k, h, min_quorum):
    """Chunks of H steps split at the schedule's chunk limits, a round at
    every H boundary: every ``begin_chunk`` and ``round_masks`` output,
    the kills, the quorum log and the fleet state after each call; then
    ``catch_up`` to every step from fresh trackers."""
    ours = FleetTracker(FaultSchedule.from_spec(spec), k, min_quorum)
    ref = jax_faults.FleetTracker(jax_faults.FaultSchedule.from_spec(spec),
                                  k, min_quorum)
    step = 0
    while step < 24:
        assert ours.begin_chunk(step) == ref.begin_chunk(step)
        end = (step // h + 1) * h - 1
        lim = ref.chunk_limit(step)
        if lim is not None:
            end = min(end, max(lim, step))
        assert ours.chunk_limit(step) == lim
        assert ours.kill_at(end) == ref.kill_at(end)
        if (end + 1) % h == 0:
            assert _round(ours.round_masks(end)) == _round(
                ref.round_masks(end))
        assert (ours.live, ours.pending_rejoin, ours.all_live) == (
            ref.live, ref.pending_rejoin, ref.all_live)
        step = end + 1
    assert ours.quorum_log == ref.quorum_log
    for s in range(0, 24, 3):
        a = FleetTracker(FaultSchedule.from_spec(spec), k, min_quorum)
        b = jax_faults.FleetTracker(
            jax_faults.FaultSchedule.from_spec(spec), k, min_quorum)
        a.catch_up(s)
        b.catch_up(s)
        assert (a.live, a.pending_rejoin) == (b.live, b.pending_rejoin)


@pytest.mark.parametrize("spec", SPECS)
def test_sim_timeline_and_retry_counts_match_the_reference(spec):
    for k, n in ((4, 12), (5, 40)):
        ours, ref = FaultSchedule.from_spec(spec), \
            jax_faults.FaultSchedule.from_spec(spec)
        assert (faults.sim_timeline(ours, k, n)
                == jax_faults.sim_timeline(ref, k, n))
        assert faults.retry_counts(ours, n) == jax_faults.retry_counts(ref, n)


def test_tracker_rejects_what_the_reference_rejects():
    fs = FaultSchedule.from_spec("crash:4@1")
    with pytest.raises(ValueError, match="outside the fleet"):
        FleetTracker(fs, 4)
    for q in (0, 5):
        with pytest.raises(ValueError, match="min_quorum"):
            FleetTracker(FaultSchedule.from_spec("crash:1@1"), 4, q)


# ---------------------------------------------------------------------------
# The masked average
# ---------------------------------------------------------------------------

def _delta(seed=7, k=4):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((k, 8, 3)).astype(np.float32),
            "b": rng.standard_normal((k, 5)).astype(np.float32)}


MASKS = [(True, True, True, True), (True, True, True, False),
         (False, True, False, True), (True, False, False, False),
         (False, False, False, False)]


# (drift-aware, mask); no drift-aware case without a contributor: such a
# round is always skipped (min_quorum >= 1), and the reference's softmax
# over K -inf logits is NaN there
AVERAGE_CASES = [(drift, m) for drift in (False, True) for m in MASKS
                 if any(m) or not drift]


@pytest.mark.parametrize("drift_aware,live", AVERAGE_CASES, ids=[
    ("drift-" if d else "plain-") + "".join("1" if x else "0" for x in m)
    for d, m in AVERAGE_CASES])
def test_masked_average_matches_the_reference(drift_aware, live):
    d = _delta()
    want = jax_outer_opt._average(
        {n: jnp.asarray(v) for n, v in d.items()},
        JaxDiLoCoConfig(drift_aware=drift_aware), live=jnp.asarray(live))
    got = outer_opt._average({n: torch.from_numpy(v) for n, v in d.items()},
                             DiLoCoConfig(drift_aware=drift_aware),
                             live=live)
    for n in d:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   atol=1e-6, rtol=0, err_msg=n)


@pytest.mark.parametrize("drift_aware", [False, True])
def test_masked_average_all_live_and_one_dead_bit_for_bit(drift_aware):
    """All-live == unmasked, and one row dead == the same average of the
    three survivors, bit for bit: the port divides by the count (the
    reference multiplies by its reciprocal, so 1/3 rounds there)."""
    d = {n: torch.from_numpy(v) for n, v in _delta().items()}
    cfg = DiLoCoConfig(drift_aware=drift_aware)
    plain = outer_opt._average(d, cfg)
    masked = outer_opt._average(d, cfg, live=(True,) * 4)
    for live, rows in (((True, True, False, True), [0, 1, 3]),
                       ((True, True, True, False), [0, 1, 2])):
        dead = outer_opt._average(d, cfg, live=live)
        surv = outer_opt._average({n: v[rows] for n, v in d.items()}, cfg)
        for n in d:
            assert torch.equal(masked[n], plain[n])
            assert torch.equal(dead[n], surv[n])


# ---------------------------------------------------------------------------
# The quorum outer steps against the reference
# ---------------------------------------------------------------------------

def _jax_like(tree, flat):
    return jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(flat["/".join(str(q.key) for q in p)]),
        tree)


def _states(jparams, codec, k=4, seed=11):
    """A K 4 state after some imagined inner steps (workers = params +
    seeded noise, seeded momentum and residual) in both packages, and
    nonzero optimizer states in the port (so a reset shows)."""
    rng = np.random.default_rng(seed)
    flat = jax_flat(jparams)
    noise = {n: np.asarray(rng.standard_normal((k,) + v.shape) * 3e-3,
                           np.float32) for n, v in flat.items()}
    mom = {n: np.asarray(rng.standard_normal(v.shape) * 1e-3, np.float32)
           for n, v in flat.items()}
    res = {n: np.asarray(rng.standard_normal((k,) + v.shape) * 1e-5,
                         np.float32) for n, v in flat.items()}
    jcfg = JaxDiLoCoConfig(num_workers=k, delta_dtype=codec)
    jt = JaxStreaming(None, JaxOptimizerConfig(total_steps=4,
                                               warmup_steps=1), jcfg,
                      replicate_fn=lambda t: t)
    js = jt.init(jparams)
    js = js._replace(
        worker_params=_jax_like(jparams, {n: flat[n][None] + noise[n]
                                          for n in flat}),
        outer=js.outer._replace(v=_jax_like(jparams, mom)))
    pt = StreamingDiLoCoTrainer(None, OptimizerConfig(total_steps=4,
                                                      warmup_steps=1),
                                DiLoCoConfig(num_workers=k,
                                             delta_dtype=codec))
    ps = pt.init(port_params(CFG, jparams))
    with torch.no_grad():
        for i, w in enumerate(ps.worker_params):
            for n, t in w.items():
                t.copy_(torch.from_numpy(flat[n] + noise[n][i]))
        for n, t in ps.outer.v.items():
            t.copy_(torch.from_numpy(mom[n]))
        for _, t in _leaves(ps.inner_opt):
            t.copy_(torch.from_numpy(np.asarray(
                rng.standard_normal(t.shape) * 1e-2, np.float32)))
    jres = _jax_like(jparams, res) if codec != "float32" else None
    pres = ({n: torch.from_numpy(v.copy()) for n, v in res.items()}
            if codec != "float32" else None)
    return jt, js, jres, pt, ps, pres


def _close(js, jres, ps, pres, atol=1e-6):
    for name, want, got in (("anchor", jax_flat(js.global_params),
                             ps.global_params),
                            ("momentum", jax_flat(js.outer.v), ps.outer.v)):
        for n in want:
            np.testing.assert_allclose(got[n].numpy(), want[n], atol=atol,
                                       rtol=0, err_msg=f"{name} {n}")
    jw = jax_flat(js.worker_params)
    for i, w in enumerate(ps.worker_params):
        for n in jw:
            np.testing.assert_allclose(w[n].numpy(), jw[n][i], atol=atol,
                                       rtol=0, err_msg=f"worker {i} {n}")
    if pres is not None:
        for n, v in jax_flat(jres).items():
            np.testing.assert_allclose(pres[n].numpy(), v, atol=atol,
                                       rtol=0, err_msg=f"residual {n}")
    assert int(ps.outer.t) == int(js.outer.t)


def _snap(ps, pres):
    return ([{n: t.clone() for n, t in w.items()} for w in ps.worker_params],
            [[t.clone() for _, t in _leaves(o)] for o in ps.inner_opt],
            None if pres is None else {n: t.clone()
                                       for n, t in pres.items()})


def _pin_rows(pt, ps, pres, before, contrib, adopt, reset):
    """In the port, bit for bit: a non-contributor's residual row keeps
    its bits (a rejoiner's is zero); a dead row's parameters and optimizer
    state keep theirs; an adopter keeps its optimizer state; a rejoiner's
    optimizer state is ``init`` of its new parameters."""
    wp0, opt0, res0 = before
    init = nanochat_optimizer(pt.opt_cfg).init
    for i in range(len(contrib)):
        leaves = [t for _, t in _leaves(ps.inner_opt[i])]
        if reset[i]:
            want = [t for _, t in _leaves(init(ps.worker_params[i]))]
            assert all(torch.equal(a, b) for a, b in zip(leaves, want))
        else:
            assert all(torch.equal(a, b) for a, b in zip(leaves, opt0[i]))
        if not (adopt[i] or reset[i]):
            assert all(torch.equal(ps.worker_params[i][n], wp0[i][n])
                       for n in wp0[i])
        if pres is not None and not contrib[i]:
            for n, t in pres.items():
                assert torch.equal(t[i], torch.zeros_like(t[i]) if reset[i]
                                   else res0[n][i])


# (contrib, adopt, reset): worker 2's payload lost, worker 3 rejoining;
# worker 3 dead; every row live
QUORUM_MASKS = {
    "lost-rejoin": ((1, 1, 0, 0), (1, 1, 1, 0), (0, 0, 0, 1)),
    "dead": ((1, 1, 1, 0), (1, 1, 1, 0), (0, 0, 0, 0)),
    "all-live": ((1, 1, 1, 1), (1, 1, 1, 1), (0, 0, 0, 0)),
}


@pytest.mark.parametrize("codec", ["float32", "int8"])
@pytest.mark.parametrize("masks", list(QUORUM_MASKS))
def test_outer_step_quorum_matches_the_reference(jparams, codec, masks):
    contrib, adopt, reset = (tuple(bool(x) for x in m)
                             for m in QUORUM_MASKS[masks])
    jt, js, jres, pt, ps, pres = _states(jparams, codec)
    before = _snap(ps, pres)
    js, jres = jax.jit(jt.outer_step_quorum)(
        js, jres, jnp.asarray(contrib), jnp.asarray(adopt),
        jnp.asarray(reset))
    ps, pres = pt.outer_step_quorum(ps, pres, contrib, adopt, reset)
    _close(js, jres, ps, pres)
    _pin_rows(pt, ps, pres, before, contrib, adopt, reset)


@pytest.mark.parametrize("codec", ["float32", "int8"])
def test_fragment_quorum_and_adopt_anchor_match_the_reference(jparams,
                                                              codec):
    """The fragment quorum step (rejoiners take the WHOLE anchor), then
    the adoption step of a skipped round, from the same state."""
    contrib, adopt, reset = (tuple(bool(x) for x in m)
                             for m in QUORUM_MASKS["lost-rejoin"])
    jt, js, jres, pt, ps, pres = _states(jparams, codec)
    before = _snap(ps, pres)
    js, jres = jax.jit(jt.outer_step_fragment_quorum)(
        js, jax_fragment_masks(jparams, 2)[1], jres, jnp.asarray(contrib),
        jnp.asarray(adopt), jnp.asarray(reset))
    ps, pres = pt.outer_step_fragment_quorum(
        ps, fragment_masks(ps.global_params, 2)[1], pres, contrib, adopt,
        reset)
    _close(js, jres, ps, pres)
    _pin_rows(pt, ps, pres, before, contrib, adopt, reset)
    again = (False, True, False, False)
    before = _snap(ps, pres)
    js, jres = jax.jit(jt.adopt_anchor)(js, jres, jnp.asarray(again))
    ps, pres = pt.adopt_anchor(ps, pres, again)
    _close(js, jres, ps, pres)
    _pin_rows(pt, ps, pres, before, (False,) * 4, (True, False, True, True),
              again)


# ---------------------------------------------------------------------------
# Whole runs inside the port, bit for bit
# ---------------------------------------------------------------------------

def _data(k, b=2, s=16, shift=0):
    def data(step):
        toks = np.random.default_rng(1000 + step).integers(
            0, 97, (4, b, s)).astype(np.int32)[shift:shift + k]
        return {"tokens": toks, "labels": (toks + 1) % 97}
    return data


class _Keep:
    """A strategy that hands out its runner (its residual and anchors)."""

    def __init__(self, strategy):
        self.strategy, self.runner = strategy, None

    def bind(self, engine, params):
        self.runner = self.strategy.bind(engine, params)
        return self.runner

    def __getattr__(self, name):
        return getattr(self.strategy, name)


def _run(params, dcfg, steps, strategy=None, **kw):
    keep = _Keep(strategy or make_strategy(dcfg))
    dt = DistTrainer(lambda p, b: lm_loss(p, b, PCFG),
                     OptimizerConfig(**OPT), dcfg, keep)
    state, hist = dt.run(dt.init(params()), _data(dcfg.num_workers), steps,
                         **kw)
    return state, hist, keep.runner


def _extras(runner):
    return {n: v for n, v in vars(runner).items()
            if n in ("residual", "anchors", "outer_v") and v is not None}


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def _same_runs(a, b):
    _same(a[0], b[0])
    _same(_extras(a[2]), _extras(b[2]))
    assert a[1]["loss"] == b[1]["loss"]
    for key in ("sync_steps", "frag_syncs", "gossip_syncs"):
        assert a[1].get(key) == b[1].get(key), key


# (strategy, DiLoCoConfig fields, K)
INVARIANT_CASES = {
    "diloco-int8": (dict(strategy="diloco", delta_dtype="int8"), 2),
    "gossip-ring-int8": (dict(strategy="gossip", delta_dtype="int8"), 4),
    "pipelined-f2-delay1-int8": (dict(strategy="pipelined",
                                      delta_dtype="int8", num_fragments=2,
                                      sync_delay=1), 2),
}


@pytest.mark.parametrize("case", list(INVARIANT_CASES))
def test_empty_schedule_and_one_attempt_drop_give_the_fault_free_run(
        params, case):
    """An empty schedule never builds the tracker; a drop the retry
    survives (one attempt) runs the quorum round with every mask true,
    which picks the same rows into the same expressions as the unmasked
    round: so both are the fault-free run bit for bit.  The reference
    pins only allclose for the drop, since its quorum round is a separately
    compiled program whose fusion may round otherwise."""
    dkw, k = INVARIANT_CASES[case]
    dcfg = DiLoCoConfig(num_workers=k, h_inner_steps=2, **dkw)
    base = _run(params, dcfg, 6)
    _same_runs(base, _run(params, dcfg, 6, faults=FaultSchedule()))
    dropped = _run(params, dcfg, 6, faults=FaultSchedule.from_spec(
        "drop:1@3"))
    _same_runs(base, dropped)
    assert (3, "drop_retry", 1) in dropped[1]["fault"]
    assert all(n == k for _, n in dropped[1]["quorum"])


@pytest.mark.parametrize("codec", ["float32", "int8"])
def test_one_dead_worker_is_the_survivors_fleet(params, codec):
    """K 4 with worker 3 dead from step 0 against K 3 on workers 0-2's
    data: the same losses, anchor, momentum and live rows bit for bit
    (the dead row never ships, so on a lossy wire the survivors' codes,
    scales and residuals are the K 3 fleet's too)."""
    d4 = DiLoCoConfig(num_workers=4, h_inner_steps=2, delta_dtype=codec)
    d3 = dataclasses.replace(d4, num_workers=3)
    keep4, keep3 = _Keep(make_strategy(d4)), _Keep(make_strategy(d3))
    runs = []
    for dcfg, keep, kw in ((d4, keep4, dict(faults=FaultSchedule.from_spec(
            "crash:3@0"))), (d3, keep3, {})):
        dt = DistTrainer(lambda p, b: lm_loss(p, b, PCFG),
                         OptimizerConfig(**OPT), dcfg, keep)
        runs.append(dt.run(dt.init(params()), _data(dcfg.num_workers), 6,
                           **kw))
    (s4, h4), (s3, h3) = runs
    assert h4["loss"] == h3["loss"]
    assert h4["quorum"] == [(1, 3), (3, 3), (5, 3)]
    _same(s4.global_params, s3.global_params)
    _same(s4.outer.v, s3.outer.v)
    _same(s4.worker_params[:3], s3.worker_params)
    _same(s4.inner_opt[:3], s3.inner_opt)
    _same(s4.worker_params[3], params())
    if codec != "float32":
        _same({n: r[:3] for n, r in keep4.runner.residual.items()},
              keep3.runner.residual)
        assert all(not r[3].any() for r in keep4.runner.residual.values())


# (DiLoCoConfig fields, K, schedule besides the kill)
RESUME_CASES = {
    "ddp": (dict(strategy="ddp", outer_lr=1.0, outer_momentum=0.0,
                 nesterov=False, h_inner_steps=1), 1, ""),
    "diloco-int8": (dict(strategy="diloco", delta_dtype="int8"), 2, ""),
    "pipelined-f2-delay1-int8-crash-rejoin": (
        dict(strategy="pipelined", delta_dtype="int8", num_fragments=2,
             sync_delay=1), 4, "crash:1@2,rejoin:1@8"),
    "gossip-ring-int8-crash-rejoin": (
        dict(strategy="gossip", delta_dtype="int8"), 4,
        "crash:2@1,rejoin:2@8,drop:0@5x2"),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_kill_then_resume_is_the_uninterrupted_run(params, tmp_path, case):
    """``kill@7`` with a checkpoint every 4 steps raises SimulatedCrash
    after step 7's checkpoint; ``resume`` continues from it (the tracker
    caught up) into the uninterrupted faulted run, bit for bit: state,
    runner extras, losses and every record."""
    dkw, k, spec = RESUME_CASES[case]
    dcfg = DiLoCoConfig(num_workers=k, **{"h_inner_steps": 2, **dkw})
    fs = FaultSchedule.from_spec(spec)
    base = _run(params, dcfg, 12, faults=fs)
    d = str(tmp_path / "ckpt")
    killed = FaultSchedule.from_spec(",".join(x for x in (spec, "kill@7")
                                              if x))
    with pytest.raises(SimulatedCrash, match="after step 7"):
        _run(params, dcfg, 12, faults=killed, checkpoint_dir=d,
             checkpoint_every=4)
    assert list_run_checkpoints(d)
    resumed = _run(params, dcfg, 12, faults=fs, checkpoint_dir=d,
                   checkpoint_every=4, resume=True)
    _same_runs(base, resumed)
    for key in ("fault", "quorum", "quorum_skip", "rejoin_drift"):
        assert base[1].get(key) == resumed[1].get(key), key


@pytest.mark.parametrize("strategy,k", [("diloco", 2), ("gossip", 4)])
def test_min_quorum_skip_leaves_the_anchor_at_init(params, strategy, k):
    """``min_quorum`` K with worker 1 down from step 0: every round is
    skipped and the anchor keeps its init bits; a rejoin at step 2 adopts
    at the skipped round 3 (the DiLoCo runner takes K 2: the anchor itself,
    bit for bit; gossip at K 4: the veterans' anchor mean, a mean of three
    equal rows, which rounds within an ulp of them) and round 5 syncs the
    whole fleet."""
    dcfg = DiLoCoConfig(num_workers=k, h_inner_steps=2, strategy=strategy)
    init = flatten(params())
    state, hist, _ = _run(params, dcfg, 6, min_quorum=k,
                          faults=FaultSchedule.from_spec("crash:1@0"))
    assert hist["sync_steps"] == [] and hist["quorum_skip"] == [1, 3, 5]
    _same(state.global_params, init)
    fs = FaultSchedule.from_spec("crash:1@0,rejoin:1@2")
    state, hist, _ = _run(params, dcfg, 4, min_quorum=k, faults=fs)
    assert hist["sync_steps"] == [] and hist["quorum_skip"] == [1, 3]
    assert [r[:2] for r in hist["rejoin_drift"]] == [(3, 1)]
    if strategy == "diloco":
        _same(state.global_params, init)
        _same(state.worker_params[1], init)
    for got in (state.global_params, state.worker_params[1]):
        for n, t in init.items():
            torch.testing.assert_close(got[n], t, rtol=2 ** -23, atol=0)
    state, hist, _ = _run(params, dcfg, 6, min_quorum=k, faults=fs)
    assert hist["sync_steps"] == [5] and hist["quorum_skip"] == [1, 3]


# ---------------------------------------------------------------------------
# What the reference rejects
# ---------------------------------------------------------------------------

REJECTIONS = {
    "ddp": (DiLoCoConfig(num_workers=1, strategy="ddp"), None,
            "crash:0@1", dict(), "does not support per-worker fault"),
    "overlapped": (DiLoCoConfig(num_workers=2, h_inner_steps=2),
                   OverlappedSync(delay=1), "crash:1@1", dict(),
                   "does not support per-worker fault"),
    "async_gossip": (DiLoCoConfig(num_workers=4, h_inner_steps=2),
                     AsyncGossipSync(jitter=1), "drop:1@1", dict(),
                     "does not support per-worker fault"),
    "per_step_loop": (DiLoCoConfig(num_workers=2, h_inner_steps=2), None,
                      "kill@1", dict(chunked=False), "chunked loop"),
    "min_quorum_0": (DiLoCoConfig(num_workers=2, h_inner_steps=2), None,
                     "crash:1@1", dict(min_quorum=0), "min_quorum"),
    "min_quorum_above_k": (DiLoCoConfig(num_workers=2, h_inner_steps=2),
                           None, "crash:1@1", dict(min_quorum=3),
                           "min_quorum"),
    "worker_outside_the_fleet": (DiLoCoConfig(num_workers=2,
                                              h_inner_steps=2), None,
                                 "crash:2@1", dict(), "outside the fleet"),
}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_the_port_rejects_what_the_reference_rejects(params, case):
    """Per-worker events on DDP, overlapped and async gossip (their
    runners' ``bind_faults`` is the base class's, as in the reference),
    faults on the per-step loop, a ``min_quorum`` outside [1, K] and a
    worker outside the fleet: each a ``ValueError`` before any step."""
    dcfg, strategy, spec, kw, match = REJECTIONS[case]
    with pytest.raises(ValueError, match=match):
        _run(params, dcfg, 2, strategy, faults=FaultSchedule.from_spec(spec),
             **kw)


def test_runners_declare_fault_support_as_the_reference(params):
    """Which runners take a tracker: the reference's fault-aware set."""
    k4 = DiLoCoConfig(num_workers=4, h_inner_steps=2)
    for strategy, dcfg, want in (
            (DDPSync(), DiLoCoConfig(num_workers=1), False),
            (OverlappedSync(), k4, False),
            (AsyncGossipSync(jitter=1), k4, False),
            (GossipSync(), k4, True),
            (make_strategy(dataclasses.replace(k4, strategy="streaming")),
             k4, True),
            (make_strategy(dataclasses.replace(k4, strategy="pipelined")),
             k4, True),
            (make_strategy(k4), k4, True)):
        _, _, runner = _run(params, dcfg, 1, strategy)
        assert runner.supports_faults == want, strategy
        if not want:
            with pytest.raises(ValueError, match="fault-aware strategies"):
                runner.bind_faults(FleetTracker(FaultSchedule(),
                                                dcfg.num_workers))


# ---------------------------------------------------------------------------
# The comm simulator's fault overlay
# ---------------------------------------------------------------------------

LINK = dict(bandwidth=12.5e9, latency=1e-3)
TIMES = [0.02, 0.02, 0.03, 0.04]
N_PARAMS = 560_988_160
COMM_SPEC = "crash:1@40,rejoin:1@160,drop:2@99x2,slow:3@10x1.5,corrupt:0@199"


@pytest.mark.parametrize("spec", [COMM_SPEC, "drop:0@99", ""])
@pytest.mark.parametrize("method", ["diloco", "streaming", "gossip"])
def test_simulators_overlay_faults_as_the_reference(method, spec):
    from repro.core import make_strategy as jax_make_strategy
    cfg = DiLoCoConfig(num_workers=4, h_inner_steps=100, strategy=method,
                       delta_dtype="int8")
    jcfg = JaxDiLoCoConfig(num_workers=4, h_inner_steps=100,
                           strategy=method, delta_dtype="int8")
    port = make_strategy(cfg).payload_schedule(N_PARAMS, 300, cfg)
    ref = jax_make_strategy(jcfg).payload_schedule(N_PARAMS, 300, jcfg)
    ours_fs = FaultSchedule.from_spec(spec)
    ref_fs = jax_faults.FaultSchedule.from_spec(spec)
    for st in (0, 2):
        got = comm_sim.simulate_heterogeneous(
            port, 300, TIMES, comm_sim.CommModel(**LINK),
            staleness_steps=st, faults=ours_fs)
        want = jax_comm_sim.simulate_heterogeneous(
            ref, 300, TIMES, jax_comm_sim.CommModel(**LINK),
            staleness_steps=st, faults=ref_fs)
        assert got == want
        if not spec:
            assert got == comm_sim.simulate_heterogeneous(
                port, 300, TIMES, comm_sim.CommModel(**LINK),
                staleness_steps=st)
    if method == "gossip":
        rounds = GossipSync().gossip_rounds(N_PARAMS, 300, cfg)
        jrounds = JaxGossipSync().gossip_rounds(N_PARAMS, 300, jcfg)
        got = comm_sim.simulate_gossip(rounds, 300, TIMES,
                                       comm_sim.CommModel(**LINK),
                                       staleness_steps=1, faults=ours_fs)
        want = jax_comm_sim.simulate_gossip(
            jrounds, 300, TIMES, jax_comm_sim.CommModel(**LINK),
            staleness_steps=1, faults=ref_fs)
        assert got == want
        if not spec:
            assert got == comm_sim.simulate_gossip(
                rounds, 300, TIMES, comm_sim.CommModel(**LINK),
                staleness_steps=1)


@pytest.mark.parametrize("method", ["diloco", "gossip", "async_gossip"])
def test_comm_report_with_faults_matches_the_reference(monkeypatch, method):
    """``comm_report(faults=)`` against the reference's on the same link
    (the reference's default link is its TPU fleet's, so both are given
    the port's)."""
    link = comm_sim.CommModel(**LINK)
    monkeypatch.setattr(jax_comm_sim, "default_comm_model",
                        lambda: jax_comm_sim.CommModel(**LINK))
    kw = dict(h_jitter=1, staleness_bound=1) if method == "async_gossip" \
        else {}
    got = train.comm_report(DiLoCoConfig(num_workers=4, delta_dtype="int8",
                                         **kw), method, N_PARAMS, 300, 100,
                            0.02, (1.0, 1.0, 1.5, 2.0),
                            faults=FaultSchedule.from_spec(COMM_SPEC))
    want = jax_comm_report(JaxDiLoCoConfig(num_workers=4, delta_dtype="int8",
                                           **kw), method, N_PARAMS, 300,
                           100, 0.02, (1.0, 1.0, 1.5, 2.0),
                           faults=jax_faults.FaultSchedule.from_spec(
                               COMM_SPEC))
    for key in ("homogeneous", "heterogeneous", "gossip"):
        assert got.get(key) == want.get(key), key
    assert got["heterogeneous"]["retry_bytes"] > 0
    assert got["link_bytes_per_s"] == link.bandwidth


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_train_cli_runs_a_fault_schedule_on_cpu(tmp_path, capsys):
    """``--fault-schedule crash:1@2,rejoin:1@4 --min-quorum 1``: the base
    stage's entry holds the fault, quorum and rejoin-drift records (H 2:
    rounds at 1, 3, 5; worker 1 down for round 3, back at round 5)."""
    out = tmp_path / "run"
    train.main(["--method", "diloco", "--steps", "6", "--workers", "2",
                "--device", "cpu", "--fault-schedule", "crash:1@2,rejoin:1@4",
                "--min-quorum", "1", "--out-dir", str(out)])
    base = json.loads((out / "diloco_metrics.json").read_text())[
        "stages"]["base"]
    assert base["fault"] == [[2, "crash", 1], [4, "rejoin_pending", 1],
                             [5, "rejoin", 1]]
    assert base["quorum"] == [[1, 2], [3, 1], [5, 1]]
    assert [r[:2] for r in base["rejoin_drift"]] == [[5, 1]]
    assert "quorum_skip" not in base
    assert "[diloco:base]" in capsys.readouterr().out


def test_faults_bench_runs_at_a_few_steps(tmp_path, capsys):
    """``benchmarks/torch_faults_bench.py`` (the reference scenario cut to
    12 steps, H 2): the quorum shrinks 8 -> 7 -> 6 at the crashes and
    grows back after the rejoin, which is recorded once with its drift;
    the exit code follows the 2% bar."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "benchmarks" / \
        "torch_faults_bench.py"
    spec = importlib.util.spec_from_file_location("torch_faults_bench", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    rc = bench.main(["--device", "cpu", "--steps", "12", "--h", "2",
                     "--out", str(tmp_path / "faults.json")])
    sec = json.loads((tmp_path / "faults.json").read_text())
    assert rc == (0 if sec["within_2pct"] else 1)
    assert sec["schedule"] == "crash:2@3,crash:5@5,rejoin:2@7"
    assert [n for _, n in sec["quorum_per_round"]] == [8, 7, 6, 6, 7, 7]
    assert [r[:2] for r in sec["rejoin_drift"]] == [[7, 2]]
    assert all(np.isfinite(r[2:]).all() for r in sec["rejoin_drift"])
    out = capsys.readouterr().out
    assert "faults/nanochat-d20-tiny/degradation,0.0," in out
