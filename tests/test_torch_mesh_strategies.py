"""Every strategy, AdaptiveH, the fault layer's quorum rounds, run
checkpoints and the hybrid pipeline across ``torch.distributed`` ranks
on the CPU (gloo, one DiLoCo worker a rank), held to the one-process
port bit for bit and to the JAX package within the tolerances its own
parity tests use.  The rank programs are ``tests/torch_mesh_ranks.py``
``strategies2`` (2 ranks: ``CASES2``, kill and resume, hybrid) and
``strategies4`` (4 ranks: ``CASES4``, gossip and the quorum rounds), each
spawned once; the one-process references run here.

* Each case's anchor, outer momentum, the rank's worker row, its rows of
  the runner's arrays (residual; gossip's anchors, momentum and boards),
  the step counters and every history record equal the one-process
  port's; the ranks' losses average to its loss, and an H schedule's or
  a checkpoint's ``fleet_loss`` is it.
* The inner steps log no collective; each rank's cross-pod bytes in the
  outer rounds are its ``shipped``, and the ranks' counts sum to the
  one-process count.  Gossip crosses by point-to-point sends, one peer
  row a round (the same bytes at K 4 as the formula gives at K 2); a
  down worker's rank sends nothing in a round.
* A 2-rank run killed and resumed equals the uninterrupted 2-rank run;
  the arrays of the 2-rank checkpoint are the one-process checkpoint's;
  a checkpoint resumes across world sizes both ways.
* Hybrid through ``run_pipeline(mesh=)``: the DiLoCo base stage bit for
  bit, the DDP stages (every rank one data index) within
  ``test_torch_multiproc.py``'s DDP tolerance of one process, and within
  ``test_torch_pipeline.py``'s tolerance of the JAX ``run_pipeline``.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from helpers import tiny_cfg
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core.faults import FaultSchedule as JaxFaultSchedule
from repro.data.pipeline import PackedDataset as JaxPackedDataset
from repro.launch import train as jax_train
from repro.launch.train import run_stage as jax_run_stage
from repro.models import build_model
from repro.models.transformer import init_params as jax_init
from repro_torch.checkpoint import load_pytree
from repro_torch.core import SimulatedCrash, transport
from repro_torch.core.sync import _gossip_payload_bytes
from repro_torch.launch import collectives as coll
from repro_torch.launch import train
from repro_torch.launch.mesh import PodReplicate, ProcessMesh, run_ranks
from repro_torch.models.transformer import flatten
from torch_parity import jax_flat, port_params

torch.set_num_threads(1)

JOIN_S = 240.0          # the whole spawn, every rank joined
CFG = tiny_cfg("dense")
# DDP across ranks against one process (test_torch_multiproc.py): the
# mean of half-batch gradient means against one mean
DDP_ATOL, DDP_RTOL = 1e-6, 1e-6


@pytest.fixture(scope="module")
def jparams():
    return jax_init(CFG, jax.random.key(0))[0]


@pytest.fixture(scope="module")
def params(jparams):
    return flatten(port_params(CFG, jparams))


@pytest.fixture(scope="module")
def hybrid_start():
    """The JAX launcher's tiny model and its initial parameters (seed 0),
    as ``test_torch_pipeline.py`` starts both pipelines."""
    vocab = train.build_pipeline(seq_len=ranks.HYBRID["seq_len"])[1]\
        .vocab_size
    jcfg, _ = jax_train.make_model("tiny", True, vocab)
    return jcfg, jax_init(jcfg, jax.random.key(0))[0]


def _spawn(fn, world, tmp):
    run_ranks(fn, world, str(tmp), timeout_s=JOIN_S)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
            for r in range(world)]


@pytest.fixture(scope="module")
def workdir(params, hybrid_start, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two")
    torch.save(params, tmp / "params.pt")
    jcfg, jp = hybrid_start
    torch.save(port_params(jcfg, jp), tmp / "hybrid_params.pt")
    # the one-process checkpoints the ranks resume from
    with pytest.raises(SimulatedCrash):
        ranks.run_case(ranks.KILL, params, checkpoint_dir=str(
            tmp / "one_ckpt"), checkpoint_every=2)
    return tmp


@pytest.fixture(scope="module")
def two(workdir):
    return _spawn(ranks.strategies2, 2, workdir)


@pytest.fixture(scope="module")
def four(params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four")
    torch.save(params, tmp / "params.pt")
    return _spawn(ranks.strategies4, 4, tmp)


_ONE = {}


def one(name, params):
    """The one-process port's run of a case (cached)."""
    if name not in _ONE:
        case = dict(ranks.CASES2, **ranks.CASES4).get(name)
        _ONE[name] = ranks.run_case(case, params)
    return _ONE[name]


def _equal(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


def _mean(losses):
    """The one-process loop's worker mean, in worker order, in float32."""
    acc = np.float32(losses[0])
    for x in losses[1:]:
        acc = acc + np.float32(x)
    return float(acc / np.float32(len(losses)))


def _assert_rank_is_one_process(got, want, rank):
    _equal(got["global"], want["global"], "global")
    _equal(got["v"], want["v"], "outer momentum")
    assert len(got["workers"]) == 1
    _equal(got["workers"][0], want["workers"][rank], "worker row")
    assert (got["step"], got["t"]) == (want["step"], want["t"])
    assert set(got["runner"]) == set(want["runner"])
    for name, arr in want["runner"].items():
        _equal(got["runner"][name], {p: v[rank:rank + 1]
                                     for p, v in arr.items()}, name)
    hist, whist = got["hist"], want["hist"]
    for key in whist:
        if key != "loss":
            assert hist[key] == whist[key], key
    if "fleet_loss" in hist:
        assert hist["fleet_loss"] == whist["loss"]
    assert set(hist) - set(whist) <= {"fleet_loss"}
    assert hist["sync_steps"] or hist["frag_syncs"] or hist["gossip_syncs"]
    # no collective in the inner steps; the rounds' cross-pod bytes are
    # this rank's shipped
    assert got["stats"]["inner"]["count_by_kind"] == {}
    assert got["stats"]["outer"]["cross_pod_bytes_per_device"] == \
        sum(got["shipped"].values()) > 0


def _check_case(rank_outs, name, params):
    want = one(name, params)
    for r, x in enumerate(rank_outs):
        _assert_rank_is_one_process(x[name], want, r)
    # the ranks' own losses average to the one-process loss (a live
    # worker's; a down rank records NaN)
    losses = [x[name]["hist"]["loss"] for x in rank_outs]
    if not ranks_spec(name):
        assert [_mean(col) for col in zip(*losses)] == want["hist"]["loss"]
    for codec, b in want["shipped"].items():
        assert sum(x[name]["shipped"].get(codec, 0) for x in rank_outs) == b


def ranks_spec(name):
    return dict(ranks.CASES2, **ranks.CASES4)[name]["spec"]


@pytest.mark.parametrize("name", list(ranks.CASES2))
def test_two_ranks_equal_one_process_bit_for_bit(two, params, name):
    _check_case(two, name, params)


@pytest.mark.parametrize("name", list(ranks.CASES4))
def test_four_ranks_equal_one_process_bit_for_bit(four, params, name):
    _check_case(four, name, params)


def test_adaptive_h_decides_the_same_rounds_on_every_rank(two, params):
    """Under ``AdaptiveH`` every rank decides from the fleet's mean loss
    (one all-gather of the chunk's loss row, scope ``loss``): H 2 until
    the slope at step 7 is steep, then its floor of 10, past the end, so
    the last round is the trailing one; ``test_torch_pipeline.py``'s
    one-process schedule."""
    name = "diloco-adaptive-h"
    for x in two:
        got = x[name]
        assert got["hist"]["sync_steps"] == [1, 3, 5, 7, 15]
        loss = got["stats"]["loss"]
        assert loss["count_by_kind"] == {"all-gather": 5}
        assert loss["bytes_by_kind"]["all-gather"] == 4 * 16
    assert two[0][name]["hist"]["fleet_loss"] == \
        one(name, params)["hist"]["loss"]


def _sent(records):
    return sum(n for kind, _, n in records if kind != "recv")


def test_gossip_crosses_one_peer_row_a_round_point_to_point(four, params):
    """Gossip at K 4 (ring, int8): every round's records on every rank are
    sends and receives, never an all-gather; a rank sends one peer row a
    round (the codes, a scale a leaf, the f32 anchors and momentum) —
    the bytes the K 2 formula gives, flat in K — and exactly the round's
    ``shipped``."""
    n = sum(p.numel() for p in params.values())
    row = _gossip_payload_bytes(transport.make_codec("int8"), n) \
        + 4 * len(params)
    for x in four:
        rounds = x["gossip-ring-int8-k4"]["rounds"]
        assert [s for s, _, _ in rounds] == [1, 3, 5]
        for _, recs, shipped in rounds:
            assert {kind for kind, _, _ in recs} == {"send", "recv"}
            assert _sent(recs) == shipped == row
            assert sum(n for kind, _, n in recs if kind == "recv") == row


@pytest.mark.parametrize("name,rank,down_rounds", [
    ("diloco-quorum-int8", 1, [1]),
    ("streaming-quorum-int8", 1, [1]),
    ("gossip-ring-crash-rejoin-drop-x2", 1, [3, 5]),
    ("diloco-crash-rejoin-drop-slow", 2, [5, 8])])
def test_a_down_rank_sends_nothing_in_a_round(two, four, name, rank,
                                              down_rounds):
    """While its worker is down a rank still takes part in the round (it
    checks the masks; in the DiLoCo family it receives the contributors'
    rows) but sends no byte of the round's wire and ships nothing; the
    contributors send theirs only."""
    outs = two if name in ranks.CASES2 else four
    rounds = {s: (recs, shipped) for s, recs, shipped in
              outs[rank][name]["rounds"]}
    for s in down_rounds:
        recs, shipped = rounds[s]
        assert shipped == 0
        assert _sent([r for r in recs if r[1] == "outer"]) == 0
        assert any(scope == "quorum" for _, scope, _ in recs)
        assert any(kind == "recv" for kind, _, _ in recs) or \
            name.startswith("gossip")


def test_quorum_masks_are_checked_across_ranks(two):
    """Every quorum round all-gathers its masks (scope ``quorum``), and a
    disagreement raises rather than leaving the ranks waiting on
    different collectives."""
    x = two[0]["diloco-quorum-int8"]
    assert x["stats"]["quorum"]["count_by_kind"] == {"all-gather": 4}

    class Parted(PodReplicate):
        def fleet_rows(self, t):
            return torch.cat([t, 1 - t])

    mesh = ProcessMesh(pod=2, data=1, rank=0, backend="gloo",
                       device=torch.device("cpu"))
    with pytest.raises(RuntimeError, match="disagree"):
        Parted(mesh).agree([1, 0, 1], "a round")


def test_collective_log_counts_sends_not_receives():
    """``collective_stats`` sums a rank's sent bytes into the wire and
    cross-pod keys; what it received is in ``bytes_by_kind`` only."""
    coll.reset_log()
    with coll.scope("outer"):
        coll._log("send", "pod", 100, True, 0.0, 0.0)
        coll._log("recv", "pod", 100, True, 0.0, 0.0)
        coll._log("broadcast", "pod", 7, True, 0.0, 0.0)
    with coll.scope("consensus"):
        coll._log("recv", "pod", 50, True, 0.0, 0.0)
    s = coll.collective_stats("outer")
    assert s["bytes_by_kind"] == {"send": 100, "recv": 100, "broadcast": 7}
    assert s["count_by_kind"] == {"send": 1, "recv": 1, "broadcast": 1}
    assert s["wire_bytes_per_device"] == s["cross_pod_bytes_per_device"] \
        == 107
    assert coll.collective_stats("consensus")["wire_bytes_per_device"] == 0
    coll.reset_log()


def test_hybrid_ddp_stages_log_their_all_reduces_as_crossing_pods(two):
    """Hybrid's mid and SFT stages run DDP over every rank of a 2-pod
    mesh (``ProcessMesh.data_view``): their gradient all-reduces span
    both pods, so each is logged as cross-pod and its bytes count in
    ``cross_pod_bytes_per_device``."""
    for x in two:
        recs = x["hybrid_all_reduce"]
        assert recs and all(cross for _, cross, _ in recs)
        assert sum(b for _, _, b in recs) > 0


@pytest.mark.parametrize("pod,data,spans", [(2, 1, True), (2, 2, True),
                                              (1, 2, False)])
def test_a_data_view_of_several_pods_spans_them(pod, data, spans):
    """``data_view`` sees every rank as one data axis; it marks its data
    group as spanning pods only where the mesh had more than one, and a
    mesh's own data group never spans them."""
    mesh = ProcessMesh(pod=pod, data=data, rank=0, backend="gloo",
                       device=torch.device("cpu"))
    view = mesh.data_view()
    assert (view.pod, view.data, view.spans_pods) == (1, pod * data, spans)
    assert not mesh.spans_pods


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "fp8",
                                   "e5m2"])
def test_the_code_board_is_typed_as_the_codec_encodes(dtype):
    """Async gossip's wire board starts as zero rows shaped and typed as
    its codec's encoding of a stack of the parameters (codes, and scales
    for the quantized codecs): what a rank sends and receives."""
    from repro_torch.core.sync import _code_board
    from repro_torch.core.transport import make_codec
    codec = make_codec(dtype)
    params = {"w": torch.randn(3, 4), "b": torch.randn(5)}
    codes, scales = _code_board(codec, params, 2)
    payload, _ = codec.encode({k: torch.stack([p, -p])
                               for k, p in params.items()})
    for k in params:
        assert codes[k].dtype == payload.data[k].dtype
        assert codes[k].shape == payload.data[k].shape
        assert not codes[k].float().any()
        if payload.scales is None:
            assert scales is None
        else:
            assert scales[k].shape == payload.scales[k].shape
            assert scales[k].dtype == payload.scales[k].dtype


def test_float8_codes_round_trip_through_a_run_checkpoint(tmp_path):
    """A run checkpoint stores float8 leaves (an fp8 wire's codes on the
    async board) as their bits and restores them bit for bit."""
    from repro_torch.checkpoint import (latest_run_checkpoint,
                                        load_run_checkpoint,
                                        save_run_checkpoint)
    g = torch.Generator().manual_seed(0)
    codes = {n: (torch.randn(2, 3, 4, generator=g) * 8).to(dt)
             for n, dt in (("e4m3", torch.float8_e4m3fn),
                           ("e5m2", torch.float8_e5m2))}
    state = {"step": torch.tensor(3, dtype=torch.int32)}
    save_run_checkpoint(str(tmp_path), 3, state,
                        extras_arrays={"pub_q": codes})
    _, got = load_run_checkpoint(
        latest_run_checkpoint(str(tmp_path)),
        {"step": torch.tensor(0, dtype=torch.int32)},
        {"pub_q": {n: torch.zeros_like(c) for n, c in codes.items()}})
    for n, c in codes.items():
        assert got["pub_q"][n].dtype == c.dtype
        assert torch.equal(got["pub_q"][n].view(torch.uint8),
                           c.view(torch.uint8))


def _case_fields(x):
    return {k: x[k] for k in ("global", "v", "workers", "step", "t",
                              "runner")}


def test_kill_and_resume_across_ranks_equals_uninterrupted(two):
    """Killed after step 3 (the checkpoint at 4 written first, on every
    rank), resumed: the 2-rank run ends as the uninterrupted 2-rank run,
    its state, runner arrays and history (each rank's own losses, the
    fleet's) bit for bit."""
    for x in two:
        assert x["killed"]
        a, b = x["resumed"], x["uninterrupted"]
        for key, val in _case_fields(b).items():
            if isinstance(val, dict):
                for name in val:
                    got = a[key][name]
                    if isinstance(got, dict):
                        _equal(got, val[name], (key, name))
                    else:
                        assert torch.equal(got, val[name]), (key, name)
            elif isinstance(val, list):
                for g, w in zip(a[key], val):
                    _equal(g, w, key)
            else:
                assert a[key] == val, key
        assert a["hist"] == b["hist"]


def _arrays(path):
    return load_pytree(str(path))


def test_checkpoint_arrays_do_not_depend_on_the_world_size(two, workdir):
    """The 2-rank checkpoint at step 4 (rank 0 gathered every worker's
    rows) holds the one-process checkpoint's arrays, state and extras
    (the int8 residual), bit for bit; its manifest's history is the
    one-process history."""
    import json
    stem = f"ckpt_{ranks.KILL_STEP:08d}"
    for part in ("state", "extras"):
        got = _arrays(workdir / "ckpt2" / f"{stem}.{part}")
        want = _arrays(workdir / "one_ckpt" / f"{stem}.{part}")
        assert set(got) == set(want)
        for p in want:
            assert got[p].dtype == want[p].dtype and \
                np.array_equal(got[p], want[p]), (part, p)
    m2, m1 = (json.loads((workdir / d / f"{stem}.manifest.json")
                         .read_text()) for d in ("ckpt2", "one_ckpt"))
    assert m2["history"] == m1["history"]
    assert len(m2["meta"]["worker_loss"]) == len(m1["history"]["loss"])


def test_checkpoints_cross_between_ranks_and_one_process(two, params,
                                                         workdir):
    """The one-process checkpoint resumed on 2 ranks, and the 2-rank
    checkpoint resumed in one process, both continue to the
    uninterrupted one-process run bit for bit."""
    whole = ranks.run_case(dict(ranks.KILL, spec=""), params)
    for r, x in enumerate(two):
        got = x["from_one"]
        _equal(got["global"], whole["global"], "global")
        _equal(got["v"], whole["v"], "v")
        _equal(got["workers"][0], whole["workers"][r], "worker")
        assert got["hist"]["fleet_loss"] == whole["hist"]["loss"]
    back = ranks.run_case(ranks.KILL, params,
                          checkpoint_dir=str(workdir / "ckpt2"), resume=True)
    for key in ("global", "v"):
        _equal(back[key], whole[key], key)
    for a, b in zip(back["workers"], whole["workers"]):
        _equal(a, b, "workers")
    _equal(back["runner"]["residual"], whole["runner"]["residual"],
           "residual")
    assert back["hist"] == whole["hist"]


def _jax_pipeline(tmp):
    return jax_train.run_pipeline(
        "hybrid", out_dir=str(tmp / "jax"),
        **{k: v for k, v in ranks.HYBRID.items() if k != "device"})


def test_hybrid_across_two_ranks(two, hybrid_start, workdir, monkeypatch,
                                 tmp_path):
    """``run_pipeline("hybrid")`` as 2 ranks: the DiLoCo base stage ends
    on one process's parameters, and its ranks' losses average to one
    process's, bit for bit; its mid and SFT
    stages run DDP over both ranks as one data axis, their losses (the
    ranks' half-batch means, averaged) within rtol 1e-6 of one process's
    and the final parameters within 1e-6; and every stage's losses within
    rtol 1e-5, the final parameters within 1e-4, of the JAX
    ``run_pipeline`` (``test_torch_pipeline.py``'s tolerances)."""
    jcfg, jp = hybrid_start

    def init(cfg, seed=0, device="cpu"):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        return port_params(jcfg, jp)

    monkeypatch.setattr(train, "init_params", init)
    monkeypatch.setattr(train, "run_stage", train.run_stage)
    ends = ranks.stage_ends(train)
    res = train.run_pipeline("hybrid", out_dir=str(tmp_path / "port"),
                             **ranks.HYBRID)
    for x in two:                       # the base stage ends bit for bit
        _equal(x["hybrid_ends"][0], ends[0], "base stage")
    jres = _jax_pipeline(tmp_path)
    for stage in ("base", "mid", "sft"):
        got = [x["hybrid"]["stages"][stage] for x in two]
        want = res["stages"][stage]
        assert [g["method"] for g in got] == [want["method"]] * 2
        mean = [_mean(col) for col in zip(*(g["losses"] for g in got))]
        if stage == "base":
            assert mean == want["losses"]
            assert got[0]["port"]["syncs"] == want["port"]["syncs"]
        else:
            np.testing.assert_allclose(mean, want["losses"], rtol=DDP_RTOL)
        np.testing.assert_allclose(mean, jres["stages"][stage]["losses"],
                                   rtol=1e-5)
    final = load_pytree(str(workdir / "hybrid" / "hybrid_final"))
    one_final = load_pytree(str(tmp_path / "port" / "hybrid_final"))
    jfinal = load_pytree(str(tmp_path / "jax" / "hybrid_final"))
    assert set(final) == set(one_final) == set(jfinal)
    for k in final:
        np.testing.assert_allclose(final[k], one_final[k], atol=DDP_ATOL,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(final[k], jfinal[k], atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def _datasets():
    tokens = np.random.default_rng(5).integers(0, 97, 4000).astype(np.int32)
    return JaxPackedDataset(tokens, 16)


def _record_quanta(monkeypatch):
    """Per leaf, the widest int8 code step of a run (one code: amax/127)."""
    quanta = {}
    orig = transport.QuantizedCodec.encode

    def encode(self, delta, residual=None, **kw):
        for k, d in delta.items():
            e = d if residual is None else d + residual[k]
            if e.numel():
                quanta[k] = max(quanta.get(k, 0.0),
                                float(e.abs().max()) / 127)
        return orig(self, delta, residual, **kw)

    monkeypatch.setattr(transport.QuantizedCodec, "encode", encode)
    return quanta


@pytest.mark.parametrize("name", [
    "streaming-f2-int8", "gossip-ring-int8-k4",
    "gossip-ring-crash-rejoin-drop-x2"])
def test_ranks_within_tolerance_of_jax(two, four, jparams, params,
                                       monkeypatch, name):
    """The ranks' anchor against the JAX ``run_stage`` of the same case:
    the losses' worker mean within rtol 1e-5, the records exact, every
    parameter within 2e-5 plus, where an inner-step difference moved an
    int8 code, one quantum (``test_torch_strategies.py``,
    ``test_torch_gossip.py`` and ``test_torch_faults_e2e.py``)."""
    outs = two if name in ranks.CASES2 else four
    c = dict(ranks.CASES2, **ranks.CASES4)[name]
    quanta = _record_quanta(monkeypatch)
    ranks.run_case(c, params)         # the codes the ranks sent, recorded
    kw = dict(steps=c["steps"], workers=c["k"], per_worker_batch=2,
              h=c["h"], seed=0)
    if c["spec"]:
        kw["faults"] = JaxFaultSchedule.from_spec(c["spec"])
    jout, jhist = jax_run_stage(
        c["method"], build_model(CFG), jparams, _datasets(),
        opt_cfg=JaxOptimizerConfig(**ranks.opt_of(c["total"])),
        diloco_cfg=JaxDiLoCoConfig(**c["dkw"]), **kw)
    hist = outs[0][name]["hist"]
    for key in ("sync_steps", "frag_syncs", "gossip_syncs", "quorum"):
        if key in jhist:
            assert hist[key] == [tuple(x) if isinstance(x, list) else x
                                 for x in jhist[key]], key
    live = [np.nan_to_num(x[name]["hist"]["loss"], nan=0.0) for x in outs]
    if not c["spec"]:
        np.testing.assert_allclose(
            [_mean(col) for col in zip(*live)], jhist["loss"], rtol=1e-5)
    want = jax_flat(jout)
    dcfg = ranks.stage_config(c)[0]
    for x in outs:
        got = {k: v.numpy() for k, v in x[name]["global"].items()}
        for k in want:
            err = np.abs(got[k] - want[k])
            over = err > 2e-5
            np.testing.assert_array_less(
                err[over], 2e-5 + quanta.get(k, 0.0) * dcfg.outer_lr
                * (1 + dcfg.outer_momentum), err_msg=k)
