"""The port's process mesh on the CPU: DiLoCo workers and DDP replicas as
``torch.distributed`` ranks (gloo, a file-store rendezvous, every rank
started with ``spawn`` and joined under a timeout), the rank programs in
``tests/torch_mesh_ranks.py``, from the JAX package's initial parameters
of ``tests/helpers.py``'s tiny dense config.

* 2 ranks, (pod 2, data 1): DiLoCo through ``DistTrainer.run`` equals
  the one-process port bit for bit (anchor, outer momentum, the rank's
  worker, step counters) on the f32 and int8 wires after 2 rounds, and is
  within ``test_torch_train.py``'s tolerance of the JAX ``run_stage``;
  ``shipped`` per rank is the rank's own payload row, the ranks' counts
  summing to the one-process count and equal to the collective log's
  cross-pod bytes; at engine level the inner steps log no collective
  and each round's cross-pod bytes equal the summed ``shipped``, the
  int8 residual rows equal the one-process rows.
* The same 2 ranks as (pod 1, data 2): DDP within a stated tolerance of
  one-process DDP on the global batch.
* 4 ranks, (pod 2, data 2): ``tests/test_system.py``'s three facts (the
  pods' losses differ, their workers diverge, the outer round resyncs
  them exactly), the data ranks of a pod bit for bit alike, the inner
  steps' all-reduces inside the pod only; within 1e-5 of one process.
* What stays refused across processes is structural: a mesh whose pods
  are not the config's workers, and in the CLI a pod-axis method with
  workers other than the pods, nccl on the CPU or with fewer cards than
  ranks.  The CLI's path runs hybrid with AdaptiveH, a fault schedule
  and run checkpoints across two ranks (every strategy across ranks:
  ``tests/test_torch_mesh_strategies.py``).
"""
import os

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from helpers import tiny_cfg
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.data.pipeline import PackedDataset as JaxPackedDataset
from repro.launch.train import run_stage as jax_run_stage
from repro.models import build_model
from repro.models.transformer import init_params as jax_init
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.core import DistTrainer, make_strategy, transport
from repro_torch.launch import train
from repro_torch.launch.mesh import ProcessMesh, run_ranks
from repro_torch.models import lm_loss
from repro_torch.models.transformer import flatten, unflatten
from torch_parity import jax_flat, port_cfg, port_params

torch.set_num_threads(1)

JOIN_S = 240.0          # the whole spawn, every rank joined


@pytest.fixture(scope="module")
def jparams():
    return jax_init(tiny_cfg("dense"), jax.random.key(0))[0]


@pytest.fixture(scope="module")
def params(jparams):
    return flatten(port_params(tiny_cfg("dense"), jparams))


def _spawn(fn, world, params, tmp):
    torch.save(params, os.path.join(tmp, "params.pt"))
    run_ranks(fn, world, str(tmp), timeout_s=JOIN_S)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
            for r in range(world)]


@pytest.fixture(scope="module")
def pair(params, tmp_path_factory):
    return _spawn(ranks.pair, 2, params, tmp_path_factory.mktemp("pair"))


@pytest.fixture(scope="module")
def grid(params, tmp_path_factory):
    return _spawn(ranks.grid, 4, params, tmp_path_factory.mktemp("grid"))


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _one_process(params, wire):
    dt = ranks.diloco_trainer(wire)
    transport.reset_shipped()
    st, hist = dt.run(dt.init(unflatten(params)),
                      ranks.worker_data(ranks.dataset()), 4)
    return st, hist, dict(transport.shipped)


def test_rank_config_is_the_tiny_config():
    assert ranks.tiny() == port_cfg(tiny_cfg("dense"))


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_two_rank_diloco_equals_one_process_bit_for_bit(pair, params,
                                                        wire):
    """Both ranks' anchors and outer momentum equal the one-process K 2
    loop's bit for bit after 2 rounds; each rank's worker equals the
    anchor (it took the round), its pod's row; the rank's history has its
    own worker's losses (the one-process history their mean) and one
    sync time a round."""
    st, hist, _ = _one_process(params, wire)
    assert [r["pod_index"] for r in pair] == [0, 1]
    assert pair[0]["pod_ranks"] == pair[1]["pod_ranks"] == (0, 1)
    for r in pair:
        got = r[wire]
        _equal(got["global"], st.global_params)
        _equal(got["v"], st.outer.v)
        assert got["step"] == int(st.inner_step) == 4
        assert got["t"] == int(st.outer.t) == 2
        assert len(got["workers"]) == 1
        _equal(got["workers"][0], st.global_params)
        assert got["hist"]["sync_steps"] == hist["sync_steps"] == [1, 3]
        assert len(got["hist"]["sync_seconds"]) == 2
        assert len(got["hist"]["inner_seconds"]) == 2
        # the run tags its log: nothing in the inner steps, every byte
        # across pods in the outer rounds
        assert got["inner"]["count_by_kind"] == {}
        assert got["outer"]["cross_pod_bytes_per_device"] == \
            got["stats"]["cross_pod_bytes_per_device"] > 0
    mean = [(np.float32(a) + np.float32(b)) / np.float32(2) for a, b in
            zip(pair[0][wire]["hist"]["loss"], pair[1][wire]["hist"]["loss"])]
    assert [float(x) for x in mean] == hist["loss"]
    assert pair[0][wire]["hist"]["loss"] != pair[1][wire]["hist"]["loss"]


def test_two_rank_diloco_within_tolerance_of_jax(pair, jparams):
    """The ranks' f32 anchor against the JAX ``run_stage("diloco")`` from
    the same parameters on the same worker batches: atol 2e-5, the
    tolerance ``test_torch_train.py`` holds the one-process port to."""
    tokens = np.random.default_rng(5).integers(0, 97, 4000).astype(np.int32)
    jout, jhist = jax_run_stage(
        "diloco", build_model(tiny_cfg("dense")), jparams,
        JaxPackedDataset(tokens, 16),
        opt_cfg=JaxOptimizerConfig(**ranks.OPT),
        diloco_cfg=JaxDiLoCoConfig(), steps=4, workers=2,
        per_worker_batch=2, h=2, seed=0)
    want = jax_flat(jout)
    for r in pair:
        got = r["float32"]["global"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=2e-5,
                                       rtol=0, err_msg=k)
    assert jhist["sync_steps"] == pair[0]["float32"]["hist"]["sync_steps"]


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_shipped_is_the_rank_own_row(pair, params, wire):
    """``shipped`` per rank is one worker's payload (codes and scales):
    the ranks' counts sum to the one-process count, and each equals the
    rank's cross-pod bytes in the collective log, all of it all-gathers
    over the pod axis (no all-reduce on a data axis of one rank)."""
    _, _, one = _one_process(params, wire)
    codec = "f32" if wire == "float32" else "int8"
    per_rank = [r[wire]["shipped"][codec] for r in pair]
    assert per_rank[0] == per_rank[1]
    assert sum(per_rank) == one[codec]
    n = sum(p.numel() for p in params.values())
    leaves = len(params)
    width = 4 if wire == "float32" else 1
    scales = 0 if wire == "float32" else 4 * leaves
    assert per_rank[0] == 2 * (n * width + scales)            # 2 rounds
    for r, b in zip(pair, per_rank):
        stats = r[wire]["stats"]
        assert stats["cross_pod_bytes_per_device"] == b
        assert stats["wire_bytes_per_device"] == b
        assert set(stats["bytes_by_kind"]) == {"all-gather"}
        assert stats["count_by_kind"]["all-gather"] == \
            2 * leaves * (1 if wire == "float32" else 2)


def test_inner_steps_issue_no_cross_pod_collective(pair, params):
    """At engine level on the int8 wire: nothing is logged in the inner
    steps; each outer round's cross-pod bytes equal the ranks' summed
    ``shipped`` of that round, over both ranks; the anchor, momentum and
    each rank's residual row equal the one-process rounds' bit for
    bit."""
    eng = ranks.diloco_trainer("int8").engine()
    st, res, _ = ranks.engine_rounds(eng, params,
                                     ranks.worker_data(ranks.dataset()), 2)
    for rnd in range(2):
        rounds = [r["int8_engine"]["rounds"][rnd] for r in pair]
        for x in rounds:
            assert x["inner"]["count_by_kind"] == {}
            assert x["inner"]["cross_pod_bytes_per_device"] == 0
            assert all(kind == "all-gather" and axis == "pod" and cross
                       for kind, axis, _, cross in x["records"])
        assert sum(x["outer"]["cross_pod_bytes_per_device"]
                   for x in rounds) == \
            sum(x["shipped"]["int8"] for x in rounds)
    for i, r in enumerate(pair):
        got = r["int8_engine"]
        _equal(got["global"], st.global_params)
        _equal(got["v"], st.outer.v)
        _equal(got["residual"], {k: v[i:i + 1] for k, v in res.items()})


def test_two_rank_ddp_within_tolerance_of_one_process(pair, params):
    """DDP over (pod 1, data 2), each rank half of the global batch of 4
    and the gradients all-reduced (mean) before the optimizer: the two
    ranks' parameters equal bit for bit, and within atol 1e-6 of
    one-process DDP on the whole batch after 2 steps (the mean of two
    half-batch means against one mean; Muon's Newton-Schulz in f32).  The
    log holds one all-reduce a leaf a step, none across pods."""
    dt = ranks.ddp_trainer()
    st, hist = dt.run(dt.init(unflatten(params)),
                      ranks.ddp_data(ranks.dataset()), 2)
    a, b = (r["ddp"] for r in pair)
    _equal(a["workers"][0], b["workers"][0])
    for k, v in st.global_params.items():
        np.testing.assert_allclose(a["global"][k].numpy(), v.numpy(),
                                   atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_allclose(
        [(x + y) / 2 for x, y in zip(a["hist"]["loss"], b["hist"]["loss"])],
        hist["loss"], rtol=1e-6)
    for r in (a, b):
        assert r["stats"]["count_by_kind"] == {"all-reduce": 2 * len(params)}
        assert r["stats"]["cross_pod_bytes_per_device"] == 0


def test_pod_grid_three_facts(grid, params):
    """(pod 2, data 2), as ``tests/test_system.py``'s multi-pod test:
    the pods' losses differ; before a round the pods' workers differ and
    the data ranks of one pod are bit for bit alike (DDP inside the pod);
    after it every worker equals the anchor and every rank holds the same
    anchor, bit for bit.  The inner steps' collectives are all-reduces on
    the data axis, never across pods; the round's cross-pod bytes equal
    the summed ``shipped``.  The anchor is within 1e-5 of one process's
    K 2 loop on the same per-worker batches (a half-batch mean of
    gradients against the whole batch's)."""
    by = {(r["pod"], r["data"]): r for r in grid}
    assert sorted(by) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for rnd in range(2):
        losses = {pd: [float(x) for x in r["rounds"][rnd]["losses"]]
                  for pd, r in by.items()}
        assert losses[(0, 0)] != losses[(1, 0)]
        before = {pd: r["rounds"][rnd]["before"][0] for pd, r in by.items()}
        _equal(before[(0, 0)], before[(0, 1)])
        _equal(before[(1, 0)], before[(1, 1)])
        assert any(not torch.equal(before[(0, 0)][k], before[(1, 0)][k])
                   for k in params)
        for r in grid:
            x = r["rounds"][rnd]
            assert x["inner"]["cross_pod_bytes_per_device"] == 0
            assert set(x["inner"]["count_by_kind"]) == {"all-reduce"}
            assert x["outer"]["cross_pod_bytes_per_device"] == \
                x["shipped"]["f32"]
    for r in grid:
        _equal(r["workers"][0], r["global"])
        _equal(r["global"], grid[0]["global"])
        _equal(r["v"], grid[0]["v"])
    eng = ranks.diloco_trainer("float32").engine()
    st, _, _ = ranks.engine_rounds(eng, params,
                                   ranks.worker_data(ranks.dataset(), 4), 2)
    for k, v in st.global_params.items():
        np.testing.assert_allclose(grid[0]["global"][k].numpy(), v.numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def _mesh_trainer(strategy_cfg, **kw):
    cfg = port_cfg(tiny_cfg("dense"))
    mesh = ProcessMesh(pod=2, data=1, rank=0, backend="gloo",
                       device=torch.device("cpu"))
    return DistTrainer(lambda p, b: lm_loss(p, b, cfg),
                       OptimizerConfig(total_steps=4, warmup_steps=1),
                       strategy_cfg, make_strategy(strategy_cfg, **kw),
                       mesh.replicate_fn)


def test_dist_trainer_refuses_a_mesh_of_other_worker_count(params):
    """A process mesh holds one worker row a pod: a config whose worker
    count is not the pod count is refused by name before any step."""
    dt = _mesh_trainer(DiLoCoConfig(num_workers=4, h_inner_steps=2))
    with pytest.raises(ValueError, match="2 worker rows"):
        dt.run(dt.init(unflatten(params)),
               ranks.worker_data(ranks.dataset()), 2)


def test_ship_bitcasts_narrow_wires_to_bytes():
    """The replicate hop sees a bf16 / fp8 payload as uint8 bytes and the
    decoder gets the wire dtype back, bit for bit (here an identity
    gather that stacks the row twice)."""
    seen = []

    def twice(flat):
        seen.extend(v.dtype for v in flat.values())
        return {k: torch.cat([v, v]) for k, v in flat.items()}

    for dtype, codec in (("bfloat16", "bf16"), ("fp8", "fp8"),
                         ("float32", "f32")):
        tr = transport.Transport(transport.make_codec(dtype), twice)
        payload, _ = tr.codec.encode({"w": torch.randn(1, 3, 5)})
        seen.clear()
        out = tr.ship(payload)
        assert seen[0] == (torch.float32 if codec == "f32" else torch.uint8)
        assert out.data["w"].dtype == payload.data["w"].dtype
        assert out.data["w"].shape == (2, 3, 5)
        assert torch.equal(out.data["w"][1].view(torch.uint8),
                           payload.data["w"][0].view(torch.uint8))


def test_cli_refuses_before_spawning():
    """What stays refused across processes is structural, and the CLI
    says so before any rank starts: a method on the pod axis (every one
    but plain DDP) with workers other than the pods, nccl on the CPU, and
    nccl with fewer cards than ranks."""
    for method in ("streaming", "gossip", "hybrid"):
        with pytest.raises(ValueError, match=method + ".*one worker a pod"):
            train.main(["--method", method, "--pods", "2", "--workers", "3",
                        "--backend", "gloo", "--device", "cpu"])
    with pytest.raises(ValueError, match="compressed ddp.*one worker a pod"):
        train.main(["--method", "ddp", "--grad-compress", "int8", "--pods",
                    "2", "--workers", "4", "--backend", "gloo", "--device",
                    "cpu"])
    with pytest.raises(ValueError, match="gloo"):
        train.main(["--method", "diloco", "--pods", "2", "--device", "cpu"])
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="NCCL rejects two ranks"):
            train.main(["--method", "diloco", "--pods", "2"])


def test_cli_pipeline_across_two_ranks():
    """``run_ranks_pipeline`` (the CLI's path) trains the tiny pipeline as
    2 DiLoCo ranks on the CPU and returns rank 0's metrics: each stage's
    syncs (H 1 here), and the wire bytes of the rank's own rows, one f32
    payload a sync."""
    res = train.run_ranks_pipeline(
        2, 1, "gloo", method="diloco", arch="tiny", workers=2,
        steps={"base": 2, "mid": 1, "sft": 1}, per_worker_batch=2,
        seq_len=32, eval_after_each_stage=False, device="cpu")
    base, mid = res["stages"]["base"], res["stages"]["mid"]
    assert (base["port"]["syncs"], mid["port"]["syncs"]) == (2, 1)
    assert np.isfinite(base["loss_last"])
    one = mid["port"]["wire_bytes"]["f32"]
    assert one % 4 == 0 and base["port"]["wire_bytes"] == {"f32": 2 * one}


def test_cli_runs_hybrid_across_two_ranks(tmp_path):
    """``run_ranks_pipeline`` runs ``--method hybrid`` as 2 ranks with
    AdaptiveH, a crash and rejoin and run checkpoints in its DiLoCo base
    stage (on the pods) and DDP over both ranks in mid and SFT; rank 0's
    metrics carry the base stage's fault records, and rank 0 wrote the
    checkpoints."""
    from repro_torch.checkpoint.checkpoint import list_run_checkpoints
    ckpt = tmp_path / "ckpt"
    res = train.run_ranks_pipeline(
        2, 1, "gloo", method="hybrid", arch="tiny", workers=2,
        steps={"base": 4, "mid": 1, "sft": 1}, per_worker_batch=2,
        seq_len=32, eval_after_each_stage=False, device="cpu",
        adaptive_h=True, fault_schedule="crash:1@1,rejoin:1@2",
        checkpoint_dir=str(ckpt), checkpoint_every=2)
    stages = res["stages"]
    assert [stages[s]["method"] for s in ("base", "mid", "sft")] == \
        ["diloco", "ddp", "ddp"]
    assert [tuple(e) for e in stages["base"]["fault"]][:1] == \
        [(1, "crash", 1)]
    assert stages["base"]["quorum"]
    assert all(np.isfinite(stages[s]["loss_last"]) for s in stages)
    assert [s for s, _ in list_run_checkpoints(str(ckpt))] == [2, 4]
