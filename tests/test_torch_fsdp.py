"""ZeRO-3 over the ``data`` axis of the port's process mesh
(``models/fsdp.py``, ``models/sharding.py`` ``fsdp_layout``,
``init_process_mesh(fsdp=True)``) and drift-aware averaging on shards,
on the CPU: four gloo ranks spawned once (``tests/torch_mesh_ranks.py``
``fsdp4``) as (data 4), (pod 2, data 2) and (data 2, model 2) meshes,
each with ``fsdp`` beside its replicated twin of the same ranks, and as
(pod 2, model 2), at the reference test's tiny config (``tiny_cfg``; the
vocab-128 variant where ``model`` splits the vocab).

Tolerances.  What is exact is held exactly: the layout against the
reference's ``spec_for``, ``gather(shard(p)) == p``, Muon on shards (the
whole matrix's update, sliced), the quantize hook (the whole leaf's
scale and codes), one step's gradients at data 2 (a two-term sum is the
same in either order, so the reduce-scatter's mean is the all-reduce's,
sliced) and Muon's update from them, an int8 round from one shared
state (anchor, momentum, residual, codes and scales), a resume against
the uninterrupted run, and a rank's live state bytes against the dry
run's.  Whole runs sum the global norm's partial squares in another
order than the whole leaf's, so they are held to their replicated twins
and to one process within 1e-6 (``test_torch_tensor_parallel.py``'s
DDP-across-ranks tolerance) and to the JAX package's one-device
``run_stage`` within 2e-5; the drift-aware weights to one process's
within 1e-6.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from helpers import tiny_cfg
from repro.configs import registry as jax_registry
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core import outer_opt as jax_outer_opt
from repro.data.pipeline import PackedDataset as JaxPackedDataset
from repro.launch.train import run_stage as jax_run_stage
from repro.models import build_model
from repro.models import sharding as jax_sharding
from repro.models.transformer import abstract_params as jax_abstract_params
from repro.models.transformer import init_params as jax_init
from repro_torch.checkpoint import load_pytree
from repro_torch.checkpoint.checkpoint import list_run_checkpoints
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.core import (AdaptiveH, DistTrainer, FaultSchedule,
                              make_strategy, outer_opt)
from repro_torch.core.sync import DiLoCoSync
from repro_torch.kernels.quantize import quantize_ef
from repro_torch.launch import train
from repro_torch.launch.dryrun_lib import runtime_state_bytes
from repro_torch.launch.mesh import (MeshShape, PodReplicate, ProcessMesh,
                                     init_process_mesh)
from repro_torch.models import lm_loss
from repro_torch.models.sharding import (fsdp_layout, gather, shard,
                                         tp_layout)
from repro_torch.models.transformer import (flatten, init_params,
                                            param_shapes)
from repro_torch.optim.base import global_norm
from repro_torch.optim.muon import muon
from torch_parity import jax_flat, port_cfg, port_params

torch.set_num_threads(1)

JOIN_S = 240.0
JCFG = tiny_cfg("dense")
JCFG_TP = tiny_cfg("dense", vocab_size=128)
CFG, CFG_TP = ranks.tiny(), ranks.tp_cfg()
# whole runs against their replicated twins and one process
ATOL, LOSS_RTOL = 1e-6, 1e-6
# the port against the JAX package (test_torch_tensor_parallel.py's)
JAX_ATOL = 2e-5
# the drift-aware softmax weights against one process's
WEIGHT_ATOL = 1e-6


class _Shape:
    """A mesh by its shape alone, as both packages' ``spec_for`` read it."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


@pytest.fixture(scope="module")
def params():
    return flatten(port_params(JCFG, jax_init(JCFG, jax.random.key(0))[0]))


@pytest.fixture(scope="module")
def params_tp():
    return flatten(port_params(JCFG_TP,
                               jax_init(JCFG_TP, jax.random.key(0))[0]))


@pytest.fixture(scope="module")
def workdir(params, params_tp, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    torch.save(params, tmp / "params.pt")
    torch.save(params_tp, tmp / "params_tp.pt")
    return tmp


@pytest.fixture(scope="module")
def four(workdir):
    from repro_torch.launch.mesh import run_ranks
    run_ranks(ranks.fsdp4, 4, str(workdir), timeout_s=JOIN_S)
    return [torch.load(os.path.join(workdir, f"fsdp_rank{r}.pt"))
            for r in range(4)]


def _group(four, mesh, fixed):
    """The ranks of ``mesh`` whose (pod, data, model) index agrees with
    ``fixed`` (None: any) on each axis, in rank order."""
    return [r for r in four if all(
        f is None or f == i for f, i in zip(fixed, r["index"][mesh]))]


def _joined(four, mesh, key, part, pod=0):
    """The one-process tree of ``part`` of ``key`` joined from pod
    ``pod``'s ranks of ``mesh`` (``gather`` over both axes)."""
    model_l, data_l = four[0]["layout"][mesh]
    group = _group(four, mesh, (pod, None, None))
    data = len({r["index"][mesh][1] for r in group})
    return gather([_pick(r[key], part) for r in group], model_l,
                  fsdp=data_l, data=data)


def _pick(x, part):
    for p in part.split("."):
        x = x[int(p)] if isinstance(x, list) else x[p]
    return x


def _equal(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), (what, k)


def _close(got, want, atol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=atol, rtol=0, err_msg=f"{what} {k}")


def _sliced(four, mesh, key, rep_key, part, what):
    """Each rank's ``part`` of ``key`` on the fsdp ``mesh`` equals its
    data piece of the replicated twin's (``rep_key``), bit for bit."""
    data_l = four[0]["layout"][mesh][1]
    for r in four:
        _, d, _ = r["index"][mesh]
        n = len({x["index"][mesh][1] for x in four})
        mine, theirs = _pick(r[key], part), _pick(r[rep_key], part)
        want = shard(theirs, None, 0, 1, fsdp=data_l, data_index=d, data=n)
        _equal(mine, want, f"{what} rank {r['index'][mesh]}")


# ---------------------------------------------------------------------------
# The layout (host only)
# ---------------------------------------------------------------------------

def _d20(layers=2):
    return jax_registry.get_config("nanochat-d20").with_(num_layers=layers)


@pytest.mark.parametrize("which,data,model", [
    ("tiny", 2, 1), ("tiny", 4, 1), ("tp", 2, 2), ("d20", 4, 1),
    ("d20", 2, 2)])
def test_fsdp_layout_is_the_references_spec_for(which, data, model):
    """Each leaf's ``fsdp`` dim is where the reference's ``spec_for``
    under its ``DEFAULT_RULES`` puts ``data`` on a (data, model) mesh
    (its ``abstract_params`` names), counted from the end; the 1-D leaves
    stay whole, and every matrix splits its d_model dim."""
    jcfg = {"tiny": JCFG, "tp": JCFG_TP, "d20": _d20()}[which]
    sds, jnames = jax_abstract_params(jcfg)
    leaves = jax.tree_util.tree_flatten_with_path(
        jnames, is_leaf=lambda x: isinstance(x, tuple) and all(
            n is None or isinstance(n, str) for n in x))[0]
    shapes = {"/".join(str(getattr(k, "key", k)) for k in p): tuple(s.shape)
              for p, s in jax.tree_util.tree_flatten_with_path(sds)[0]}
    layout = fsdp_layout(port_cfg(jcfg), data, model)
    for p, names in leaves:
        path = "/".join(str(getattr(k, "key", k)) for k in p)
        spec = tuple(jax_sharding.spec_for(names, shapes[path],
                                           _Shape(data, model)))
        dim = next((i for i, a in enumerate(spec) if a == "data"), None)
        want = None if dim is None else dim - len(shapes[path])
        assert layout[path] == want, path
    assert all(layout[k] is None for k in layout if "scale" in k)
    assert layout["layers/attn/wq"] == -2 and layout["layers/attn/wo"] == -1
    assert layout["embed/table"] == -1


@pytest.mark.parametrize("data,model", [(2, 1), (4, 1), (2, 2)])
def test_gather_of_shard_is_the_params_bit_for_bit(data, model):
    """Every rank's shard (its model piece of its data piece) joins back
    to the parameters bit for bit, on both axes; a whole leaf is the
    same on every rank."""
    cfg = CFG_TP
    lay, dlay = tp_layout(cfg, model), fsdp_layout(cfg, data, model)
    p = flatten(init_params(cfg, seed=3))
    parts = [shard(p, lay, m, model, fsdp=dlay, data_index=d, data=data)
             for d in range(data) for m in range(model)]
    for path in p:
        if lay[path] is None and dlay[path] is None:
            assert all(torch.equal(s[path], p[path]) for s in parts)
        else:
            assert parts[0][path].numel() < p[path].numel(), path
    _equal(gather(parts, lay, fsdp=dlay, data=data), p, "gather(shard(p))")


# ---------------------------------------------------------------------------
# The unit checks, on the (data 2, model 2) fsdp mesh
# ---------------------------------------------------------------------------

def _d2m2(four):
    return sorted(four, key=lambda r: r["index"]["d2m2f"][1:])


def test_muon_on_shards_is_the_whole_update_sliced(four):
    g = ranks.tp_inputs()["muon"]
    opt = muon(0.02)
    want, _ = opt.update(dict(g), opt.init(g), g,
                         torch.zeros((), dtype=torch.int32))
    model_l, data_l = four[0]["layout"]["d2m2f"]
    got = gather([r["units"]["muon"] for r in _d2m2(four)], model_l,
                 fsdp=data_l, data=2)
    _equal(got, want, "muon")


def test_global_norm_on_shards_is_the_whole_norm(four, params_tp):
    """Summed over both groups (the split leaves' partial squares), a
    whole leaf counted once: the whole tree's norm within 1e-6, the same
    bits on every rank."""
    want = global_norm(params_tp)
    norms = [r["units"]["global_norm"] for r in four]
    for n in norms:
        np.testing.assert_allclose(n.item(), want.item(), rtol=1e-6)
    assert all(torch.equal(n, norms[0]) for n in norms)


def test_quantize_on_shards_is_the_whole_leaf_sliced(four):
    """The amax maxed over the data and the model group: every rank's
    scale is the whole leaf's, and the codes and residual join to the
    whole leaf's, bit for bit."""
    x = ranks.tp_inputs()
    wq, wr, ws = quantize_ef(x["delta"], x["residual"], dtype="int8")
    model_l, data_l = four[0]["layout"]["d2m2f"]
    k = "layers/attn/wq"
    for r in four:
        assert torch.equal(r["units"]["quantize"][2], ws)
    for i, want in enumerate((wq, wr)):
        got = gather([{k: r["units"]["quantize"][i]} for r in _d2m2(four)],
                     model_l, fsdp=data_l, data=2)[k]
        assert torch.equal(got, want), i


# ---------------------------------------------------------------------------
# One step from one shared state (data 2, model 2)
# ---------------------------------------------------------------------------

def test_step_gradients_and_muon_are_the_replicated_runs_sliced(four):
    """One step's reduce-scattered gradients equal the replicated run's
    all-reduced gradients, sliced to the rank's data piece, bit for bit,
    and so does Muon's update from them (its matrix gathered over both
    groups); the loss is the same bits."""
    _sliced(four, "d2m2f", "grads_d2m2f", "grads_d2m2r", "grads",
            "gradients")
    _sliced(four, "d2m2f", "grads_d2m2f", "grads_d2m2r", "muon", "muon")
    for r in four:
        assert torch.equal(r["grads_d2m2f"]["loss"],
                           r["grads_d2m2r"]["loss"])


def test_step_collectives_gather_and_reduce_scatter_over_data(four):
    """Under fsdp the step's data-axis collectives are the weights'
    all-gathers (forward and remat's recompute), their gradients'
    reduce-scatters and the whole leaves' gradient all-reduces (the
    norm scales), none crossing a pod; the replicated twin all-reduces
    every gradient and gathers nothing over data."""
    model_l, data_l = four[0]["layout"]["d2m2f"]
    n_split = sum(d is not None for d in data_l.values())
    L = CFG_TP.num_layers
    for r in four:
        data_f = [k for k, a, _ in r["grads_d2m2f"]["records"]
                  if a == "data"]
        data_r = [k for k, a, _ in r["grads_d2m2r"]["records"]
                  if a == "data"]
        per_layer = 7               # wq, wk, wv, wo, w_up, w_gate, w_down
        assert data_f.count("reduce-scatter") == L * per_layer + 1
        # the layers twice (forward and recompute) and the embedding once
        assert data_f.count("all-gather") == 2 * L * per_layer + 1
        # the whole leaves' means: ln1, ln2, final_norm
        assert data_f.count("all-reduce") == len(data_l) - n_split
        assert data_r == ["all-reduce"] * len(data_l)


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------

_ONE = {}


def _jax_ddp(jcfg):
    tokens = np.random.default_rng(5).integers(
        0, 97, 4000).astype(np.int32)
    jout, _ = jax_run_stage(
        "ddp", build_model(jcfg), jax_init(jcfg, jax.random.key(0))[0],
        JaxPackedDataset(tokens, 16),
        opt_cfg=JaxOptimizerConfig(**dict(ranks.OPT, fused_adamw=False)),
        diloco_cfg=JaxDiLoCoConfig(), steps=2, workers=2,
        per_worker_batch=2, h=1, seed=0)
    return jax_flat(jout)


@pytest.mark.parametrize("mesh", ["d4f", "d2m2f"])
def test_ddp_matches_replicated_one_process_and_jax(four, params, params_tp,
                                                    mesh):
    """2 DDP steps with fsdp on (data 4) and (data 2, model 2): the
    joined parameters against the replicated twin's and the one-process
    port's (``ATOL``, losses ``LOSS_RTOL``) and the JAX
    ``run_stage("ddp")`` (``JAX_ATOL``)."""
    cfg, flat, jcfg = ((CFG, params, JCFG) if mesh == "d4f"
                       else (CFG_TP, params_tp, JCFG_TP))
    dt = ranks.ddp_trainer(cfg=cfg)
    from repro_torch.models.transformer import unflatten
    st, hist = dt.run(dt.init(unflatten(flat)),
                      ranks.ddp_data(ranks.dataset()), 2)
    got = _joined(four, mesh, f"ddp_{mesh}", "global")
    twin = _joined(four, mesh.replace("f", "r"),
                   f"ddp_{mesh.replace('f', 'r')}", "global")
    _close(got, twin, ATOL, "fsdp vs replicated")
    _close(got, st.global_params, ATOL, "fsdp vs one process")
    _close(got, _jax_ddp(jcfg), JAX_ATOL, "fsdp vs jax")
    # the ranks' mean (the model ranks of a data index record the same)
    np.testing.assert_allclose(
        np.mean([r[f"ddp_{mesh}"]["hist"]["loss"] for r in four], axis=0),
        hist["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_diloco_run_matches_replicated_one_process_and_jax(four, params,
                                                           wire):
    """One DiLoCo round through ``DistTrainer.run`` on (pod 2, data 2)
    with fsdp: each pod's joined anchor against the replicated twin's and
    one process's (``ATOL``), and on the f32 wire the JAX
    ``run_stage("diloco")`` (``JAX_ATOL``); the data ranks of a worker
    record the same losses as the twin's.  On the int8 wire the data
    axis's gradient mean parts from one process's at the last bit and
    may flip a code by one step, so against one process an element may
    differ by one code step of its leaf, at most 1% of a leaf's elements
    past ``ATOL`` (``test_torch_tensor_parallel.py``'s
    ``_close_in_steps``)."""
    case = ranks.FSDP_DILOCO[wire]
    with ranks.WireLog() as wire_log:
        ref = ranks.run_case(case, params)
    d = DiLoCoConfig()
    step = {k: d.outer_lr * (1 + d.outer_momentum) / 2
            * float(wire_log[k][1].sum()) if wire_log else 0.0
            for k in ref["global"]}
    for pod in (0, 1):
        got = _joined(four, "p2d2f", f"run_{wire}_p2d2f", "global", pod)
        twin = _joined(four, "p2d2r", f"run_{wire}_p2d2r", "global", pod)
        _close(got, twin, ATOL, "fsdp vs replicated")
        for k, t in ref["global"].items():
            diff = (got[k] - t).abs()
            assert float(diff.max()) <= ATOL + step[k], k
            assert float((diff > ATOL).float().mean()) <= 0.01, k
    if wire == "float32":
        tokens = np.random.default_rng(5).integers(
            0, 97, 4000).astype(np.int32)
        jout, _ = jax_run_stage(
            "diloco", build_model(JCFG), jax_init(JCFG, jax.random.key(0))[0],
            JaxPackedDataset(tokens, 16),
            opt_cfg=JaxOptimizerConfig(**ranks.opt_of(8)),
            diloco_cfg=JaxDiLoCoConfig(), steps=2, workers=2,
            per_worker_batch=2, h=2, seed=0)
        _close(_joined(four, "p2d2f", f"run_{wire}_p2d2f", "global"),
               jax_flat(jout), JAX_ATOL, "fsdp vs jax")
    for r in four:
        f, t = r[f"run_{wire}_p2d2f"], r[f"run_{wire}_p2d2r"]
        np.testing.assert_allclose(f["hist"]["loss"], t["hist"]["loss"],
                                   rtol=LOSS_RTOL)
        assert f["hist"]["sync_steps"] == ref["hist"]["sync_steps"] == [1]


def test_round_from_one_state_is_the_replicated_rounds_sliced(four):
    """The int8 round on the fsdp (pod 2, data 2) mesh from the
    replicated run's worker just before its round: the anchor, momentum,
    residual and codes are the replicated round's, sliced to the rank's
    data piece, and every scale the same, bit for bit (the round is
    elementwise and the amax a max)."""
    for part in ("global", "v", "residual"):
        _sliced(four, "p2d2f", "round_p2d2f", "round_p2d2r", part, part)
    data_l = four[0]["layout"]["p2d2f"][1]
    for r in four:
        d = r["index"]["p2d2f"][1]
        f, t = r["round_p2d2f"]["wire"], r["round_p2d2r"]["wire"]
        assert set(f) == set(t) == set(data_l)
        for k, (q, s) in f.items():
            assert torch.equal(s, t[k][1]), k
            want = shard({k: t[k][0].view(torch.uint8)}, None, 0, 1,
                         fsdp=data_l, data_index=d, data=2)[k]
            assert torch.equal(q.view(torch.uint8), want), k


def test_fsdp_ships_half_the_bytes(four, params):
    """A rank of the fsdp (pod 2, data 2) run sends across pods its
    shards' codes and every leaf's scale, half the replicated rank's
    bytes but for the whole leaves (the norm scales), which every data
    rank ships; the run's ``shipped`` is what its round sent."""
    data_l = four[0]["layout"]["p2d2f"][1]
    shapes = param_shapes(CFG)
    codes = sum(math.prod(s) // (2 if data_l[k] is not None else 1)
                for k, s in shapes.items())
    whole = sum(math.prod(s) for s in shapes.values())
    for r in four:
        f, t = r["round_p2d2f"]["cross_pod"], r["round_p2d2r"]["cross_pod"]
        assert f == codes + 4 * len(shapes)
        assert t == whole + 4 * len(shapes)
        assert 0.5 < f / t < 0.51
        run = r["run_int8_p2d2f"]
        assert run["stats"]["outer"]["cross_pod_bytes_per_device"] == \
            sum(run["shipped"].values()) == f


# ---------------------------------------------------------------------------
# Drift-aware averaging on shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["p2m2", "p2d2f"])
def test_drift_aware_round_matches_one_process_and_jax(four, mesh):
    """One drift-aware int8 round on (pod 2, model 2) and on fsdp (pod 2,
    data 2): every rank's softmax weights within ``WEIGHT_ATOL`` of one
    process's from the same decoded deltas (the shards joined), the same
    bits on every rank, and the joined averaged delta within ``ATOL`` of
    one process's ``_average`` and ``JAX_ATOL`` of the JAX package's
    drift-aware average."""
    model_l, data_l = four[0]["layout"][mesh]
    key = f"drift_{mesh}"
    group = _group(four, mesh, (0, None, None))
    data = len({r["index"][mesh][1] for r in group})
    delta = gather([r[key]["average"][0][0] for r in group], model_l,
                   fsdp=data_l, data=data)
    avg = gather([r[key]["average"][0][1] for r in group], model_l,
                 fsdp=data_l, data=data)
    mean = {k: outer_opt._mean(d) for k, d in delta.items()}
    want_w = outer_opt.drift_weights(delta, mean)
    ws = [r[key]["weights"][0] for r in four]
    for w in ws:
        np.testing.assert_allclose(w.numpy(), want_w.numpy(), rtol=0,
                                   atol=WEIGHT_ATOL)
        assert torch.equal(w, ws[0])
    dcfg = DiLoCoConfig(**ranks.FSDP_DRIFT)
    _close(avg, outer_opt._average(delta, dcfg), ATOL, "vs one process")
    jdelta = {k: jnp.asarray(d.numpy()) for k, d in delta.items()}
    jout = jax_outer_opt._average(
        jdelta, JaxDiLoCoConfig(delta_dtype="int8", drift_aware=True))
    _close(avg, {k: np.asarray(v) for k, v in jout.items()}, JAX_ATOL,
           "vs jax")


# ---------------------------------------------------------------------------
# Run checkpoints and the state a rank holds
# ---------------------------------------------------------------------------

def test_resume_is_the_uninterrupted_run_bit_for_bit(four):
    """``FSDP_CKPT`` on fsdp (pod 2, data 2), written at step 2 and
    resumed to step 4: each rank's anchor, momentum, worker and residual
    shards equal the uninterrupted run's, bit for bit."""
    for r in four:
        a, b = r["ckpt_resumed"], r["ckpt_whole"]
        assert a["step"] == b["step"] == 4
        _equal(a["global"], b["global"], "anchor")
        _equal(a["v"], b["v"], "momentum")
        _equal(a["workers"][0], b["workers"][0], "worker")
        _equal(a["runner"]["residual"], b["runner"]["residual"], "residual")


def test_checkpoint_holds_the_one_process_layout(four, workdir):
    """The step-2 checkpoint the fsdp ranks wrote holds each worker's
    parameters, the anchor and the residual in the one-process layout:
    the ranks' shards joined over the data group, bit for bit."""
    steps = dict(list_run_checkpoints(str(workdir / "fsdp_ckpt")))
    assert 2 in steps
    import json
    with open(steps[2]) as f:
        m = json.load(f)
    d = os.path.dirname(steps[2])
    saved = load_pytree(os.path.join(d, m["files"]["state"]))
    extras = load_pytree(os.path.join(d, m["files"]["extras"]))
    for pod in (0, 1):
        worker = _joined(four, "p2d2f", "ckpt_first", "workers.0", pod)
        for k, t in worker.items():
            assert np.array_equal(saved[f"worker_params/{pod}/{k}"],
                                  t.numpy()), k
        res = _joined(four, "p2d2f", "ckpt_first", "runner.residual", pod)
        for k, t in res.items():
            assert np.array_equal(extras[f"residual/{k}"][pod:pod + 1],
                                  t.numpy()), k
    anchor = _joined(four, "p2d2f", "ckpt_first", "global")
    for k, t in anchor.items():
        assert saved[f"global_params/{k}"].shape == param_shapes(CFG)[k]
        assert np.array_equal(saved[f"global_params/{k}"], t.numpy()), k


@pytest.mark.parametrize("name,mesh_shape,strategy,fsdp,cfg", [
    ("ddp_d4f", (1, 4, 1), "ddp", True, CFG),
    ("ddp_d2m2f", (1, 2, 2), "ddp", True, CFG_TP),
    ("diloco_p2d2f", (2, 2, 1), "diloco", True, CFG),
    ("diloco_p2d2r", (2, 2, 1), "diloco", False, CFG)])
def test_live_state_bytes_equal_the_dry_runs(four, name, mesh_shape,
                                             strategy, fsdp, cfg):
    """A rank's live state after ``init`` (``live_state_bytes``: the
    parameters, the optimizer state and, for DiLoCo, the anchor, the
    outer momentum and the int8 wire's residual) equals the dry run's
    per-device bytes of the same mesh under the runtime's rules
    (``runtime_state_bytes``); under fsdp it is about a data degree's
    share of the replicated rank's."""
    mesh = MeshShape(tuple(zip(("pod", "data", "model"), mesh_shape)))
    want = runtime_state_bytes(
        cfg, mesh, strategy=strategy, fsdp=fsdp,
        opt_cfg=OptimizerConfig(**ranks.OPT),
        dcfg=DiLoCoConfig(num_workers=mesh_shape[0], delta_dtype="int8"))
    for r in four:
        assert r["live_bytes"][name] == want, r["index"]
    if name == "diloco_p2d2f":
        rep = four[0]["live_bytes"]["diloco_p2d2r"]
        assert 0.5 < four[0]["live_bytes"][name] / rep < 0.51


# ---------------------------------------------------------------------------
# What fsdp refuses, by name
# ---------------------------------------------------------------------------

def _fake_fsdp_mesh(cfg=CFG, pod=1, data=2, model=1):
    return ProcessMesh(pod=pod, data=data, rank=0, backend="gloo",
                       device=torch.device("cpu"), model=model,
                       layout=tp_layout(cfg, model) if model > 1 else None,
                       data_layout=fsdp_layout(cfg, data, model))


@pytest.mark.parametrize("name,match", [
    ("streaming", "'streaming' strategy"), ("gossip", "'gossip' strategy"),
    ("ddp_compressed", "'ddp_compressed' strategy"),
    ("adaptive_h", "AdaptiveH"), ("faults", "fault layer")])
def test_distributed_run_refuses_what_fsdp_does_not_hold(name, match):
    faults = None
    if name == "ddp_compressed":
        from repro_torch.core import compressed_ddp_config
        dcfg = compressed_ddp_config(DiLoCoConfig(num_workers=2,
                                                  grad_compress="int8"))
        strategy = make_strategy(dcfg)
    elif name == "adaptive_h":
        dcfg = DiLoCoConfig(num_workers=2)
        strategy = DiLoCoSync(h_schedule=AdaptiveH(h0=2))
    elif name == "faults":
        dcfg = DiLoCoConfig(num_workers=2)
        strategy = make_strategy(dcfg)
        faults = FaultSchedule.from_spec("crash:1@1,rejoin:1@2")
    else:
        dcfg = DiLoCoConfig(num_workers=2, strategy=name, num_fragments=2)
        strategy = make_strategy(dcfg)
    dt = DistTrainer(lambda p, b: lm_loss(p, b, CFG),
                     OptimizerConfig(**ranks.opt_of(8)), dcfg, strategy,
                     PodReplicate(_fake_fsdp_mesh(pod=2)))
    with pytest.raises(NotImplementedError,
                       match=f"{match}.*fsdp over the data axis"):
        dt.run(None, None, 2, faults=faults)


@pytest.mark.parametrize("method,pods,kw,match", [
    ("hybrid", 2, {}, "--method hybrid"),
    ("streaming", 2, {}, "--method streaming"),
    ("ddp", 2, {}, "plain ddp across pods"),
    ("ddp", 2, dict(grad_compress="int8"), "compressed ddp"),
    ("diloco", 2, dict(adaptive_h=True), "--adaptive-h"),
    ("diloco", 2, dict(fault_schedule="crash:1@1"), "--fault-schedule")])
def test_cli_refuses_what_fsdp_does_not_hold(method, pods, kw, match):
    """``run_ranks_pipeline(fsdp=True)`` refuses these before it starts a
    rank."""
    with pytest.raises(NotImplementedError, match=f"{match}.*--fsdp"):
        train.run_ranks_pipeline(pods, 2, "gloo", 1, True, method=method,
                                 workers=pods, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["moe", "ssm", "hybrid", "audio", "vlm"])
def test_other_families_refuse_fsdp(kind):
    cfg = port_cfg(tiny_cfg(kind))
    with pytest.raises(NotImplementedError, match="fsdp over the data axis"):
        init_process_mesh(1, 2, backend="gloo", device="cpu", rank=0,
                          world_size=2, cfg=cfg, fsdp=True)


def test_fsdp_needs_data_ranks_and_its_config():
    """``--fsdp`` without ``--data-procs`` > 1 is an argparse error; a
    mesh with fsdp needs the config; a data view of an fsdp mesh is
    refused; on one data rank fsdp shards nothing."""
    with pytest.raises(SystemExit):
        train.main(["--fsdp", "--pods", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="--data-procs > 1"):
        train.run_ranks_pipeline(2, 1, "gloo", 1, True, method="diloco",
                                 workers=2, device="cpu")
    with pytest.raises(ValueError, match="needs the model config"):
        init_process_mesh(1, 2, backend="gloo", device="cpu", rank=0,
                          world_size=2, fsdp=True)
    with pytest.raises(NotImplementedError, match="data view"):
        _fake_fsdp_mesh(pod=2).data_view()
    assert fsdp_layout(CFG, 1) == {k: None for k in param_shapes(CFG)}


def test_cli_runs_diloco_with_fsdp():
    """The CLI's ``--pods 2 --data-procs 2 --fsdp`` path: the tiny
    pipeline's DiLoCo as 4 ranks, each stage ending on the gathered
    one-process parameters with finite losses; rank 0's int8 wire bytes
    are its data shards' codes and every leaf's scale a sync."""
    res = train.run_ranks_pipeline(
        2, 2, "gloo", 1, True, method="diloco", arch="tiny", workers=2,
        steps={"base": 2, "mid": 1, "sft": 1}, per_worker_batch=2,
        seq_len=32, delta_dtype="int8", eval_after_each_stage=False,
        device="cpu")
    stages = res["stages"]
    assert all(np.isfinite(stages[s]["loss_last"]) for s in stages)
    base = stages["base"]["port"]
    assert base["syncs"] == 2 and set(base["wire_bytes"]) == {"int8"}
    vocab = train.build_pipeline(seq_len=32)[1].vocab_size
    cfg = train.make_model("tiny", True, vocab)
    layout = fsdp_layout(cfg, 2)
    shapes = param_shapes(cfg)
    n = sum(math.prod(s) // (2 if layout[k] is not None else 1)
            for k, s in shapes.items())
    assert base["wire_bytes"]["int8"] == 2 * (n + 4 * len(shapes))
