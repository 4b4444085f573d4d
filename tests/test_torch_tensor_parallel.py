"""Tensor parallelism over the ``model`` axis of the port's process mesh
(``models/tensor_parallel.py``, ``models/sharding.py`` ``tp_layout``),
on the CPU: four gloo ranks spawned once (``tests/torch_mesh_ranks.py``
``tensor_parallel4``), as (pod 2, model 2) and (data 2, model 2) meshes,
at the reference test's tiny config with a vocab of 128 (the model axis
splits it) and a 3-head variant whose attention stays whole.

Tolerances.  A row-parallel product summed by an all-reduce is not bit
for bit with one GEMM, so runs are held to the one-process port within
the DDP-across-ranks tolerance (``test_torch_mesh_strategies.py``: atol
1e-6, losses rtol 1e-6) and to the JAX package within the DiLoCo / DDP
parity tolerance of ``test_torch_multiproc.py`` / ``test_torch_train.py``
(atol 2e-5).  What is exact is held exactly: the shards' layout and
``gather(shard(p)) == p``, the vocab-parallel embedding, Muon on shards
(the whole matrix's update, sliced), the quantize hook (the whole leaf's
scale and codes), a DiLoCo round from one shared state (anchor,
momentum, residual, codes and scales), and every replicated leaf across
the model ranks.
"""
import math
import os
import shutil

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
from repro_torch.checkpoint import load_pytree
from repro_torch.checkpoint.checkpoint import (latest_run_checkpoint,
                                              list_run_checkpoints)
from repro_torch.configs import NANOCHAT_D20, DiLoCoConfig, OptimizerConfig
from repro_torch.core import (AdaptiveH, DistTrainer, FaultSchedule,
                              SimulatedCrash, make_strategy)
from repro_torch.core.sync import DiLoCoSync
from repro_torch.kernels.quantize import quantize_ef
from repro_torch.launch import train
from repro_torch.launch.mesh import (PodReplicate, ProcessMesh,
                                     init_process_mesh)
from repro_torch.models import lm_loss, tensor_parallel as tp
from repro_torch.models.layers import embed, softmax_ce_sums
from repro_torch.models.sharding import (gather, local_shape, shard,
                                         spec_for, tp_layout)
from repro_torch.models.transformer import (flatten, forward_hidden,
                                            init_params, param_names,
                                            param_shapes, unflatten)
from repro_torch.optim.base import global_norm
from repro_torch.optim.muon import muon
from repro_torch.serving import Engine
from torch_parity import jax_flat, port_params

torch.set_num_threads(1)

JOIN_S = 240.0
JCFG = tiny_cfg("dense", vocab_size=128)
JCFG3 = tiny_cfg("dense", vocab_size=128, num_heads=3, num_kv_heads=1,
                 head_dim=16)
CFG, CFG3 = ranks.tp_cfg(), ranks.tp_cfg3()
# tensor parallelism against one process (the DDP-across-ranks tolerance)
ATOL, LOSS_RTOL = 1e-6, 1e-6
# the port against the JAX package (test_torch_multiproc.py's DiLoCo)
JAX_ATOL = 2e-5
ATTN = ("layers/attn/wq", "layers/attn/wk", "layers/attn/wv",
        "layers/attn/wo")


class _Axis:
    def __init__(self, model):
        self.shape = {"model": model}


@pytest.fixture(scope="module")
def params():
    return flatten(port_params(JCFG, jax_init(JCFG, jax.random.key(0))[0]))


@pytest.fixture(scope="module")
def params3():
    return flatten(port_params(JCFG3,
                               jax_init(JCFG3, jax.random.key(0))[0]))


@pytest.fixture(scope="module")
def workdir(params, params3, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    torch.save(params, tmp / "params.pt")
    torch.save(params3, tmp / "params3.pt")
    # a one-process checkpoint at step 2 for the ranks to resume from
    with pytest.raises(SimulatedCrash):
        ranks.run_case(dict(ranks.TP_CKPT, spec="kill@1"), params, cfg=CFG,
                       checkpoint_dir=str(tmp / "one_ckpt"),
                       checkpoint_every=2)
    return tmp


@pytest.fixture(scope="module")
def four(workdir):
    from repro_torch.launch.mesh import run_ranks
    run_ranks(ranks.tensor_parallel4, 4, str(workdir), timeout_s=JOIN_S)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"))
            for r in range(4)]


def _model_pair(four, pod=0):
    """The two model ranks of ``pod``'s worker, in model-index order."""
    pair = [r for r in four if r["index"][0] == pod]
    return sorted(pair, key=lambda r: r["index"][2])


def _close(got, want, atol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=atol, rtol=0, err_msg=f"{what} {k}")


def _equal(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), (what, k)


_ONE = {}


def one(name, params, **kw):
    """The one-process port's run of a case at ``CFG`` (cached)."""
    if name not in _ONE:
        case = ranks.TP_DILOCO.get(name, ranks.TP_CKPT)
        _ONE[name] = ranks.run_case(case, params, cfg=CFG, **kw)
    return _ONE[name]


# ---------------------------------------------------------------------------
# The layout (host only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,model,differs", [
    (CFG, 2, ()), (CFG3, 2, ATTN),
    (NANOCHAT_D20.with_(num_layers=2), 2, ()),
    (NANOCHAT_D20.with_(num_layers=2), 4, ATTN)])
def test_layout_is_spec_for_but_whole_heads(cfg, model, differs):
    """Each leaf's shard shape is ``local_shape(spec_for(...))`` over a
    ``model`` axis, except the named attention leaves, which the head
    rule keeps whole where the heads do not divide (3 heads at model 2;
    d20's 10 at model 4, where ``spec_for`` cuts heads in half)."""
    layout, shapes = tp_layout(cfg, model), param_shapes(cfg)
    axis = _Axis(model)
    got_differs = []
    for path, names in param_names(cfg).items():
        want = local_shape(shapes[path], spec_for(names, shapes[path], axis),
                           axis)
        shard_shape = list(shapes[path])
        if layout[path] is not None:
            shard_shape[layout[path]] //= model
        if tuple(shard_shape) != want:
            got_differs.append(path)
            assert layout[path] is None, path
    assert tuple(sorted(got_differs)) == tuple(sorted(differs))
    assert all(layout[p] is None for p in shapes if "/ln" in p or
               "norm" in p)
    # the MLP and the vocab split wherever spec_for splits them
    assert layout["layers/mlp/w_up"] == -1
    assert layout["layers/mlp/w_down"] == -2
    assert layout["embed/table"] == -2


@pytest.mark.parametrize("cfg,model", [
    (CFG, 2), (CFG3, 2),
    (NANOCHAT_D20.with_(num_layers=1, vocab_size=1024), 2),
    (NANOCHAT_D20.with_(num_layers=1, vocab_size=1024), 4)])
def test_gather_of_shard_is_the_params_bit_for_bit(cfg, model):
    """A whole leaf is the same on every rank; the shards join back to
    the parameters bit for bit (d20's widths at a cut vocab)."""
    layout = tp_layout(cfg, model)
    p = flatten(init_params(cfg, seed=3))
    parts = [shard(p, layout, i, model) for i in range(model)]
    for path, dim in layout.items():
        if dim is None:
            assert all(torch.equal(s[path], p[path]) for s in parts)
    _equal(gather(parts, layout), p, "gather(shard(p))")


def test_quantize_hook_is_applied_to_the_amax():
    """The plain quantize with an ``amax_reduce`` hook codes against the
    hook's amax: a hook returning the whole row's amax gives a slice's
    codes, scale and residual as the whole row's, sliced."""
    x = tp_inputs_delta()
    whole_q, whole_r, whole_s = quantize_ef(x, dtype="int8")
    amax = x.abs().amax(dim=(1, 2, 3), keepdim=True)
    half = x[..., :32]
    q, r, s = quantize_ef(half, dtype="int8", amax_reduce=lambda a: amax)
    assert torch.equal(s, whole_s)
    assert torch.equal(q, whole_q[..., :32])
    assert torch.equal(r, whole_r[..., :32])
    with pytest.raises(ValueError, match="per-row"):
        quantize_ef(half, dtype="int8", tile=64, amax_reduce=lambda a: a)


def tp_inputs_delta():
    return ranks.tp_inputs()["delta"]


# ---------------------------------------------------------------------------
# The unit checks, on the ranks' model groups
# ---------------------------------------------------------------------------

def test_vocab_parallel_embedding_and_ce_equal_the_whole(four, params):
    x = ranks.tp_inputs()
    want = embed({"table": params["embed/table"]}, x["tokens"], CFG)
    logits = x["logits"].clone().requires_grad_(True)
    total, count = softmax_ce_sums(logits, x["labels"], z_loss=1e-4)
    grad = torch.autograd.grad(total, logits)[0]
    for pod in (0, 1):
        pair = _model_pair(four, pod)
        for r in pair:
            assert torch.equal(r["units"]["embed"], want)
            t, c = r["units"]["ce"]
            assert c == count
            np.testing.assert_allclose(t.item(), total.item(), rtol=1e-6)
        g = torch.cat([r["units"]["ce_grad"] for r in pair], dim=-1)
        np.testing.assert_allclose(g.numpy(), grad.numpy(), rtol=0,
                                   atol=1e-6 * grad.abs().max().item())


def test_muon_on_shards_is_the_whole_update_sliced(four):
    g = ranks.tp_inputs()["muon"]
    opt = muon(0.02)
    want, _ = opt.update(dict(g), opt.init(g), g,
                         torch.zeros((), dtype=torch.int32))
    layout = four[0]["layout"]
    for pod in (0, 1):
        pair = _model_pair(four, pod)
        _equal(gather([r["units"]["muon"] for r in pair], layout), want,
               "muon")


def test_global_norm_on_shards_is_the_whole_norm(four, params):
    want = global_norm(params)
    for r in four:
        np.testing.assert_allclose(r["units"]["global_norm"].item(),
                                   want.item(), rtol=1e-6)
    # every model rank gets the same bits
    for pod in (0, 1):
        a, b = _model_pair(four, pod)
        assert torch.equal(a["units"]["global_norm"],
                           b["units"]["global_norm"])


def test_quantize_on_shards_is_the_whole_leaf_sliced(four):
    x = ranks.tp_inputs()
    wq, wr, ws = quantize_ef(x["delta"], x["residual"], dtype="int8")
    for pod in (0, 1):
        pair = _model_pair(four, pod)
        for r in pair:
            assert torch.equal(r["units"]["quantize"][2], ws)
        for i, want in enumerate((wq, wr)):
            got = torch.cat([r["units"]["quantize"][i] for r in pair], -1)
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The model, one forward and backward from the shared parameters
# ---------------------------------------------------------------------------

def test_forward_backward_from_one_state(four, params):
    """Loss rtol 1e-6 and every gradient leaf within 1e-5 of its max,
    against one process; the model ranks' losses and whole leaves'
    gradients are the same bits; the collectives are the model axis's
    only (remat's recompute re-issues the forward's all-reduces)."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, _ = lm_loss(unflatten(leaves),
                      ranks._tensors(ranks.dataset().batch(0, 2, seed=0)),
                      CFG)
    want = dict(zip(leaves, torch.autograd.grad(loss,
                                                list(leaves.values()))))
    layout = four[0]["layout"]
    for pod in (0, 1):
        pair = _model_pair(four, pod)
        for r in pair:
            np.testing.assert_allclose(r["loss_grads"]["loss"].item(),
                                       loss.item(), rtol=1e-6)
        assert torch.equal(pair[0]["loss_grads"]["loss"],
                           pair[1]["loss_grads"]["loss"])
        got = gather([r["loss_grads"]["grads"] for r in pair], layout)
        for k, g in want.items():
            np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=0,
                                       atol=1e-5 * g.abs().max().item(),
                                       err_msg=k)
            if layout[k] is None:
                assert torch.equal(pair[0]["loss_grads"]["grads"][k],
                                   pair[1]["loss_grads"]["grads"][k]), k
        recs = pair[0]["loss_grads"]["records"]
        assert recs and all(axis == "model" and not cross
                            for _, axis, cross in recs)
        # forward: embed, 2 a layer, the CE's max and sums; backward: the
        # recompute's 2 a layer, 2 a layer and the unembedding's copy
        L = CFG.num_layers
        assert len(recs) == (1 + 2 * L + 2) + (2 * L + 2 * L + 1)


# ---------------------------------------------------------------------------
# DiLoCo and DDP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_diloco_round_from_one_state_is_one_process(four, params, wire):
    """The round the ranks ran, run by one process from the same state
    (the ranks' worker shards just before it, gathered): the anchor, the
    momentum and the residual bit for bit, and on the int8 wire every
    leaf's scale the whole leaf's on every model rank and its codes the
    one-process codes' slices."""
    layout = four[0]["layout"]
    eng = ranks.diloco_trainer(wire, cfg=CFG).engine()
    st = eng.init(unflatten(params))
    res = eng.init_residual(st.global_params)
    for w in (0, 1):
        pair = _model_pair(four, w)
        whole = gather([r[f"round_{wire}"]["before"] for r in pair], layout)
        for k, t in st.worker_params[w].items():
            t.copy_(whole[k])
    with ranks.WireLog() as wire_log:
        st, res = eng.outer_step_ef(st, res)
    for w in (0, 1):
        pair = _model_pair(four, w)
        got = [r[f"round_{wire}"] for r in pair]
        _equal(gather([g["global"] for g in got], layout), st.global_params,
               "anchor")
        _equal(gather([g["v"] for g in got], layout), st.outer.v, "v")
        if res is not None:
            _equal(gather([g["residual"] for g in got], layout),
                   {k: v[w:w + 1] for k, v in res.items()}, "residual")
        for k, (q, s) in wire_log.items():
            dim = layout[k]
            assert all(torch.equal(g["wire"][k][1], s[w:w + 1])
                       for g in got), k
            codes = [g["wire"][k][0] for g in got]
            whole_q = (codes[0] if dim is None else
                       torch.cat([c.view(torch.uint8) for c in codes],
                                 dim=dim).view(q.dtype))
            assert torch.equal(whole_q.view(torch.uint8),
                               q[w:w + 1].view(torch.uint8)), k
        assert (wire == "int8") == bool(wire_log)


def _code_step(four, wire, layout):
    """Per leaf, what one int8 code step of every worker moves the anchor
    by in the round: outer lr x (1 + momentum) x the workers' scales
    summed, over K (0 on the f32 wire)."""
    if wire == "float32":
        return {k: 0.0 for k in layout}
    d = DiLoCoConfig()
    return {k: d.outer_lr * (1 + d.outer_momentum) / 2 * sum(
        float(_model_pair(four, w)[0]["run_int8"]["wire"][k][1].max())
        for w in (0, 1)) for k in layout}


def _close_in_steps(got, want, atol, step, what):
    """Every element within ``atol`` plus one code step of its leaf, and
    at most 1% of a leaf's elements past ``atol`` (the elements whose
    code a last-bit difference flipped)."""
    assert set(got) == set(want), what
    for k in want:
        diff = (got[k] - torch.as_tensor(np.array(want[k]))).abs()
        assert float(diff.max()) <= atol + step[k], (what, k)
        assert float((diff > atol).float().mean()) <= 0.01, (what, k)


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_diloco_run_matches_one_process_and_jax(four, params, wire):
    """One round through ``DistTrainer.run``: the ranks' anchor against
    the one-process port's (``ATOL``) and the JAX ``run_stage("diloco")``
    (``JAX_ATOL``), their losses within ``LOSS_RTOL``, the model ranks of
    a worker with equal losses.  On the int8 wire the inner steps'
    last-bit differences flip a few codes by one step, so an element may
    differ by one code step of its leaf (``_close_in_steps``); from one
    shared state the round is exact (the test above)."""
    ref = one(wire, params)
    layout = four[0]["layout"]
    dcfg = JaxDiLoCoConfig() if wire == "float32" else JaxDiLoCoConfig(
        delta_dtype="int8")
    tokens = np.random.default_rng(5).integers(0, 97, 4000).astype(np.int32)
    jout, _ = jax_run_stage(
        "diloco", build_model(JCFG), jax_init(JCFG, jax.random.key(0))[0],
        JaxPackedDataset(tokens, 16),
        opt_cfg=JaxOptimizerConfig(**ranks.opt_of(8)), diloco_cfg=dcfg,
        steps=2, workers=2, per_worker_batch=2, h=2, seed=0)
    want_jax = jax_flat(jout)
    step = _code_step(four, wire, layout)
    for w in (0, 1):
        pair = _model_pair(four, w)
        got = gather([r[f"run_{wire}"]["global"] for r in pair], layout)
        _close_in_steps(got, ref["global"], ATOL, step,
                        "anchor vs one process")
        _close_in_steps(got, want_jax, JAX_ATOL, step, "anchor vs jax")
        la, lb = (r[f"run_{wire}"]["hist"]["loss"] for r in pair)
        assert la == lb
        assert pair[0][f"run_{wire}"]["hist"]["sync_steps"] == \
            ref["hist"]["sync_steps"] == [1]
    mean = [(np.float32(a) + np.float32(b)) / np.float32(2) for a, b in zip(
        _model_pair(four, 0)[0][f"run_{wire}"]["hist"]["loss"],
        _model_pair(four, 1)[0][f"run_{wire}"]["hist"]["loss"])]
    np.testing.assert_allclose(mean, ref["hist"]["loss"], rtol=LOSS_RTOL)


def test_ddp_matches_one_process_and_jax(four, params):
    """2 DDP steps on (data 2, model 2) against the one-process port
    (``ATOL``, losses ``LOSS_RTOL``) and the JAX ``run_stage("ddp")``
    (``JAX_ATOL``); the gradient mean runs over the data group of each
    model index (across no pod) and the model all-reduces inside it."""
    cfg = CFG
    dt = ranks.ddp_trainer(cfg=cfg)
    st, hist = dt.run(dt.init(unflatten(params)),
                      ranks.ddp_data(ranks.dataset()), 2)
    tokens = np.random.default_rng(5).integers(0, 97, 4000).astype(np.int32)
    jout, _ = jax_run_stage(
        "ddp", build_model(JCFG), jax_init(JCFG, jax.random.key(0))[0],
        JaxPackedDataset(tokens, 16),
        opt_cfg=JaxOptimizerConfig(**dict(ranks.OPT, fused_adamw=False)),
        diloco_cfg=JaxDiLoCoConfig(), steps=2, workers=2,
        per_worker_batch=2, h=1, seed=0)
    layout = four[0]["layout"]
    by_data = {}
    for r in four:
        by_data.setdefault(r["ddp"]["index"][1], []).append(r["ddp"])
    for d, group in by_data.items():
        group.sort(key=lambda x: x["index"][2])
        got = gather([g["global"] for g in group], layout)
        _close(got, st.global_params, ATOL, "ddp vs one process")
        _close(got, jax_flat(jout), JAX_ATOL, "ddp vs jax")
        recs = group[0]["records"]
        assert {a for _, a, _ in recs} == {"data", "model"}
        assert not any(cross for _, _, cross in recs)
    mean = [(np.float32(a) + np.float32(b)) / np.float32(2) for a, b in zip(
        by_data[0][0]["hist"]["loss"], by_data[1][0]["hist"]["loss"])]
    np.testing.assert_allclose(mean, hist["loss"], rtol=LOSS_RTOL)


def test_replicated_leaves_are_bit_for_bit_across_model_ranks(four):
    """Every whole leaf (the norm scales; attention at 3 heads) holds the
    same bits on both model ranks of a worker, after DiLoCo on both
    wires, DDP and the 3-head run, in the anchor and the worker."""
    layout, layout3 = four[0]["layout"], four[0]["layout3"]
    for key, lay in (("run_float32", layout), ("run_int8", layout),
                     ("ddp", layout), ("three_heads", layout3)):
        groups = {}
        for r in four:
            idx = r[key].get("index", r["index"]) if key == "ddp" \
                else r["index"]
            groups.setdefault(idx[:2], []).append(r[key])
        for a, b in groups.values():
            for part in ("global", "v"):
                for k, dim in lay.items():
                    if dim is None:
                        assert torch.equal(a[part][k], b[part][k]), (key, k)
            for k, dim in lay.items():
                if dim is None:
                    assert torch.equal(a["workers"][0][k],
                                       b["workers"][0][k]), (key, k)


def test_three_heads_keep_attention_whole(four, params3):
    """At 3 heads the layout keeps attention's four leaves whole (each
    rank runs every head), the MLP and the vocab still split; the run
    matches the one-process port within ``ATOL``."""
    layout3 = four[0]["layout3"]
    assert all(layout3[k] is None for k in ATTN)
    assert layout3["layers/mlp/w_up"] == -1
    assert layout3["embed/table"] == -2
    ref = ranks.run_case(ranks.TP_DILOCO["float32"], params3, cfg=CFG3)
    for w in (0, 1):
        pair = _model_pair(four, w)
        assert pair[0]["three_heads"]["global"]["layers/attn/wq"].shape == \
            params3["layers/attn/wq"].shape
        got = gather([r["three_heads"]["global"] for r in pair], layout3)
        _close(got, ref["global"], ATOL, "3 heads vs one process")


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_model_collectives_stay_inside_the_pod(four, wire):
    """The inner steps log model-axis collectives only (the layers'
    all-reduces, Muon's all-gathers), none crossing a pod; the round's
    cross-pod bytes are each rank's shards' encoded bytes (codes and
    scales, the run's ``shipped``), and on the int8 wire the round adds
    one model-axis MAX per split leaf."""
    layout = four[0]["layout"]
    n_split = sum(d is not None for d in layout.values())
    for r in four:
        x = r[f"round_{wire}"]
        inner = [rec for rec in x["records"] if rec[4] == "inner"]
        outer = [rec for rec in x["records"] if rec[4] == "outer"]
        assert inner and all(a == "model" and not c
                             for _, a, c, _, _ in inner)
        assert {k for k, *_ in inner} == {"all-reduce", "all-gather"}
        cross = sum(b for k, a, c, b, _ in outer if c)
        sh = sum(t.numel() * t.element_size()
                 for t in x["global"].values())
        width = 4 if wire == "float32" else 1
        scales = 0 if wire == "float32" else 4 * len(layout)
        assert cross == sh // 4 * width + scales
        model = [rec for rec in outer if rec[1] == "model"]
        assert len(model) == (n_split if wire == "int8" else 0)
        assert all(k == "all-reduce" and not c for k, _, c, _, _ in model)
        run = r[f"run_{wire}"]
        assert run["stats"]["outer"]["cross_pod_bytes_per_device"] == \
            sum(run["shipped"].values())


def test_checkpoint_at_model_2_resumes_at_model_1_and_back(four, params,
                                                           workdir,
                                                           tmp_path):
    """The ranks' run checkpoint (written at model 2) holds the
    one-process layout: its arrays are the ranks' gathered state, bit
    for bit.  One process resumes from its step-2 checkpoint; the ranks
    resumed from a one-process step-2 checkpoint; each ends within
    ``ATOL`` of the one-process uninterrupted run."""
    layout = four[0]["layout"]
    ckpt = str(workdir / "tp_ckpt")
    m = latest_run_checkpoint(ckpt)
    assert m["step"] == 4
    saved = load_pytree(os.path.join(m["_dir"], m["files"]["state"]))
    for w in (0, 1):
        pair = _model_pair(four, w)
        got = gather([r["ckpt_run"]["workers"][0] for r in pair], layout)
        for k, t in got.items():
            assert np.array_equal(saved[f"worker_params/{w}/{k}"],
                                  t.numpy()), k
        anchor = gather([r["ckpt_run"]["global"] for r in pair], layout)
        for k, t in anchor.items():
            assert np.array_equal(saved[f"global_params/{k}"], t.numpy()), k
    whole = one("ckpt", params)
    # model 2 -> model 1: resume the one process from the ranks' step 2
    step2 = tmp_path / "step2"
    shutil.copytree(ckpt, step2)
    for step, manifest in list_run_checkpoints(str(step2)):
        if step != 2:
            os.remove(manifest)
    resumed = ranks.run_case(ranks.TP_CKPT, params, cfg=CFG,
                             checkpoint_dir=str(step2), resume=True)
    _close(resumed["global"], whole["global"], ATOL, "resumed at model 1")
    # model 1 -> model 2: the ranks resumed from one process's step 2
    for w in (0, 1):
        pair = _model_pair(four, w)
        got = gather([r["from_one"]["global"] for r in pair], layout)
        _close(got, whole["global"], ATOL, "resumed at model 2")
        assert pair[0]["from_one"]["step"] == 4


def test_a_checkpoint_joins_shards_at_model_index_0_only(four):
    """A run checkpoint under a model axis joins each split leaf at model
    index 0 of its pod (gathers on the model group, never an all-gather,
    none crossing pods); only the model-index-0 ranks then run the pod
    gather to rank 0, so the other model ranks send nothing across
    pods."""
    for r in four:
        st = r["ckpt_run"]["stats"]["checkpoint"]
        assert st["count_by_kind"].get("gather", 0) > 0, r["index"]
        assert "all-gather" not in st["count_by_kind"], r["index"]
        assert ((st["cross_pod_bytes_per_device"] > 0)
                == (r["index"][2] == 0)), r["index"]


# ---------------------------------------------------------------------------
# What a model axis > 1 refuses, by name
# ---------------------------------------------------------------------------

def _fake_mesh(cfg=CFG, pod=2, data=1, model=2):
    """A (pod, data, model) mesh as rank 0 sees it, without a process
    group: what the checks before any collective read."""
    return ProcessMesh(pod=pod, data=data, rank=0, backend="gloo",
                       device=torch.device("cpu"), model=model,
                       layout=tp_layout(cfg, model))


def _strategy(name, **kw):
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=2, strategy=name, **kw)
    return dcfg, make_strategy(dcfg)


@pytest.mark.parametrize("name,kw,match", [
    ("streaming", dict(num_fragments=2), "'streaming' strategy"),
    ("overlapped", dict(sync_delay=1), "'overlapped' strategy"),
    ("pipelined", dict(num_fragments=2, sync_delay=1),
     "'pipelined' strategy"),
    ("gossip", {}, "'gossip' strategy"),
    ("async_gossip", dict(h_jitter=1), "'async_gossip' strategy"),
    ("ddp_compressed", {}, "'ddp_compressed' strategy"),
    ("adaptive_h", {}, "AdaptiveH"),
    ("faults", {}, "fault layer"),
    ("drift_aware", {}, "drift-aware")])
def test_distributed_run_refuses_what_tp_does_not_hold(name, kw, match,
                                                       params, request):
    """Each strategy or option a model axis does not hold is refused by
    name before any collective.  Drift-aware averaging is held: the
    ranks' ``TP_DRIFT`` run through ``DistTrainer.run`` on (pod 2, model
    2) ends within ``ATOL`` of one process's (its cosines summed over the
    model shards), the model ranks of a worker with equal losses."""
    if name == "drift_aware":
        four = request.getfixturevalue("four")
        ref = ranks.run_case(ranks.TP_DRIFT, params, cfg=CFG)
        layout = four[0]["layout"]
        for w in (0, 1):
            pair = _model_pair(four, w)
            got = gather([r["drift"]["global"] for r in pair], layout)
            _close(got, ref["global"], ATOL, "drift-aware vs one process")
            assert pair[0]["drift"]["hist"]["loss"] == \
                pair[1]["drift"]["hist"]["loss"]
            assert pair[0]["drift"]["hist"]["sync_steps"] == [1]
        return
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
        dcfg, strategy = _strategy("diloco")
        faults = FaultSchedule.from_spec("crash:1@1,rejoin:1@2")
    else:
        dcfg, strategy = _strategy(name, **kw)
    dt = DistTrainer(lambda p, b: lm_loss(p, b, CFG),
                     OptimizerConfig(**ranks.opt_of(8)), dcfg, strategy,
                     PodReplicate(_fake_mesh()))
    with pytest.raises(NotImplementedError, match=match):
        dt.run(None, None, 2, faults=faults)


@pytest.mark.parametrize("kind", ["moe", "ssm", "hybrid", "audio", "vlm"])
def test_other_families_refuse_a_model_axis(kind):
    from torch_parity import port_cfg
    cfg = port_cfg(tiny_cfg(kind))
    with pytest.raises(NotImplementedError, match="other families"):
        init_process_mesh(2, 1, 2, backend="gloo", device="cpu", rank=0,
                          world_size=4, cfg=cfg)
    with tp.use(_fake_mesh()):
        with pytest.raises(NotImplementedError, match="other families"):
            forward_hidden(init_params(cfg, seed=0), {}, cfg)


def test_serving_refuses_a_model_axis(params):
    """The ``Engine`` runs on no mesh, as the reference's; the static
    serve step runs over a model axis (``test_torch_tp_serving.py``)."""
    p = unflatten(params)
    with tp.use(_fake_mesh()):
        with pytest.raises(NotImplementedError, match="runs on no mesh"):
            Engine(CFG, p, device="cpu")


def test_model_axis_needs_its_config_and_shards_need_an_axis(params):
    with pytest.raises(ValueError, match="needs the model config"):
        init_process_mesh(1, 1, 2, backend="gloo", device="cpu", rank=0,
                          world_size=2)
    own = shard(params, tp_layout(CFG, 2), 0, 2)
    batch = ranks._tensors(ranks.dataset().batch(0, 2, seed=0))
    with pytest.raises(ValueError, match="no model axis is active"):
        lm_loss(unflatten(own), batch, CFG)


@pytest.mark.parametrize("method,kw,match", [
    ("streaming", {}, "--method streaming"),
    ("gossip", {}, "--method gossip"),
    ("ddp", dict(grad_compress="int8"), "compressed ddp"),
    ("diloco", dict(adaptive_h=True), "--adaptive-h"),
    ("diloco", dict(fault_schedule="crash:1@1"), "--fault-schedule"),
    ("diloco", dict(drift_aware=True), "--drift-aware")])
def test_cli_refuses_what_tp_does_not_hold(method, kw, match):
    """``run_ranks_pipeline`` (the CLI's path) refuses these before it
    starts a rank.  ``--drift-aware`` runs: the tiny pipeline's DiLoCo as
    (pod 2, model 2) ranks, its stages ending on finite losses with the
    base stage's two rounds on the f32 wire."""
    if kw.get("drift_aware"):
        res = train.run_ranks_pipeline(
            2, 1, "gloo", 2, method=method, arch="tiny", workers=2,
            steps={"base": 2, "mid": 1, "sft": 1}, per_worker_batch=2,
            seq_len=32, eval_after_each_stage=False, device="cpu", **kw)
        stages = res["stages"]
        assert all(np.isfinite(stages[s]["loss_last"]) for s in stages)
        assert stages["base"]["port"]["syncs"] == 2
        assert set(stages["base"]["port"]["wire_bytes"]) == {"f32"}
        return
    with pytest.raises(NotImplementedError, match=match):
        train.run_ranks_pipeline(2, 1, "gloo", 2, method=method, workers=2,
                                 device="cpu", **kw)


def test_cli_refuses_the_other_families():
    with pytest.raises(NotImplementedError, match="other families"):
        train.run_ranks_pipeline(2, 1, "gloo", 2, method="diloco",
                                 workers=2, device="cpu",
                                 arch="mamba2-1.3b")


def test_one_model_rank_is_the_mesh_as_it_was():
    """``model`` 1 keeps the (pod, data) mesh: the rank order, no model
    group, no layout, and the trainers see no model axis."""
    m = ProcessMesh(pod=2, data=2, rank=3, backend="gloo",
                    device=torch.device("cpu"))
    assert (m.pod_index, m.data_index, m.model_index) == (1, 1, 0)
    assert m.rank_of(1, 1, 0) == 3 and m.model_group is None
    assert PodReplicate(m).tp is None
    t = _fake_mesh(pod=2, data=2, model=2)
    t.rank = 5
    assert (t.pod_index, t.data_index, t.model_index) == (1, 0, 1)
    assert t.rank_of(1, 0, 1) == 5 and PodReplicate(t).tp is t
    with tp.use(m):
        assert tp.active() is None and m.split_dim("layers/mlp/w_up") is None


def test_cli_runs_hybrid_with_a_model_axis():
    """``run_ranks_pipeline`` (the CLI's ``--pods 2 --model-procs 2``)
    trains the tiny pipeline's hybrid as 4 ranks: the DiLoCo base stage
    on (pod 2, model 2), then DDP over the data view (data 2, model 2),
    each stage ending on the gathered one-process parameters; rank 0's
    wire bytes are its shards' f32 payload a sync."""
    res = train.run_ranks_pipeline(
        2, 1, "gloo", 2, method="hybrid", arch="tiny", workers=2,
        steps={"base": 2, "mid": 1, "sft": 1}, per_worker_batch=2,
        seq_len=32, eval_after_each_stage=False, device="cpu")
    stages = res["stages"]
    assert [stages[s]["method"] for s in ("base", "mid", "sft")] == \
        ["diloco", "ddp", "ddp"]
    assert all(np.isfinite(stages[s]["loss_last"]) for s in stages)
    base = stages["base"]["port"]
    assert base["syncs"] == 2 and set(base["wire_bytes"]) == {"f32"}
    vocab = train.build_pipeline(seq_len=32)[1].vocab_size
    cfg = train.make_model("tiny", True, vocab)
    layout = tp_layout(cfg, 2)
    n = sum(math.prod(s) // (2 if layout[k] is not None else 1)
            for k, s in param_shapes(cfg).items())
    assert base["wire_bytes"]["f32"] == 2 * 4 * n
