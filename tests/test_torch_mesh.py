"""The port's launch layer against the JAX package's, host logic only (no
process, no device, nothing compiled): ``models.sharding.spec_for`` over
the reference's cases and random names, dims, meshes and profiles; the
profiles and ``auto_profile``; ``tp_kv_repeat``, ``long_context_variant``,
``decode_cache_capacity`` and ``input_specs`` for every arch id and
shape; ``flops_per_device`` / ``bytes_per_device`` exactly; parameter
names and shapes against ``abstract_params``; the per-device bytes of the
abstract DiLoCo and DDP states under the reference's ``spec_for`` on the
same shape-only mesh; the step factories; and the dry-run CLI, whose JSON
``comm_sim.load_calibration`` reads."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro.launch import analytic as jax_analytic
from repro.launch import dryrun_lib as jax_dryrun
from repro.launch import state as jax_state
from repro.models import sharding as jax_sharding
from repro.models.transformer import abstract_params as jax_abstract_params
from repro_torch import configs
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.launch import analytic, comm_sim, dryrun, dryrun_lib, mesh
from repro_torch.launch import state, steps
from repro_torch.models import (decode_step_lm, forward_lm, init_decode_cache,
                                init_params, param_names, param_shapes)
from repro_torch.models import sharding
from torch_parity import port_cfg

torch.set_num_threads(1)

IDS = configs.ALL_IDS
SHAPE_NAMES = list(configs.SHAPES)


class FakeMesh:
    """A mesh by its shape alone, as both packages' ``spec_for`` read it."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _is_names(x):
    return isinstance(x, tuple) and all(n is None or isinstance(n, str)
                                        for n in x)


# ---------------------------------------------------------------------------
# spec_for
# ---------------------------------------------------------------------------

def _spec_cases():
    """The reference's ``test_launch_units`` cases, then random ones."""
    cases = [({"data": 16, "model": 16}, ("batch", "seq", "heads"),
              (256, 4096, 25), None),
             ({"data": 16, "model": 16}, ("batch", "seq", "heads"),
              (256, 4096, 32), None),
             ({"data": 16, "model": 16}, ("model", "ffn"), (1024, 4096),
              None)]
    rng = np.random.default_rng(0)
    names = list(sharding.DEFAULT_RULES) + [None, "pod", "kv_seq", "other"]
    sizes = (1, 2, 3, 4, 6, 8, 16, 25, 32, 40, 64, 256, 4096)
    meshes = ({"data": 32, "model": 8}, {"pod": 2, "data": 32, "model": 8},
              {"data": 16, "model": 16}, {"data": 4, "model": 2},
              {"pod": 3, "data": 2, "model": 4}, {"data": 1, "model": 1})
    profiles = [None] + sorted(dryrun_lib.PROFILES) + ["kv_seq", "pod"]
    for _ in range(40):
        nd = int(rng.integers(1, 5))
        prof = profiles[int(rng.integers(len(profiles)))]
        cases.append((meshes[int(rng.integers(len(meshes)))],
                      tuple(names[int(i)] for i in
                            rng.integers(0, len(names), nd)),
                      tuple(int(sizes[int(i)]) for i in
                            rng.integers(0, len(sizes), nd)), prof))
    return cases


def _rules(prof):
    if prof is None:
        return None
    if prof == "kv_seq":
        return {"kv_seq": ("model",)}
    if prof == "pod":
        return {"batch": ("data",), "pod": ("pod",)}
    return dryrun_lib.PROFILES[prof]


@pytest.mark.parametrize("mesh_shape,names,dims,prof", _spec_cases())
def test_spec_for_matches_the_reference(mesh_shape, names, dims, prof):
    """The same spec (the reference's PartitionSpec entries), with and
    without dims (the divisibility fallback), each mesh axis used once;
    and ``local_shape`` divides each dim by its axes."""
    m = FakeMesh(mesh_shape)
    with sharding.sharding_ctx(m, _rules(prof)), \
            jax_sharding.sharding_ctx(m, _rules(prof)):
        for d in (dims, None):
            got = sharding.spec_for(names, d)
            assert got == tuple(jax_sharding.spec_for(names, d)), (d, got)
        spec = sharding.spec_for(names, dims)
        assert sharding.active_mesh() is m
    axes = [a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)]
    assert len(axes) == len(set(axes))
    shard = sharding.local_shape(dims, spec, m)
    for n, s, e in zip(dims, shard, spec):
        ways = 1
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            ways *= mesh_shape[a]
        assert s * ways == n
    assert sharding.spec_for(names, dims) == ()        # no mesh outside


def test_default_rules_and_profiles_are_the_reference():
    assert sharding.DEFAULT_RULES == jax_sharding.DEFAULT_RULES
    assert dryrun_lib.PROFILES == jax_dryrun.PROFILES


# ---------------------------------------------------------------------------
# Configs and shapes
# ---------------------------------------------------------------------------

def test_shapes_are_the_reference():
    assert list(configs.SHAPES) == list(jax_base.SHAPES)
    for name, s in configs.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            jax_base.SHAPES[name])
        assert configs.shape_by_name(name) is s
    assert configs.LONG_CONTEXT_WINDOW == jax_registry.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("arch", IDS)
def test_shape_helpers_match_the_reference(arch):
    """``long_context_variant``, ``decode_cache_capacity``, ``tp_kv_repeat``
    (tp 8 and 16) and ``auto_profile`` (tp 8 and 16, 256 and 512 chips)
    give the reference's results; ``input_specs`` its shapes and dtypes
    (f32 and bf16 compute), on ``meta``."""
    cfg, jcfg = configs.get_config(arch), jax_registry.get_config(arch)
    assert dataclasses.asdict(configs.long_context_variant(cfg)) == \
        dataclasses.asdict(jax_registry.long_context_variant(jcfg))
    for tp in (8, 16):
        assert dataclasses.asdict(state.tp_kv_repeat(cfg, tp)) == \
            dataclasses.asdict(jax_state.tp_kv_repeat(jcfg, tp))
    for name in SHAPE_NAMES:
        s, js = configs.SHAPES[name], jax_base.SHAPES[name]
        for c, jc in ((cfg, jcfg), (configs.long_context_variant(cfg),
                                    jax_registry.long_context_variant(jcfg))):
            assert configs.decode_cache_capacity(c, s) == \
                jax_registry.decode_cache_capacity(jc, js)
        for tp in (8, 16):
            for chips in (256, 512):
                assert dryrun_lib.auto_profile(cfg, s, tp, chips) == \
                    jax_dryrun.auto_profile(jcfg, js, tp, chips)
        for dt in ("float32", "bfloat16"):
            got = configs.input_specs(cfg.with_(compute_dtype=dt), s,
                                      batch_override=8 if dt == "float32"
                                      else None)
            want = jax_registry.input_specs(
                jcfg.with_(compute_dtype=dt), js,
                batch_override=8 if dt == "float32" else None)
            assert list(got) == list(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), k
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k


@pytest.mark.parametrize("arch", IDS)
def test_analytic_flops_and_bytes_equal_the_reference(arch):
    """Every term of ``flops_per_device`` and ``bytes_per_device`` equals
    the reference's exactly, for each shape (and its long-context
    variant), remat on and off, 256 and 512 chips, with a cache
    capacity; and ``attention_kv_bytes``."""
    assert analytic.TRAIN_MULT == jax_analytic.TRAIN_MULT
    cfg, jcfg = configs.get_config(arch), jax_registry.get_config(arch)
    for name in SHAPE_NAMES:
        s, js = configs.SHAPES[name], jax_base.SHAPES[name]
        for c, jc in ((cfg, jcfg), (configs.long_context_variant(cfg),
                                    jax_registry.long_context_variant(jcfg))):
            for chips in (256, 512):
                for remat in (True, False):
                    assert analytic.flops_per_device(c, s, chips, remat) == \
                        jax_analytic.flops_per_device(jc, js, chips, remat)
                for cap in (0, 8192):
                    assert analytic.bytes_per_device(
                        c, s, chips, cache_capacity=cap) == \
                        jax_analytic.bytes_per_device(
                            jc, js, chips, cache_capacity=cap)
    assert analytic.attention_kv_bytes(cfg, 4096, 8) == \
        jax_analytic.attention_kv_bytes(jcfg, 4096, 8)


@pytest.mark.parametrize("arch", IDS)
def test_param_names_and_shapes_match_abstract_params(arch):
    """Each manifest path's logical names and shape equal those of the
    reference's ``abstract_params`` (its ``eval_shape``), on the reduced
    config."""
    jcfg = jax_registry.get_reduced(arch)
    sds, jnames = jax_abstract_params(jcfg)
    flat = jax.tree_util.tree_flatten_with_path(
        jnames, is_leaf=_is_names)[0]
    want_names = {"/".join(str(getattr(k, "key", k)) for k in p): n
                  for p, n in flat}
    want_shapes = {"/".join(str(getattr(k, "key", k)) for k in p):
                   tuple(leaf.shape) for p, leaf in
                   jax.tree_util.tree_flatten_with_path(sds)[0]}
    cfg = port_cfg(jcfg)
    assert param_names(cfg) == want_names
    assert param_shapes(cfg) == want_shapes
    params, names = state.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in params.values())
    assert names == want_names


def _jax_bytes(sds, names, m):
    total = [0]

    def add(n, s):
        spec = jax_sharding.spec_for(n, s.shape, m)
        shard = sharding.local_shape(s.shape, tuple(spec), m)
        total[0] += int(np.prod(shard, dtype=np.int64)) * s.dtype.itemsize
        return n

    jax.tree.map(add, names, sds, is_leaf=_is_names)
    return total[0]


MESHES = {"production_multi_pod": {"pod": 2, "data": 32, "model": 8},
          "small": {"pod": 2, "data": 4, "model": 2}}


@pytest.mark.parametrize("arch", IDS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_abstract_state_bytes_per_device_match_the_reference(arch,
                                                             mesh_name):
    """The per-device bytes of the abstract DiLoCo state (K 2, its worker
    rows on ``pod``) and of the DDP train state, under the reference's
    2d profile with the worker dim on ``pod``, equal the reference's
    state under its own ``spec_for`` on the same shape-only mesh (its
    ``eval_shape``; nothing compiled)."""
    jcfg = jax_registry.get_reduced(arch)
    cfg = port_cfg(jcfg)
    m = FakeMesh(MESHES[mesh_name])
    opt, jopt = OptimizerConfig(), jax_base.OptimizerConfig()
    rules = {"pod": ("pod",), "batch": ("data",)}
    with sharding.sharding_ctx(m, rules), \
            jax_sharding.sharding_ctx(m, rules):
        st, names = state.abstract_diloco_state(
            cfg, opt, DiLoCoConfig(num_workers=2))
        jst, jnames = jax_state.abstract_diloco_state(
            jcfg, jopt, jax_base.DiLoCoConfig(num_workers=2))
        assert state.state_bytes(st, names, m) == _jax_bytes(jst, jnames, m)
        for field in ("worker_params", "inner_opt"):
            got = state.state_bytes(getattr(st, field), getattr(names, field),
                                    m)
            want = _jax_bytes(getattr(jst, field), getattr(jnames, field), m)
            assert got == want, field
        tst, tnames = state.abstract_train_state(cfg, opt)
        jtst, jtnames = jax_state.abstract_train_state(jcfg, jopt)
        assert state.state_bytes(tst, tnames, m) == \
            _jax_bytes(jtst, jtnames, m)


def test_names_trees_and_decode_cache():
    """``add_leading``, ``opt_state_names`` (an AdamW moment and a Muon
    buffer take their parameter's names, scalars none),
    ``shardings_from_names`` and the decode cache's names in the port's
    layouts."""
    cfg = port_cfg(tiny_cfg("dense"))
    params, names = state.abstract_params(cfg)
    lead = state.add_leading(names, "pod")
    assert lead["layers/attn/wq"] == ("pod", "stack", "fsdp", "heads")
    opt = state.opt_state_names(
        {"adamw": {"m": {"embed/table": params["embed/table"]}},
         "muon": {"mu": {"layers/attn/wq": params["layers/attn/wq"]}},
         "t": torch.empty((), device="meta")}, names)
    assert opt["adamw"]["m"]["embed/table"] == ("vocab", "fsdp")
    assert opt["muon"]["mu"]["layers/attn/wq"] == ("stack", "fsdp", "heads")
    assert opt["t"] == ()
    m = FakeMesh({"data": 2, "model": 2})
    specs = state.shardings_from_names(names, params, m)
    assert specs["layers/attn/wq"] == (None, "data", "model")
    cache = init_decode_cache(cfg, 4, 32, device="meta")
    cnames = state.decode_cache_names(cache)
    assert cnames["attn"]["k"] == ("stack", "batch", "kv_heads", "kv_seq",
                                   None)
    assert cnames["attn"]["pos"] == ("stack", "batch", "kv_seq")
    nbytes = {k: t.numel() * t.element_size()
              for k, t in cache["attn"].items() if torch.is_tensor(t)}
    # K / V: batch over data, KV heads over model; pos: batch over data
    assert state.state_bytes(cache, cnames, m) == \
        (nbytes["k"] + nbytes["v"]) // 4 + nbytes["pos"] // 2


# ---------------------------------------------------------------------------
# Meshes and the dry run
# ---------------------------------------------------------------------------

def test_production_meshes_and_h100_constants():
    """(data 32, model 8) and (pod, 32, 8): 256 cards a pod, the model
    axis inside one 8-card NVLink domain; the data sheet's rates; the
    comm simulator reads its constants from here."""
    single = mesh.make_production_mesh()
    multi = mesh.make_production_mesh(multi_pod=True, num_pods=3)
    assert single.shape == {"data": 32, "model": 8} and single.size == 256
    assert list(multi.shape.items()) == [("pod", 3), ("data", 32),
                                         ("model", 8)]
    assert mesh.make_host_mesh(2, 1).shape == {"data": 2, "model": 1}
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.HBM_PER_CHIP) == \
        (989e12, 3.35e12, 80e9)
    assert mesh.ICI_BW == mesh.NVLINK_BW == 450e9
    assert mesh.DCN_BW == comm_sim.LINK_BW == 12.5e9
    assert comm_sim.PEAK_FLOPS_BF16 is mesh.PEAK_FLOPS_BF16
    assert comm_sim.HBM_BW is mesh.HBM_BW


def test_dryrun_cli_json_feeds_load_calibration(tmp_path, capsys):
    """``--all --multi-pod --json-out`` resolves 40 combinations in the
    reference's JSON layout (compiled-only fields None); the outer step
    on the int8 wire reports each device's payload shard at 1 byte an
    element plus a scale a leaf, all of it across pods, the reference's
    leaves and names giving the same count; ``load_calibration`` reads
    the step time from the first and the sync bytes from the second."""
    inner = tmp_path / "inner.json"
    assert dryrun.main(["--all", "--multi-pod", "--json-out",
                        str(inner)]) == 0
    rows = json.loads(inner.read_text())
    assert len(rows) == len(jax_registry.ARCH_IDS) * len(SHAPE_NAMES)
    assert {r["step_kind"] for r in rows} == {"diloco-inner", "prefill",
                                             "decode"}
    for r in rows:
        assert r["lower_s"] is None and r["memory"]["temp_size_in_bytes"] \
            is None
        assert r["memory"]["argument_size_in_bytes"] > 0
        assert r["analytic"]["total_flops"] > 0
    cal = comm_sim.load_calibration(str(inner), arch=rows[0]["arch"])
    r0 = rows[0]
    assert cal.step_time_s == max(
        r0["analytic"]["total_flops"] / mesh.PEAK_FLOPS_BF16,
        r0["analytic"]["bytes"] / mesh.HBM_BW)

    outer = tmp_path / "outer.json"
    assert dryrun.main(["--outer", "--delta-dtype", "int8", "--json-out",
                        str(outer)]) == 0
    (o,) = json.loads(outer.read_text())
    jcfg = jax_registry.get_config("nanochat-d20").with_(
        param_dtype="bfloat16", vocab_pad_multiple=256)
    m = FakeMesh({"pod": 2, "data": 32, "model": 8})
    sds, jnames = jax_abstract_params(jcfg)
    want = 0
    with jax_sharding.sharding_ctx(m, {"pod": ("pod",)}):
        for n, s in zip(jax.tree.leaves(jnames, is_leaf=_is_names),
                        jax.tree.leaves(sds)):
            spec = tuple(jax_sharding.spec_for(n, s.shape, m))
            want += int(np.prod(sharding.local_shape(s.shape, spec, m))) + 4
    c = o["collectives_weighted"]
    assert c["wire_bytes_per_device"] == c["cross_pod_bytes_per_device"] \
        == want
    cal = comm_sim.load_calibration(str(outer))
    assert cal.sync_bytes_per_worker == want and cal.sync_dtype == "int8"
    res = dryrun_lib.dryrun_outer_step("nanochat-d20", verbose=False)
    assert res.roofline()["bound"] == "collective"
    assert "combinations resolved" in capsys.readouterr().out


@pytest.mark.parametrize("profile", ["2d", "auto"])
def test_dryrun_single_pod_train_arguments(profile):
    """A single-pod train step's argument bytes are its DDP state's and
    batch's shards under the profile's rules (``auto``: qwen's dp, every
    parameter whole on a card); the roofline names a bound."""
    res = dryrun_lib.dryrun_combo(
        "qwen1.5-0.5b", "train_4k",
        rules={"__auto__": True} if profile == "auto" else {},
        verbose=False)
    rl = res.roofline()
    assert rl["bound"] in ("compute", "memory") and rl["collective_s"] is None
    if profile == "auto":
        cfg = configs.get_config("qwen1.5-0.5b").with_(
            param_dtype="bfloat16", vocab_pad_multiple=256)
        n = sum(int(np.prod(s)) for s in param_shapes(cfg).values())
        assert res.memory["argument_size_in_bytes"] > n * 2


# ---------------------------------------------------------------------------
# The step factories
# ---------------------------------------------------------------------------

def test_step_factories_on_the_cpu():
    """``make_inner_chunk`` over a (T, K) batch gives the per-step inner
    steps' losses and parameters bit for bit; ``make_diloco_steps`` and
    ``make_train_step`` run; prefill is the forward's last position and
    serve one ``decode_step_lm``."""
    cfg = port_cfg(tiny_cfg("dense"))
    opt = OptimizerConfig(total_steps=4, warmup_steps=1)
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=2)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2, 2, 9)))
    batches = {"tokens": toks[..., :-1].contiguous(),
               "labels": toks[..., 1:].contiguous()}
    params = init_params(cfg, seed=0)
    from repro_torch.core import DiLoCoTrainer
    from repro_torch.models import lm_loss
    tr = DiLoCoTrainer(lambda p, b: lm_loss(p, b, cfg), opt, dcfg)
    st, losses = steps.make_inner_chunk(cfg, opt, dcfg)(tr.init(params),
                                                        batches)
    inner, outer = steps.make_diloco_steps(cfg, opt, dcfg)
    ref = tr.init(params)
    for i in range(2):
        ref, loss = inner(ref, {k: v[i] for k, v in batches.items()})
        assert torch.equal(loss, losses[i])
    for a, b in zip(st.worker_params, ref.worker_params):
        assert all(torch.equal(a[k], b[k]) for k in a)
    ref = outer(ref)
    assert int(ref.outer.t) == 1
    from repro_torch.core import DDPTrainer
    ts = steps.make_train_step(cfg, opt)
    dst, loss = ts(DDPTrainer(None, opt).init(params),
                   {k: v[0, 0] for k, v in batches.items()})
    assert torch.isfinite(loss) and int(dst.step) == 1
    prefill = steps.make_prefill_step(cfg)
    b = {"tokens": batches["tokens"][0, 0]}
    assert torch.equal(prefill(params, b), forward_lm(params, b, cfg)[0][:,
                                                                         -1])
    serve = steps.make_serve_step(cfg)
    tok = {"token": b["tokens"][:, :1], "position": 0}
    got, _ = serve(params, init_decode_cache(cfg, 2, 8), tok)
    with torch.no_grad():
        want, _ = decode_step_lm(params, init_decode_cache(cfg, 2, 8), tok,
                                 cfg)
    assert torch.equal(got, want[:, 0])
