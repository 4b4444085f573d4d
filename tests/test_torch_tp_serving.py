"""Tensor-parallel serving over the ``model`` axis of the port's process
mesh (``launch/steps.py`` ``make_serve_step`` / ``make_prefill_step``
with ``mesh=``, ``models/sharding.py`` ``serve_layout``), on the CPU:
four gloo ranks spawned once (``tests/torch_mesh_ranks.py``
``tp_serving4``) as (data 2, model 2) and (1, 1, 4) meshes, at the
tensor-parallel tests' tiny configs: 4 heads and 2 KV heads
(head-parallel at model 2, and at model 4 after the KV repeat) and 3
heads and 1 KV head (``kv_seq`` at model 2 and 4).

A prompt fed token by token and 12 decode tokens, teacher-forced,
through an 8-slot ring that wraps across the ``kv_seq`` ranks' slots.
Tolerances: the one-process port within the tensor-parallel tests'
``ATOL`` 1e-6 (a row-parallel product summed by an all-reduce is not bit
for bit with one GEMM), the JAX package within their ``JAX_ATOL`` 2e-5.
What is exact is held exactly: ``vocab_parallel_argmax`` against
``torch.argmax``, ``gather_cache(shard_cache(c))``, the gathered
partials' combine against the split mirror, the shapes and bytes the
dry run resolves against a live rank's.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from helpers import tiny_cfg
from repro.checkpoint.checkpoint import _path_str
from repro.launch import steps as jax_steps
from repro.models import build_model
from repro.models.transformer import init_params as jax_init
from repro_torch.configs import NANOCHAT_D20
from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.decode_attention import (
    combine_partials, decode_attention_partials,
    decode_attention_partials_plain)
from repro_torch.kernels.decode_attention.ref import (
    combine_partials as combine_partials_plain, decode_attention_split_plain)
from repro_torch.launch.dryrun_lib import dryrun_combo
from repro_torch.launch.mesh import ProcessMesh, make_host_mesh
from repro_torch.launch.state import (abstract_params, decode_cache_names,
                                      tp_kv_repeat)
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.sharding import (gather_cache, local_shape,
                                         repeat_kv_heads, serve_layout,
                                         shard, shard_cache, sharding_ctx,
                                         spec_for, tp_layout)
from repro_torch.models.transformer import (decode_step_lm, decode_step_paged,
                                            flatten, forward_lm,
                                            init_decode_cache, unflatten)
from repro_torch.serving import Engine
from torch_parity import port_cfg, port_params

torch.set_num_threads(1)

JOIN_S = 240.0
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
JCFGS = {"tp_cfg": tiny_cfg("dense", vocab_size=128),
         "tp_cfg3": tiny_cfg("dense", vocab_size=128, num_heads=3,
                             num_kv_heads=1, head_dim=16)}
CFGS = {"tp_cfg": ranks.tp_cfg(), "tp_cfg3": ranks.tp_cfg3()}
ATOL = 1e-6        # against one process (test_torch_tensor_parallel.py)
JAX_ATOL = 2e-5    # against the JAX package (the same file's)
MODES = {"heads2": "heads", "heads4": "heads", "kv_seq2": "kv_seq",
         "kv_seq4": "kv_seq"}


@pytest.fixture(scope="module")
def jparams():
    return {k: jax_init(c, jax.random.key(0))[0] for k, c in JCFGS.items()}


@pytest.fixture(scope="module")
def params(jparams):
    return {k: flatten(port_params(JCFGS[k], p)) for k, p in jparams.items()}


@pytest.fixture(scope="module")
def four(params, tmp_path_factory):
    from repro_torch.launch.mesh import run_ranks
    tmp = tmp_path_factory.mktemp("tp_serve")
    torch.save(params["tp_cfg"], tmp / "params.pt")
    torch.save(params["tp_cfg3"], tmp / "params3.pt")
    run_ranks(ranks.tp_serving4, 4, str(tmp), timeout_s=JOIN_S)
    return [torch.load(tmp / f"serve_rank{r}.pt") for r in range(4)]


_ONE = {}


def one_process(name, params):
    """The one-process port's serve run of ``SERVE_CASES[name]``'s config
    (cached): each step's logits, the final cache, the prompt's prefill
    logits."""
    cname = ranks.SERVE_CASES[name][0]
    if cname not in _ONE:
        cfg, p = CFGS[cname], unflatten(params[cname])
        tokens, positions = ranks.serve_inputs()
        cache = init_decode_cache(cfg, ranks.SERVE_B, ranks.SERVE_CAP)
        step = make_serve_step(cfg)
        logits = []
        for t in range(tokens.shape[1]):
            out, cache = step(p, cache, {
                "token": torch.from_numpy(tokens[:, t:t + 1]),
                "position": torch.from_numpy(positions[t])})
            logits.append(out)
        prefill = make_prefill_step(cfg)(p, {"tokens": torch.from_numpy(
            tokens[:, :ranks.SERVE_PROMPT])})
        _ONE[cname] = (torch.stack(logits), cache, prefill)
    return _ONE[cname]


_JAX = {}


def jax_run(name, jparams):
    """The JAX package's one-process serve and prefill steps (cached)."""
    cname = ranks.SERVE_CASES[name][0]
    if cname not in _JAX:
        model = build_model(JCFGS[cname])
        tokens, positions = ranks.serve_inputs()
        cache = model.init_cache(ranks.SERVE_B, ranks.SERVE_CAP)
        serve = jax.jit(jax_steps.make_serve_step(model))
        logits = []
        for t in range(tokens.shape[1]):
            out, cache = serve(jparams[cname], cache, {
                "token": jnp.asarray(tokens[:, t:t + 1]),
                "position": jnp.asarray(positions[t])})
            logits.append(np.asarray(out))
        prefill = jax_steps.make_prefill_step(model)(
            jparams[cname], {"tokens": jnp.asarray(
                tokens[:, :ranks.SERVE_PROMPT])})
        _JAX[cname] = (np.stack(logits), np.asarray(prefill))
    return _JAX[cname]


def _groups(four, name):
    """{data index: that data rank's model ranks' results, in model-index
    order}."""
    out = {}
    for r in four:
        x = r["cases"][name]
        out.setdefault(x["index"][1], []).append(x)
    return {d: sorted(g, key=lambda x: x["index"][2])
            for d, g in out.items()}


def _rows(name, d):
    data = ranks.SERVE_CASES[name][1][1]
    n = ranks.SERVE_B // data
    return slice(d * n, (d + 1) * n)


def _gathered(four, name, key):
    """The whole (..., B, V) of ``key`` ("logits" or "prefill"): each
    data rank's rows, its model ranks' vocab columns joined."""
    parts = [torch.cat([x[key] for x in g], dim=-1)
             for _, g in sorted(_groups(four, name).items())]
    return torch.cat(parts, dim=-2)


def _live(positions):
    """(T, B) rows with a live key (a query at -1 has none)."""
    return positions >= 0


def _fake_mesh(model, cfg=None):
    return ProcessMesh(pod=1, data=1, rank=0, backend="gloo",
                       device=torch.device("cpu"), model=model,
                       layout=tp_layout(cfg or CFGS["tp_cfg"], model))


# ---------------------------------------------------------------------------
# The layout (host only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,model,mode,kv", [
    (CFGS["tp_cfg"], 2, "heads", 2), (CFGS["tp_cfg"], 4, "heads", 4),
    (CFGS["tp_cfg3"], 2, "kv_seq", 1), (CFGS["tp_cfg3"], 4, "kv_seq", 1),
    (NANOCHAT_D20, 2, "heads", 10), (NANOCHAT_D20, 4, "kv_seq", 10)])
def test_serve_layout_follows_the_reference_rules(cfg, model, mode, kv):
    """Head-parallel where the KV heads divide ``model`` after
    ``tp_kv_repeat`` (the tiny 2 KV heads repeat to 4 at model 4), else
    ``kv_seq`` with attention whole (3 heads of 1 KV; d20's 10 at 4); the
    layout is ``tp_layout`` of the repeated config."""
    got, layout = serve_layout(cfg, model)
    rep = tp_kv_repeat(cfg, model)
    assert (got, rep.num_kv_heads) == (mode, kv)
    assert layout == tp_layout(rep, model)
    whole = all(layout[f"layers/attn/{w}"] is None
                for w in ("wq", "wk", "wv", "wo"))
    assert whole == (mode == "kv_seq")
    assert layout["layers/mlp/w_up"] == -1 and layout["embed/table"] == -2


def test_repeat_kv_heads_keeps_the_function(params):
    """The repeated config (4 KV heads for 2) on ``repeat_kv_heads``'
    parameters gives the original's forward and serve logits within
    1e-6; each new KV head is a copy of its query group's own."""
    cfg = CFGS["tp_cfg"]
    rep = tp_kv_repeat(cfg, 4)
    p = params["tp_cfg"]
    p4 = repeat_kv_heads(p, cfg, 4)
    hd = cfg.resolved_head_dim()
    wk = p4["layers/attn/wk"].reshape(2, 64, 4, hd)
    orig = p["layers/attn/wk"].reshape(2, 64, 2, hd)
    for j in range(4):
        assert torch.equal(wk[:, :, j], orig[:, :, j // 2])
    assert repeat_kv_heads(p, cfg, 2) is p
    tokens, positions = ranks.serve_inputs()
    want, _ = forward_lm(unflatten(p), {"tokens": torch.from_numpy(tokens)},
                         cfg)
    got, _ = forward_lm(unflatten(p4), {"tokens": torch.from_numpy(tokens)},
                        rep)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    c1 = init_decode_cache(cfg, ranks.SERVE_B, ranks.SERVE_CAP)
    c4 = init_decode_cache(rep, ranks.SERVE_B, ranks.SERVE_CAP)
    live = _live(positions)
    for t in range(tokens.shape[1]):
        batch = {"token": torch.from_numpy(tokens[:, t:t + 1]),
                 "position": torch.from_numpy(positions[t])}
        a, c1 = decode_step_lm(unflatten(p), c1, batch, cfg)
        b, c4 = decode_step_lm(unflatten(p4), c4, batch, rep)
        np.testing.assert_allclose(b[live[t]].numpy(), a[live[t]].numpy(),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode,model", [("heads", 2), ("heads", 4),
                                        ("kv_seq", 2), ("kv_seq", 4)])
def test_gather_of_shard_cache_is_the_cache(mode, model):
    """A filled one-process cache cut into the ranks' parts and joined
    back, bit for bit; a part holds its heads or its slots."""
    cfg = tp_kv_repeat(CFGS["tp_cfg"], 4)
    c = init_decode_cache(cfg, 3, 8)
    g = torch.Generator().manual_seed(3)
    for key in ("k", "v"):
        c["attn"][key].normal_(generator=g)
    c["attn"]["pos"].copy_(torch.randint(-1, 20, c["attn"]["pos"].shape,
                                         generator=g))
    c["attn"]["idx"] = 13
    parts = [shard_cache(c, mode, i, model) for i in range(model)]
    k = parts[0]["attn"]["k"]
    assert k.shape[-3 if mode == "heads" else -2] * model == \
        c["attn"]["k"].shape[-3 if mode == "heads" else -2]
    assert parts[0]["attn"].get("kv_seq", 1) == (model if mode == "kv_seq"
                                                 else 1)
    parts[0]["attn"]["pos"].fill_(-7)          # a part is a copy
    assert not bool((c["attn"]["pos"] == -7).any())
    parts[0] = shard_cache(c, mode, 0, model)
    back = gather_cache(parts)
    assert set(back["attn"]) == set(c["attn"])
    assert back["attn"]["idx"] == 13
    for key in ("k", "v", "pos"):
        assert torch.equal(back["attn"][key], c["attn"][key]), key


@pytest.mark.parametrize("name", list(ranks.SERVE_CASES))
def test_runtime_cache_part_is_what_decode_cache_names_resolve(name):
    """Each leaf of a rank's cache part (``init_decode_cache(...,
    mesh=)``) has the shape ``decode_cache_names`` resolves on a
    (data 1, model M) mesh under the reference's serve rules (``kv_seq``
    over ``model`` where the KV heads do not divide)."""
    cname, (_, _, model) = ranks.SERVE_CASES[name]
    cfg = tp_kv_repeat(CFGS[cname], model)
    whole = init_decode_cache(cfg, 4, 16, device="meta")
    part = init_decode_cache(cfg, 4, 16, device="meta",
                             mesh=_fake_mesh(model, cfg))
    mesh = make_host_mesh(1, model)
    rules = {"kv_seq": ("model",)} if MODES[name] == "kv_seq" else {}
    names = decode_cache_names(whole)
    with sharding_ctx(mesh, rules):
        for key in ("k", "v", "pos"):
            t = whole["attn"][key]
            want = local_shape(tuple(t.shape),
                               spec_for(names["attn"][key], tuple(t.shape),
                                        mesh), mesh)
            assert tuple(part["attn"][key].shape) == want, key


@pytest.mark.parametrize("cname,model", [("tp_cfg", 2), ("tp_cfg", 4),
                                         ("tp_cfg3", 2), ("tp_cfg3", 4)])
def test_dryrun_decode_bytes_are_a_live_rank(cname, model):
    """The dry run's per-device argument bytes of ``decode_32k`` on a
    (data 1, model M) mesh equal what one rank of the live serve step
    holds: its parameter shards (``repeat_kv_heads``, then ``shard`` of
    ``serve_layout``), its cache part and the step's batch, at the dry
    run's dtypes and padded vocab."""
    from repro_torch.configs.base import DECODE_32K
    from repro_torch.configs.registry import decode_cache_capacity
    res = dryrun_combo("tiny", "decode_32k", mesh=make_host_mesh(1, model),
                       cfg_override=CFGS[cname], verbose=False)
    cfg = CFGS[cname].with_(compute_dtype="bfloat16",
                            param_dtype="bfloat16", vocab_pad_multiple=256)
    rep = tp_kv_repeat(cfg, model)
    flat, _ = abstract_params(cfg)
    mode, layout = serve_layout(cfg, model)
    own = shard(repeat_kv_heads(flat, cfg, model), layout, 0, model)
    B = DECODE_32K.global_batch
    cache = init_decode_cache(rep, B, decode_cache_capacity(rep, DECODE_32K),
                              dtype=torch.bfloat16, device="meta",
                              mesh=_fake_mesh(model, rep))
    leaves = list(own.values()) + [t for k, t in cache["attn"].items()
                                   if torch.is_tensor(t)]
    live = sum(t.numel() * t.element_size() for t in leaves) + 2 * B * 4
    assert res.memory["argument_size_in_bytes"] == live


# ---------------------------------------------------------------------------
# The serve and prefill steps across the ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(ranks.SERVE_CASES))
def test_serve_steps_match_one_process(four, params, name):
    """Every step's gathered logits within ``ATOL`` of the one-process
    port's ``decode_step_lm`` (rows with a live key), and the gathered
    final caches its cache (k / v within ``ATOL`` of the leaf's largest
    magnitude, a second layer's K and V carrying the first's last-bit
    differences at values up to ~5; ``pos`` and ``idx`` exactly; after
    the KV repeat each original KV head's copies)."""
    cname, (_, data, model) = ranks.SERVE_CASES[name]
    want, cache, _ = one_process(name, params)
    got = _gathered(four, name, "logits")
    live = _live(ranks.serve_inputs()[1])
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(),
                               atol=ATOL, rtol=0)
    times = tp_kv_repeat(CFGS[cname], model).num_kv_heads // \
        CFGS[cname].num_kv_heads
    for d, g in _groups(four, name).items():
        assert all(x["mode"] == MODES[name] for x in g)
        part = gather_cache([x["cache"] for x in g])["attn"]
        whole = {k: v[:, _rows(name, d)] for k, v in cache["attn"].items()
                 if k != "idx"}
        T = ranks.SERVE_PROMPT + ranks.SERVE_DECODE
        assert part["idx"] == cache["attn"]["idx"] == T
        assert torch.equal(part["pos"], whole["pos"])
        for key in ("k", "v"):
            heads = part[key].unflatten(2, (-1, times))
            for j in range(times):
                np.testing.assert_allclose(
                    heads[:, :, :, j].numpy(), whole[key].numpy(),
                    atol=ATOL * float(whole[key].abs().max()), rtol=0,
                    err_msg=key)


@pytest.mark.parametrize("name", list(ranks.SERVE_CASES))
def test_serve_and_prefill_steps_match_jax(four, params, jparams, name):
    """The gathered serve logits against the JAX package's one-process
    ``make_serve_step``, and the prefill step's (the prompt's last
    position) against its ``make_prefill_step``, within ``JAX_ATOL``; the
    prefill against the one-process port within ``ATOL``."""
    want, want_prefill = jax_run(name, jparams)
    live = _live(ranks.serve_inputs()[1])
    got = _gathered(four, name, "logits").numpy()
    np.testing.assert_allclose(got[live], want[live], atol=JAX_ATOL, rtol=0)
    prefill = _gathered(four, name, "prefill").numpy()
    np.testing.assert_allclose(prefill, want_prefill, atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(prefill, one_process(name, params)[2].numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", list(ranks.SERVE_CASES))
def test_greedy_ids_are_argmax_of_the_gathered_logits(four, name):
    """``vocab_parallel_argmax`` on every model rank equals
    ``torch.argmax`` of the gathered logits, every step and row."""
    got = _gathered(four, name, "logits")
    for d, g in _groups(four, name).items():
        want = got[:, _rows(name, d)].argmax(-1)
        for x in g:
            assert torch.equal(x["ids"], want)


@pytest.mark.parametrize("name", list(ranks.SERVE_CASES))
def test_serve_step_collectives_are_the_model_axis(four, name):
    """A step's collectives, all on the model axis and none across a pod:
    the embedding's all-reduce, then per layer the attention's (the
    head-parallel ``wo`` reduce, or the ``kv_seq`` partials' all-gather)
    and the MLP's all-reduce; the logits stay split."""
    L = CFGS[ranks.SERVE_CASES[name][0]].num_layers
    attn = "all-reduce" if MODES[name] == "heads" else "all-gather"
    want = [("all-reduce", "model", False)] + [
        (attn, "model", False), ("all-reduce", "model", False)] * L
    for r in four:
        assert all(rec == want for rec in r["cases"][name]["records"])


@pytest.mark.parametrize("model", [2, 4])
def test_exact_parts_of_the_kv_seq_decode(four, model):
    """On the plain path the ranks' partials of their slots, gathered and
    combined, are the split mirror's output over the whole ring with the
    same 64-slot chunks, bit for bit; ``vocab_parallel_argmax`` of tied
    logits is ``torch.argmax`` (the lowest id of the ties)."""
    q, k, v, pos, q_pos = ranks.serve_ring()
    want = decode_attention_split_plain(q, k, v, pos, q_pos, chunk_keys=64)
    for r in four:
        u = r["units"][model]
        assert torch.equal(u["attention"], want)
        assert torch.equal(u["ids"], u["tied"].argmax(-1))


def test_cpu_split_ring_entries_are_their_plain_versions():
    """On CPU tensors ``decode_attention_partials`` and
    ``combine_partials`` are the plain versions (no launch counted), and
    the one-chunk case keeps its partials."""
    q, k, v, pos, q_pos = ranks.serve_ring()
    reset_launches()
    m, l, acc = decode_attention_partials(q, k[:, :, :64], v[:, :, :64],
                                          pos[:, :64].contiguous(), q_pos)
    assert m.shape == (2, 1, 3, 1) and acc.shape == (2, 1, 3, 1, 16)
    want = decode_attention_partials_plain(q, k[:, :, :64], v[:, :, :64],
                                           pos[:, :64], q_pos)
    for a, b in zip((m, l, acc), want):
        assert torch.equal(a, b)
    out = combine_partials(m, l, acc, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, combine_partials_plain(m, l, acc).bfloat16())
    assert sum(launches.values()) == 0


# ---------------------------------------------------------------------------
# The reference's partitioned serve step on four fake devices
# ---------------------------------------------------------------------------

_KV_SEQ_SNIPPET = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys, json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
sys.path.insert(0, SRCPATH)
from repro.checkpoint.checkpoint import _path_str
from repro.configs.base import ModelConfig
from repro.launch import steps
from repro.launch.dryrun_lib import _batch_shardings
from repro.launch.mesh import make_host_mesh
from repro.launch.state import decode_cache_names, shardings_from_names
from repro.models.sharding import sharding_ctx, spec_for
from repro.models.transformer import abstract_params, build_model

data = np.load(INPATH)
cfg = ModelConfig(**json.loads(CFG))
model = build_model(cfg)
mesh = make_host_mesh(1, 4)
_, pnames = abstract_params(cfg)
params = jax.tree_util.tree_map_with_path(
    lambda p, _: jnp.asarray(data["p/" + _path_str(p)]),
    abstract_params(cfg)[0])
tokens, positions = data["tokens"], data["positions"]
B, T = tokens.shape
with sharding_ctx(mesh, {"kv_seq": ("model",)}):
    cache = model.init_cache(B, CAP)
    c_names = decode_cache_names(cache)
    c_sh = shardings_from_names(c_names, cache, mesh)
    p_sh = shardings_from_names(pnames, params, mesh)
    batch = {"token": jax.ShapeDtypeStruct((B, 1), jnp.int32),
             "position": jax.ShapeDtypeStruct((B,), jnp.int32)}
    b_sh = _batch_shardings(batch, mesh)
    out_sh = NamedSharding(mesh, spec_for(("batch", "vocab"),
                                          (B, cfg.padded_vocab()), mesh))
    step = jax.jit(steps.make_serve_step(model),
                   in_shardings=(p_sh, c_sh, b_sh),
                   out_shardings=(out_sh, c_sh))
    params = jax.device_put(params, p_sh)
    cache = jax.device_put(cache, c_sh)
    logits = []
    for t in range(T):
        out, cache = step(params, cache, {
            "token": jnp.asarray(tokens[:, t:t + 1]),
            "position": jnp.asarray(positions[t])})
        logits.append(np.asarray(out))
np.save(OUTPATH, np.stack(logits))
print(json.dumps({"k": str(cache["attn"]["k"].sharding.spec),
                  "pos": str(cache["attn"]["pos"].sharding.spec),
                  "logits": str(out.sharding.spec)}))
"""


def test_kv_seq_ranks_match_the_reference_partitioned_serve_step(
        four, jparams, tmp_path):
    """The JAX package's ``make_serve_step`` jitted on a (1, 4) mesh of
    fake devices with the cache's ``kv_seq`` over ``model``
    (``shardings_from_names`` of ``decode_cache_names``), in a
    subprocess: its cache is split by slots, its logits by vocab, and
    every step's logits match the port's (1, 1, 4) ``kv_seq`` ranks'
    gathered logits within ``JAX_ATOL``."""
    cfg = JCFGS["tp_cfg3"]
    tokens, positions = ranks.serve_inputs()
    flat = {f"p/{_path_str(p)}": np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(jparams["tp_cfg3"])[0]}
    np.savez(tmp_path / "in.npz", tokens=tokens, positions=positions,
             **flat)
    code = (f"SRCPATH = {SRC!r}\nINPATH = {str(tmp_path / 'in.npz')!r}\n"
            f"OUTPATH = {str(tmp_path / 'out.npy')!r}\n"
            f"CAP = {ranks.SERVE_CAP}\n"
            f"CFG = {json.dumps(dataclasses.asdict(cfg))!r}\n"
            + _KV_SEQ_SNIPPET)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, (res.stderr[-3000:], res.stdout[-500:])
    specs = json.loads(res.stdout.strip().splitlines()[-1])
    assert "model" in specs["k"] and "model" in specs["pos"], specs
    assert "model" in specs["logits"], specs
    want = np.load(tmp_path / "out.npy")
    got = _gathered(four, "kv_seq4", "logits").numpy()
    live = _live(positions)
    np.testing.assert_allclose(got[live], want[live], atol=JAX_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# What a model axis still refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["moe", "ssm", "hybrid", "audio", "vlm"])
def test_serve_step_refuses_the_other_families(kind):
    cfg = port_cfg(tiny_cfg(kind))
    step = make_serve_step(cfg, _fake_mesh(2))
    with pytest.raises(NotImplementedError, match="other families"):
        step({}, {}, {"token": torch.zeros(1, 1, dtype=torch.long),
                      "position": 0})


def test_paged_steps_and_the_engine_refuse_a_model_axis(params):
    cfg, p = CFGS["tp_cfg"], unflatten(params["tp_cfg"])
    with tp.use(_fake_mesh(2)):
        with pytest.raises(NotImplementedError, match="runs on no mesh"):
            Engine(cfg, p, device="cpu")
        with pytest.raises(NotImplementedError, match="make_serve_step"):
            decode_step_paged(p, {"k": torch.zeros(2, 1, 4, 2, 16)}, {
                "token": torch.zeros(1, 1, dtype=torch.long),
                "position": torch.zeros(1, dtype=torch.int32),
                "block_table": torch.zeros(1, 1, dtype=torch.int32)}, cfg)


def test_a_cache_part_must_match_the_layout(params):
    """``init_decode_cache(mesh=)`` takes the served (repeated) config and
    a capacity the ranks split; ``decode_step_lm`` refuses a whole cache
    where ``kv_seq`` is served, and a ``kv_seq`` part with no model axis
    active."""
    with pytest.raises(ValueError, match="tp_kv_repeat"):
        init_decode_cache(CFGS["tp_cfg"], 2, 8, mesh=_fake_mesh(4))
    cfg3 = CFGS["tp_cfg3"]
    with pytest.raises(ValueError, match="does not split"):
        init_decode_cache(cfg3, 2, 6, mesh=_fake_mesh(4, cfg3))
    p = unflatten(params["tp_cfg3"])
    batch = {"token": torch.zeros(2, 1, dtype=torch.long), "position": 0}
    with tp.use(_fake_mesh(2, cfg3)):
        with pytest.raises(ValueError, match="kv_seq"):
            decode_step_lm(p, init_decode_cache(cfg3, 2, 8), batch, cfg3)
    part = init_decode_cache(cfg3, 2, 8, mesh=_fake_mesh(2, cfg3))
    assert part["attn"]["kv_seq"] == 2 and part["attn"]["k"].shape[-2] == 4
    with pytest.raises(ValueError, match="kv_seq"):
        decode_step_lm(p, part, batch, cfg3)
