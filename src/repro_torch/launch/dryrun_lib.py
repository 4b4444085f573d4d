"""The dry run of the port (the JAX package's ``launch/dryrun_lib.py``):
every (architecture × input shape × mesh × sharding profile), described
without allocating or compiling anything.

The reference lowers and compiles each step with XLA and reads memory,
cost and collective statistics off the compiled program.  Eager PyTorch
has no compiler to lower to, so the port resolves the same abstract
state (``launch/state.py``, on the ``meta`` device) under the same rules
(the profile or ``auto_profile``; ``kv_seq`` over ``model`` for KV heads
that do not divide it, with attention's leaves whole as the port's serve
step holds them; the worker dim on ``pod`` when training across pods)
and reports:

* per-device **argument bytes**, from each argument's shard shape;
* the analytic FLOPs and HBM bytes (``launch/analytic.py``), ``n_params``
  and ``roofline()`` at the H100 constants of ``launch/mesh.py``;
* for the outer step (``dryrun_outer_step``), the wire bytes one device
  sends across pods: its shard of its worker's payload at the codec's
  width, plus the scales (the runtime's collective log counts the same;
  the reference counts the gathered result, all K rows).

The runtime's own meshes.  ``runtime_rules`` are the rules a runtime
process mesh holds a worker under: ``"fsdp": ("data",)`` where the run
shards over ``data`` (``init_process_mesh(fsdp=True)``) and ``()`` where
its data ranks replicate the worker, the worker dim on ``pod``, and
attention whole where the head counts do not divide ``model`` (as
``models.sharding.tp_layout`` keeps it).  ``runtime_state_bytes``
resolves the abstract DDP or DiLoCo state under them at the runtime's
f32: the bytes one rank holds, which equal a rank's live state
(``launch.state.live_state_bytes``).  The one split the rules do not
name is a qkv bias's, which ``tp_layout`` cuts with its heads; no
config the runtime shards on a model axis in these checks has one.

Fields that only a compiled program has are None: ``temp_size_in_bytes``
and the other compiled sizes, ``lower_s`` / ``compile_s``, XLA's cost
analysis, and the collective bytes of a sharded inner step (the
partitioner decides those).  ``roofline()`` then leaves the collective
term out.  Host only: no device, no process group, no ``XLA_FLAGS``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import (DiLoCoConfig, ModelConfig,
                                      OptimizerConfig, ShapeConfig)
from repro_torch.configs.registry import (decode_cache_capacity, get_config,
                                          input_specs, long_context_variant,
                                          shape_by_name)
from repro_torch.core.transport import QuantizedCodec, make_codec
from repro_torch.launch.analytic import bytes_per_device, flops_per_device
from repro_torch.launch.mesh import (DCN_BW, HBM_BW, ICI_BW,
                                     PEAK_FLOPS_BF16, MeshShape,
                                     make_production_mesh)
from repro_torch.launch.state import (abstract_diloco_state, abstract_params,
                                      abstract_train_state, add_leading,
                                      decode_cache_names, state_bytes,
                                      tp_kv_repeat)
from repro_torch.models.sharding import local_shape, sharding_ctx, spec_for

# the compiled sizes the reference reads from XLA's memory analysis
_COMPILED = ("temp_size_in_bytes", "output_size_in_bytes",
             "alias_size_in_bytes", "generated_code_size_in_bytes")

_BATCH_NAMES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "patches": ("batch", None, None),
    "frames": ("batch", None, None),
    "token": ("batch", None),
    "position": ("batch",),
}


def _batch_names(batch: Dict[str, torch.Tensor], stacked: bool = False):
    return {k: (("pod",) + _BATCH_NAMES[k] if stacked else _BATCH_NAMES[k])
            for k in batch}


def _cast_params(tree, dtype):
    """Floating leaves of a (meta) tree in ``dtype``."""
    if torch.is_tensor(tree):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast_params(v, dtype) for k, v in tree.items()}
    return tree


@dataclasses.dataclass
class DryrunResult:
    arch: str
    shape: str
    mesh_desc: str
    step_kind: str
    lower_s: Optional[float]             # None: no compiler
    compile_s: Optional[float]           # None: no compiler
    memory: Dict[str, Optional[int]]     # argument bytes; compiled: None
    flops_per_device: Optional[float]    # XLA's cost analysis: None
    hlo_bytes_per_device: Optional[float]
    collectives: Optional[Dict[str, Any]]           # HLO parse: None
    collectives_weighted: Optional[Dict[str, Any]]  # outer step: the wire
    analytic: Dict[str, float]
    n_params: int

    def roofline(self) -> Dict[str, Any]:
        """Seconds of each term at the H100 constants, and the largest;
        a term the dry run cannot count is None and left out."""
        a = self.analytic
        t_compute = (a["total_flops"] / PEAK_FLOPS_BF16
                     if "total_flops" in a else None)
        t_memory = a["bytes"] / HBM_BW if "bytes" in a else None
        t_coll = cross_s = None
        c = self.collectives_weighted
        if c is not None:
            cross = c.get("cross_pod_bytes_per_device", 0)
            cross_s = cross / DCN_BW
            t_coll = (c["wire_bytes_per_device"] - cross) / ICI_BW + cross_s
        terms = [(t, n) for t, n in ((t_compute, "compute"),
                                     (t_memory, "memory"),
                                     (t_coll, "collective")) if t is not None]
        return {"compute_s": t_compute, "memory_s": t_memory,
                "collective_s": t_coll, "cross_pod_s": cross_s,
                "bound": max(terms)[1] if terms else None}


def _memory(arg_bytes: int) -> Dict[str, Optional[int]]:
    return dict({"argument_size_in_bytes": arg_bytes},
                **{k: None for k in _COMPILED})


def _finish(arch, shape_name, mesh: MeshShape, kind: str, arg_bytes: int,
            n_params: int, verbose: bool = True, cfg=None, shape=None,
            cache_capacity: int = 0, collectives=None) -> DryrunResult:
    analytic: Dict[str, float] = {}
    if cfg is not None and shape is not None:
        analytic.update(flops_per_device(cfg, shape, mesh.size,
                                         remat=cfg.remat))
        analytic.update(bytes_per_device(cfg, shape, mesh.size,
                                         cache_capacity=cache_capacity))
    res = DryrunResult(
        arch=arch, shape=shape_name,
        mesh_desc="x".join(f"{k}={v}" for k, v in mesh.shape.items()),
        step_kind=kind, lower_s=None, compile_s=None,
        memory=_memory(arg_bytes), flops_per_device=None,
        hlo_bytes_per_device=None, collectives=None,
        collectives_weighted=collectives, analytic=analytic,
        n_params=n_params)
    if verbose:
        rl = res.roofline()
        def num(v):
            return "-" if v is None else f"{v:.3e}"
        wire = (collectives or {}).get("wire_bytes_per_device")
        print(f"[dryrun] {arch:24s} {shape_name:12s} {res.mesh_desc:24s} "
              f"{kind:12s} args={arg_bytes / 2**30:7.2f}GiB "
              f"flops/dev={num(analytic.get('total_flops'))} "
              f"hbm/dev={num(analytic.get('bytes'))} "
              f"wire/dev={num(wire)} bound={rl['bound']}", flush=True)
    return res


def default_opt_cfg() -> OptimizerConfig:
    return OptimizerConfig(total_steps=10000, warmup_steps=100)


# Sharding profiles: logical-rule overrides for ``sharding_ctx``, the
# reference's table (its hillclimbs' choices per model class)
PROFILES: Dict[str, Dict] = {
    # baseline: FSDP over `data` x tensor-parallel over `model`
    "2d": {},
    # pure data-parallel: batch over every card, weights replicated
    "dp": {"batch": ("data", "model"), "fsdp": (), "model": (), "vocab": (),
           "heads": (), "kv_heads": (), "ffn": (), "expert": ()},
    # data-parallel batch + FSDP weights (the variant of "dp" that fits)
    "dp_fsdp": {"batch": ("data", "model"), "model": (), "vocab": (),
                "heads": (), "kv_heads": (), "ffn": (), "expert": (),
                "fsdp": ("data",)},
    # attention data-parallel only; the MLP and experts keep TP
    "attn_dp": {"heads": (), "kv_heads": ()},
    # experts over `model` (num_experts % tp == 0) + attention DP
    "expert_parallel": {"heads": (), "kv_heads": (), "expert": ("model",),
                        "ffn": ()},
    # Megatron-style sequence parallelism: the residual stream on `model`
    "seqpar": {"seq": ("model",)},
}


def auto_profile(cfg: ModelConfig, shape: ShapeConfig, tp: int,
                 chips: int = 256) -> Dict:
    """The reference's per-class choice: train under 1B params with a
    batch that divides the cards -> dp; under 3B -> dp_fsdp; MoE whose
    experts divide ``tp`` -> expert_parallel; train over 50B -> + seqpar;
    else the 2d baseline; decode untouched."""
    if shape.kind == "decode":
        return {}
    n = cfg.param_count()
    rules: Dict = {}
    dp_batch_ok = shape.global_batch % chips == 0
    if shape.kind == "train" and n < 1e9 and dp_batch_ok:
        return dict(PROFILES["dp"])
    if shape.kind == "train" and n < 3e9 and dp_batch_ok:
        return dict(PROFILES["dp_fsdp"])
    if cfg.num_experts and cfg.num_experts % tp == 0:
        rules.update(PROFILES["expert_parallel"])
    if n > 5e10 and shape.kind == "train":
        rules.update(PROFILES["seqpar"])
    return rules


def _dryrun_cfg(arch_id: str, cfg_override: Optional[ModelConfig] = None
                ) -> ModelConfig:
    cfg = cfg_override or get_config(arch_id)
    return cfg.with_(compute_dtype="bfloat16", param_dtype="bfloat16",
                     vocab_pad_multiple=256)


def dryrun_combo(arch_id: str, shape_name: str, *, multi_pod: bool = False,
                 mesh: Optional[MeshShape] = None,
                 rules: Optional[Dict] = None,
                 cfg_override: Optional[ModelConfig] = None,
                 verbose: bool = True) -> DryrunResult:
    """The step this (arch × shape) pair runs, resolved on the mesh:

    train_4k    -> train step (multi_pod: the DiLoCo inner step, one
                   worker a pod)
    prefill_32k -> prefill step
    decode_*    -> serve step (1 token against a seq_len cache)
    """
    shape = shape_by_name(shape_name)
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    tp = mesh.shape.get("model", 1)
    n_pods = mesh.shape.get("pod", 1)

    cfg = _dryrun_cfg(arch_id, cfg_override)
    if shape.sub_quadratic_required:
        cfg = long_context_variant(cfg)
    if shape.kind == "decode":
        cfg = tp_kv_repeat(cfg, tp)
    n_params = cfg.param_count()

    eff_rules = dict(rules or {})
    if eff_rules.pop("__auto__", False):
        eff_rules = auto_profile(cfg, shape, tp)
    if (shape.kind == "decode" and cfg.num_kv_heads % tp
            and cfg.arch_type != "ssm"):
        # KV heads that do not divide the TP axis: shard the cache's
        # sequence dim over `model` instead; the port's serve step then
        # holds attention's leaves whole on every rank (models.sharding
        # serve_layout), where spec_for would cut the heads' columns
        eff_rules.setdefault("kv_seq", ("model",))
        eff_rules.setdefault("heads", ())
        eff_rules.setdefault("kv_heads", ())
    if multi_pod and shape.kind == "train":
        # the DiLoCo inner step: the worker dim owns "pod", batch "data"
        eff_rules.setdefault("batch", ("data",))
        eff_rules.setdefault("pod", ("pod",))
    finish = dict(n_params=n_params, verbose=verbose, cfg=cfg, shape=shape)

    with sharding_ctx(mesh, eff_rules):
        if shape.kind == "train" and not multi_pod:
            state, names = abstract_train_state(cfg, default_opt_cfg())
            state = state._replace(params=_cast_params(state.params,
                                                       torch.bfloat16))
            batch = input_specs(cfg, shape)
            args = (state_bytes(state, names, mesh)
                    + state_bytes(batch, _batch_names(batch), mesh))
            return _finish(arch_id, shape_name, mesh, "train", args,
                           **finish)

        if shape.kind == "train":
            dcfg = DiLoCoConfig(num_workers=n_pods)
            state, names = abstract_diloco_state(cfg, default_opt_cfg(), dcfg)
            state = state._replace(
                global_params=_cast_params(state.global_params,
                                           torch.bfloat16),
                worker_params=_cast_params(state.worker_params,
                                           torch.bfloat16))
            per_worker = {k: torch.empty(
                (n_pods, s.shape[0] // n_pods) + tuple(s.shape[1:]),
                dtype=s.dtype, device="meta")
                for k, s in input_specs(cfg, shape).items()}
            args = (state_bytes(state, names, mesh)
                    + state_bytes(per_worker,
                                  _batch_names(per_worker, stacked=True),
                                  mesh))
            return _finish(arch_id, shape_name, mesh, "diloco-inner", args,
                           **finish)

        params, pnames = abstract_params(cfg)
        params = _cast_params(params, torch.bfloat16)
        args = state_bytes(params, pnames, mesh)
        batch = input_specs(cfg, shape)
        if shape.kind == "prefill":
            batch.pop("labels", None)
            args += state_bytes(batch, _batch_names(batch), mesh)
            return _finish(arch_id, shape_name, mesh, "prefill", args,
                           **finish)

        from repro_torch.models import init_decode_cache
        cap = decode_cache_capacity(cfg, shape)
        cache = init_decode_cache(cfg, shape.global_batch, cap,
                                  dtype=torch.bfloat16, device="meta")
        args += (state_bytes(cache, decode_cache_names(cache), mesh)
                 + state_bytes(batch, _batch_names(batch), mesh))
        return _finish(arch_id, shape_name, mesh, "decode", args,
                       cache_capacity=cap, **finish)


def dryrun_outer_step(arch_id: str, *, delta_dtype: str = "float32",
                      drift_aware: bool = False,
                      verbose: bool = True) -> DryrunResult:
    """The DiLoCo outer step on the multi-pod mesh: the delta exchange
    across pods that the paper's communication saving is about.  Each
    device sends its shard of its worker's payload (the leaf's spec
    without the pod dim) at the codec's width, and a lossy codec's scale
    a leaf; that is the step's wire, all of it across pods."""
    mesh = make_production_mesh(multi_pod=True)
    n_pods = mesh.shape["pod"]
    cfg = _dryrun_cfg(arch_id)
    dcfg = DiLoCoConfig(num_workers=n_pods, delta_dtype=delta_dtype,
                        drift_aware=drift_aware)
    codec = make_codec(dcfg.delta_dtype)
    with sharding_ctx(mesh, {"pod": ("pod",)}):
        state, names = abstract_diloco_state(cfg, default_opt_cfg(), dcfg)
        state = state._replace(
            global_params=_cast_params(state.global_params, torch.bfloat16),
            worker_params=_cast_params(state.worker_params, torch.bfloat16))
        payload = scales = 0
        for k, t in state.global_params.items():
            shard = local_shape(tuple(t.shape),
                                spec_for(names.global_params[k],
                                         tuple(t.shape), mesh), mesh)
            count = 1
            for d in shard:
                count *= d
            payload += count * codec.width
            scales += 4 if isinstance(codec, QuantizedCodec) else 0
        args = state_bytes(state, names, mesh)
    n_leaves = len(state.global_params)
    wire = payload + scales
    colls = {"bytes_by_kind": {"all-gather": wire},
             "count_by_kind": {"all-gather": n_leaves * (2 if scales else 1)},
             "wire_bytes_per_device": wire,
             "cross_pod_bytes_per_device": wire}
    return _finish(arch_id, f"outer[{delta_dtype}]", mesh, "diloco-outer",
                   args, cfg.param_count(), verbose, collectives=colls)


def runtime_rules(cfg: ModelConfig, mesh: MeshShape, fsdp: bool) -> Dict:
    """The logical rules a runtime process mesh of ``mesh``'s shape holds
    a worker of ``cfg`` under (the module docstring's)."""
    model = mesh.shape.get("model", 1)
    rules: Dict = {"fsdp": ("data",) if fsdp else (), "pod": ("pod",)}
    if model > 1 and (cfg.num_heads % model or cfg.num_kv_heads % model):
        rules.update(heads=(), kv_heads=())
    return rules


def runtime_state_bytes(cfg: ModelConfig, mesh: MeshShape, *,
                        strategy: str = "diloco", fsdp: bool = False,
                        opt_cfg: Optional[OptimizerConfig] = None,
                        dcfg: Optional[DiLoCoConfig] = None) -> int:
    """Bytes one rank of a runtime (pod, data, model) process mesh holds of
    its training state, resolved under ``runtime_rules`` at the config's
    parameter dtype: ``ddp``, ``core.ddp.DDPTrainer``'s state (parameters,
    optimizer state, step); ``diloco``, ``DiLoCoTrainer``'s (the anchor,
    the outer momentum, the worker row's parameters and inner optimizer
    state, the counters) plus the error-feedback residual row of a lossy
    wire (``dcfg``; default the f32 wire, K = the mesh's pods)."""
    opt_cfg = opt_cfg or default_opt_cfg()
    with sharding_ctx(mesh, runtime_rules(cfg, mesh, fsdp)):
        if strategy == "ddp":
            state, names = abstract_train_state(cfg, opt_cfg)
            return state_bytes(state, names, mesh)
        dcfg = dcfg or DiLoCoConfig(num_workers=mesh.shape.get("pod", 1))
        state, names = abstract_diloco_state(cfg, opt_cfg, dcfg)
        total = state_bytes(state, names, mesh)
        if dcfg.error_feedback and make_codec(dcfg.delta_dtype).lossy:
            params, pnames = abstract_params(cfg)
            residual = {k: torch.empty((dcfg.num_workers,) + tuple(p.shape),
                                       dtype=torch.float32, device="meta")
                        for k, p in params.items()}
            total += state_bytes(residual, add_leading(pnames, "pod"), mesh)
        return total
