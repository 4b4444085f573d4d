"""Rank programs of ``tests/test_torch_multiproc.py``: each runs in a
process started by ``repro_torch.launch.mesh.run_ranks`` (gloo on the
CPU, file-store rendezvous) and writes what it holds to
``<workdir>/rank<r>.pt`` for the test to compare.  This module imports
no JAX, so a rank starts in about a second."""
import os

import numpy as np
import torch

# every wait on another rank is bounded: a dead rank fails the others
TIMEOUT_S = 60.0
OPT = dict(total_steps=8, warmup_steps=2, schedule="wsd",
           learning_rate=0.02, adam_lr=1e-3, fused_adamw=True)


def tiny():
    """``tests/helpers.py tiny_cfg("dense")`` in the port's config."""
    from repro_torch.configs import ModelConfig
    return ModelConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=97)


def dataset():
    """``test_torch_train.py``'s corpus (seq_len 16)."""
    from repro_torch.data import PackedDataset
    tokens = np.random.default_rng(5).integers(0, 97, 4000).astype(np.int32)
    return PackedDataset(tokens, 16)


def diloco_trainer(wire: str, replicate_fn=None, k: int = 2, cfg=None):
    from repro_torch.configs import DiLoCoConfig, OptimizerConfig
    from repro_torch.core import DistTrainer, make_strategy
    from repro_torch.models import lm_loss
    cfg = cfg or tiny()
    dcfg = DiLoCoConfig(num_workers=k, h_inner_steps=2, delta_dtype=wire)
    return DistTrainer(lambda p, b: lm_loss(p, b, cfg),
                       OptimizerConfig(**OPT), dcfg, make_strategy(dcfg),
                       replicate_fn)


def ddp_trainer(replicate_fn=None, cfg=None):
    from repro_torch.configs import DiLoCoConfig, OptimizerConfig
    from repro_torch.core import DistTrainer, make_strategy
    from repro_torch.models import lm_loss
    cfg = cfg or tiny()
    dcfg = DiLoCoConfig(num_workers=1, h_inner_steps=1, outer_lr=1.0,
                        outer_momentum=0.0, nesterov=False, strategy="ddp")
    return DistTrainer(lambda p, b: lm_loss(p, b, cfg),
                       OptimizerConfig(**dict(OPT, fused_adamw=False)), dcfg,
                       make_strategy(dcfg), replicate_fn)


def worker_data(ds, per_worker: int = 2, k: int = 2):
    return lambda s: ds.worker_batches(s, k, per_worker, seed=0)


def ddp_data(ds):
    return lambda s: {k: v[None] for k, v in ds.batch(s, 4, seed=0).items()}


def _clone(flat):
    return {k: v.detach().clone() for k, v in flat.items()}


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def engine_rounds(eng, params, data, rounds: int, mesh=None):
    """``rounds`` DiLoCo rounds of 2 inner steps at engine level, the
    inner steps and the outer round in their own collective-log scopes.
    Returns the state, the residual and a record per round: each step's
    losses, the worker parameters just before the round, the round's
    ``shipped`` and the log's statistics of each scope."""
    from repro_torch.core import transport
    from repro_torch.launch import collectives as coll
    state, res = eng.init(params), eng.init_residual(params)
    out = []
    for r in range(rounds):
        transport.reset_shipped()
        coll.reset_log()
        losses = []
        with coll.scope("inner"):
            for i in range(2):
                b = data(2 * r + i)
                if mesh is not None:
                    b = mesh.local_batch(b)
                state, loss = eng.inner_step(state, _tensors(b))
                losses.append(loss.clone())
        before = [_clone(w) for w in state.worker_params]
        with coll.scope("outer"):
            state, res = eng.outer_step_ef(state, res)
        out.append({"losses": losses, "before": before,
                    "shipped": dict(transport.shipped),
                    "inner": coll.collective_stats("inner"),
                    "outer": coll.collective_stats("outer"),
                    "records": [(c.kind, c.axis, c.nbytes, c.cross_pod)
                                for c in coll.records()]})
    return state, res, out


def _state(st, res=None):
    return {"global": _clone(st.global_params), "v": _clone(st.outer.v),
            "workers": [_clone(w) for w in st.worker_params],
            "step": int(st.inner_step), "t": int(st.outer.t),
            "residual": None if res is None else _clone(res)}


def pair(rank: int, world: int, init_method: str, workdir: str) -> None:
    """Two ranks: DiLoCo on a (pod 2, data 1) mesh through
    ``DistTrainer.run`` on the f32 and int8 wires (4 steps, H 2), the int8
    rounds again at engine level with the log scoped, then DDP on a
    (pod 1, data 2) mesh of the same ranks (2 steps, global batch 4)."""
    torch.set_num_threads(1)
    from repro_torch.core import transport
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models.transformer import unflatten
    mesh = init_process_mesh(2, 1, backend="gloo", device="cpu", rank=rank,
                             world_size=world, init_method=init_method,
                             timeout_s=TIMEOUT_S)
    params = torch.load(os.path.join(workdir, "params.pt"))
    ds = dataset()
    out = {"pod_index": mesh.pod_index, "pod_ranks": mesh.pod_ranks}
    for wire in ("float32", "int8"):
        dt = diloco_trainer(wire, mesh.replicate_fn)
        transport.reset_shipped()
        coll.reset_log()
        st, hist = dt.run(dt.init(unflatten(params)), worker_data(ds), 4)
        out[wire] = dict(_state(st), hist=hist,
                         shipped=dict(transport.shipped),
                         stats=coll.collective_stats(),
                         inner=coll.collective_stats("inner"),
                         outer=coll.collective_stats("outer"))
    eng = diloco_trainer("int8", mesh.replicate_fn).engine()
    st, res, rounds = engine_rounds(eng, params, worker_data(ds), 2, mesh)
    out["int8_engine"] = dict(_state(st, res), rounds=rounds)

    dmesh = init_process_mesh(1, 2, backend="gloo", device="cpu",
                              timeout_s=TIMEOUT_S)
    dt = ddp_trainer(dmesh.replicate_fn)
    coll.reset_log()
    st, hist = dt.run(dt.init(unflatten(params)), ddp_data(ds), 2)
    out["ddp"] = dict(_state(st), hist=hist, stats=coll.collective_stats())
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    mesh.close()


def grid(rank: int, world: int, init_method: str, workdir: str) -> None:
    """Four ranks, a (pod 2, data 2) mesh: DiLoCo K 2 (f32 wire), per-worker
    batch 4 split over the pod's two data ranks, 2 rounds of 2 inner
    steps at engine level."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_process_mesh
    mesh = init_process_mesh(2, 2, backend="gloo", device="cpu", rank=rank,
                             world_size=world, init_method=init_method,
                             timeout_s=TIMEOUT_S)
    params = torch.load(os.path.join(workdir, "params.pt"))
    eng = diloco_trainer("float32", mesh.replicate_fn).engine()
    st, res, rounds = engine_rounds(eng, params, worker_data(dataset(), 4),
                                    2, mesh)
    torch.save(dict(_state(st), rounds=rounds, pod=mesh.pod_index,
                    data=mesh.data_index),
               os.path.join(workdir, f"rank{rank}.pt"))
    mesh.close()


def card_cfg():
    """A small config the card's kernels take (head dim 64)."""
    from repro_torch.configs import ModelConfig
    return ModelConfig(num_layers=2, d_model=128, num_heads=2,
                       num_kv_heads=1, head_dim=64, d_ff=256, vocab_size=97)


def card_trainer(wire: str, replicate_fn=None):
    from repro_torch.configs import DiLoCoConfig, OptimizerConfig
    from repro_torch.core import DistTrainer, make_strategy
    from repro_torch.models import lm_loss
    cfg = card_cfg()
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=2, delta_dtype=wire)
    return DistTrainer(lambda p, b: lm_loss(p, b, cfg),
                       OptimizerConfig(**OPT), dcfg, make_strategy(dcfg),
                       replicate_fn)


def pair_cuda(rank: int, world: int, init_method: str, workdir: str,
              backend: str) -> None:
    """Two ranks on the card(s): DiLoCo (pod 2, data 1) through
    ``DistTrainer.run`` on the f32 and int8 wires from ``init_params(seed
    =0)`` on the rank's card, with each run's kernel launch counts."""
    from repro_torch.kernels import KERNELS, launches, reset_launches
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models import init_params
    mesh = init_process_mesh(2, 1, backend=backend, device="cuda",
                             rank=rank, world_size=world,
                             init_method=init_method, timeout_s=TIMEOUT_S)
    params = init_params(card_cfg(), seed=0, device=mesh.device)
    out = {}
    for wire in ("float32", "int8"):
        dt = card_trainer(wire, mesh.replicate_fn)
        reset_launches()
        coll.reset_log()
        st, _ = dt.run(dt.init(params), worker_data(dataset()), 4)
        out[wire] = {"global": {k: v.cpu() for k, v in
                                st.global_params.items()},
                     "v": {k: v.cpu() for k, v in st.outer.v.items()},
                     "launches": {k: launches[k] for k in KERNELS},
                     "inner": coll.collective_stats("inner"),
                     "outer": coll.collective_stats("outer")}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    mesh.close()


# ---------------------------------------------------------------------------
# Every strategy, AdaptiveH, the fault layer, run checkpoints and hybrid
# across ranks (tests/test_torch_mesh_strategies.py)
# ---------------------------------------------------------------------------

def opt_of(total: int):
    """The optimizer of the JAX-parity test a case mirrors (its
    ``total_steps``; no fused AdamW, as those tests run)."""
    return dict(total_steps=total, warmup_steps=2, schedule="wsd",
                learning_rate=0.02, adam_lr=1e-3)


# name -> method, DiLoCoConfig fields, K, H, steps, the optimizer's
# total_steps, a fault schedule, min_quorum, AdaptiveH's arguments
def _case(method, dkw, k, h, steps, total, spec="", quorum=1, adaptive=None):
    return dict(method=method, dkw=dkw, k=k, h=h, steps=steps, total=total,
                spec=spec, min_quorum=quorum, adaptive=adaptive)


CASES2 = {
    # test_torch_strategies.py's streaming-f2-int8 case, and its f32 twin
    "streaming-f2-int8": _case("streaming", dict(delta_dtype="int8",
                                                 num_fragments=2), 2, 2, 4, 8),
    "streaming-f2-f32": _case("streaming", dict(num_fragments=2), 2, 4, 8, 8),
    "overlapped-delay1-jitter1-int8": _case(
        "overlapped", dict(delta_dtype="int8", sync_delay=1, h_jitter=1,
                           sync_seed=3), 2, 3, 6, 8),
    "overlapped-delay1-f32": _case("overlapped", dict(sync_delay=1), 2, 2,
                                   5, 8),
    "pipelined-f2-delay1-int8": _case(
        "pipelined", dict(delta_dtype="int8", num_fragments=2, sync_delay=1),
        2, 2, 5, 8),
    "pipelined-f2-f32": _case("pipelined", dict(num_fragments=2), 2, 2, 4,
                              8),
    "ddp-compressed-int8": _case("ddp", dict(grad_compress="int8"), 2, 2, 4,
                                 8),
    "ddp-compressed-f32": _case("ddp", dict(grad_compress="float32"), 2, 2,
                                3, 8),
    # test_torch_pipeline.py's AdaptiveH case: H 2, then its floor of 10
    "diloco-adaptive-h": _case("diloco", {}, 2, 2, 16, 16,
                               adaptive=dict(h0=2, window=4)),
    # quorum rounds with a worker down, a rejoin and a payload counted out
    "diloco-quorum-int8": _case("diloco", dict(delta_dtype="int8"), 2, 2, 8,
                                12, "crash:1@1,rejoin:1@3,drop:0@5x2"),
    "streaming-quorum-int8": _case(
        "streaming", dict(delta_dtype="int8", num_fragments=2), 2, 4, 8, 12,
        "crash:1@1,rejoin:1@3,drop:0@5x2"),
    "pipelined-quorum": _case(
        "pipelined", dict(num_fragments=2, sync_delay=1), 2, 2, 8, 12,
        "crash:1@1,rejoin:1@4,corrupt:0@5x2"),
}

CASES4 = {
    # test_torch_gossip.py's cases
    "gossip-ring-int8-k4": _case("gossip", dict(delta_dtype="int8"), 4, 2, 6,
                                 12),
    "gossip-random-f32-k4": _case("gossip", dict(topology="random",
                                                 sync_seed=3), 4, 2, 6, 12),
    "async-jitter1-bound2-int8-k4": _case(
        "async_gossip", dict(delta_dtype="int8", h_jitter=1,
                             staleness_bound=2, sync_seed=1), 4, 2, 7, 12),
    # test_torch_faults_e2e.py's cases
    "gossip-ring-crash-rejoin-drop-x2": _case(
        "gossip", {}, 4, 2, 12, 12, "crash:1@3,rejoin:1@6,drop:0@5x2"),
    "diloco-crash-rejoin-drop-slow": _case(
        "diloco", {}, 4, 3, 12, 12,
        "slow:3@2x1.5,crash:2@4,drop:1@5,rejoin:2@10"),
}

# the run-checkpoint case: DiLoCo int8, a checkpoint every 2 steps, a
# kill after step 3 (the latest checkpoint is at 4)
KILL = _case("diloco", dict(delta_dtype="int8"), 2, 2, 8, 12, "kill@3")
KILL_STEP = 4

# the hybrid pipeline (the tiny launcher model, evals off)
HYBRID = dict(arch="tiny", steps={"base": 4, "mid": 2, "sft": 2},
              workers=2, per_worker_batch=2, seq_len=64,
              eval_after_each_stage=False, device="cpu")

RUNNER_ARRAYS = ("residual", "anchors", "outer_v", "pub", "pub_anch", "pub_v")


class KeepRunner:
    """Hands ``DistTrainer.run`` the strategy's runner and keeps it, with
    each step's collective records and ``shipped`` bytes of the round it
    ran (``rounds``: (step, records, shipped))."""

    def __init__(self, strategy):
        self.strategy, self.runner, self.rounds = strategy, None, []

    def bind(self, engine, params):
        from repro_torch.core import transport
        from repro_torch.launch import collectives as coll
        self.runner = runner = self.strategy.bind(engine, params)
        orig = runner.after_step

        def after_step(state, step, loss):
            n, before = len(coll.records()), sum(transport.shipped.values())
            out = orig(state, step, loss)
            new = coll.records()[n:]
            if new:
                self.rounds.append(
                    (step, [(r.kind, r.scope, r.nbytes) for r in new],
                     sum(transport.shipped.values()) - before))
            return out

        runner.after_step = after_step
        return runner

    def __getattr__(self, name):
        return getattr(self.strategy, name)


def stage_config(case):
    """``launch.train.run_stage``'s config and strategy for a case."""
    import dataclasses
    from repro_torch.configs import DiLoCoConfig
    from repro_torch.core import AdaptiveH, compressed_ddp_config, \
        make_strategy
    c = case
    base = DiLoCoConfig(**c["dkw"])
    if c["method"] == "ddp":
        dcfg = compressed_ddp_config(dataclasses.replace(
            base, num_workers=c["k"]))
    else:
        delay = min(base.sync_delay, c["h"] - 1)
        jitter = min(base.h_jitter, c["h"] - 1 - delay)
        dcfg = dataclasses.replace(base, num_workers=c["k"],
                                   h_inner_steps=c["h"], strategy=c["method"],
                                   sync_delay=delay, h_jitter=jitter)
    hs = AdaptiveH(**c["adaptive"]) if c["adaptive"] else None
    return dcfg, make_strategy(dcfg, h_schedule=hs)


def run_case(case, params, replicate_fn=None, cfg=None, **run_kw):
    """A case through ``DistTrainer.run`` as ``run_stage`` runs it (tiny
    dense unless ``cfg``, per-worker batch 2 of ``dataset()``), from the
    flat ``params`` (on the device to train on).  Returns what a test
    compares: the state, the runner's arrays, the history (timings left
    out), ``shipped``, the collective log's statistics by scope and each
    round's records."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.core import DistTrainer, FaultSchedule, transport
    from repro_torch.launch import collectives as coll
    from repro_torch.models import lm_loss
    from repro_torch.models.transformer import unflatten
    cfg = cfg or tiny()
    dcfg, strategy = stage_config(case)
    keep = KeepRunner(strategy)
    dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg),
                     OptimizerConfig(**opt_of(case["total"])), dcfg, keep,
                     replicate_fn)
    transport.reset_shipped()
    coll.reset_log()
    faults = FaultSchedule.from_spec(case["spec"]) if case["spec"] else None
    st, hist = dt.run(dt.init(unflatten(params)),
                      worker_data(dataset(), 2, case["k"]), case["steps"],
                      faults=faults, min_quorum=case["min_quorum"], **run_kw)
    r, keep.runner = keep.runner, None
    del r.after_step            # the wrapper refers back to the runner
    return dict(
        _state(st), runner={n: _clone(getattr(r, n)) for n in RUNNER_ARRAYS
                            if isinstance(getattr(r, n, None), dict)},
        hist={k: v for k, v in hist.items()
              if k not in ("step_seconds", "inner_seconds", "sync_seconds")},
        shipped=dict(transport.shipped),
        stats={s: coll.collective_stats(s) for s in
               ("inner", "outer", "loss", "quorum", "consensus",
                "checkpoint")},
        rounds=keep.rounds)


def _gloo_mesh(rank, world, init_method, pods):
    from repro_torch.launch.mesh import init_process_mesh
    torch.set_num_threads(1)
    return init_process_mesh(pods, world // pods, backend="gloo",
                             device="cpu", rank=rank, world_size=world,
                             init_method=init_method, timeout_s=TIMEOUT_S)


def strategies2(rank: int, world: int, init_method: str,
                workdir: str) -> None:
    """Two ranks, (pod 2, data 1): every case of ``CASES2``; the kill and
    resume case (killed, resumed, uninterrupted, and resumed from the
    one-process checkpoint in ``workdir/one_ckpt``); then the hybrid
    pipeline through ``run_pipeline(mesh=)`` from the parameters in
    ``workdir/hybrid_params.pt``, with its gradient all-reduces' log
    records."""
    from repro_torch.core import SimulatedCrash
    from repro_torch.launch import train
    mesh = _gloo_mesh(rank, world, init_method, 2)
    params = torch.load(os.path.join(workdir, "params.pt"))
    out = {name: run_case(c, params, mesh.replicate_fn)
           for name, c in CASES2.items()}
    ckpt = os.path.join(workdir, "ckpt2")
    try:
        run_case(KILL, params, mesh.replicate_fn, checkpoint_dir=ckpt,
                 checkpoint_every=2)
        out["killed"] = False
    except SimulatedCrash:
        out["killed"] = True
    out["resumed"] = run_case(KILL, params, mesh.replicate_fn,
                              checkpoint_dir=ckpt, checkpoint_every=2,
                              resume=True)
    out["uninterrupted"] = run_case(
        dict(KILL, spec=""), params, mesh.replicate_fn,
        checkpoint_dir=os.path.join(workdir, "ckpt2_whole"),
        checkpoint_every=2)
    out["from_one"] = run_case(KILL, params, mesh.replicate_fn,
                               checkpoint_dir=os.path.join(workdir,
                                                           "one_ckpt"),
                               resume=True)
    hparams = torch.load(os.path.join(workdir, "hybrid_params.pt"))
    train.init_params = lambda cfg, seed=0, device="cpu": hparams
    ends = stage_ends(train)
    from repro_torch.launch import collectives as coll
    coll.reset_log()
    out["hybrid"] = train.run_pipeline(
        "hybrid", mesh=mesh, out_dir=os.path.join(workdir, "hybrid"),
        **HYBRID)
    out["hybrid_ends"] = ends
    # the mid and SFT stages' gradient all-reduces (kind, cross-pod, bytes)
    out["hybrid_all_reduce"] = [(r.kind, r.cross_pod, r.nbytes)
                                for r in coll.records()
                                if r.kind == "all-reduce"]
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    mesh.close()


def stage_ends(train):
    """Make ``train.run_stage`` record the parameters each stage ends on
    (flat copies, in stage order) in the list returned."""
    from repro_torch.models.transformer import flatten
    run_stage, ends = train.run_stage, []

    def stage(*a, **kw):
        p, hist = run_stage(*a, **kw)
        ends.append(_clone(flatten(p)))
        return p, hist

    train.run_stage = stage
    return ends


def strategies4(rank: int, world: int, init_method: str,
                workdir: str) -> None:
    """Four ranks, (pod 4, data 1): every case of ``CASES4``."""
    mesh = _gloo_mesh(rank, world, init_method, 4)
    params = torch.load(os.path.join(workdir, "params.pt"))
    out = {name: run_case(c, params, mesh.replicate_fn)
           for name, c in CASES4.items()}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    mesh.close()


# two ranks on the card(s): gossip (ring; K 2 binds DiLoCo's runner) and
# the quorum rounds, int8
CUDA_CASES = {
    "gossip-ring-int8": _case("gossip", dict(delta_dtype="int8"), 2, 2, 4, 8),
    "diloco-quorum-int8": CASES2["diloco-quorum-int8"],
}


def to_cpu(x):
    """A rank's output with every tensor on the host."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(to_cpu(v) for v in x)
    return x


def strategies_cuda(rank: int, world: int, init_method: str, workdir: str,
                    backend: str) -> None:
    """Two ranks on the card(s): each case of ``CUDA_CASES`` at
    ``card_cfg()`` from ``init_params(seed=0)`` on the rank's card, with
    its kernel launch counts."""
    from repro_torch.kernels import KERNELS, launches, reset_launches
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models import init_params
    from repro_torch.models.transformer import flatten
    mesh = init_process_mesh(2, 1, backend=backend, device="cuda",
                             rank=rank, world_size=world,
                             init_method=init_method, timeout_s=TIMEOUT_S)
    params = flatten(init_params(card_cfg(), seed=0, device=mesh.device))
    out = {}
    for name, case in CUDA_CASES.items():
        reset_launches()
        out[name] = to_cpu(run_case(case, params, mesh.replicate_fn,
                                    cfg=card_cfg()))
        out[name]["launches"] = {k: launches[k] for k in KERNELS}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    mesh.close()


# ---------------------------------------------------------------------------
# Tensor parallelism over the model axis
# (tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------

def tp_cfg(heads: int = 4, kv: int = 2, head_dim: int = 0):
    """The tiny dense config with a vocab the model axis splits (128); at
    ``heads`` 3 (``head_dim`` 16) attention stays whole at model 2."""
    from repro_torch.configs import ModelConfig
    return ModelConfig(num_layers=2, d_model=64, num_heads=heads,
                       num_kv_heads=kv, head_dim=head_dim, d_ff=128,
                       vocab_size=128)


def tp_cfg3():
    return tp_cfg(3, 1, 16)


# one DiLoCo round (K 2, H 2) on each wire; 4 steps with a checkpoint
# every 2 for the checkpoint cases
TP_DILOCO = {"float32": _case("diloco", {}, 2, 2, 2, 8),
             "int8": _case("diloco", dict(delta_dtype="int8"), 2, 2, 2, 8)}
TP_CKPT = _case("diloco", {}, 2, 2, 4, 8)
# drift-aware averaging through DistTrainer.run on the model axis
TP_DRIFT = _case("diloco", dict(drift_aware=True), 2, 2, 2, 8)
TP_SEED = 11


def tp_inputs():
    """The unit checks' inputs, from one seed (the same on every rank):
    tokens, logits and labels (some -1), Muon's gradients of two split
    leaves, and a (1, 2, 64, 64) delta with its residual."""
    g = torch.Generator().manual_seed(TP_SEED)
    labels = torch.randint(0, 128, (4, 8), generator=g)
    labels[0, :3] = -1
    return {"tokens": torch.randint(0, 128, (4, 8), generator=g),
            "logits": 3 * torch.randn(4, 8, 128, generator=g),
            "labels": labels,
            "muon": {"layers/attn/wq": torch.randn(2, 64, 64, generator=g),
                     "layers/mlp/w_down": torch.randn(2, 128, 64,
                                                      generator=g)},
            "delta": torch.randn(1, 2, 64, 64, generator=g),
            "residual": 1e-3 * torch.randn(1, 2, 64, 64, generator=g)}


def tp_units(mesh, params) -> dict:
    """This rank's side of the unit checks, on its model group: the
    vocab-parallel embedding, CE (sums and the logits' gradient, z-loss
    on), Muon's update of split leaves, the global norm of the tiny
    tree's shards and the quantize kernel's plain version with the MAX
    hook, each on this rank's shards of ``tp_inputs``."""
    from repro_torch.kernels.quantize import quantize_ef
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models.layers import embed, softmax_ce_sums
    from repro_torch.models.sharding import shard
    from repro_torch.optim.base import global_norm
    from repro_torch.optim.muon import muon
    x = tp_inputs()
    cfg = tp_cfg()
    own = shard(params, mesh.layout, mesh.model_index, mesh.model)
    out = {}
    with tp.use(mesh):
        out["embed"] = embed({"table": own["embed/table"]}, x["tokens"], cfg)
        local = mesh.model_part(x["logits"], -1).clone().requires_grad_(True)
        total, count = softmax_ce_sums(local, x["labels"], z_loss=1e-4,
                                       vocab_parallel=True)
        out["ce"] = (total.detach(), count)
        out["ce_grad"] = torch.autograd.grad(total, local)[0]
        grads = shard(x["muon"], mesh.layout, mesh.model_index, mesh.model)
    opt = muon(0.02, axis=mesh)
    upd, _ = opt.update(grads, opt.init(grads), grads,
                        torch.zeros((), dtype=torch.int32))
    out["muon"] = upd
    out["global_norm"] = global_norm(own, mesh)
    d = mesh.model_part(x["delta"], -1)
    r = mesh.model_part(x["residual"], -1)
    out["quantize"] = quantize_ef(
        d, r, dtype="int8",
        amax_reduce=lambda a: mesh.model_all_reduce(a, "max"))
    return out


def tp_loss_grads(mesh, params, cfg) -> dict:
    """One forward and backward of ``lm_loss`` on this rank's shards of
    ``params`` (a (2, 16) batch of ``dataset()``): the loss, the shards'
    gradients and the collective records it made."""
    from repro_torch.launch import collectives as coll
    from repro_torch.models import lm_loss
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models.sharding import shard
    from repro_torch.models.transformer import unflatten
    own = shard(params, mesh.layout, mesh.model_index, mesh.model)
    leaves = {k: v.requires_grad_(True) for k, v in own.items()}
    coll.reset_log()
    with tp.use(mesh):
        loss, _ = lm_loss(unflatten(leaves),
                          _tensors(dataset().batch(0, 2, seed=0)), cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return {"loss": loss.detach(), "grads": dict(zip(leaves, grads)),
            "records": [(r.kind, r.axis, r.cross_pod)
                        for r in coll.records()]}


class WireLog:
    """Records each quantized payload's codes and scales by leaf
    (``QuantizedCodec.encode`` wrapped while in use)."""

    def __enter__(self):
        from repro_torch.core import transport
        self.codec, self.orig = transport.QuantizedCodec, \
            transport.QuantizedCodec.encode
        self.wire = {}

        def encode(codec, delta, residual=None, kind="delta", fragment=-1,
                   axis=None):
            payload, res = self.orig(codec, delta, residual, kind, fragment,
                                     axis)
            for k in payload.data:
                self.wire[k] = (payload.data[k].clone(),
                                payload.scales[k].clone())
            return payload, res

        self.codec.encode = encode
        return self.wire

    def __exit__(self, *exc):
        self.codec.encode = self.orig


def tp_round(mesh, params, wire: str) -> dict:
    """One DiLoCo round at engine level (K 2, H 2) on this rank's shards:
    the worker shards just before the round, the state after it, the
    wire's codes and scales, and the collective records of the inner
    steps and of the round."""
    from repro_torch.launch import collectives as coll
    from repro_torch.models.transformer import unflatten
    eng = diloco_trainer(wire, mesh.replicate_fn, cfg=tp_cfg()).engine()
    st = eng.init(unflatten(params))
    res = eng.init_residual(st.global_params)
    data = worker_data(dataset())
    coll.reset_log()
    with coll.scope("inner"):
        for i in range(2):
            st, _ = eng.inner_step(st, _tensors(mesh.local_batch(data(i))))
    before = _clone(st.worker_params[0])
    with WireLog() as wire_log, coll.scope("outer"):
        st, res = eng.outer_step_ef(st, res)
    return dict(_state(st, res), before=before, wire=dict(wire_log),
                records=[(r.kind, r.axis, r.cross_pod, r.nbytes, r.scope)
                         for r in coll.records()])


def tensor_parallel4(rank: int, world: int, init_method: str,
                     workdir: str) -> None:
    """Four ranks.  As (pod 2, data 1, model 2) at ``tp_cfg()``: the unit
    checks, one forward and backward from the shared parameters, a
    DiLoCo round at engine level and through ``DistTrainer.run`` on the
    f32 and int8 wires (``TP_DILOCO``), drift-aware (``TP_DRIFT``),
    ``TP_CKPT`` writing run
    checkpoints (``workdir/tp_ckpt``) and resumed from the one-process
    checkpoint in ``workdir/one_ckpt``; as (pod 1, data 2, model 2): 2
    DDP steps; as (pod 2, data 1, model 2) at ``tp_cfg3()``, whose
    attention stays whole: the f32 round."""
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models.transformer import unflatten
    torch.set_num_threads(1)
    kw = dict(backend="gloo", device="cpu", rank=rank, world_size=world,
              init_method=init_method, timeout_s=TIMEOUT_S)
    mesh = init_process_mesh(2, 1, 2, cfg=tp_cfg(), **kw)
    params = torch.load(os.path.join(workdir, "params.pt"))
    cfg = tp_cfg()
    out = {"index": (mesh.pod_index, mesh.data_index, mesh.model_index),
           "layout": mesh.layout, "units": tp_units(mesh, params),
           "loss_grads": tp_loss_grads(mesh, params, cfg)}
    for wire, case in TP_DILOCO.items():
        out[f"round_{wire}"] = tp_round(mesh, params, wire)
        with WireLog() as wire_log:
            out[f"run_{wire}"] = run_case(case, params, mesh.replicate_fn,
                                          cfg=cfg)
        out[f"run_{wire}"]["wire"] = dict(wire_log)
    out["drift"] = run_case(TP_DRIFT, params, mesh.replicate_fn, cfg=cfg)
    out["ckpt_run"] = run_case(TP_CKPT, params, mesh.replicate_fn, cfg=cfg,
                               checkpoint_dir=os.path.join(workdir,
                                                           "tp_ckpt"),
                               checkpoint_every=2)
    out["from_one"] = run_case(TP_CKPT, params, mesh.replicate_fn, cfg=cfg,
                               checkpoint_dir=os.path.join(workdir,
                                                           "one_ckpt"),
                               resume=True)
    dmesh = init_process_mesh(1, 2, 2, cfg=cfg, **kw)
    dt = ddp_trainer(dmesh.replicate_fn, cfg=cfg)
    from repro_torch.launch import collectives as coll
    coll.reset_log()
    st, hist = dt.run(dt.init(unflatten(params)), ddp_data(dataset()), 2)
    out["ddp"] = dict(_state(st), hist=hist,
                      records=[(r.kind, r.axis, r.cross_pod)
                               for r in coll.records()],
                      index=(dmesh.pod_index, dmesh.data_index,
                             dmesh.model_index))
    params3 = torch.load(os.path.join(workdir, "params3.pt"))
    mesh3 = init_process_mesh(2, 1, 2, cfg=tp_cfg3(), **kw)
    out["three_heads"] = run_case(TP_DILOCO["float32"], params3,
                                  mesh3.replicate_fn, cfg=tp_cfg3())
    out["layout3"] = mesh3.layout
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    mesh.close()


# ---------------------------------------------------------------------------
# Tensor-parallel serving (tests/test_torch_tp_serving.py)
# ---------------------------------------------------------------------------

# a prompt fed token by token, then decode tokens, teacher-forced, through
# an 8-slot ring (it wraps across the kv_seq ranks' slots); 4 rows, 2 a
# data rank on the (data 2, model 2) mesh
SERVE_B, SERVE_CAP, SERVE_PROMPT, SERVE_DECODE = 4, 8, 5, 12
# case -> (config, (pod, data, model)): head-parallel at model 2,
# head-parallel after the KV repeat at model 4 (2 KV heads -> 4), kv_seq
# at model 2 and 4 (1 KV head, 3 query heads)
SERVE_CASES = {"heads2": ("tp_cfg", (1, 2, 2)),
               "heads4": ("tp_cfg", (1, 1, 4)),
               "kv_seq2": ("tp_cfg3", (1, 2, 2)),
               "kv_seq4": ("tp_cfg3", (1, 1, 4))}
# the exact checks' ring: (B, KV, G, cap, D), 64-slot chunks
SERVE_RING = (2, 1, 3, 256, 16)


def serve_inputs():
    """Tokens (B, T) int32 and positions (T, B) int32 of the serve run:
    row 0 one step behind (a left-pad token at -1 first), row 2 three
    ahead."""
    T = SERVE_PROMPT + SERVE_DECODE
    tokens = np.random.default_rng(TP_SEED).integers(
        0, 128, (SERVE_B, T)).astype(np.int32)
    t = np.arange(T)[:, None]
    positions = np.maximum(t + np.array([-1, 0, 3, 0]), -1).astype(np.int32)
    return tokens, positions


def serve_ring():
    """The exact checks' ring: q, k, v, pos, q_pos from one seed, every
    slot live but the last row's dead run."""
    B, KV, G, S, D = SERVE_RING
    g = torch.Generator().manual_seed(TP_SEED)
    q = torch.randn(B, KV, G, D, generator=g)
    k, v = torch.randn(2, B, KV, S, D, generator=g)
    pos = torch.randperm(S, generator=g).int().expand(B, S).contiguous()
    pos[-1, 40:140] = -1
    return q, k, v, pos, torch.full((B,), S - 1, dtype=torch.int32)


def serve_case(mesh, cfg, flat, cfg_one) -> dict:
    """The serve run of this rank on ``mesh``: ``flat`` one-process
    parameters of ``cfg_one`` through ``repeat_kv_heads`` and ``shard``;
    each step's logits (this rank's vocab columns), greedy ids and
    collective records, the final cache part, the prefill step's logits
    of the prompt."""
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_decode_cache
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models.sharding import (repeat_kv_heads, serve_layout,
                                             shard)
    from repro_torch.models.transformer import unflatten
    mode, layout = serve_layout(cfg_one, mesh.model)
    params = unflatten(shard(repeat_kv_heads(flat, cfg_one, mesh.model),
                             layout, mesh.model_index, mesh.model))
    tokens, positions = serve_inputs()
    n = SERVE_B // mesh.data
    rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    tokens = torch.from_numpy(tokens[rows])
    cache = init_decode_cache(cfg, n, SERVE_CAP, mesh=mesh)
    step = make_serve_step(cfg, mesh)
    logits, ids, records = [], [], []
    for t in range(tokens.shape[1]):
        coll.reset_log()
        out, cache = step(params, cache, {
            "token": tokens[:, t:t + 1],
            "position": torch.from_numpy(positions[t, rows])})
        records.append([(r.kind, r.axis, r.cross_pod)
                        for r in coll.records()])
        logits.append(out)
        with tp.use(mesh):
            ids.append(tp.vocab_parallel_argmax(out))
    prefill = make_prefill_step(cfg, mesh)(
        params, {"tokens": tokens[:, :SERVE_PROMPT]})
    return {"index": (mesh.pod_index, mesh.data_index, mesh.model_index),
            "mode": mode, "logits": torch.stack(logits),
            "ids": torch.stack(ids), "records": records, "cache": cache,
            "prefill": prefill}


def serve_units(mesh) -> dict:
    """The exact checks on this model group: ``vocab_parallel_argmax`` of
    this rank's columns of tied logits, and the kv_seq attention of this
    rank's slots of ``serve_ring`` (plain partials, gathered, combined)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_partials)
    from repro_torch.models import tensor_parallel as tp
    g = torch.Generator().manual_seed(TP_SEED)
    tied = torch.randint(0, 3, (6, 8 * mesh.model), generator=g).float()
    q, k, v, pos, q_pos = serve_ring()
    part = [mesh.model_part(t, -2 if t.dim() == 4 else -1).contiguous()
            for t in (k, v, pos)]
    with tp.use(mesh):
        ids = tp.vocab_parallel_argmax(mesh.model_part(tied, -1))
        attn = tp.seq_parallel_attention(*decode_attention_partials(
            q, *part, q_pos))
    return {"tied": tied, "ids": ids, "attention": attn}


def tp_serving4(rank: int, world: int, init_method: str,
                workdir: str) -> None:
    """Four ranks: each case of ``SERVE_CASES`` on its mesh of the same
    ranks (the served config ``tp_kv_repeat(cfg, model)``), then
    ``serve_units`` on the (data 2, model 2) and (1, 1, 4) meshes.
    Writes ``serve_rank<r>.pt``."""
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models.sharding import tp_kv_repeat
    torch.set_num_threads(1)
    kw = dict(backend="gloo", device="cpu", rank=rank, world_size=world,
              init_method=init_method, timeout_s=TIMEOUT_S)
    flat = {"tp_cfg": torch.load(os.path.join(workdir, "params.pt")),
            "tp_cfg3": torch.load(os.path.join(workdir, "params3.pt"))}
    out = {"cases": {}, "units": {}}
    for name, (cname, shape) in SERVE_CASES.items():
        cfg_one = globals()[cname]()
        cfg = tp_kv_repeat(cfg_one, shape[2])
        mesh = init_process_mesh(*shape, cfg=cfg, **kw)
        out["cases"][name] = serve_case(mesh, cfg, flat[cname], cfg_one)
        if name.startswith("kv_seq"):
            out["units"][shape[2]] = serve_units(mesh)
    torch.save(out, os.path.join(workdir, f"serve_rank{rank}.pt"))
    mesh.close()


# ---------------------------------------------------------------------------
# ZeRO-3 over the data axis (tests/test_torch_fsdp.py)
# ---------------------------------------------------------------------------

# the meshes of the 4 ranks: name -> ((pod, data, model), fsdp, config);
# each fsdp mesh beside its replicated twin of the same ranks
FSDP_MESHES = {"d4f": ((1, 4, 1), True, "tiny"),
               "d4r": ((1, 4, 1), False, "tiny"),
               "p2d2f": ((2, 2, 1), True, "tiny"),
               "p2d2r": ((2, 2, 1), False, "tiny"),
               "d2m2f": ((1, 2, 2), True, "tp_cfg"),
               "d2m2r": ((1, 2, 2), False, "tp_cfg"),
               "p2m2": ((2, 1, 2), False, "tp_cfg")}
# DiLoCo K 2 H 2 (one round) on each wire; the checkpoint case writes at
# step 2 and resumes to 4
FSDP_DILOCO = {"float32": _case("diloco", {}, 2, 2, 2, 8),
               "int8": _case("diloco", dict(delta_dtype="int8"), 2, 2, 2, 8)}
FSDP_CKPT = _case("diloco", dict(delta_dtype="int8"), 2, 2, 4, 8)
FSDP_DRIFT = dict(delta_dtype="int8", drift_aware=True)


def _fsdp_batch(mesh, step: int = 0):
    """This rank's part of a 4-row ``dataset()`` batch (one DDP step)."""
    b = mesh.local_batch({k: v[None] for k, v in
                          dataset().batch(step, 4, seed=0).items()})
    return {k: v[0] for k, v in _tensors(b).items()}


def fsdp_grads(mesh, params, cfg) -> dict:
    """One step's loss and gradients on this rank's shards of ``params``
    from its part of a 4-row batch, reduced as the inner step reduces
    them (``grad_reduce``), then Muon's update of the Muon leaves from
    those gradients; and the collective records of the step."""
    from repro_torch.launch import collectives as coll
    from repro_torch.models import fsdp, lm_loss
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models.transformer import unflatten
    from repro_torch.optim import partition_label
    from repro_torch.optim.muon import muon
    leaves = {k: v.requires_grad_(True) for k, v in mesh.own(params).items()}
    coll.reset_log()
    with tp.use(mesh), fsdp.use(mesh):
        loss, _ = lm_loss(unflatten(leaves), _fsdp_batch(mesh), cfg)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    grads = mesh.grad_reduce(grads)
    records = [(r.kind, r.axis, r.nbytes) for r in coll.records()]
    mats = {k: g for k, g in grads.items()
            if partition_label(k, g) == "muon"}
    opt = muon(0.02, axis=mesh)
    upd, _ = opt.update(mats, opt.init(mats), mats,
                        torch.zeros((), dtype=torch.int32))
    return {"loss": loss.detach(), "grads": grads, "muon": upd,
            "records": records}


def fsdp_units(mesh, params) -> dict:
    """This rank's side of the unit checks on a (data 2, model 2) fsdp
    mesh: Muon's update of ``tp_inputs``' split leaves on their shards,
    the global norm of the parameters' shards, and the quantize kernel's
    plain version on a shard of ``tp_inputs``' delta (a ``wq`` stack)
    with the amax MAX over both groups."""
    from repro_torch.kernels.quantize import quantize_ef
    from repro_torch.optim.base import global_norm
    from repro_torch.optim.muon import muon
    x = tp_inputs()
    grads = mesh.own(x["muon"])
    opt = muon(0.02, axis=mesh)
    upd, _ = opt.update(grads, opt.init(grads), grads,
                        torch.zeros((), dtype=torch.int32))
    k = "layers/attn/wq"
    d = mesh.own({k: x["delta"]})[k]
    r = mesh.own({k: x["residual"]})[k]
    return {"muon": upd, "global_norm": global_norm(mesh.own(params), mesh),
            "quantize": quantize_ef(
                d, r, dtype="int8",
                amax_reduce=lambda a: mesh.reduce_leaves([k], [a],
                                                         "max")[0])}


def fsdp_round(mesh, params, cfg, dkw, before=None) -> dict:
    """Two inner steps and one DiLoCo round (K 2, H 2) at engine level on
    this rank's shards: from the shared ``params``, or with the worker
    set to ``before`` (one-process flat tensors of this pod's worker)
    just before the round.  Returns the worker just before the round
    (this rank's), the state after it, the wire's codes and scales, the
    drift-aware weights and the averaged delta (when ``dkw`` asks for
    them), the cross-pod bytes and the records of the round."""
    from repro_torch.configs import DiLoCoConfig, OptimizerConfig
    from repro_torch.core import DiLoCoTrainer, outer_opt
    from repro_torch.launch import collectives as coll
    from repro_torch.models import lm_loss
    from repro_torch.models.transformer import unflatten
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=2, **dkw)
    eng = DiLoCoTrainer(lambda p, b: lm_loss(p, b, cfg),
                        OptimizerConfig(**OPT), dcfg, mesh.replicate_fn)
    st = eng.init(unflatten(params))
    res = eng.init_residual(st.global_params)
    if before is None:
        data = worker_data(dataset())
        for i in range(2):
            st, _ = eng.inner_step(st, _tensors(mesh.local_batch(data(i))))
    else:
        for k, t in mesh.own(before).items():
            st.worker_params[0][k].copy_(t)
    worker = _clone(st.worker_params[0])
    seen = {"weights": [], "average": []}
    orig_w, orig_a = outer_opt.drift_weights, outer_opt._average

    def weights(*a, **kw):
        w = orig_w(*a, **kw)
        seen["weights"].append(w.clone())
        return w

    def average(delta, *a, **kw):
        out = orig_a(delta, *a, **kw)
        seen["average"].append((_clone(delta), _clone(out)))
        return out

    outer_opt.drift_weights, outer_opt._average = weights, average
    coll.reset_log()
    try:
        with WireLog() as wire, coll.scope("outer"):
            st, res = eng.outer_step_ef(st, res)
    finally:
        outer_opt.drift_weights, outer_opt._average = orig_w, orig_a
    outer = coll.records("outer")
    return dict(_state(st, res), before=worker, wire=dict(wire),
                weights=seen["weights"],
                average=seen["average"] if dcfg.drift_aware else [],
                cross_pod=sum(r.nbytes for r in outer if r.cross_pod),
                records=[(r.kind, r.axis, r.cross_pod, r.nbytes)
                         for r in outer])


def fsdp4(rank: int, world: int, init_method: str, workdir: str) -> None:
    """Four ranks, on the meshes of ``FSDP_MESHES`` (each fsdp mesh beside
    its replicated twin): the unit checks and one step's gradients and
    Muon update on (data 2, model 2); 2 DDP steps on (data 4) and on
    (data 2, model 2); a DiLoCo round through ``DistTrainer.run`` on
    (pod 2, data 2), f32 and int8; an int8 round at engine level on the
    replicated (pod 2, data 2) mesh, then on the fsdp one from the
    replicated run's worker just before it; drift-aware int8 rounds on
    (pod 2, model 2) and fsdp (pod 2, data 2); ``FSDP_CKPT`` written at
    step 2 and resumed to 4, and uninterrupted; a rank's live state
    bytes.  Writes ``fsdp_rank<r>.pt``."""
    from repro_torch.configs import DiLoCoConfig, OptimizerConfig
    from repro_torch.core import DiLoCoTrainer
    from repro_torch.core.ddp import DDPTrainer
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.launch.state import live_state_bytes
    from repro_torch.models import lm_loss
    from repro_torch.models.transformer import unflatten
    torch.set_num_threads(1)
    kw = dict(backend="gloo", device="cpu", rank=rank, world_size=world,
              init_method=init_method, timeout_s=TIMEOUT_S)
    cfgs = {"tiny": tiny(), "tp_cfg": tp_cfg()}
    flat = {"tiny": torch.load(os.path.join(workdir, "params.pt")),
            "tp_cfg": torch.load(os.path.join(workdir, "params_tp.pt"))}
    meshes = {name: init_process_mesh(*shape, cfg=cfgs[c], fsdp=f, **kw)
              for name, (shape, f, c) in FSDP_MESHES.items()}
    out = {"index": {n: (m.pod_index, m.data_index, m.model_index)
                     for n, m in meshes.items()},
           "layout": {n: (m.layout, m.data_layout)
                      for n, m in meshes.items()}}
    tiny_p, tp_p = flat["tiny"], flat["tp_cfg"]
    out["units"] = fsdp_units(meshes["d2m2f"], tp_p)
    for n in ("d2m2f", "d2m2r"):
        out[f"grads_{n}"] = fsdp_grads(meshes[n], tp_p, cfgs["tp_cfg"])
    for n, c in (("d4f", "tiny"), ("d4r", "tiny"), ("d2m2f", "tp_cfg"),
                 ("d2m2r", "tp_cfg")):
        dt = ddp_trainer(meshes[n].replicate_fn, cfg=cfgs[c])
        st, hist = dt.run(dt.init(unflatten(flat[c])), ddp_data(dataset()),
                          2)
        out[f"ddp_{n}"] = dict(_state(st), hist=hist)
    for wire, case in FSDP_DILOCO.items():
        for n in ("p2d2f", "p2d2r"):
            out[f"run_{wire}_{n}"] = run_case(case, tiny_p,
                                              meshes[n].replicate_fn)
    # an int8 round from one shared state: the replicated mesh's, then
    # the fsdp mesh's from its worker just before the round
    dkw = dict(delta_dtype="int8")
    rep = fsdp_round(meshes["p2d2r"], tiny_p, cfgs["tiny"], dkw)
    out["round_p2d2r"] = rep
    out["round_p2d2f"] = fsdp_round(meshes["p2d2f"], tiny_p, cfgs["tiny"],
                                    dkw, before=rep["before"])
    out["drift_p2m2"] = fsdp_round(meshes["p2m2"], tp_p, cfgs["tp_cfg"],
                                   FSDP_DRIFT)
    out["drift_p2d2f"] = fsdp_round(meshes["p2d2f"], tiny_p, cfgs["tiny"],
                                    FSDP_DRIFT)
    ckpt = os.path.join(workdir, "fsdp_ckpt")
    rep_f = meshes["p2d2f"].replicate_fn
    out["ckpt_first"] = run_case(dict(FSDP_CKPT, steps=2), tiny_p, rep_f,
                                 checkpoint_dir=ckpt, checkpoint_every=2)
    out["ckpt_resumed"] = run_case(FSDP_CKPT, tiny_p, rep_f,
                                   checkpoint_dir=ckpt, resume=True)
    out["ckpt_whole"] = run_case(FSDP_CKPT, tiny_p, rep_f)
    # the live state of a rank, as each trainer holds it after init
    live = {}
    for n, c in (("d4f", "tiny"), ("d2m2f", "tp_cfg")):
        st = DDPTrainer(lambda p, b: None, OptimizerConfig(**OPT),
                        meshes[n].replicate_fn).init(flat[c])
        live[f"ddp_{n}"] = live_state_bytes(st)
    for n in ("p2d2f", "p2d2r"):
        eng = DiLoCoTrainer(lambda p, b: lm_loss(p, b, cfgs["tiny"]),
                            OptimizerConfig(**OPT),
                            DiLoCoConfig(num_workers=2, **dkw),
                            meshes[n].replicate_fn)
        st = eng.init(tiny_p)
        live[f"diloco_{n}"] = live_state_bytes(
            st, eng.init_residual(st.global_params))
    out["live_bytes"] = live
    torch.save(out, os.path.join(workdir, f"fsdp_rank{rank}.pt"))
    meshes["d4f"].close()
