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


def diloco_trainer(wire: str, replicate_fn=None, k: int = 2):
    from repro_torch.configs import DiLoCoConfig, OptimizerConfig
    from repro_torch.core import DistTrainer, make_strategy
    from repro_torch.models import lm_loss
    cfg = tiny()
    dcfg = DiLoCoConfig(num_workers=k, h_inner_steps=2, delta_dtype=wire)
    return DistTrainer(lambda p, b: lm_loss(p, b, cfg),
                       OptimizerConfig(**OPT), dcfg, make_strategy(dcfg),
                       replicate_fn)


def ddp_trainer(replicate_fn=None):
    from repro_torch.configs import DiLoCoConfig, OptimizerConfig
    from repro_torch.core import DistTrainer, make_strategy
    from repro_torch.models import lm_loss
    cfg = tiny()
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
