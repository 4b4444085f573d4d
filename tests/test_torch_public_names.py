"""The public names the JAX package exports and the port now has too,
each held to its original on the CPU: ``optim.sgd_nesterov`` and
``optim.chain_clip``, ``core.register_strategy`` (a registered strategy
is what ``make_strategy`` builds), ``core.fragment_fraction``, the codec
classes ``core.Codec`` / ``F32Passthrough`` / ``BF16Cast`` /
``Int8Symmetric``, and ``launch.CommModel`` / ``simulate_schedule`` /
``modeled_step_time`` / ``default_comm_model``.  Every numeric comparison
is bit for bit unless stated: the same f32 operations in the same
order."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.launch as jax_launch
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.core import streaming as jax_streaming
from repro.optim import base as jax_base
from repro.optim.sgd_nesterov import sgd_nesterov as jax_sgd_nesterov
from repro_torch import core, launch, optim
from repro_torch.configs import DiLoCoConfig
from repro_torch.core import sync, transport
from repro_torch.launch import comm_sim

torch.set_num_threads(1)

SHAPES = {"embed/table": (11, 6), "layers/attn/wq": (3, 6, 6),
          "layers/ln1/scale": (3, 6), "final_norm/scale": (6,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax(flat):
    return {k: jnp.asarray(v) for k, v in flat.items()}


def _torch(flat):
    return {k: torch.from_numpy(v.copy()) for k, v in flat.items()}


def _same(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def test_sgd_nesterov_math():
    """``tests/test_optim.py``'s case: lr 1, momentum 0.5, Nesterov."""
    opt = optim.sgd_nesterov(lr=1.0, momentum=0.5, nesterov=True)
    p = {"w": torch.zeros(2)}
    upd, _ = opt.update({"w": torch.tensor([1.0, 2.0])}, opt.init(p), p,
                        torch.tensor(0, dtype=torch.int32))
    np.testing.assert_allclose(upd["w"].numpy(), -(np.array([1.0, 2.0])
                                                   + 0.5 * np.array([1.0,
                                                                     2.0])))


@pytest.mark.parametrize("nesterov", [True, False])
@pytest.mark.parametrize("lr", [0.8, "schedule"])
def test_sgd_nesterov_matches_the_reference_over_steps(nesterov, lr):
    """Three updates from the same gradients: updates and momentum."""
    lr_fn = (lambda s: 0.8 / (1.0 + s)) if lr == "schedule" else lr
    jopt = jax_sgd_nesterov(lr=lr_fn, momentum=0.9, nesterov=nesterov)
    opt = optim.sgd_nesterov(lr=lr_fn, momentum=0.9, nesterov=nesterov)
    p = _tree(0)
    js, ts = jopt.init(_jax(p)), opt.init(_torch(p))
    for step in range(3):
        g = _tree(step + 1, 0.1)
        ju, js = jopt.update(_jax(g), js, _jax(p), step)
        tu, ts = opt.update(_torch(g), ts, _torch(p), step)
        for k in p:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(ts["v"][k].numpy(),
                                       np.asarray(js["v"][k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
            assert tu[k].dtype == torch.float32


@pytest.mark.parametrize("max_norm", [0.05, 100.0])
def test_chain_clip_matches_the_reference(max_norm):
    """Clipping that bites (0.05) and one that does not (100): the wrapped
    optimizer sees the clipped gradients and its updates match."""
    jopt = jax_base.chain_clip(jax_sgd_nesterov(lr=0.5), max_norm)
    opt = optim.chain_clip(optim.sgd_nesterov(lr=0.5), max_norm)
    p, g = _tree(3), _tree(4, 0.2)
    ju, _ = jopt.update(_jax(g), jopt.init(_jax(p)), _jax(p), 0)
    tu, _ = opt.update(_torch(g), opt.init(_torch(p)), _torch(p), 0)
    for k in p:
        np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


def test_register_strategy_reaches_make_strategy():
    """A plugin strategy registered under a new name is what
    ``make_strategy`` builds for that ``DiLoCoConfig.strategy``, with the
    config and H schedule handed to its factory; the decorator returns the
    factory, as the reference's does; the built-in names stay the
    reference's, in its order."""
    seen = []

    @core.register_strategy("test_plugin")
    def factory(cfg, h_schedule):
        seen.append((cfg.num_workers, h_schedule))
        return sync.DiLoCoSync(h_schedule=h_schedule)

    try:
        assert callable(factory) and "test_plugin" in core.strategy_names()
        strat = core.make_strategy(DiLoCoConfig(num_workers=3,
                                                strategy="test_plugin"))
        assert isinstance(strat, sync.DiLoCoSync)
        assert seen == [(3, None)]
    finally:
        del sync._STRATEGY_REGISTRY["test_plugin"]
    assert core.strategy_names() == jax_core.strategy_names()
    with pytest.raises(ValueError, match="test_plugin"):
        core.make_strategy(DiLoCoConfig(strategy="test_plugin"))


def _nested(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


@pytest.mark.parametrize("num_fragments", [1, 2, 3, 4])
def test_fragment_fraction_matches_the_reference(num_fragments):
    """Each fragment's share of the elements, from the port's fragments
    (layer ranges) and the reference's boolean masks; they sum to 1."""
    p = _tree(5)
    jmasks = jax_streaming.fragment_masks(_nested(_jax(p)), num_fragments)
    frags = core.fragment_masks(_torch(p), num_fragments)
    got = [core.fragment_fraction(_torch(p), f) for f in frags]
    want = [jax_streaming.fragment_fraction(_nested(_jax(p)), m)
            for m in jmasks]
    assert got == want
    assert abs(sum(got) - 1.0) < 1e-12


@pytest.mark.parametrize("name", ["F32Passthrough", "BF16Cast",
                                  "Int8Symmetric"])
@pytest.mark.parametrize("residual", [False, True])
def test_exported_codecs_match_the_reference(name, residual):
    """The classes ``repro_torch.core`` exports are the transport's, and
    each encodes, decodes and sizes a payload as the reference's class of
    the same name (its jnp oracle for int8)."""
    cls = getattr(core, name)
    assert cls is getattr(transport, name) and issubclass(cls, core.Codec)
    jkw = {"use_kernel": False} if name == "Int8Symmetric" else {}
    jc, pc = getattr(jax_core, name)(**jkw), cls()
    assert (pc.name, pc.width, pc.lossy) == (jc.name, jc.width, jc.lossy)
    d, r = _tree(6, 1e-2), _tree(7, 1e-4)
    jp, jr = jc.encode(_jax(d), _jax(r) if residual else None)
    pp, pr = pc.encode(_torch(d), _torch(r) if residual else None)
    assert pp.nbytes() == jp.nbytes() and pp.codec == jp.codec
    jd, pd = jc.decode(jp), pc.decode(pp)
    for k in d:
        got, want = pp.data[k], jp.data[k]
        if got.dtype == torch.bfloat16:
            got, want = got.float(), jnp.asarray(want, jnp.float32)
        _same(got, want, f"data {k}")
        if jp.scales is not None:
            _same(pp.scales[k], jp.scales[k], f"scale {k}")
        _same(pd[k], jd[k], f"decode {k}")
        if residual:
            _same(pr[k], jr[k], f"residual {k}")


def test_exported_comm_model_names_match_the_reference():
    """``repro_torch.launch`` exports the comm simulator's names; on the
    same events and link they give the reference's results; the default
    model is the port's own link (a 100 Gbit/s port), not the TPU's."""
    for name in ("CommModel", "simulate_schedule", "modeled_step_time",
                 "default_comm_model"):
        assert getattr(launch, name) is getattr(comm_sim, name)
        assert name in launch.__all__ and name in jax_launch.__all__
    link = dict(bandwidth=2e8, latency=2e-3)
    assert [f.name for f in dataclasses.fields(launch.CommModel)] == \
        [f.name for f in dataclasses.fields(jax_launch.CommModel)]
    port = sync.DiLoCoSync(h=4).payload_schedule(
        1_000_000, 16, DiLoCoConfig(num_workers=4, h_inner_steps=4,
                                    delta_dtype="int8"))
    ref = jax_core.DiLoCoSync(h=4).payload_schedule(
        1_000_000, 16, JaxDiLoCoConfig(num_workers=4, h_inner_steps=4,
                                       delta_dtype="int8"))
    assert launch.simulate_schedule(port, 16, 0.01,
                                    launch.CommModel(**link)) == \
        jax_launch.simulate_schedule(ref, 16, 0.01,
                                     jax_launch.CommModel(**link))
    assert launch.modeled_step_time(3e15, 0.4, peak_flops=1e15) == \
        jax_launch.modeled_step_time(3e15, 0.4, peak_flops=1e15)
    assert launch.modeled_step_time(3e15) == \
        3e15 / (comm_sim.PEAK_FLOPS_BF16 * 0.4)
    dm = launch.default_comm_model()
    assert isinstance(dm, launch.CommModel)
    assert dm.bandwidth == comm_sim.LINK_BW
