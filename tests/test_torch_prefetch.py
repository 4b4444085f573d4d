"""The port's chunked loop machinery, on the CPU: the ``Prefetcher`` and
``stack_batches`` (``repro_torch.data.pipeline``) case by case as
``tests/test_chunked.py`` pins the JAX package's, each against the JAX
``Prefetcher`` on the same ``data_fn``; and through ``DistTrainer.run``:
prefetch equal to no prefetch bit for bit, the eval hook splitting a
chunk, ``record_every``, ``max_chunk`` and one read of the losses per
chunk, with the eval steps, eval values and thinned history held against
the JAX ``DistTrainer`` (losses and eval values rtol 1e-5, as the
training tests hold the port).  Sizes are ``tests/helpers.py``'s tiny
dense config; batches are made with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core import DiLoCoSync as JaxDiLoCoSync
from repro.core import DistTrainer as JaxDistTrainer
from repro.data.pipeline import Prefetcher as JaxPrefetcher
from repro.data.pipeline import stack_batches as jax_stack_batches
from repro.models import build_model
from repro.models.transformer import init_params as jax_init
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.core import (DDPSync, DiLoCoSync, DistTrainer,
                              OverlappedSync, PipelinedSync, StreamingSync)
from repro_torch.core import dist_trainer as dist_trainer_mod
from repro_torch.data import Prefetcher, stack_batches
from repro_torch.models import lm_loss
from torch_parity import port_cfg, port_params

torch.set_num_threads(1)

CFG = tiny_cfg("dense")
PCFG = port_cfg(CFG)
OPT = dict(total_steps=100, warmup_steps=0, schedule="constant",
           learning_rate=0.02, adam_lr=1e-3)


@pytest.fixture(scope="module")
def jparams():
    return jax_init(CFG, jax.random.key(0))[0]


def _np_data(k, step, B=2, S=16):
    toks = np.random.default_rng(1000 + step).integers(
        0, CFG.vocab_size, (k, B, S + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _dcfg(k, h):
    if k == 1:
        return DiLoCoConfig(num_workers=1, h_inner_steps=1, outer_lr=1.0,
                            outer_momentum=0.0, nesterov=False)
    return DiLoCoConfig(num_workers=k, h_inner_steps=h)


def _run(params, strategy, k, h, steps, **kw):
    dt = DistTrainer(lambda p, b: lm_loss(p, b, PCFG), OptimizerConfig(**OPT),
                     _dcfg(k, h), strategy)
    return dt.run(dt.init(params), lambda s: _np_data(k, s), steps, **kw)


def _assert_state_equal(a, b):
    for k in a.global_params:
        assert torch.equal(a.global_params[k], b.global_params[k]), k
        for wa, wb in zip(a.worker_params, b.worker_params):
            assert torch.equal(wa[k], wb[k]), k


def _assert_hist_equal(a, b):
    for key in ("step", "loss", "sync_steps", "frag_syncs", "evals"):
        assert a[key] == b[key], key


# ---------------------------------------------------------------------------
# Prefetcher units, each beside the JAX Prefetcher
# ---------------------------------------------------------------------------

def _both(data_fn, n, depth):
    return Prefetcher(data_fn, n, depth=depth), JaxPrefetcher(data_fn, n,
                                                              depth=depth)


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_prefetcher_orders_and_stacks():
    fn = lambda s: {"x": np.full((2, 3), s, np.int32)}
    pf, jpf = _both(fn, 7, 2)
    try:
        a = pf.take(0, 3)
        assert a["x"].shape == (3, 2, 3)
        assert [int(a["x"][i, 0, 0]) for i in range(3)] == [0, 1, 2]
        _same(a, jpf.take(0, 3))
        b = pf.take(3, 4)
        assert [int(b["x"][i, 0, 0]) for i in range(4)] == [3, 4, 5, 6]
        _same(b, jpf.take(3, 4))
    finally:
        pf.close()
        jpf.close()


def test_prefetcher_starts_at_the_resume_cursor():
    fn = lambda s: {"x": np.full((2,), s, np.int32)}
    pf = Prefetcher(fn, 9, depth=3, start=5)
    jpf = JaxPrefetcher(fn, 9, depth=3, start=5)
    try:
        got = pf.take(5, 4)
        assert [int(got["x"][i, 0]) for i in range(4)] == [5, 6, 7, 8]
        _same(got, jpf.take(5, 4))
        pf._thread.join(timeout=5)          # produced 5..8, then stopped
        assert not pf._thread.is_alive() and pf._q.empty()
    finally:
        pf.close()
        jpf.close()


def test_prefetcher_surfaces_producer_error():
    def bad(step):
        if step == 2:
            raise RuntimeError("boom")
        return {"x": np.zeros(2)}

    for cls in (Prefetcher, JaxPrefetcher):
        pf = cls(bad, 5, depth=2)
        try:
            with pytest.raises(RuntimeError, match="boom"):
                pf.take(0, 5)
        finally:
            pf.close()


def test_prefetcher_close_unblocks_full_queue():
    pf = Prefetcher(lambda s: {"x": np.zeros(4)}, 1000, depth=2)
    pf.take(0, 1)
    pf.close()      # must not hang with the producer parked on a full queue
    assert not pf._thread.is_alive()


def test_prefetcher_prime_matches_take():
    """A primed chunk with matching bounds is returned verbatim; priming
    never changes what take() produces."""
    fn = lambda s: {"x": np.full((2,), s, np.int32)}
    pf, jpf = _both(fn, 9, 3)
    try:
        _same(pf.take(0, 2), jpf.take(0, 2))
        pf.prime(2, 3)
        jpf.prime(2, 3)
        b = pf.take(2, 3)
        assert [int(b["x"][i, 0]) for i in range(3)] == [2, 3, 4]
        _same(b, jpf.take(2, 3))
        pf.prime(5, 4)
        jpf.prime(5, 4)
        _same(pf.take(5, 4), jpf.take(5, 4))
    finally:
        pf.close()
        jpf.close()


def test_prefetcher_prime_mismatch_falls_back_losslessly():
    """If the consumer's chunk bounds moved after priming, take() recovers
    the raw items and serves the requested bounds exactly."""
    fn = lambda s: {"x": np.full((2,), s, np.int32)}
    pf, jpf = _both(fn, 10, 4)
    try:
        for p in (pf, jpf):
            p.prime(0, 4)                     # guess: steps 0..3
        a = pf.take(0, 2)                     # actual chunk is shorter
        assert [int(a["x"][i, 0]) for i in range(2)] == [0, 1]
        _same(a, jpf.take(0, 2))
        b = pf.take(2, 5)                     # next chunk spans leftovers
        assert [int(b["x"][i, 0]) for i in range(5)] == [2, 3, 4, 5, 6]
        _same(b, jpf.take(2, 5))
        for p in (pf, jpf):
            p.prime(7, 2)
        c = pf.take(7, 3)                     # longer than primed
        assert [int(c["x"][i, 0]) for i in range(3)] == [7, 8, 9]
        _same(c, jpf.take(7, 3))
    finally:
        pf.close()
        jpf.close()


def test_prefetcher_prime_surfaces_producer_error():
    def bad(step):
        if step == 1:
            raise RuntimeError("boom")
        return {"x": np.zeros(2)}

    pf = Prefetcher(bad, 5, depth=2)
    try:
        pf.prime(0, 3)
        with pytest.raises(RuntimeError, match="boom"):
            pf.take(0, 3)
    finally:
        pf.close()


def test_stack_batches():
    batches = [{"a": np.arange(3)}, {"a": np.arange(3) + 10}]
    out = stack_batches(batches)
    assert torch.equal(out["a"], torch.tensor([[0, 1, 2], [10, 11, 12]]))
    np.testing.assert_array_equal(out["a"].numpy(),
                                  np.asarray(jax_stack_batches(batches)["a"]))
    # tensors stack where they lie, then move to the device asked for
    t = stack_batches([{"a": torch.ones(2)}, {"a": torch.zeros(2)}], "cpu")
    assert t["a"].shape == (2, 2) and t["a"].device.type == "cpu"


# ---------------------------------------------------------------------------
# Through DistTrainer.run
# ---------------------------------------------------------------------------

STRATEGIES = {
    "ddp": (1, lambda: DDPSync()),
    "diloco": (2, lambda: DiLoCoSync()),
    "streaming": (2, lambda: StreamingSync(num_fragments=2)),
    "overlapped": (3, lambda: OverlappedSync(delay=2, jitter=1, seed=3)),
    "pipelined": (2, lambda: PipelinedSync(num_fragments=2, delay=1)),
}


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_prefetch_is_drop_in(jparams, name):
    """Prefetch 3 equals prefetch 0 bit for bit, for every strategy (h 4,
    10 steps: trailing partial rounds and the flush paths)."""
    k, make = STRATEGIES[name]
    params = port_params(CFG, jparams)
    ref_state, ref_hist = _run(params, make(), k, 4, 10)
    pf_state, pf_hist = _run(params, make(), k, 4, 10, prefetch=3)
    _assert_state_equal(ref_state, pf_state)
    _assert_hist_equal(ref_hist, pf_hist)


def _param_sum(p):
    return float(sum(float(v.double().sum()) for v in p.values()))


def test_eval_mid_chunk_splits_and_matches_jax(jparams):
    """eval_every 3 with H 4: evals land mid-round and split the chunks —
    the same (step, value) pairs as the per-step loop, bit for bit, and
    as the JAX DistTrainer's steps (values rtol 1e-5); record_every 2
    thins the loss history as the JAX package's does; syncs do not
    drift."""
    params = port_params(CFG, jparams)
    kw = dict(eval_fn=_param_sum, eval_every=3, record_every=2)
    ref_state, ref_hist = _run(params, DiLoCoSync(), 2, 4, 12,
                               chunked=False, **kw)
    chk_state, chk_hist = _run(params, DiLoCoSync(), 2, 4, 12, prefetch=2,
                               **kw)
    assert [s for s, _ in chk_hist["evals"]] == [2, 5, 8, 11]
    assert chk_hist["sync_steps"] == [3, 7, 11]
    assert chk_hist["step"] == [0, 2, 4, 6, 8, 10]
    _assert_hist_equal(ref_hist, chk_hist)
    _assert_state_equal(ref_state, chk_state)

    model = build_model(CFG)
    jdt = JaxDistTrainer(model.loss, JaxOptimizerConfig(**OPT),
                         JaxDiLoCoConfig(num_workers=2, h_inner_steps=4),
                         JaxDiLoCoSync())
    jeval = lambda p: float(sum(float(np.asarray(x, np.float64).sum())
                                for x in jax.tree.leaves(p)))
    _, jhist = jdt.run(jdt.init(jparams),
                       lambda s: {k: jnp.asarray(v) for k, v in
                                  _np_data(2, s).items()}, 12,
                       eval_fn=jeval, eval_every=3, record_every=2)
    assert chk_hist["step"] == jhist["step"]
    assert chk_hist["sync_steps"] == jhist["sync_steps"]
    assert [s for s, _ in chk_hist["evals"]] == [s for s, _ in
                                                 jhist["evals"]]
    np.testing.assert_allclose([v for _, v in chk_hist["evals"]],
                               [v for _, v in jhist["evals"]], rtol=1e-5)
    np.testing.assert_allclose(chk_hist["loss"], jhist["loss"], rtol=1e-5)


def test_eval_hook_sees_refreshed_global_params_under_ddp(jparams):
    """DDP keeps its global parameters in the worker: refresh() hands the
    eval hook the worker's current tensors."""
    params = port_params(CFG, jparams)
    seen = []
    state, hist = _run(params, DDPSync(), 1, 1, 4,
                       eval_fn=lambda g: seen.append(
                           {k: v.clone() for k, v in g.items()}) or 0.0,
                       eval_every=2)
    assert [s for s, _ in hist["evals"]] == [1, 3]
    for k, v in seen[-1].items():
        assert torch.equal(v, state.worker_params[0][k]), k
    assert not all(torch.equal(seen[0][k], seen[1][k]) for k in seen[0])


@pytest.mark.parametrize("max_chunk,fetches", [(0, 1), (3, 3), (128, 1)])
def test_max_chunk_caps_the_chunk_and_one_read_per_chunk(jparams,
                                                         monkeypatch,
                                                         max_chunk,
                                                         fetches):
    """8 steps at H 8: one chunk (one read of the losses), or 3 + 3 + 2
    under max_chunk 3, the same parameters either way."""
    calls = []
    real = dist_trainer_mod._fetch
    monkeypatch.setattr(dist_trainer_mod, "_fetch",
                        lambda x: calls.append(1) or real(x))
    params = port_params(CFG, jparams)
    ref_state, _ = _run(params, DiLoCoSync(), 2, 8, 8)
    calls.clear()
    state, hist = _run(params, DiLoCoSync(), 2, 8, 8, max_chunk=max_chunk)
    assert len(calls) == fetches
    assert hist["sync_steps"] == [7]
    _assert_state_equal(ref_state, state)
