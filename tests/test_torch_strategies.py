"""The port's sync strategies on the codec wire against the JAX package,
on the CPU: ``run_stage`` of DiLoCo with each codec (and without error
feedback, and drift-aware), compressed DDP, streaming, overlapped and
pipelined sync against the JAX ``run_stage`` on the same data; and inside
the port, the reference's own invariants (DiLoCo K 1 == DDP, overlapped
delay 0 / streaming F 1 / pipelined F 1 == DiLoCo, compressed DDP f32 ==
per-step delta-averaged DDP, chunked == per-step with a residual), the
wire-bytes count and the CLI.

Sizes are ``tests/helpers.py``'s tiny dense config, all in float32."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.data.pipeline import PackedDataset as JaxPackedDataset
from repro.launch.train import run_stage as jax_run_stage
from repro.models import build_model
from repro.models.transformer import init_params as jax_init
from repro_torch.checkpoint import params_to_numpy
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.core import (DDPSync, DiLoCoSync, DistTrainer,
                              OverlappedSync, PipelinedSync, StreamingSync,
                              compressed_ddp_config, make_strategy, transport)
from repro_torch.core.diloco import worker_step
from repro_torch.data import PackedDataset
from repro_torch.launch import train
from repro_torch.models import lm_loss
from repro_torch.optim import nanochat_optimizer
from torch_parity import jax_flat, port_cfg, port_params

torch.set_num_threads(1)

OPT = dict(total_steps=8, warmup_steps=2, schedule="wsd",
           learning_rate=0.02, adam_lr=1e-3)
# wire codec -> its widest code step in units of amax: int8 1/127; fp8
# the spacing of the top binade over QMAX (e4m3 32/448, e5m2 8192/57344)
CODE_STEP = {"int8": 1 / 127, "fp8": 32 / 448, "fp8_e5m2": 8192 / 57344}


@pytest.fixture(scope="module")
def jparams():
    return jax_init(tiny_cfg("dense"), jax.random.key(0))[0]


def _datasets(seq_len=16, n=4000):
    tokens = np.random.default_rng(5).integers(0, 97, n).astype(np.int32)
    return (JaxPackedDataset(tokens, seq_len),
            PackedDataset(tokens.copy(), seq_len))


def _record_quanta(monkeypatch, codec: str):
    """Wrap the port's exchange to record, per leaf, the widest code step
    of the run: amax(|delta + residual|) times ``CODE_STEP`` for int8 /
    fp8, one bf16 ulp at that amax for bf16, 0 for f32."""
    quanta = {}
    orig = transport.Transport.exchange

    def exchange(self, delta, residual=None, **kw):
        for k, d in delta.items():
            e = d if residual is None else d + residual[k]
            amax = float(e.abs().max()) if e.numel() else 0.0
            if codec in CODE_STEP:
                q = amax * CODE_STEP[codec]
            elif codec == "bf16":
                q = 2.0 ** (np.floor(np.log2(amax)) - 7) if amax else 0.0
            else:
                q = 0.0
            quanta[k] = max(quanta.get(k, 0.0), q)
        return orig(self, delta, residual, **kw)

    monkeypatch.setattr(transport.Transport, "exchange", exchange)
    return quanta


# (method, DiLoCoConfig fields, h, steps)
CASES = {
    "diloco-int8": ("diloco", dict(delta_dtype="int8"), 2, 4),
    "diloco-fp8": ("diloco", dict(delta_dtype="fp8"), 2, 4),
    "diloco-fp8_e5m2": ("diloco", dict(delta_dtype="fp8_e5m2"), 2, 4),
    "diloco-bf16": ("diloco", dict(delta_dtype="bfloat16"), 2, 4),
    "diloco-int8-no-ef": ("diloco", dict(delta_dtype="int8",
                                         error_feedback=False), 2, 4),
    "diloco-drift-aware": ("diloco", dict(drift_aware=True), 2, 4),
    "ddp-grad-compress-int8": ("ddp", dict(grad_compress="int8"), 2, 4),
    "streaming-f2-int8": ("streaming", dict(delta_dtype="int8",
                                            num_fragments=2), 2, 4),
    "overlapped-delay1-int8": ("overlapped", dict(delta_dtype="int8",
                                                  sync_delay=1), 2, 4),
    "overlapped-delay1-jitter1-int8": (
        "overlapped", dict(delta_dtype="int8", sync_delay=1, h_jitter=1,
                           sync_seed=3), 3, 6),
    "pipelined-f2-delay1-int8": ("pipelined", dict(
        delta_dtype="int8", num_fragments=2, sync_delay=1), 2, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_stage_matches_jax(jparams, monkeypatch, case):
    """The port's run_stage against the JAX run_stage (K 2, per-worker
    batch 2) from the same parameters on the same worker_batches: losses
    within rtol 1e-5, sync and fragment-sync records exactly, final
    parameters within the f32 DiLoCo test's 2e-5 (Muon and the inner
    steps sum in another order) plus, on elements where that moved a code
    across a rounding boundary, one quantum (the leaf's widest code step
    x outer_lr x (1 + mu)).
    The JAX package runs its Pallas kernels in interpret mode, whose
    scales may sit one ulp off the oracle the port follows."""
    method, dkw, h, steps = CASES[case]
    cfg = tiny_cfg("dense")
    jds, ds = _datasets()
    kw = dict(steps=steps, workers=2, per_worker_batch=2, h=h, seed=0)
    jout, jhist = jax_run_stage(
        method, build_model(cfg), jparams, jds,
        opt_cfg=JaxOptimizerConfig(**OPT),
        diloco_cfg=JaxDiLoCoConfig(**dkw), **kw)
    dcfg = DiLoCoConfig(**dkw)
    codec = transport.make_codec("int8" if method == "ddp"
                                 else dcfg.delta_dtype).name
    quanta = _record_quanta(monkeypatch, codec)
    out, hist = train.run_stage(
        method, port_cfg(cfg), port_params(cfg, jparams), ds,
        opt_cfg=OptimizerConfig(**OPT), diloco_cfg=dcfg, **kw)
    assert hist["step"] == jhist["step"] == list(range(steps))
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    assert hist["sync_steps"] == jhist["sync_steps"]
    assert hist["frag_syncs"] == jhist["frag_syncs"]
    assert hist["sync_steps"] or hist["frag_syncs"]
    eta, mu = ((1.0, 0.0) if method == "ddp" else
               (dcfg.outer_lr, dcfg.outer_momentum))
    got, want = params_to_numpy(out), jax_flat(jout)
    flipped = 0
    for k in want:
        err = np.abs(got[k] - want[k])
        over = err > 2e-5
        flipped += int(over.sum())
        np.testing.assert_array_less(
            err[over], 2e-5 + quanta.get(k, 0.0) * eta * (1 + mu),
            err_msg=k)
    print(f"{case}: {flipped} elements beyond 2e-5 (flipped codes)")


# ---------------------------------------------------------------------------
# The reference's invariants, inside the port
# ---------------------------------------------------------------------------

def _run(params, dcfg, strategy, steps, k=2, chunked=True, opt=None):
    cfg = port_cfg(tiny_cfg("dense"))
    _, ds = _datasets()
    dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg),
                     OptimizerConfig(**(opt or OPT)), dcfg, strategy)
    data = ((lambda s: ds.worker_batches(s, k, 2)) if k > 1 or
            not isinstance(strategy, DDPSync) else
            (lambda s: {n: v[None] for n, v in ds.batch(s, 2).items()}))
    return dt.run(dt.init(params()), data, steps, chunked=chunked)


def _equal_states(a, b):
    for k, v in a.global_params.items():
        assert torch.equal(v, b.global_params[k]), k
    for wa, wb in zip(a.worker_params, b.worker_params):
        for k in wa:
            assert torch.equal(wa[k], wb[k]), k


@pytest.fixture
def params(jparams):
    return lambda: port_params(tiny_cfg("dense"), jparams)


def test_diloco_k1_h1_lr1_mu0_matches_ddp(params):
    """DiLoCo with the identity outer step (K 1, H 1, lr 1, mu 0) is DDP:
    losses within rtol 1e-6, parameters within 1e-6 (anchor + (w -
    anchor) rounds through f32), as the reference pins it."""
    dcfg = DiLoCoConfig(num_workers=1, h_inner_steps=1, outer_lr=1.0,
                        outer_momentum=0.0, nesterov=False)
    sa, ha = _run(params, dcfg, DDPSync(), 6, k=1)
    sb, hb = _run(params, dcfg, DiLoCoSync(), 6, k=1)
    np.testing.assert_allclose(ha["loss"], hb["loss"], rtol=1e-6)
    for k, v in sa.global_params.items():
        np.testing.assert_allclose(v.numpy(), sb.global_params[k].numpy(),
                                   atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("codec", ["float32", "int8"])
def test_overlapped_delay0_is_diloco_bit_for_bit(params, codec):
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=4, delta_dtype=codec)
    sa, ha = _run(params, dcfg, DiLoCoSync(), 12)
    sb, hb = _run(params, dcfg, OverlappedSync(delay=0), 12)
    assert ha["sync_steps"] == hb["sync_steps"] == [3, 7, 11]
    assert ha["loss"] == hb["loss"]
    _equal_states(sa, sb)


def test_streaming_f1_is_diloco_bit_for_bit(params):
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=4, delta_dtype="int8",
                        num_fragments=1)
    sa, ha = _run(params, dcfg, DiLoCoSync(), 12)
    sb, hb = _run(params, dcfg, StreamingSync(num_fragments=1), 12)
    assert [s for s, _ in hb["frag_syncs"]] == ha["sync_steps"] == [3, 7, 11]
    assert ha["loss"] == hb["loss"]
    _equal_states(sa, sb)


@pytest.mark.parametrize("codec", ["float32", "fp8"])
def test_pipelined_f1_delay0_is_diloco_bit_for_bit(params, codec):
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=4, delta_dtype=codec,
                        num_fragments=1)
    sa, ha = _run(params, dcfg, DiLoCoSync(), 10)
    sb, hb = _run(params, dcfg, PipelinedSync(num_fragments=1, delay=0), 10)
    assert [s for s, _ in hb["frag_syncs"]] + hb["sync_steps"] == \
        ha["sync_steps"] == [3, 7, 9]
    assert ha["loss"] == hb["loss"]
    _equal_states(sa, sb)


def test_ddp_compressed_f32_is_per_step_delta_averaged_ddp(params):
    """Compressed DDP with the f32 wire at lr 1, mu 0: every step each of
    the K workers steps from the common parameters and the parameters
    become anchor + mean(w_i - anchor) — bit for bit against that loop
    written out by hand (0·v + d and anchor + 1·d are exact)."""
    cfg = port_cfg(tiny_cfg("dense"))
    _, ds = _datasets()
    dcfg = compressed_ddp_config(DiLoCoConfig(num_workers=2))
    state, hist = _run(params, dcfg, make_strategy(dcfg), 4)
    assert hist["sync_steps"] == [0, 1, 2, 3]
    opt = nanochat_optimizer(OptimizerConfig(**OPT))
    from repro_torch.models.transformer import flatten
    anchor = flatten(params())
    workers = [{k: v.clone() for k, v in anchor.items()} for _ in range(2)]
    states = [opt.init(w) for w in workers]
    losses = []
    for s in range(4):
        b = ds.worker_batches(s, 2, 2)
        step = torch.tensor(s, dtype=torch.int32)
        ls = []
        for i in range(2):
            states[i], loss = worker_step(
                lambda p, bb: lm_loss(p, bb, cfg), opt, workers[i],
                states[i], {n: torch.from_numpy(v[i]) for n, v in b.items()},
                step)
            ls.append(loss.item())
        losses.append(float((np.float32(ls[0]) + np.float32(ls[1]))
                            / np.float32(2)))
        with torch.no_grad():
            for k in anchor:
                d = ((workers[0][k] - anchor[k]) + (workers[1][k]
                                                    - anchor[k])) / 2
                anchor[k] = anchor[k] + d
                for w in workers:
                    w[k].copy_(anchor[k])
    assert hist["loss"] == losses
    for k, v in anchor.items():
        assert torch.equal(state.global_params[k], v), k


@pytest.mark.parametrize("name,dkw", [
    ("diloco", dict(delta_dtype="int8")),
    ("ddp_compressed", dict(grad_compress="fp8")),
    ("streaming", dict(delta_dtype="int8", num_fragments=2)),
    ("overlapped", dict(delta_dtype="int8", sync_delay=1, h_jitter=1)),
    ("pipelined", dict(delta_dtype="fp8_e5m2", num_fragments=2,
                       sync_delay=1))])
def test_chunked_equals_per_step_with_a_residual(params, name, dkw):
    """The chunked loop and the per-step loop give the same losses,
    records and parameters bit for bit with an error-feedback residual
    carried across rounds (5 steps at H 3: a partial last round)."""
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=3, strategy=name, **dkw)
    if name == "ddp_compressed":
        dcfg = compressed_ddp_config(dcfg)
    runs = [_run(params, dcfg, make_strategy(dcfg), 5, chunked=c)
            for c in (True, False)]
    (sa, ha), (sb, hb) = runs
    assert ha["loss"] == hb["loss"]
    assert ha["sync_steps"] == hb["sync_steps"]
    assert ha["frag_syncs"] == hb["frag_syncs"]
    assert ha["sync_steps"] or ha["frag_syncs"]
    _equal_states(sa, sb)


def test_shipped_wire_bytes_per_sync(params):
    """Each DiLoCo int8 round ships K rows of one byte per parameter plus
    a 4-byte scale per leaf and row; f32 ships 4 bytes per parameter."""
    from repro_torch.models.transformer import flatten
    flat = flatten(params())
    n, n_leaves = sum(v.numel() for v in flat.values()), len(flat)
    for codec, per_row in (("int8", n + 4 * n_leaves), ("float32", 4 * n)):
        transport.reset_shipped()
        dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=2,
                            delta_dtype=codec)
        _, hist = _run(params, dcfg, DiLoCoSync(), 4)
        name = transport.make_codec(codec).name
        assert dict(transport.shipped) == {
            name: 2 * per_row * len(hist["sync_steps"])}


def test_strategies_reject_bad_overlap_knobs(params):
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=2)
    for strat in (OverlappedSync(delay=2), OverlappedSync(delay=1, jitter=1),
                  PipelinedSync(delay=2)):
        with pytest.raises(ValueError, match="need"):
            _run(params, dcfg, strat, 1)
    bad = dataclasses.replace(compressed_ddp_config(dcfg), outer_lr=0.5)
    with pytest.raises(ValueError, match="identity outer update"):
        _run(params, bad, make_strategy(bad), 1)


@pytest.mark.parametrize("argv", [
    ["--method", "streaming", "--delta-dtype", "int8", "--fragments", "2"],
    ["--method", "overlapped", "--delta-dtype", "fp8", "--sync-delay", "1",
     "--h-jitter", "1"],
    ["--method", "pipelined", "--delta-dtype", "e5m2", "--fragments", "2",
     "--sync-delay", "1", "--no-error-feedback"],
    ["--method", "ddp", "--grad-compress", "int8"],
    ["--method", "diloco", "--delta-dtype", "bf16", "--drift-aware"]],
    ids=lambda a: "-".join(x.lstrip("-") for x in a[1:4]))
def test_train_cli_runs_each_strategy_on_cpu(capsys, argv):
    """The CLI runs the three stages under each strategy and wire; the
    base stage's line shows the wire bytes shipped."""
    res = train.main(["--device", "cpu", "--steps", "6", "--workers", "2"]
                     + argv)
    out = capsys.readouterr().out
    for stage in ("base", "mid", "sft"):
        assert (f"[{argv[1]}:{stage}] tiny-nanochat device=cpu "
                f"kernels=plain" in out)
    assert "wire_bytes={'" in out
    base = res["stages"]["base"]
    assert len(base["losses"]) == 6 and all(np.isfinite(base["losses"]))
    assert base["port"]["syncs"] and base["port"]["wire_bytes"]
