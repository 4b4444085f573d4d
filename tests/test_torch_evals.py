"""The port's evals against the JAX package, on the CPU: the sft-stage
``tasks`` and ``core`` of the port's ``run_pipeline("hybrid", ...)`` equal
the JAX ``chat_suite`` and ``heldout_metrics`` run on the checkpoint it
wrote (loaded through the JAX ``load_pytree`` / ``load_config``); on the
same parameters the raw eval outputs (the multiple-choice option scores
and the arith / pattern greedy rows) are equal between the packages, on
that trained tiny model and on a random reduced nanochat-d20 with the
tokenizer's vocab (a 65536-row head could emit ids the tokenizer cannot
decode).  One JAX ``Engine`` per model."""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_config as jax_load_config
from repro.checkpoint import load_pytree as jax_load_pytree
from repro.evals import chat_suite as jax_chat_suite
from repro.evals import heldout_metrics as jax_heldout_metrics
from repro.launch import train as jax_train
from repro.models import build_model
from repro.models.transformer import init_params as jax_init
from repro.serving import Engine as JaxEngine
from repro_torch import Engine
from repro_torch.checkpoint import (load_config, load_pytree,
                                    params_from_numpy)
from repro_torch.evals import (arith_exact, chat_suite, heldout_metrics,
                               mc_accuracy, pattern_exact)
from repro_torch.launch import train
from torch_parity import port_cfg, port_params

torch.set_num_threads(1)

STEPS = {"base": 8, "mid": 4, "sft": 4}
HELDOUT = dict(batches=4, batch_size=8)


@pytest.fixture(scope="module")
def world():
    """Both packages' tokenizer, stages and suites (the same texts)."""
    return train.build_pipeline(seq_len=64), jax_train.build_pipeline(
        seq_len=64)


@pytest.fixture(scope="module")
def hybrid_run(world, tmp_path_factory):
    """The port's hybrid pipeline with evals after each stage, from the
    JAX launcher's initial tiny parameters, and its final checkpoint."""
    (_, tok, _, _), _ = world
    jcfg, _ = jax_train.make_model("tiny", True, tok.vocab_size)
    jparams = jax_init(jcfg, jax.random.key(0))[0]
    out = tmp_path_factory.mktemp("hybrid")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "init_params",
                   lambda cfg, seed=0, device="cpu": port_params(jcfg,
                                                                 jparams))
        res = train.run_pipeline("hybrid", arch="tiny", steps=STEPS,
                                 workers=2, per_worker_batch=2, seq_len=64,
                                 eval_after_each_stage=True,
                                 out_dir=str(out), device="cpu")
    return res, str(out / "hybrid_final")


def _engines(world, ckpt=None, arch=None):
    """(port Engine, JAX Engine) on one set of parameters: the checkpoint
    ``ckpt`` (through each package's loader), or random parameters of
    ``make_model(arch, True, vocab)`` carried across."""
    (_, tok, _, _), (_, jtok, _, _) = world
    if ckpt is not None:
        jcfg = jax_load_config(ckpt)
        jparams = jax_load_pytree(jax_init(jcfg, jax.random.key(0))[0], ckpt)
        cfg = load_config(ckpt)
        params = params_from_numpy(load_pytree(ckpt), cfg, "cpu")
    else:
        jcfg, _ = jax_train.make_model(arch, True, tok.vocab_size)
        jparams = jax_init(jcfg, jax.random.key(3))[0]
        cfg, params = port_cfg(jcfg), port_params(jcfg, jparams)
    return (Engine(cfg, params, tok, device="cpu"),
            JaxEngine(build_model(jcfg), jparams, jtok))


@pytest.fixture(scope="module")
def trained_engines(world, hybrid_run):
    return _engines(world, ckpt=hybrid_run[1])


@pytest.fixture(scope="module")
def d20_engines(world):
    return _engines(world, arch="nanochat-d20")


def test_pipeline_evals_equal_jax_on_its_checkpoint(world, hybrid_run,
                                                    trained_engines):
    """The port run's sft-stage ``tasks`` and ``core`` equal the JAX
    ``chat_suite`` and ``heldout_metrics`` on the checkpoint it wrote
    (rtol 1e-5), and every stage recorded both."""
    (_, _, _, _), (_, jtok, jstages, jsuites) = world
    res, _ = hybrid_run
    _, jeng = trained_engines
    sft = res["stages"]["sft"]
    want_tasks = jax_chat_suite(jeng, jtok, jsuites)
    want_core = jax_heldout_metrics(ds=jstages["base"], engine=jeng,
                                    **HELDOUT)
    assert set(sft["tasks"]) == set(want_tasks)
    for k, v in want_tasks.items():
        np.testing.assert_allclose(sft["tasks"][k], v, rtol=1e-5, err_msg=k)
    for k, v in want_core.items():
        np.testing.assert_allclose(sft["core"][k], v, rtol=1e-5, err_msg=k)
    assert [res["stages"][s]["method"] for s in STEPS] == \
        ["diloco", "ddp", "ddp"]
    for e in res["stages"].values():
        assert set(e["tasks"]) == {"mc", "arith", "pattern", "chatcore"}
        assert np.isfinite(e["core"]["heldout_ce"])


@pytest.mark.parametrize("which", ["trained", "d20"])
def test_raw_eval_outputs_equal_jax(world, which, trained_engines,
                                    d20_engines):
    """The MC option scores (rtol 1e-5) and the arith / pattern greedy
    rows (token for token, EOS included) of the two packages' engines on
    one set of parameters: the trained tiny model and a random reduced
    nanochat-d20 whose vocab is the tokenizer's."""
    (_, tok, _, suites), _ = world
    eng, jeng = trained_engines if which == "trained" else d20_engines
    rows = [(tok.encode(it["prompt"]), tok.encode(o + " "))
            for it in suites["mc"] for o in it["options"]]
    np.testing.assert_allclose(eng.score_continuations_batch(rows),
                               np.asarray(jeng.score_continuations_batch(
                                   rows)), rtol=1e-5)
    eos = tok.special_id("<|assistant_end|>")
    for name in ("arith", "pattern"):
        prompts = [tok.encode(it["prompt"]) for it in suites[name]]
        got = eng.generate(prompts, max_new=8, greedy=True, eos_id=eos)
        want = jeng.generate(prompts, max_new=8, greedy=True, eos_id=eos)
        assert [list(map(int, r)) for r in got] == \
            [list(map(int, r)) for r in want], name
        assert all(t < tok.vocab_size for r in got for t in r)


def test_eval_functions_equal_jax_on_reduced_d20(world, d20_engines):
    """Each of the port's task evals equals the JAX one on the random
    reduced nanochat-d20, and ``chat_suite`` composes them the same way
    (a subset of suites, and ``mc_heldout``)."""
    (_, tok, _, suites), (_, jtok, _, jsuites) = world
    eng, jeng = d20_engines
    from repro.evals import arith_exact as j_arith
    from repro.evals import mc_accuracy as j_mc
    from repro.evals import pattern_exact as j_pattern
    assert mc_accuracy(eng, tok, suites["mc"]) == \
        j_mc(jeng, jtok, jsuites["mc"])
    assert arith_exact(eng, tok, suites["arith"]) == \
        j_arith(jeng, jtok, jsuites["arith"])
    assert pattern_exact(eng, tok, suites["pattern"]) == \
        j_pattern(jeng, jtok, jsuites["pattern"])
    sub = {"mc": suites["mc"][:8], "mc_heldout": suites["mc"][8:16]}
    jsub = {"mc": jsuites["mc"][:8], "mc_heldout": jsuites["mc"][8:16]}
    assert chat_suite(eng, tok, sub) == jax_chat_suite(jeng, jtok, jsub)


def test_heldout_metrics_entries_agree(world, d20_engines):
    """``heldout_metrics`` from cfg + params equals the one from the
    engine and the JAX package's (rtol 1e-5); without a model or a
    dataset it raises ``TypeError``, as the JAX one does."""
    (_, _, stages, _), (_, _, jstages, _) = world
    eng, jeng = d20_engines
    a = heldout_metrics(eng.cfg, eng.params, ds=stages["base"], **HELDOUT)
    assert a == heldout_metrics(ds=stages["base"], engine=eng, **HELDOUT)
    want = jax_heldout_metrics(ds=jstages["base"], engine=jeng, **HELDOUT)
    for k in want:
        np.testing.assert_allclose(a[k], want[k], rtol=1e-5, err_msg=k)
    assert np.isclose(a["core_proxy"], np.exp(-a["heldout_ce"]))
    with pytest.raises(TypeError, match="cfg\\+params or engine"):
        heldout_metrics(ds=stages["base"])
    with pytest.raises(TypeError, match="ds is required"):
        heldout_metrics(engine=eng)
