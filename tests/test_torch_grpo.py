"""The port's GRPO stage (``repro_torch.core.grpo``) against the JAX
package's, on the CPU at ``tests/helpers.py``'s tiny dense config: the
loss and its gradient against ``jax.value_and_grad``, one
``rollout_and_step`` on injected completions (both engines'
``generate_ids`` return the same rows: the port samples from its own
keyed stream, not ``jax.random``), the reward function; and inside the
port, sampling deterministic per seed, each iteration rolling out with
the parameters the previous update left, and the reference's property
that the update raises the probability of rewarded completions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core.grpo import GRPOTrainer as JaxGRPOTrainer
from repro.core.grpo import arith_reward_fn as jax_arith_reward_fn
from repro.core.grpo import grpo_loss as jax_grpo_loss
from repro.models.transformer import build_model
from repro.models.transformer import init_params as jax_init
from repro.serving.engine import Engine as JaxEngine
from repro_torch import Engine
from repro_torch.checkpoint import params_to_numpy
from repro_torch.configs import OptimizerConfig
from repro_torch.core import GRPOTrainer, arith_reward_fn, grpo_loss
from repro_torch.data import synthetic, train_tokenizer
from repro_torch.models import forward_lm
from repro_torch.models.transformer import flatten, unflatten
from repro_torch.serving.engine import Engine as PortEngine
from torch_parity import jax_flat, port_cfg, port_params

# tiny shapes: intra-op threads would only contend with the other test
# workers on the same cores
torch.set_num_threads(1)

OPT = dict(total_steps=4, warmup_steps=0, schedule="constant",
           learning_rate=0.02, adam_lr=3e-3)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10], [11]]


@pytest.fixture(scope="module")
def jparams():
    return jax_init(tiny_cfg("dense"), jax.random.key(0))[0]


def _batch(seed, cfg, B=3, T=9):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = np.full((B, T), -1, np.int32)
    labels[0, 2:6] = toks[0, 3:7]
    labels[1, 4:8] = toks[1, 5:9]
    labels[2, 0:3] = toks[2, 1:4]
    adv = rng.standard_normal(B).astype(np.float32)
    return {"tokens": toks, "labels": labels, "adv": adv}


def _first_token_reward(target):
    return lambda _, row: 1.0 if int(row[0]) == target else 0.0


def test_grpo_loss_and_grads_match_jax_value_and_grad(jparams):
    """Loss (rtol 1e-6) and every gradient leaf (atol 1e-6, rtol 1e-4)
    against jax.value_and_grad of the reference's grpo_loss; the metric
    too."""
    cfg = tiny_cfg("dense")
    batch = _batch(0, cfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jax_grpo_loss(p, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, build_model(cfg)),
        has_aux=True)(jparams)
    leaves = flatten(port_params(cfg, jparams))
    for t in leaves.values():
        t.requires_grad_(True)
    loss, met = grpo_loss(unflatten(leaves), {k: torch.from_numpy(v) for k, v
                                              in batch.items()},
                          port_cfg(cfg))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(met["mean_logprob"].item(),
                               float(jmet["mean_logprob"]), rtol=1e-6)
    want = jax_flat(jgrads)
    assert set(want) == set(leaves)
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-6, rtol=1e-4,
                                   err_msg=k)


def test_grpo_loss_sign(jparams):
    """The reference's property: with adv = 1, loss == -mean_logprob."""
    cfg = tiny_cfg("dense")
    batch = {"tokens": torch.tensor([[1, 2, 3, 4, 5, 6]], dtype=torch.int32),
             "labels": torch.tensor([[-1, -1, 4, 5, 6, -1]],
                                    dtype=torch.int32),
             "adv": torch.tensor([1.0])}
    loss, met = grpo_loss(port_params(cfg, jparams), batch, port_cfg(cfg))
    assert torch.isfinite(loss)
    assert abs(loss.item() + met["mean_logprob"].item()) < 1e-5


def test_rollout_and_step_on_injected_completions_matches_jax(jparams,
                                                              monkeypatch):
    """Both engines' generate_ids return the same ragged-free rows: the
    update's tokens, labels and advantages are the reference's bit for
    bit, the mean reward and the loss agree, and the parameters after one
    step within atol 1e-6.  Then both trainers' engines, on the updated
    parameters, decode the same greedy rows."""
    cfg = tiny_cfg("dense")
    G, max_new = 4, 3
    rows = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (len(PROMPTS) * G, max_new)).astype(np.int32)
    rows[::3, 0] = 7                   # mixed rewards in every group
    monkeypatch.setattr(JaxEngine, "generate_ids",
                        lambda self, prompts, **kw: rows.copy())
    monkeypatch.setattr(PortEngine, "generate_ids",
                        lambda self, prompts, **kw: rows.copy())
    reward = _first_token_reward(7)

    jtr = JaxGRPOTrainer(build_model(cfg), JaxOptimizerConfig(**OPT),
                         group_size=G, max_new=max_new)
    seen = {}

    def jax_update(state, batch):
        seen["jax"] = {k: np.asarray(v) for k, v in batch.items()}
        return jax.jit(jtr._update)(state, batch)

    jtr._update_jit = jax_update
    jstate, jloss, jmean = jtr.rollout_and_step(jtr.init(jparams), PROMPTS,
                                                reward, pad_id=0, seed=3)

    tr = GRPOTrainer(port_cfg(cfg), OptimizerConfig(**OPT), group_size=G,
                     max_new=max_new)

    def port_update(state, batch):
        seen["port"] = {k: v.numpy().copy() for k, v in batch.items()}
        return GRPOTrainer.update(tr, state, batch)

    tr.update = port_update
    state, loss, mean = tr.rollout_and_step(
        tr.init(port_params(cfg, jparams)), PROMPTS, reward, pad_id=0,
        seed=3)
    for k in ("tokens", "labels", "adv"):
        assert seen["port"][k].dtype == seen["jax"][k].dtype, k
        np.testing.assert_array_equal(seen["port"][k], seen["jax"][k],
                                      err_msg=k)
    assert mean == jmean
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 1
    got, want = params_to_numpy(state["params"]), jax_flat(jstate["params"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    monkeypatch.undo()
    # the reference rebinds its engine's parameters at the next rollout;
    # the port's engine holds the tensors the update wrote
    jtr._engine.params = jstate["params"]
    np.testing.assert_array_equal(
        tr._engine.generate_ids(PROMPTS, max_new=6),
        jtr._engine.generate_ids(PROMPTS, max_new=6))


def _run(tparams, iters, seed0=0, G=4, max_new=2, record=None):
    cfg = port_cfg(tiny_cfg("dense"))
    tr = GRPOTrainer(cfg, OptimizerConfig(**OPT), group_size=G,
                     max_new=max_new)
    state = tr.init(tparams)
    for it in range(iters):
        rows = []

        def reward(i, row):
            rows.append(np.array(row))
            return 1.0 if int(row[0]) % 4 == 0 else 0.0

        state, loss, _ = tr.rollout_and_step(state, PROMPTS, reward,
                                             pad_id=0, seed=seed0 + it)
        assert np.isfinite(loss)
        if record is not None:
            record.append(np.stack(rows))
    return tr, state


def _tensors(tree):
    """Every tensor of a nest of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def test_same_seed_gives_the_same_state_bit_for_bit(jparams):
    cfg = tiny_cfg("dense")
    ra, rb = [], []
    _, sa = _run(port_params(cfg, jparams), 2, record=ra)
    _, sb = _run(port_params(cfg, jparams), 2, record=rb)
    for a, b in zip(ra, rb):
        np.testing.assert_array_equal(a, b)
    assert int(sa["step"]) == int(sb["step"]) == 2
    for k, v in flatten(sa["params"]).items():
        assert torch.equal(v, flatten(sb["params"])[k]), k
    la, lb = _tensors(sa["opt"]), _tensors(sb["opt"])
    assert la and len(la) == len(lb)
    assert all(torch.equal(a, b) for a, b in zip(la, lb))


def test_second_iteration_rolls_out_with_the_updated_policy(jparams):
    """Iteration 2 samples what a fresh engine samples on the updated
    parameters with its seed; the trainer's engine scores as that fresh
    engine does and not as one on the initial parameters: it sees the
    in-place update."""
    cfg = tiny_cfg("dense")
    tparams = port_params(cfg, jparams)
    G, max_new = 4, 2
    rep = [p for p in PROMPTS for _ in range(G)]
    tr, state = _run(tparams, 1)
    fresh = Engine(port_cfg(cfg), state["params"], device="cpu")
    want = fresh.generate_ids(rep, max_new=max_new, greedy=False, seed=1)
    rows = []
    tr.rollout_and_step(state, PROMPTS,
                        lambda i, row: rows.append(np.array(row)) or 0.0,
                        pad_id=0, seed=1)
    np.testing.assert_array_equal(np.stack(rows), want)
    # after iteration 2's update: the engine holds the tensors it wrote
    fresh = Engine(port_cfg(cfg), state["params"], device="cpu")
    stale = Engine(port_cfg(cfg), tparams, device="cpu")
    score = [(p, [5, 6]) for p in PROMPTS]
    got = tr._engine.score_continuations_batch(score)
    np.testing.assert_array_equal(got, fresh.score_continuations_batch(score))
    assert not np.allclose(got, stale.score_continuations_batch(score),
                           rtol=0, atol=1e-4)


def test_arith_reward_fn_matches_the_reference():
    world = synthetic.World.make(20)
    tok = train_tokenizer(synthetic.gen_sft_texts(world, 300), 512)
    items = synthetic.gen_arith_eval(6, seed=31)
    rng = np.random.default_rng(0)
    rows = []
    for i, it in enumerate(items):
        good = tok.encode(" " + it["answer"] + " .")
        rows.append((i, np.asarray(good, np.int32)))
        rows.append((i, rng.integers(0, tok.vocab_size, 5).astype(np.int32)))
    ours, ref = arith_reward_fn(tok, items), jax_arith_reward_fn(tok, items)
    got = [ours(i, r) for i, r in rows]
    assert got == [ref(i, r) for i, r in rows]
    assert 0.0 < sum(got) < len(got)


@pytest.mark.slow
def test_grpo_increases_reward_probability():
    """The reference's slow property in the port: reward completions whose
    FIRST token is a fixed target id; a few GRPO iterations must raise the
    probability of that token."""
    from repro_torch.models import init_params
    cfg = port_cfg(tiny_cfg("dense", vocab_size=16))
    params = init_params(cfg, seed=1)
    target = 7
    tr = GRPOTrainer(cfg, OptimizerConfig(total_steps=30, warmup_steps=0,
                                          schedule="constant",
                                          learning_rate=0.02, adam_lr=3e-3),
                     group_size=16, max_new=2)
    state = tr.init(params)
    prompts = [[1, 2, 3], [4, 5]]

    def p_target(params):
        with torch.no_grad():
            logits, _ = forward_lm(params, {"tokens": torch.tensor(
                [prompts[0]])}, cfg)
        return float(torch.softmax(logits[0, -1], -1)[target])

    before = p_target(state["params"])
    for it in range(8):
        state, loss, mean_r = tr.rollout_and_step(
            state, prompts, _first_token_reward(target), pad_id=0, seed=it)
    after = p_target(state["params"])
    assert after > before, (before, after)
