"""Simplified GRPO (the JAX package's ``core/grpo.py``): nanochat's
optional final stage, reward-model-free policy optimization, reproduced
on the synthetic arithmetic task.

Per prompt, sample G completions on-policy, score them with a
programmatic reward (exact match), normalize advantages within the group
(A_i = (r_i - mean r) / (std r + eps)), and take one policy-gradient step

    L = - E[ A_i * log pi(completion_i | prompt) ]

(no ratio or clipping: one on-policy step, as in nanochat's simplified
GRPO).  DiLoCo-wrapped GRPO is this loss handed to ``DiLoCoTrainer``.

The policy's parameters are updated IN PLACE by the update
(``core/diloco.py worker_step``), and the rollout engine holds the same
tensors, so every iteration samples from the policy the previous update
left.  Rollouts draw from the engine's keyed sampler, (seed, request id,
position), not ``jax.random``: deterministic per seed, other bits than
the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.core.diloco import worker_step
from repro_torch.models.transformer import flatten, forward_lm, unflatten
from repro_torch.optim import nanochat_optimizer
from repro_torch.serving.engine import Engine


def grpo_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, T), labels (B, T) (-1 outside the completion),
    adv (B,).  Returns (loss, {"mean_logprob"})."""
    logits, _ = forward_lm(params, {"tokens": batch["tokens"]}, cfg)
    lp = torch.log_softmax(logits.float(), dim=-1)
    labels = batch["labels"].long()
    gold = torch.gather(lp, -1, labels.clamp(min=0)[..., None])[..., 0]
    valid = (labels >= 0).float()
    seq_logprob = torch.sum(gold * valid, dim=1)
    tokens_per_seq = torch.sum(valid, dim=1).clamp(min=1.0)
    loss = -torch.mean(batch["adv"] * seq_logprob / tokens_per_seq)
    return loss, {"mean_logprob": torch.mean(seq_logprob / tokens_per_seq)}


def rollout_batch(prompts: Sequence[Sequence[int]], out: np.ndarray,
                  rewards: np.ndarray, group_size: int, max_new: int,
                  pad_id: int) -> Dict[str, np.ndarray]:
    """The update's batch from G rollouts a prompt (``prompts`` and
    ``out`` in the rollout order: prompt i's group at rows i*G ..
    i*G + G - 1): advantages normalised within each group in float32,
    tokens padded with ``pad_id``, labels -1 outside the completion."""
    G = group_size
    adv = rewards.reshape(-1, G)
    adv = (adv - adv.mean(axis=1, keepdims=True)) / (
        adv.std(axis=1, keepdims=True) + 1e-6)
    adv = adv.reshape(-1)
    tmax = max(len(p) for p in prompts) + max_new
    toks = np.full((len(prompts), tmax), pad_id, np.int32)
    labels = np.full((len(prompts), tmax), -1, np.int32)
    for i, p in enumerate(prompts):
        seq = list(p) + list(out[i])
        toks[i, :len(seq)] = seq
        # predict completion tokens: positions len(p)-1 .. len(seq)-2
        labels[i, len(p) - 1:len(seq) - 1] = out[i]
    return {"tokens": toks, "labels": labels, "adv": adv}


@dataclasses.dataclass
class GRPOTrainer:
    cfg: ModelConfig
    opt_cfg: OptimizerConfig
    group_size: int = 8
    max_new: int = 8
    temperature: float = 1.0

    def init(self, params) -> Dict:
        """``params``: a nested tree (or flat dict); it is copied, never
        written.  The state lives on the parameters' device."""
        with torch.no_grad():
            own = {k: p.detach().clone() for k, p in flatten(params).items()}
        device = next(iter(own.values())).device
        return {"params": unflatten(own),
                "opt": nanochat_optimizer(self.opt_cfg).init(own),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def update(self, state: Dict, batch: Dict[str, torch.Tensor]
               ) -> Tuple[Dict, torch.Tensor]:
        """One policy-gradient step on ``batch`` (tensors on the state's
        device), the parameters updated in place.  Returns (state, loss
        as a 0-d tensor)."""
        opt_state, loss = worker_step(
            lambda p, b: grpo_loss(p, b, self.cfg),
            nanochat_optimizer(self.opt_cfg), flatten(state["params"]),
            state["opt"], batch, state["step"])
        return {"params": state["params"], "opt": opt_state,
                "step": state["step"] + 1}, loss

    def rollout_and_step(self, state: Dict, prompts: Sequence[Sequence[int]],
                         reward_fn: Callable[[int, np.ndarray], float],
                         pad_id: int, seed: int = 0
                         ) -> Tuple[Dict, float, float]:
        """One GRPO iteration: sample G completions per prompt, reward,
        normalize within group, update.  reward_fn(prompt_idx, token_row)
        -> float.  Returns (state, loss, mean_reward).

        Rollouts go through the continuous-batching scheduler (the serving
        path of the evals): G x P sampled requests share the slot set,
        each keyed by ``seed`` and its request id, so on-policy sampling
        is deterministic per seed; one engine, on the parameters' device,
        serves every iteration."""
        params = state["params"]
        if not hasattr(self, "_engine") or self._engine.cfg is not self.cfg:
            device = next(iter(flatten(params).values())).device
            self._engine = Engine(self.cfg, params, device=device)
        engine = self._engine
        engine.params = params
        G = self.group_size
        rep_prompts = [p for p in prompts for _ in range(G)]
        out = engine.generate_ids(rep_prompts, max_new=self.max_new,
                                  greedy=False,
                                  temperature=self.temperature, seed=seed)
        rewards = np.asarray([
            reward_fn(i // G, out[i]) for i in range(len(rep_prompts))],
            np.float32)
        batch = rollout_batch(rep_prompts, out, rewards, G, self.max_new,
                              pad_id)
        device = state["step"].device
        state, loss = self.update(state, {k: torch.from_numpy(v).to(device)
                                          for k, v in batch.items()})
        return state, float(loss), float(rewards.mean())


def arith_reward_fn(tok, items: List[dict]) -> Callable:
    """Reward = 1 if the decoded completion starts with the gold answer."""
    def fn(prompt_idx: int, row: np.ndarray) -> float:
        text = tok.decode(list(row)).strip()
        return 1.0 if text.startswith(items[prompt_idx]["answer"]) else 0.0
    return fn
