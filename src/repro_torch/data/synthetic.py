"""The synthetic three-stage corpora and eval suites of the JAX package's
``repro.data.synthetic``, copied line for line (same seeds, same texts):
a seeded world of entity facts, arithmetic statements, word patterns and
filler for the base stage (and the tokenizer), chat-schema dialogues for
mid-training, single-turn instruction pairs for SFT, and the
multiple-choice, arithmetic and pattern eval items.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Sequence, Tuple

ATTRIBUTES = ["color", "size", "shape", "sound", "taste"]
VALUES = {
    "color": ["red", "blue", "green", "gold", "black"],
    "size": ["tiny", "small", "large", "huge", "giant"],
    "shape": ["round", "square", "flat", "long", "curved"],
    "sound": ["quiet", "loud", "soft", "sharp", "deep"],
    "taste": ["sweet", "sour", "salty", "bitter", "plain"],
}
FILLER = ["the", "a", "is", "of", "and", "it", "that", "very", "quite",
          "really", "also", "so", "now", "then", "here", "there"]
PATTERN_WORDS = ["ka", "lo", "mi", "zu", "re"]


@dataclasses.dataclass
class World:
    """A fixed fact table: entity -> attribute -> value."""
    n_entities: int
    facts: Dict[str, Dict[str, str]]
    entities: List[str]

    @classmethod
    def make(cls, n_entities: int = 40, seed: int = 1234) -> "World":
        rng = random.Random(seed)
        entities = [f"ent{i}" for i in range(n_entities)]
        facts = {e: {a: rng.choice(VALUES[a]) for a in ATTRIBUTES}
                 for e in entities}
        return cls(n_entities, facts, entities)

    def train_entities(self) -> List[str]:
        return self.entities[: int(0.8 * self.n_entities)]

    def eval_entities(self) -> List[str]:
        return self.entities[int(0.8 * self.n_entities):]


# ---------------------------------------------------------------------------
# Sentence generators
# ---------------------------------------------------------------------------

def _fact_sentence(world: World, rng: random.Random, ents: Sequence[str]) -> str:
    e = rng.choice(list(ents))
    a = rng.choice(ATTRIBUTES)
    v = world.facts[e][a]
    forms = [
        f"the {a} of {e} is {v} .",
        f"{e} has a {v} {a} .",
        f"everyone knows the {a} of {e} is {v} .",
    ]
    return rng.choice(forms)


def _arith_sentence(rng: random.Random, hard: bool = False) -> str:
    hi = 99 if hard else 49
    a, b = rng.randint(0, hi), rng.randint(0, hi)
    op = rng.choice(["+", "-", "*"])
    if op == "+":
        r = a + b
    elif op == "-":
        a, b = max(a, b), min(a, b)
        r = a - b
    else:
        a, b = rng.randint(0, 12), rng.randint(0, 12)
        r = a * b
    return f"{a} {op} {b} = {r} ."


def _pattern_sentence(rng: random.Random) -> str:
    w1, w2 = rng.sample(PATTERN_WORDS, 2)
    n = rng.randint(2, 4)
    return " ".join([w1, w2] * n) + " ."


def _filler_sentence(rng: random.Random) -> str:
    n = rng.randint(3, 8)
    return " ".join(rng.choices(FILLER, k=n)) + " ."


def gen_pretrain_texts(world: World, n: int, seed: int = 0) -> List[str]:
    rng = random.Random(seed)
    ents = world.train_entities()
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.45:
            out.append(_fact_sentence(world, rng, ents))
        elif r < 0.7:
            out.append(_arith_sentence(rng))
        elif r < 0.85:
            out.append(_pattern_sentence(rng))
        else:
            out.append(_filler_sentence(rng))
    return out


# ---------------------------------------------------------------------------
# Chat / instruction stages
# ---------------------------------------------------------------------------

def _chat(q: str, a: str) -> str:
    return (f"<|user_start|>{q}<|user_end|>"
            f"<|assistant_start|>{a}<|assistant_end|>")


def _qa_pair(world: World, rng: random.Random, ents: Sequence[str]
             ) -> Tuple[str, str]:
    r = rng.random()
    if r < 0.5:
        e = rng.choice(list(ents))
        a = rng.choice(ATTRIBUTES)
        return (f"what is the {a} of {e} ?", f"the {a} of {e} is {world.facts[e][a]} .")
    if r < 0.85:
        s = _arith_sentence(rng)
        lhs, res = s.rstrip(" .").split(" = ")
        return (f"compute {lhs} .", f"{lhs} = {res} .")
    w1, w2 = rng.sample(PATTERN_WORDS, 2)
    return (f"continue the pattern {w1} {w2} {w1} {w2} .",
            f"{w1} {w2} {w1} {w2} .")


def gen_dialogue_texts(world: World, n: int, seed: int = 1) -> List[str]:
    """Mid-training stage: multi-turn dialogues (SmolTalk proxy)."""
    rng = random.Random(seed)
    ents = world.train_entities()
    out = []
    for _ in range(n):
        turns = rng.randint(1, 3)
        convo = "<|bos|>"
        for _ in range(turns):
            q, a = _qa_pair(world, rng, ents)
            convo += _chat(q, a)
        out.append(convo)
    return out


def gen_sft_texts(world: World, n: int, seed: int = 2) -> List[str]:
    """SFT stage: single-turn, arithmetic/fact heavy, clean answers."""
    rng = random.Random(seed)
    ents = world.train_entities()
    out = []
    for _ in range(n):
        q, a = _qa_pair(world, rng, ents)
        out.append("<|bos|>" + _chat(q, a))
    return out


# ---------------------------------------------------------------------------
# Eval item generators (consumed by repro.evals.tasks)
# ---------------------------------------------------------------------------

def gen_mc_eval(world: World, n: int, seed: int = 7,
                heldout: bool = False) -> List[dict]:
    """MMLU-like multiple choice on world facts."""
    rng = random.Random(seed)
    ents = world.eval_entities() if heldout else world.train_entities()
    items = []
    for _ in range(n):
        e = rng.choice(list(ents))
        a = rng.choice(ATTRIBUTES)
        gold = world.facts[e][a]
        opts = [v for v in VALUES[a] if v != gold]
        rng.shuffle(opts)
        options = opts[:3] + [gold]
        rng.shuffle(options)
        items.append({
            "prompt": f"<|user_start|>what is the {a} of {e} ?<|user_end|>"
                      f"<|assistant_start|>the {a} of {e} is ",
            "options": options,
            "answer": options.index(gold),
        })
    return items


def gen_arith_eval(n: int, seed: int = 8) -> List[dict]:
    """GSM8K-like: exact-match arithmetic completion."""
    rng = random.Random(seed)
    items = []
    for _ in range(n):
        s = _arith_sentence(rng)
        lhs, res = s.rstrip(" .").split(" = ")
        items.append({
            "prompt": f"<|user_start|>compute {lhs} .<|user_end|>"
                      f"<|assistant_start|>{lhs} = ",
            "answer": res,
        })
    return items


def gen_pattern_eval(n: int, seed: int = 9) -> List[dict]:
    """HumanEval-like: deterministic continuation exact-match."""
    rng = random.Random(seed)
    items = []
    for _ in range(n):
        w1, w2 = rng.sample(PATTERN_WORDS, 2)
        items.append({
            "prompt": f"<|user_start|>continue the pattern {w1} {w2} {w1} {w2} ."
                      f"<|user_end|><|assistant_start|>",
            "answer": f"{w1} {w2}",
        })
    return items
