"""The synthetic pretraining corpus the serving CLI trains its tokenizer
on: a seeded world of entity facts, arithmetic statements, word patterns
and filler, generated exactly as the JAX package's ``repro.data.synthetic``
generates it (same seeds, same texts), so the port's tokenizer has the
same merges and ids as the JAX pipeline's.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Sequence

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
