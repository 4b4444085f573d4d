from repro_torch.data import synthetic
from repro_torch.data.pipeline import (PackedDataset, Prefetcher,
                                       stack_batches)
from repro_torch.data.pipeline import build_tokenizer as train_tokenizer
from repro_torch.data.tokenizer import SPECIAL_TOKENS, BPETokenizer


def build_tokenizer() -> BPETokenizer:
    """The serving CLI's tokenizer: a 512-token BPE trained on the first
    2000 synthetic pretraining texts — the tokenizer the JAX package's
    training pipeline builds with its default seed."""
    world = synthetic.World.make(40, seed=1234)
    texts = synthetic.gen_pretrain_texts(world, 2000, seed=0)
    return train_tokenizer(texts, 512)


__all__ = ["BPETokenizer", "PackedDataset", "Prefetcher", "SPECIAL_TOKENS",
           "build_tokenizer", "stack_batches", "synthetic",
           "train_tokenizer"]
