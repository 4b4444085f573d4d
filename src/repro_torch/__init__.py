"""PyTorch/CUDA port of the repro system, beside the JAX package ``repro``.

It serves (the continuous-batching paged-KV engine, the static-bucket
path and scoring) and trains (DiLoCo, DDP and the other outer-sync
strategies on the codec wire) the dense decoder (nanochat-d20), and
serves and scores the mamba-2 decoder (mamba2-1.3b), with hand-written
Hopper kernels for every TPU kernel on those paths.  The package
imports torch and numpy only — nothing of JAX and
nothing of ``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""
from repro_torch.serving import Engine, Request

__all__ = ["Engine", "Request"]
