"""PyTorch/CUDA port of the repro system, beside the JAX package ``repro``.

This slice ports the continuous-batching serving path of the dense
decoder (nanochat-d20): the paged-KV engine, its host-side scheduler, and
hand-written Hopper kernels for RMSNorm and paged decode / verify
attention.  The package imports torch and numpy only — nothing of JAX and
nothing of ``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""
from repro_torch.serving import Engine, Request

__all__ = ["Engine", "Request"]
