from repro_torch.serving.drafter import propose as draft_propose
from repro_torch.serving.engine import Engine, resolve_device
from repro_torch.serving.kv_cache import KVBlockPool, pad_block_table
from repro_torch.serving.prefix_tree import PrefixTree
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["Engine", "KVBlockPool", "PrefixTree", "Request", "Scheduler",
           "draft_propose", "pad_block_table", "resolve_device"]
