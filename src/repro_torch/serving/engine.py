"""Inference engine — the port of the JAX package's ``repro.serving.engine``:
the continuous-batching path over the paged KV pool, the static-bucket
path, and continuation scoring.

Layers, as in the JAX package:

* ``serving.kv_cache``   — paged KV-block pool (host allocator; the device
  pool is ``models.transformer.init_paged_cache``);
* ``serving.scheduler``  — admission / eviction over a fixed slot set,
  block-budget reservation + lazy mapping, prefix sharing;
* ``serving.drafter``    — prompt-lookup n-gram drafter;
* this module            — the persistent decode loop: one step over the
  whole slot set, position-gated so slots at different depths coexist.

Two step shapes, selected by ``spec_k``:

**spec_k == 0.**  Each step feeds ``prefill_chunk`` token-steps (a Python
loop where the JAX package scans): every slot consumes its scripted
pending tokens (prompt chunks: chunked prefill) or chains on its own
samples.  Every token-step is one decode forward, so the paged decode
kernel serves prefill and decode alike.

**spec_k > 0.**  draft -> verify -> accept -> rollback: the host drafter
proposes up to ``spec_k`` tokens per decoding slot, ONE multi-token
forward (``verify_step_paged``, the paged verify kernel) scores all
``spec_k + 1`` positions, greedy slots accept the longest draft prefix
matching the argmax chain (token-identical to spec_k == 0), sampling
slots run rejection sampling against the deterministic drafter, and
rejected suffixes are rolled back on the host (``KVBlockPool.truncate``);
stale pool contents are masked by the position gate.

Differences from the JAX package, by design:

* the pool is updated IN PLACE (the JAX engine donates it to each jitted
  call); ``self._pool`` holds it across ``run()`` calls;
* sampling draws from a counter-based stream keyed by ``(seed, rid,
  position)``: a fresh ``torch.Generator`` (Philox on CUDA) seeded from
  that triple per sampled position, so a request's tokens do not depend
  on which requests shared its batch.  The bits differ from
  ``jax.random``'s; greedy decoding gives the JAX engine's tokens.

Sliding windows, as in the JAX package: a uniform ``cfg.window`` (no
``window_pattern``) recycles each slot's blocks that fell wholly out of
the window (``Scheduler.recycle_window``, ``stats["recycled_blocks"]``)
and budgets a request for its live window only, so a windowed pool
admits more than the full footprint would; the recycled table entries
read -1, which the paged kernels treat as unmapped.  Windowed configs
bypass the prefix cache (recycling would free blocks other slots share).
A ``window_pattern`` keeps every block: its global layers read them all.

**The static-bucket path** (``generate_ids_static``) serves what the
scheduler path cannot: archs without a paged cache (``arch_type="ssm"``:
an SSM engine builds no pool, and ``run()`` raises), and batches that do
not fit (empty prompts, max_new < 1, over capacity), to which
``generate`` routes.  Prompts are left-padded to the longest; every token
of the padded prompts, then every generated token, is one
``decode_step_lm`` over the whole batch (a Python loop where the JAX
package scans), against a ring KV cache of ``Tp + max_new`` slots (the
ring decode kernel) or the SSM conv ring and state.  Left-pad tokens sit
at position -1: the attention masks them, but the SSM step ignores the
position, as the JAX package's does, so a shorter prompt's pad tokens run
through the SSM state before the prompt and an SSM's tokens depend on the
batch's padding.  The port follows the reference there.  Sampling draws
Gumbel noise from one generator seeded by ``seed`` (not ``jax.random``'s
bits); greedy tokens equal the JAX engine's.  The step loop reads nothing
back from the device until the tokens are done.

**Scoring** (``score_continuations*``): one full-sequence forward
(``forward_lm``: the flash kernel for a dense model, the SSD kernel for
an SSM) over rows padded to a multiple of 16 tokens; the sum of the
continuation tokens' log-probabilities per row.

Quantized KV pools (``cfg.kv_cache_dtype`` int8 / fp8 / fp8_e5m2) store a
1-byte payload plus f32 per-token-per-head scale planes, which
``init_paged_cache`` allocates with the pool; a byte-budget engine
(``pool_bytes``) fits proportionally more blocks and admits more requests.
Quantize on scatter and dequant on load happen inside
``models.attention.paged_decode_attention``; the copy-on-write fork copies
every pool leaf, scales included.  The two step shapes stay bit-exact
with each other under greedy decoding: where the attention quantizes,
their GEMMs run per token column (``attention.serving_matmul``), so a
verify forward writes the pool that decode forwards write.
``cfg.fp8_matmul`` runs the plain-pool kernels' QK^T in fp8.

Device -> host reads in the step loops go through the module-level
``_fetch`` only: one batched read per step.  The rows each forward writes
into the pool are worked out on the host (``attention.scatter_plan``,
from the host's positions and block tables) and uploaded with the step's
other inputs, and uploads are asynchronous (``Engine._put``), so a greedy
step does not make the host wait on the device before its ``_fetch``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import BPETokenizer
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.attention import scatter_plan
from repro_torch.models.transformer import (Params, _require_supported,
                                            decode_step_lm,
                                            decode_step_paged, flatten,
                                            forward_lm, init_decode_cache,
                                            init_paged_cache, kv_pool_dtype,
                                            paged_block_bytes,
                                            paged_cache_supported,
                                            verify_step_paged)
from repro_torch.serving import drafter as drafter_mod
from repro_torch.serving.kv_cache import KVBlockPool, pad_block_table
from repro_torch.serving.prefix_tree import PrefixTree
from repro_torch.serving.scheduler import Request, Scheduler


def _fetch(t: torch.Tensor) -> np.ndarray:
    """The ONLY device->host read of the step loops (one per step)."""
    return t.cpu().numpy()


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device.  CUDA is the default everywhere in the
    port; asking for it without a usable card raises (no CPU fallback —
    pass ``device="cpu"`` to run the plain versions on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: the port runs on cuda or cpu")
    return dev


def _draws(keys: Sequence[tuple], vocab: int,
           device: torch.device) -> torch.Tensor:
    """(len(keys), 2*vocab + 1) uniforms in [0, 1), row i from a generator
    seeded by ``keys[i] = (seed, rid, position)``: columns [0, V) drive the
    categorical sample, column V the rejection test, [V+1, 2V+1) the
    residual sample.  Every row draws the same count, so a position's
    numbers are the same in both step shapes.  (Python's hash of a tuple
    of ints is fixed for a given interpreter version: no hash seed.)"""
    rows = []
    for key in keys:
        g = torch.Generator(device=device)
        g.manual_seed(hash(key))
        rows.append(torch.rand(2 * vocab + 1, generator=g, device=device))
    return torch.stack(rows)


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms: argmax(logits + noise) ~ softmax."""
    return -torch.log(-torch.log(u))


def _left_pad(prompts: Sequence[Sequence[int]], pad_id: int):
    """(tokens (B, Tp) int32 left-padded with ``pad_id``, lens (B,))."""
    tp = max(len(p) for p in prompts)
    out = np.full((len(prompts), tp), pad_id, np.int32)
    lens = np.zeros((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        out[i, tp - len(p):] = p
        lens[i] = len(p)
    return out, lens


@dataclasses.dataclass
class Engine:
    cfg: ModelConfig
    params: Params
    tok: Optional[BPETokenizer] = None
    max_len: int = 256                 # per-request prompt+gen capacity
    num_slots: int = 8                 # concurrent sequences in the step
    block_size: int = 16               # KV tokens per pool block
    num_blocks: Optional[int] = None   # pool size; default fits all slots
    pool_bytes: Optional[int] = None   # or: byte budget for the pool
    prefill_chunk: int = 8             # token-steps per step call
    spec_k: int = 0                    # speculative draft length; 0 = off
    draft_ngram: int = 3               # longest suffix n-gram to match
    policy: str = "fifo"               # fifo | longest_prefill | cache_aware
    prefix_cache: bool = False         # share prompt-prefix KV blocks
    prefix_cache_blocks: Optional[int] = None   # LRU bound on cache blocks
    device: object = "cuda"            # "cuda" (default) or "cpu"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        cfg = self.cfg
        if tp.active() is not None:
            raise NotImplementedError(
                "the Engine under a model axis > 1: it runs on no mesh, as "
                "the reference's Engine does; serve over a model axis "
                "through launch.steps.make_serve_step and "
                "make_prefill_step")
        _require_supported(cfg)
        for path, t in flatten(self.params).items():
            if t.device.type != self.device.type:
                raise ValueError(f"param {path} is on {t.device}, the engine "
                                 f"on {self.device}")
        self.continuous = paged_cache_supported(cfg)
        if not self.continuous:
            return                     # static-bucket path only: no pool
        self._mb = -(-self.max_len // self.block_size)   # blocks per slot
        self.bytes_per_block = paged_block_bytes(cfg, self.block_size)
        if self.num_blocks is None:
            if self.pool_bytes is not None:
                self.num_blocks = max(
                    self.pool_bytes // self.bytes_per_block, 1)
            else:
                self.num_blocks = self.num_slots * self._mb
        self.capacity = self._mb * self.block_size
        self._pool = None       # device pool, allocated on first run()
        # a uniform window recycles blocks; a window_pattern's global
        # layers keep every block alive
        self._recycle_w = int(cfg.window) \
            if (cfg.window and not cfg.window_pattern) else 0
        self._tree = None
        self._host_pool = None
        if self.prefix_cache and not self._recycle_w:
            self._tree = PrefixTree(self.block_size,
                                    self.prefix_cache_blocks or 0)

    # ----------------------------------------------------------------------
    # Device steps
    # ----------------------------------------------------------------------

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """Upload a host array.  On CUDA it is staged in pinned memory and
        copied asynchronously, so the host does not wait for the work
        already queued on the stream."""
        if self.device.type != "cuda":
            return torch.tensor(a, device=self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
            self.device, non_blocking=True)

    def _choose(self, logits: torch.Tensor, sampling) -> torch.Tensor:
        """Next token per row of logits (S, V): argmax for greedy rows, a
        keyed categorical sample for the others.  ``sampling`` is None
        when every row is greedy, else (greedy (S,) bool host array,
        temps (S,) host array, keys per sampled row)."""
        greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        if sampling is None:
            return greedy_tok
        greedy, temps, keys = sampling
        sampled_rows = np.nonzero(~greedy)[0]
        V = logits.shape[-1]
        noise = torch.zeros_like(logits)
        noise[self._put(sampled_rows)] = _gumbel(
            _draws(keys, V, self.device)[:, :V])
        temp = self._put(np.maximum(np.where(greedy, 1.0, temps),
                                    1e-6).astype(np.float32))
        sampled = torch.argmax(logits / temp[:, None] + noise,
                               dim=-1).to(torch.int32)
        return torch.where(self._put(greedy), greedy_tok, sampled)

    def _step(self, pool, script: np.ndarray, n_script: np.ndarray,
              start: np.ndarray, table: torch.Tensor, table_h: np.ndarray,
              greedy: np.ndarray, temps: np.ndarray, rids: np.ndarray,
              seed: int) -> torch.Tensor:
        """``prefill_chunk`` token-steps over the whole slot set.  script:
        (S, T) pending tokens; n_script: (S,) how many are scripted —
        beyond that a slot chains on its own samples; start: (S,) first
        write position (−1 = inactive); table / table_h: the block table on
        the device and on the host.  Returns samples (S, T) on the device:
        samples[:, t] is the token chosen after feeding token t."""
        S, T = script.shape
        active = start >= 0
        pos = np.where(active[:, None], start[:, None] + np.arange(T),
                       -1).astype(np.int32)
        # every token-step's scatter rows, uploaded in one copy and sliced
        # by host-known offsets
        plans = [scatter_plan(pos[:, t:t + 1], table_h, self.block_size)
                 for t in range(T)]
        cuts = np.cumsum([0] + [p.shape[1] for p in plans])
        plan_d = self._put(np.concatenate(plans, axis=1))
        script_d = self._put(script)
        n_script_d = self._put(n_script)
        pos_d = self._put(pos)
        all_greedy = bool(greedy[active].all())
        prev = torch.zeros(S, dtype=torch.int32, device=self.device)
        outs = []
        for t in range(T):
            tok = torch.where(n_script_d > t, script_d[:, t], prev)
            plan_t = plan_d[:, int(cuts[t]):int(cuts[t + 1])]
            logits, _ = decode_step_paged(
                self.params, pool, {"token": tok[:, None],
                                    "position": pos_d[:, t],
                                    "block_table": table,
                                    "kv_scatter": (plan_t[0], plan_t[1])},
                self.cfg)
            sampling = None
            if not all_greedy:
                sample_on = active & ~greedy
                keys = [(seed, int(rids[s]), int(start[s]) + t)
                        for s in np.nonzero(sample_on)[0]]
                sampling = (~sample_on, temps, keys)
            prev = self._choose(logits[:, 0].float(), sampling)
            outs.append(prev)
        return torch.stack(outs, dim=1)

    def _verify(self, pool, script: np.ndarray, start: np.ndarray,
                n_feed: np.ndarray, table: torch.Tensor, table_h: np.ndarray,
                greedy: Optional[np.ndarray] = None,
                temps: Optional[np.ndarray] = None,
                rids: Optional[np.ndarray] = None,
                seed: int = 0) -> torch.Tensor:
        """One speculative round: all W = spec_k + 1 scripted positions of
        every slot scored in ONE forward.  script: (S, W) = [carry,
        draft_1..draft_m] or a prompt chunk; n_feed: (S,) live tokens;
        start: (S,) first write position (−1 = inactive); table / table_h:
        the block table on the device and on the host.

        Greedy-only rounds (``greedy`` None) return the argmax (S, W).
        Otherwise returns (4, S, W) int32: per fed position t the argmax,
        a categorical sample, whether rejection sampling accepts the NEXT
        scripted token (u < p(script[t+1])), and a sample from the
        residual distribution (p with that draft zeroed, renormalized)."""
        S, W = script.shape
        t_idx = np.arange(W)[None, :]
        live = (start[:, None] >= 0) & (t_idx < n_feed[:, None])
        pos = np.where(live, start[:, None] + t_idx, -1).astype(np.int32)
        script_d = self._put(script)
        plan_d = self._put(scatter_plan(pos, table_h, self.block_size))
        logits, _ = verify_step_paged(
            self.params, pool, {"tokens": script_d, "positions":
                                self._put(pos), "block_table": table,
                                "kv_scatter": (plan_d[0], plan_d[1])},
            self.cfg)
        logits = logits.float()                              # (S, W, V)
        greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        if greedy is None:
            return greedy_tok
        V = logits.shape[-1]
        temp = np.maximum(np.where(greedy, 1.0, temps), 1e-6)
        scaled = logits / self._put(temp.astype(np.float32))[:, None, None]
        # keyed draws for every live position of a sampling slot; greedy
        # slots and padding keep zero noise / u = 1 (never read)
        drawn = live & ~greedy[:, None]
        flat_rows = np.nonzero(drawn.reshape(-1))[0]
        u_all = torch.ones(S * W, 2 * V + 1, device=self.device)
        if flat_rows.size:
            keys = [(seed, int(rids[r // W]), int(pos.reshape(-1)[r]))
                    for r in flat_rows]
            u_all[self._put(flat_rows)] = _draws(keys, V, self.device)
        u_all = u_all.reshape(S, W, 2 * V + 1)
        noise = torch.where(self._put(drawn)[..., None],
                            _gumbel(u_all[..., :V]),
                            torch.zeros((), device=self.device))
        sampled = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
        probs = torch.softmax(scaled, dim=-1)
        nxt = torch.roll(script_d.long(), -1, dims=1)        # draft at t+1
        p_draft = torch.gather(probs, -1, nxt[..., None])[..., 0]
        accept = (u_all[..., V] < p_draft).to(torch.int32)
        resid_logits = scaled.scatter(-1, nxt[..., None], float("-inf"))
        noise2 = torch.where(self._put(drawn)[..., None],
                             _gumbel(u_all[..., V + 1:]),
                             torch.zeros((), device=self.device))
        resid = torch.argmax(resid_logits + noise2, dim=-1).to(torch.int32)
        return torch.stack([greedy_tok, sampled, accept, resid])

    # ----------------------------------------------------------------------
    # Continuous decode loop (the scheduler path)
    # ----------------------------------------------------------------------

    def _make_sched(self, round_tokens: int) -> Scheduler:
        if self._tree is not None:
            # persistent host pool: at run end only the tree's refcounts
            # survive — the resident prefix cache the next run matches
            if self._host_pool is None:
                self._host_pool = KVBlockPool(
                    self.num_blocks, self.block_size,
                    bytes_per_block=self.bytes_per_block)
            pool = self._host_pool
        else:
            pool = KVBlockPool(self.num_blocks, self.block_size,
                               bytes_per_block=self.bytes_per_block)
        sched = Scheduler(self.num_slots, pool, self._mb, self.policy,
                          window=self._recycle_w, tree=self._tree)
        sched.chunk_tokens = round_tokens
        return sched

    def _device_pool(self):
        if self._pool is None:
            self._pool = init_paged_cache(self.cfg, self.num_blocks,
                                          self.block_size,
                                          device=self.device)
        return self._pool

    def kv_report(self) -> Dict[str, object]:
        """Static KV-pool facts for serving reports."""
        cfg = self.cfg
        return {
            "kv_cache_dtype": cfg.kv_cache_dtype or "compute",
            "kv_pool_dtype": str(kv_pool_dtype(cfg)).replace("torch.", ""),
            "block_size": self.block_size,
            "num_blocks": self.num_blocks,
            "bytes_per_block": self.bytes_per_block,
            "pool_bytes": self.num_blocks * self.bytes_per_block,
        }

    def _prep_round(self, sched: Scheduler, act: List[int],
                    tables: np.ndarray, round_tokens,
                    stats: Dict[str, float]) -> None:
        """Recycle dead window blocks, lazily map the blocks this round
        writes (``round_tokens``: int, or a per-slot (S,) array) and
        refresh the padded block tables where the mapping changed."""
        for si in act:
            slot = sched.slots[si]
            n = int(round_tokens[si]) if isinstance(round_tokens, np.ndarray)\
                else int(round_tokens)
            recycled = sched.recycle_window(si)
            stats["recycled_blocks"] += recycled
            if sched.ensure_mapped(si, slot.pos + n - 1) or recycled:
                tables[si] = pad_block_table(slot.blocks, self._mb)
                self._tdirty = True

    def _expire_due(self, sched: Scheduler, now_v: float, use_time: bool,
                    tables: np.ndarray, stats: Dict[str, float]) -> None:
        """Evict requests past their deadline (only under ``use_time``)."""
        if not use_time:
            return
        for si, req in sched.expire(now_v):
            stats["expired"] += 1
            if si is not None:      # running slot freed: clear its table row
                tables[si] = -1
                self._tdirty = True

    def _attach_new(self, sched: Scheduler, newly: List[int], pool,
                    tables: np.ndarray, stats: Dict[str, float]) -> None:
        """Post-admission hook: run pending copy-on-write boundary forks
        (one in-place block copy per fork), count skipped prefix tokens,
        and build the table rows of prefix-attached slots."""
        for si in newly:
            slot = sched.slots[si]
            if slot.pos:        # admission matched a cached prefix
                stats["prefix_skipped_tokens"] += slot.pos
            if slot.cow is not None:
                src, dst = slot.cow
                for buf in pool.values():
                    buf[:, dst] = buf[:, src]
                sched.cow_executed(si)
            if slot.blocks:
                tables[si] = pad_block_table(slot.blocks, self._mb)
                self._tdirty = True

    def run(self, requests: Sequence[Request], *, seed: int = 0,
            use_time: bool = False) -> Dict[str, float]:
        """Drive the continuous loop until every request finished.  Mutates
        each ``Request`` in place (``tokens``, admit/finish times, draft
        counters) and returns aggregate stats.  ``use_time`` honors
        ``Request.arrival`` (seconds relative to the call) against the wall
        clock; otherwise all requests are immediately admissible."""
        if not self.continuous:
            raise RuntimeError(f"arch {self.cfg.arch_type!r} has no paged "
                               f"cache: the continuous path is unsupported "
                               f"(generate takes the static path)")
        if self.spec_k > 0:
            return self._run_spec(requests, seed=seed, use_time=use_time)
        S, MB, T = self.num_slots, self._mb, self.prefill_chunk
        sched = self._make_sched(T)
        for r in requests:
            if r.max_new < 1:
                raise ValueError(f"request {r.rid}: max_new must be >= 1")
            sched.submit(r)
        pool = self._device_pool()
        tables = np.full((S, MB), -1, np.int32)
        self._tdirty = True
        tables_dev = self._put(tables)
        stats = {"step_calls": 0, "prefill_tokens": 0, "generated": 0,
                 "token_slots": 0, "recycled_blocks": 0,
                 "prefix_skipped_tokens": 0, "expired": 0}
        t0 = time.perf_counter()
        now = (lambda: time.perf_counter() - t0) if use_time else \
            (lambda: float("inf"))

        while sched.has_work():
            self._expire_due(sched, now(), use_time, tables, stats)
            newly = sched.admit(now())
            act = sched.active_slots()
            if not act:
                time.sleep(5e-4)        # idle: waiting on future arrivals
                continue
            self._attach_new(sched, newly, pool, tables, stats)
            self._prep_round(sched, act, tables, T, stats)

            # -- build the scripted chunk for every active slot ------------
            script = np.zeros((S, T), np.int32)
            n_script = np.zeros((S,), np.int32)
            start = np.full((S,), -1, np.int32)
            temps = np.ones((S,), np.float32)
            greedy = np.ones((S,), bool)
            rids = np.zeros((S,), np.int64)
            for si in act:
                slot = sched.slots[si]
                n = min(T, len(slot.feed))
                script[si, :n] = slot.feed[:n]
                n_script[si] = n
                start[si] = slot.pos
                temps[si] = slot.req.temperature
                greedy[si] = slot.req.greedy
                rids[si] = slot.req.rid

            if self._tdirty:    # device tables re-upload only on change
                tables_dev = self._put(tables)
                self._tdirty = False
            samples = _fetch(self._step(pool, script, n_script, start,
                                        tables_dev, tables, greedy, temps,
                                        rids, seed))
            stats["step_calls"] += 1
            stats["token_slots"] += len(act) * T

            # -- consume: scripted tokens advance, the rest are samples ----
            for si in act:
                slot = sched.slots[si]
                n = int(n_script[si])
                slot.pos += T
                exhausted = n == len(slot.feed)
                del slot.feed[:n]
                stats["prefill_tokens"] += max(n - (1 if slot.generated
                                                    else 0), 0)
                if not exhausted:
                    continue            # still mid-prompt: nothing sampled
                if slot.generated == 0:
                    # prompt fully written this round: register its blocks
                    # before any emit can finish the slot
                    sched.register_prefix(si)
                done = False
                for tok in samples[si, n - 1:]:
                    done = self._emit(sched, si, int(tok), stats, now,
                                      use_time, tables)
                    if done:
                        break
                if not done:            # carry the last sample into the
                    slot.feed = [slot.req.tokens[-1]]   # next chunk
        stats["wall"] = time.perf_counter() - t0
        stats.update(sched.capacity_report())
        return stats

    # ------------------------------------------------------------------
    # Speculative loop (spec_k > 0): draft -> verify -> accept -> rollback
    # ------------------------------------------------------------------

    def _run_spec(self, requests: Sequence[Request], *, seed: int = 0,
                  use_time: bool = False) -> Dict[str, float]:
        S, MB, W = self.num_slots, self._mb, self.spec_k + 1
        sched = self._make_sched(W)
        for r in requests:
            if r.max_new < 1:
                raise ValueError(f"request {r.rid}: max_new must be >= 1")
            sched.submit(r)
        pool = self._device_pool()
        tables = np.full((S, MB), -1, np.int32)
        self._tdirty = True
        tables_dev = self._put(tables)
        stats = {"step_calls": 0, "prefill_tokens": 0, "generated": 0,
                 "token_slots": 0, "recycled_blocks": 0, "drafted": 0,
                 "accepted": 0, "rolled_back": 0,
                 "prefix_skipped_tokens": 0, "expired": 0}
        t0 = time.perf_counter()
        now = (lambda: time.perf_counter() - t0) if use_time else \
            (lambda: float("inf"))

        while sched.has_work():
            self._expire_due(sched, now(), use_time, tables, stats)
            newly = sched.admit(now())
            act = sched.active_slots()
            if not act:
                time.sleep(5e-4)
                continue
            self._attach_new(sched, newly, pool, tables, stats)

            # -- draft: build [carry, d_1..d_m] / prompt-chunk scripts -----
            script = np.zeros((S, W), np.int32)
            n_feed = np.zeros((S,), np.int32)
            start = np.full((S,), -1, np.int32)
            temps = np.ones((S,), np.float32)
            greedy = np.ones((S,), bool)
            rids = np.zeros((S,), np.int64)
            n_draft = np.zeros((S,), np.int32)
            for si in act:
                slot = sched.slots[si]
                if len(slot.feed) > 1:          # prefill chunk: no drafts
                    n = min(W, len(slot.feed))
                    script[si, :n] = slot.feed[:n]
                else:                           # decode: carry + drafts
                    room = min(self.spec_k,
                               slot.req.max_new - slot.generated - 1)
                    drafts = drafter_mod.propose(slot.history, room,
                                                 max_n=self.draft_ngram) \
                        if room > 0 else []
                    n_draft[si] = len(drafts)
                    n = 1 + len(drafts)
                    script[si, :n] = slot.feed + drafts
                n_feed[si] = n
                start[si] = slot.pos
                temps[si] = slot.req.temperature
                greedy[si] = slot.req.greedy
                rids[si] = slot.req.rid
            self._prep_round(sched, act, tables, n_feed, stats)

            # -- verify: one forward over every scripted position ----------
            if self._tdirty:    # device tables re-upload only on change
                tables_dev = self._put(tables)
                self._tdirty = False
            if all(greedy[si] for si in act):
                g_tok = _fetch(self._verify(pool, script, start, n_feed,
                                            tables_dev, tables))
                s_tok = acc = resid = g_tok      # unread on greedy slots
            else:
                g_tok, s_tok, acc, resid = _fetch(self._verify(
                    pool, script, start, n_feed, tables_dev, tables, greedy,
                    temps, rids, seed))
            stats["step_calls"] += 1
            stats["token_slots"] += len(act) * W

            # -- accept / rollback -----------------------------------------
            for si in act:
                slot = sched.slots[si]
                n = int(n_feed[si])
                if n_draft[si] == 0 and len(slot.feed) > 1:
                    # prefill round: n prompt tokens written
                    slot.pos += n
                    exhausted = n == len(slot.feed)
                    del slot.feed[:n]
                    stats["prefill_tokens"] += n if not slot.generated else 0
                    if not exhausted:
                        continue
                    if slot.generated == 0:
                        sched.register_prefix(si)   # prompt fully written
                    # first sample comes from the last prompt position
                    tok = int(g_tok[si, n - 1] if slot.req.greedy
                              else s_tok[si, n - 1])
                    if self._emit(sched, si, tok, stats, now, use_time,
                                  tables):
                        continue
                    slot.feed = [slot.req.tokens[-1]]
                    continue

                # decode round: carry at start, m drafts behind it
                if slot.generated == 0:
                    # single-token feed (1-token prompt tail): the carry
                    # token completed the prompt in this round's step
                    sched.register_prefix(si)
                m = int(n_draft[si])
                is_greedy = slot.req.greedy
                a = 0                   # accepted drafts (committed writes)
                done = False
                for i in range(m):
                    d = int(script[si, i + 1])
                    ok = (d == int(g_tok[si, i])) if is_greedy \
                        else bool(acc[si, i])
                    if ok:
                        a += 1
                        done = self._emit(sched, si, d, stats, now,
                                          use_time, tables)
                        if done:
                            break
                    else:               # emit the target's own token
                        done = self._emit(
                            sched, si,
                            int(g_tok[si, i]) if is_greedy
                            else int(resid[si, i]),
                            stats, now, use_time, tables)
                        break
                else:
                    if not done:        # every draft accepted: bonus token
                        done = self._emit(
                            sched, si,
                            int(g_tok[si, m]) if is_greedy
                            else int(s_tok[si, m]),
                            stats, now, use_time, tables)
                stats["drafted"] += m
                stats["accepted"] += a
                slot.req.drafted += m
                slot.req.accepted += a
                if done:
                    continue            # finish() already ran inside _emit
                # commit carry + a accepted drafts; roll back the rest
                slot.pos = int(start[si]) + 1 + a
                if a < m:
                    stats["rolled_back"] += m - a
                    sched.pool.truncate(slot, slot.pos)
                slot.feed = [slot.req.tokens[-1]]
        stats["wall"] = time.perf_counter() - t0
        stats["accept_rate"] = (stats["accepted"] / stats["drafted"]
                                if stats["drafted"] else float("nan"))
        stats.update(sched.capacity_report())
        return stats

    def _emit(self, sched: Scheduler, si: int, tok: int, stats, now,
              use_time: bool, tables: np.ndarray) -> bool:
        """Append one generated token; finish the slot on EOS/max_new.
        Returns True when the slot finished."""
        slot = sched.slots[si]
        slot.generated += 1
        slot.req.tokens.append(tok)
        stats["generated"] += 1
        if slot.generated == 1:
            slot.req.first_token_time = now() if use_time else 0.0
        if slot.generated >= slot.req.max_new or tok == slot.req.eos_id:
            sched.finish(si, now() if use_time else 0.0)
            tables[si] = -1
            self._tdirty = True
            return True
        return False

    # ----------------------------------------------------------------------
    # Static-bucket path (ssm archs, and batches the scheduler cannot serve)
    # ----------------------------------------------------------------------

    def _generate_scan(self, tokens: torch.Tensor, lens: np.ndarray, *,
                       max_new: int, greedy: bool, temperature: float,
                       seed: int) -> torch.Tensor:
        """tokens: (B, Tp) left-padded prompts on the device; lens: (B,)
        host prompt lengths.  Feeds every prompt column (row b's token t
        at position t - (Tp - lens[b]), -1 for its pad tokens), then
        max_new generated tokens.  Returns (B, max_new) on the device."""
        B, Tp = tokens.shape
        cache = init_decode_cache(self.cfg, B, Tp + max_new,
                                  device=self.device)
        pre = np.maximum(np.arange(Tp)[:, None] - (Tp - lens)[None, :],
                         -1).astype(np.int32)                 # (Tp, B)
        pos_d = self._put(np.concatenate(
            [pre, lens[None, :] + np.arange(max_new)[:, None]]).astype(
                np.int32))
        logits = None
        for t in range(Tp):
            logits, cache = decode_step_lm(
                self.params, cache, {"token": tokens[:, t:t + 1],
                                     "position": pos_d[t]}, self.cfg)
        g = None
        if not greedy:
            g = torch.Generator(device=self.device)
            g.manual_seed(seed)
        out = []
        for t in range(max_new):
            lg = logits[:, 0].float()
            if greedy:
                nxt = torch.argmax(lg, dim=-1)
            else:
                u = torch.rand(lg.shape, generator=g, device=self.device)
                nxt = torch.argmax(lg / temperature + _gumbel(u), dim=-1)
            nxt = nxt.to(torch.int32)
            out.append(nxt)
            if t + 1 < max_new:         # the last token's logits go unused
                logits, cache = decode_step_lm(
                    self.params, cache, {"token": nxt[:, None],
                                         "position": pos_d[Tp + t]},
                    self.cfg)
        if not out:
            return torch.zeros((B, 0), dtype=torch.int32, device=self.device)
        return torch.stack(out, dim=1)

    def generate_ids_static(self, prompts: Sequence[Sequence[int]],
                            max_new: int = 16, greedy: bool = True,
                            temperature: float = 1.0,
                            seed: int = 0) -> np.ndarray:
        """The static-bucket path: the batch is left-padded to its longest
        prompt and stalls until its longest request finishes.  Returns
        (B, max_new) int32."""
        pad = self.tok.pad if self.tok else 0
        tokens, lens = _left_pad(prompts, pad)
        with torch.no_grad():
            out = self._generate_scan(self._put(tokens), lens,
                                      max_new=max_new, greedy=greedy,
                                      temperature=temperature, seed=seed)
        return _fetch(out)

    # ----------------------------------------------------------------------
    # Public API
    # ----------------------------------------------------------------------

    def _fits(self, prompts: Sequence[Sequence[int]], max_new: int) -> bool:
        """Whether the scheduler path can serve this batch; anything it
        cannot (empty prompts, max_new < 1, over-capacity requests — per
        slot OR whole pool — or an arch without a paged cache) routes to
        the static path instead."""
        return (self.continuous and max_new >= 1
                and all(1 <= len(p) and len(p) + max_new <= self.capacity
                        and -(-(len(p) + max_new) // self.block_size)
                        <= self.num_blocks
                        for p in prompts))

    def generate(self, prompts: Sequence[Sequence[int]], max_new: int = 16,
                 greedy: bool = True, temperature: float = 1.0,
                 seed: int = 0, eos_id: Optional[int] = None
                 ) -> List[List[int]]:
        """Ragged generation: the scheduler path when the batch fits (EOS
        evicts early, freeing the slot for queued requests), the static
        bucket otherwise (trimmed to match).  Rows include the EOS token
        when one was produced."""
        if self._fits(prompts, max_new):
            reqs = [Request(rid=i, prompt=list(p), max_new=max_new,
                            temperature=temperature, greedy=greedy,
                            eos_id=eos_id)
                    for i, p in enumerate(prompts)]
            self.run(reqs, seed=seed)
            return [r.tokens for r in reqs]
        rows = [[int(t) for t in r] for r in self.generate_ids_static(
            prompts, max_new=max_new, greedy=greedy,
            temperature=temperature, seed=seed)]
        if eos_id is not None:
            rows = [row[:row.index(eos_id) + 1] if eos_id in row else row
                    for row in rows]
        return rows

    def generate_ids(self, prompts: Sequence[Sequence[int]],
                     max_new: int = 16, greedy: bool = True,
                     temperature: float = 1.0, seed: int = 0) -> np.ndarray:
        return np.asarray(self.generate(prompts, max_new=max_new,
                                        greedy=greedy,
                                        temperature=temperature, seed=seed),
                          np.int32)

    def chat(self, prompts: List[str], max_new: int = 32,
             greedy: bool = True, temperature: float = 1.0) -> List[str]:
        """Text in, text out, stopping at ``<|assistant_end|>``."""
        if self.tok is None:
            raise ValueError("chat needs the engine's tokenizer")
        ids = [self.tok.encode(p) for p in prompts]
        stop = self.tok.special_id("<|assistant_end|>")
        rows = self.generate(ids, max_new=max_new, greedy=greedy,
                             temperature=temperature, eos_id=stop)
        texts = []
        for row in rows:
            if stop in row:
                row = row[:row.index(stop)]
            texts.append(self.tok.decode(list(row)))
        return texts

    # -- scoring (the multiple-choice evals) --------------------------------

    def _score_batch(self, tokens: torch.Tensor,
                     cont_mask: torch.Tensor) -> torch.Tensor:
        """tokens: (B, T); cont_mask: (B, T), 1 where position t's target
        (token t+1) belongs to the continuation.  Returns (B,) summed
        log-probabilities."""
        logits, _ = forward_lm(self.params, {"tokens": tokens}, self.cfg)
        lp = torch.log_softmax(logits.float(), dim=-1)
        tgt = torch.roll(tokens, -1, dims=1).long()
        gold = torch.gather(lp, -1, tgt[..., None])[..., 0]
        return torch.sum(gold * cont_mask, dim=1)

    def score_continuations_batch(self, rows) -> np.ndarray:
        """rows: list of (prompt_ids, option_ids).  One forward for the
        whole batch, padded to a shared length bucket (a multiple of 16)."""
        pad = self.tok.pad if self.tok else 0
        tmax = max(len(p) + len(o) for p, o in rows)
        tmax = -(-tmax // 16) * 16
        toks = np.full((len(rows), tmax), pad, np.int32)
        mask = np.zeros((len(rows), tmax), np.float32)
        for i, (p, o) in enumerate(rows):
            full = list(p) + list(o)
            toks[i, :len(full)] = full
            mask[i, len(p) - 1:len(full) - 1] = 1.0
        with torch.no_grad():
            out = self._score_batch(self._put(toks), self._put(mask))
        return _fetch(out)

    def score_continuations(self, prompt_ids: Sequence[int],
                            options_ids: Sequence[Sequence[int]]
                            ) -> np.ndarray:
        return self.score_continuations_batch(
            [(prompt_ids, o) for o in options_ids])
