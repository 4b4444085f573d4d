"""Event-driven communication simulator: payload schedules -> modeled time.

Converts a ``SyncStrategy.payload_schedule`` (what crosses the slow
boundary between workers, and when) into modeled wall-clock, so
strategies can be compared on *time*, not just bytes.  The model is
deliberately simple and fully documented:

* compute: every inner step costs ``step_time_s`` (derive it from the
  analytic roofline via ``modeled_step_time``, or calibrate it against a
  ``launch.dryrun`` JSON dump via ``load_calibration``);
* communication: each worker ships its payload over its own boundary link
  (``CommModel.bandwidth`` bytes/s, plus a fixed per-transfer ``latency``).
  Transfers on one link serialize.  ``simulate_schedule`` models the
  symmetric fleet (one link); ``simulate_heterogeneous`` gives every
  worker its own step clock (``step_times[w]``) and link, with a
  bounded-staleness apply rule; ``simulate_gossip`` replaces the fleet
  barrier with per-PAIR barriers driven by ``GossipRound`` events
  (``SyncStrategy.gossip_rounds``) — each worker blocks only on its own
  transfer and the peers named by its deps, which is why modeled gossip
  wall-clock stays at or below the bounded-staleness all-reduce baseline;
* blocking: a transfer whose ``apply_step`` equals its emit step stalls the
  loop immediately (DDP's per-step all-reduce, DiLoCo's outer step); a
  later ``apply_step`` gives the transfer a window of inner compute to hide
  behind (Streaming / Overlapped / Pipelined DiLoCo) — the loop stalls only
  for the portion that does not fit.  In the heterogeneous simulator the
  outer update is a fleet barrier: a round completes when the LAST worker's
  payload lands, and every worker may run at most ``staleness_steps`` past
  the round's ``apply_step`` before blocking on the result.

Bytes are accounted per codec (``SyncEvent.codec``): results carry a
``bytes_by_codec`` breakdown next to ``total_bytes``.

This is the JAX package's ``launch/comm_sim.py`` with the port's own
constants (below): an H100's data-sheet rates for the roofline step time,
and a worker's boundary link of one 100 Gbit/s Ethernet port.  It runs on
the host and never touches the device.  ``faults=`` overlays a
``core.faults.FaultSchedule`` on the simulators.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, Iterable, List, Optional, Sequence

# NVIDIA H100 SXM, data sheet: dense bf16 tensor-core rate and HBM3 rate
PEAK_FLOPS_BF16 = 989e12      # FLOP/s
HBM_BW = 3.35e12              # bytes/s
# a worker's boundary link: one 100 Gbit/s Ethernet port (IEEE 802.3ba),
# its line rate in bytes/s, not a measurement
LINK_BW = 100e9 / 8
# the per-transfer fixed cost: the model's assumption, not a measurement
LINK_LATENCY = 1e-3           # s


@dataclasses.dataclass(frozen=True)
class CommModel:
    bandwidth: float                # bytes/s per worker across the boundary
    latency: float = LINK_LATENCY   # per-transfer fixed cost (s)


def transfer_time(nbytes: int, comm: CommModel) -> float:
    return comm.latency + nbytes / comm.bandwidth


def _index_events(events: Iterable):
    by_step: Dict[int, List] = {}
    total_bytes = 0
    by_codec: Dict[str, float] = {}
    for ev in events:
        by_step.setdefault(ev.step, []).append(ev)
        total_bytes += ev.bytes_per_worker
        codec = getattr(ev, "codec", "f32")
        by_codec[codec] = by_codec.get(codec, 0.0) + ev.bytes_per_worker
    return by_step, total_bytes, by_codec


def simulate_schedule(events: Iterable, num_steps: int, step_time_s: float,
                      comm: CommModel) -> Dict[str, float]:
    """Walk the step timeline, overlaying transfers on the boundary link.

    ``events`` are ``repro_torch.core.sync.SyncEvent``s sorted by ``step``
    (the strategies emit them sorted).  Returns wall-clock plus a breakdown:
    ``comm_s`` is total link-busy time, ``stall_s`` the part of it the
    compute timeline actually had to wait for (exposed communication).
    """
    by_step, total_bytes, by_codec = _index_events(events)

    now = 0.0            # compute-timeline clock
    link_free = 0.0      # when the boundary link next idles
    comm_s = 0.0
    stall_s = 0.0
    in_flight: List = []  # (done_time, apply_step)

    for step in range(num_steps):
        now += step_time_s
        for ev in by_step.get(step, ()):
            start = max(now, link_free)
            done = start + transfer_time(ev.bytes_per_worker, comm)
            comm_s += done - start
            link_free = done
            in_flight.append((done, ev.apply_step))
        # block on every transfer whose result is due by this step
        still = []
        for done, apply_step in in_flight:
            if apply_step <= step:
                if done > now:
                    stall_s += done - now
                    now = done
            else:
                still.append((done, apply_step))
        in_flight = still

    # results still in flight at the end must land before training finishes
    for done, _ in in_flight:
        if done > now:
            stall_s += done - now
            now = done

    compute_s = num_steps * step_time_s
    return {"wall_clock_s": now, "compute_s": compute_s, "comm_s": comm_s,
            "stall_s": stall_s, "total_bytes": float(total_bytes),
            "bytes_by_codec": by_codec,
            "overhead_frac": (now - compute_s) / max(now, 1e-12)}


def _fault_tables(faults, w_n: int, num_steps: int):
    """Expand an optional ``FaultSchedule`` into the per-step tables the
    simulators consume; (None, None, {}, {}) when there are no faults, so
    the no-fault arithmetic stays literally the existing code path."""
    if faults is None or faults.empty:
        return None, None, {}, {}
    from repro_torch.core.faults import sim_timeline
    faults.validate(w_n)
    alive_t, factor_t, failed = sim_timeline(faults, w_n, num_steps)
    drops: Dict[int, Dict[int, int]] = {}   # step -> {worker: attempts}
    for e in faults.events:
        if e.kind in ("drop", "corrupt"):
            drops.setdefault(e.step, {})[e.worker] = e.attempts
    return alive_t, factor_t, failed, drops


def simulate_heterogeneous(events: Iterable, num_steps: int,
                           step_times: Sequence[float], comm: CommModel,
                           staleness_steps: int = 0,
                           faults=None) -> Dict[str, float]:
    """Per-worker step clocks + bounded-staleness apply rule.

    ``step_times[w]`` is worker w's inner-step seconds (heterogeneous
    fleet).  Every worker ships each scheduled payload over its own link
    when ITS clock reaches the emit step; the round's outer update is
    ready when the last worker's transfer lands, and workers block on it
    at ``apply_step + staleness_steps`` (staleness 0 = synchronous apply).
    With identical ``step_times`` and staleness 0 this reduces exactly to
    ``simulate_schedule``.

    ``faults`` (a ``core.faults.FaultSchedule``) overlays the same
    script the trainer consumes: crashed workers stop stepping and ship
    nothing (their clock freezes until a rejoin), ``slow`` scales a
    worker's step time, ``drop``/``corrupt`` cost one retry transfer —
    counted in ``retry_bytes`` — and with ``attempts >= 2`` the round
    stops waiting on that worker entirely.  An empty schedule reduces
    exactly (bitwise) to the fault-free model.

    ``compute_s`` is the slowest worker's pure-compute time (the fleet's
    compute critical path); ``straggler_s`` the spread the slowest worker
    adds over the fastest.
    """
    w_n = len(step_times)
    if w_n == 0:
        raise ValueError("need at least one worker step time")
    by_step, total_bytes, by_codec = _index_events(events)
    alive_t, factor_t, failed, drops = _fault_tables(faults, w_n, num_steps)

    clock = [0.0] * w_n
    link_free = [0.0] * w_n
    busy = [0.0] * w_n
    stall = [0.0] * w_n
    retry_bytes = 0.0
    in_flight: List = []  # (round_done_time, block_step)

    def block_on(done: float):
        for w in range(w_n):
            if done > clock[w]:
                stall[w] += done - clock[w]
                clock[w] = done

    for step in range(num_steps):
        for w in range(w_n):
            if alive_t is None:
                clock[w] += step_times[w]
            elif alive_t[step][w]:
                clock[w] += step_times[w] * factor_t[step][w]
        for ev in by_step.get(step, ()):
            round_done = 0.0
            for w in range(w_n):
                if alive_t is not None and not alive_t[step][w]:
                    continue            # dead: ships nothing
                start = max(clock[w], link_free[w])
                t = transfer_time(ev.bytes_per_worker, comm)
                resend = 1 if w in drops.get(step, ()) else 0
                done = start + (1 + resend) * t
                retry_bytes += resend * ev.bytes_per_worker
                busy[w] += done - start
                link_free[w] = done
                if w not in failed.get(step, ()):
                    round_done = max(round_done, done)
            in_flight.append((round_done, ev.apply_step + staleness_steps))
        still = []
        for done, block_step in in_flight:
            if block_step <= step:
                block_on(done)
            else:
                still.append((done, block_step))
        in_flight = still

    for done, _ in in_flight:
        block_on(done)

    now = max(clock)
    compute_s = num_steps * max(step_times)
    return {"wall_clock_s": now, "compute_s": compute_s,
            "comm_s": max(busy), "stall_s": max(stall),
            "straggler_s": num_steps * (max(step_times) - min(step_times)),
            "total_bytes": float(total_bytes), "bytes_by_codec": by_codec,
            "retry_bytes": retry_bytes,
            "overhead_frac": (now - compute_s) / max(now, 1e-12)}


def simulate_gossip(rounds: Iterable, num_steps: int,
                    step_times: Sequence[float], comm: CommModel,
                    staleness_steps: int = 0,
                    faults=None) -> Dict[str, float]:
    """Per-pair event model for the gossip strategies.

    ``rounds`` are ``repro_torch.core.sync.GossipRound``s (duck-typed, like
    ``SyncEvent``): worker w ships ``nbytes`` over its OWN link when its
    clock reaches ``emit_steps[w]`` (-1 = not participating), then blocks
    at ``emit + staleness_steps`` on its own transfer plus the transfers
    named by ``deps[w]`` — a PAIR barrier, not a fleet barrier.  A dropped
    contribution (empty deps) blocks only on the worker's own ship-out.
    Byte totals are denominated per worker (the busiest link), matching
    ``hop_bytes_per_worker``: gossip traffic is flat in fleet size.

    ``faults`` overlays a ``core.faults.FaultSchedule``: crashed
    workers stop stepping, skip their ship-outs, and vanish from peers'
    pair barriers (the ``transfers`` key never lands — peers proceed on
    their own clock, gossip's no-fleet-barrier property); ``slow`` scales
    a worker's step time; ``drop``/``corrupt`` cost one retry transfer
    (``retry_bytes``), with ``attempts >= 2`` also hiding the payload
    from peers.  An empty schedule reduces exactly to the fault-free
    model.
    """
    w_n = len(step_times)
    if w_n == 0:
        raise ValueError("need at least one worker step time")
    by_emit: Dict[int, List] = {}
    for rnd in rounds:
        for w, es in enumerate(rnd.emit_steps):
            if es >= 0:
                by_emit.setdefault(es, []).append((w, rnd))
    alive_t, factor_t, failed, drops = _fault_tables(faults, w_n, num_steps)

    clock = [0.0] * w_n
    link_free = [0.0] * w_n
    busy = [0.0] * w_n
    stall = [0.0] * w_n
    shipped = [0.0] * w_n
    retry_bytes = 0.0
    by_codec_w: List[Dict[str, float]] = [{} for _ in range(w_n)]
    transfers: Dict = {}      # (worker, emit_step) -> done time
    pending: List = []        # (block_step, worker, transfer keys)

    def block(w: int, keys, own: float) -> None:
        done = max((transfers[k] for k in keys if k in transfers),
                   default=0.0)
        done = max(done, own)
        if done > clock[w]:
            stall[w] += done - clock[w]
            clock[w] = done

    for step in range(num_steps):
        for w in range(w_n):
            if alive_t is None:
                clock[w] += step_times[w]
            elif alive_t[step][w]:
                clock[w] += step_times[w] * factor_t[step][w]
        # ship-outs first: a co-due peer's transfer must exist before any
        # same-step pair barrier references it
        for w, rnd in by_emit.get(step, ()):
            if alive_t is not None and not alive_t[step][w]:
                continue                # dead: no ship-out, no barrier
            start = max(clock[w], link_free[w])
            resend = 1 if w in drops.get(step, ()) else 0
            done = start + (1 + resend) * transfer_time(rnd.nbytes, comm)
            retry_bytes += resend * rnd.nbytes
            busy[w] += done - start
            link_free[w] = done
            shipped[w] += rnd.nbytes
            codec = getattr(rnd, "codec", "f32")
            by_codec_w[w][codec] = by_codec_w[w].get(codec, 0.0) + rnd.nbytes
            if w not in failed.get(step, ()):
                # lost payloads never land for PEERS; the sender still
                # blocks on its own attempt (the ``done`` carried below)
                transfers[(w, step)] = done
            keys = [(w, step)] + [tuple(d) for d in rnd.deps[w]]
            pending.append((step + staleness_steps, w, keys, done))
        still = []
        for block_step, w, keys, own in pending:
            if block_step <= step:
                block(w, keys, own)
            else:
                still.append((block_step, w, keys, own))
        pending = still

    for _, w, keys, own in pending:  # in-flight results land before the end
        block(w, keys, own)

    now = max(clock)
    compute_s = num_steps * max(step_times)
    busiest = max(range(w_n), key=lambda w: shipped[w])
    return {"wall_clock_s": now, "compute_s": compute_s,
            "comm_s": max(busy), "stall_s": max(stall),
            "straggler_s": num_steps * (max(step_times) - min(step_times)),
            "total_bytes": float(shipped[busiest]),
            "bytes_by_codec": by_codec_w[busiest],
            "retry_bytes": retry_bytes,
            "overhead_frac": (now - compute_s) / max(now, 1e-12)}


# ---------------------------------------------------------------------------
# Step-time modeling + dry-run calibration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommCalibration:
    """Measured / HLO-derived overrides for the simulator's two analytic
    assumptions: the inner-step seconds and the outer-sync wire bytes.
    ``sync_dtype`` records which delta dtype the measured outer step was
    compiled with (from the entry's ``outer[<dtype>]`` shape tag), so
    consumers can normalize the bytes against the right analytic width."""
    step_time_s: Optional[float] = None
    sync_bytes_per_worker: Optional[float] = None
    sync_dtype: str = "float32"
    source: str = "analytic"


def load_calibration(path: str, arch: Optional[str] = None
                     ) -> Optional[CommCalibration]:
    """Calibrate against a dry-run JSON dump in the JAX package's
    ``launch.dryrun --json-out`` format (e.g. ``dryrun_outer.json``).

    * step time — from a ``train`` / ``diloco-inner`` entry: its
      ``measured_step_s`` field if present (real profiled seconds merged
      into the dump), else the roofline bound max(flops/peak,
      hbm_bytes/hbm_bw) at this module's H100 rates from its analytic
      terms — either replaces the
      fixed 40%-MFU assumption;
    * sync bytes — the outer-step entry's HLO-parsed cross-pod wire bytes
      (falling back to total wire bytes), replacing width×n_params.
    """
    try:
        with open(path) as f:
            entries = json.load(f)
    except (OSError, ValueError):
        return None
    if isinstance(entries, dict):
        entries = [entries]
    step_time = None
    sync_bytes = None
    sync_dtype = "float32"
    for e in entries:
        if arch is not None and e.get("arch") != arch:
            continue
        measured = e.get("measured_step_s")
        kind = e.get("step_kind", "")
        analytic = e.get("analytic") or {}
        if step_time is None and kind in ("train", "diloco-inner"):
            # only inner/train entries describe a training step; measured
            # seconds on decode/prefill/outer entries are other latencies
            if measured:
                step_time = float(measured)
            else:
                flops = float(analytic.get("total_flops") or 0.0)
                hbm = float(analytic.get("bytes") or 0.0)
                derived = max(flops / PEAK_FLOPS_BF16, hbm / HBM_BW)
                if derived > 0:
                    step_time = derived
        if sync_bytes is None and kind == "diloco-outer":
            colls = (e.get("collectives_weighted") or e.get("collectives")
                     or {})
            b = (colls.get("cross_pod_bytes_per_device")
                 or colls.get("wire_bytes_per_device"))
            if b:
                sync_bytes = float(b)
                m = re.match(r"outer\[(\w+)\]", e.get("shape", ""))
                if m:
                    sync_dtype = m.group(1)
    if step_time is None and sync_bytes is None:
        return None
    return CommCalibration(step_time_s=step_time,
                           sync_bytes_per_worker=sync_bytes,
                           sync_dtype=sync_dtype, source=path)


def modeled_step_time(total_flops_per_device: float, mfu: float = 0.4,
                      peak_flops: float = PEAK_FLOPS_BF16,
                      calibration: Optional[CommCalibration] = None) -> float:
    """Inner-step seconds from the analytic per-device FLOPs at an
    assumed MFU (of the H100's dense bf16 peak by default) — unless
    a ``CommCalibration`` carries a measured / roofline-derived step time,
    which then takes precedence over the MFU guess."""
    if calibration is not None and calibration.step_time_s:
        return calibration.step_time_s
    return total_flops_per_device / (peak_flops * mfu)


def default_comm_model() -> CommModel:
    """The slow boundary link the paper's DiLoCo targets: ``LINK_BW``
    (one 100 Gbit/s Ethernet port per worker) at ``LINK_LATENCY``."""
    return CommModel(bandwidth=LINK_BW)
