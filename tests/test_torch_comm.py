"""The port's comm simulator (``repro_torch.launch.comm_sim``) and comm
report (``launch.train.comm_report``) against the JAX package's, on the
CPU: the same events (each package's strategies' ``payload_schedule`` and
``gossip_rounds``) and the same ``CommModel`` give exactly the same
dicts from ``simulate_schedule``, ``simulate_heterogeneous``,
``simulate_gossip``, ``modeled_step_time`` and ``load_calibration``;
``comm_report`` equals the reference's under the same link.  The port
states its own constants (an H100's data sheet, a 100 Gbit/s Ethernet
link), not the reference's TPU ones.  (The fault overlay is held to the
reference in ``test_torch_faults.py``.)"""
import dataclasses
import json

import pytest

from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.core import sync as jax_sync
from repro.launch import comm_sim as jax_sim
from repro.launch import mesh as jax_mesh
from repro.launch import train as jax_train
from repro_torch.configs import DiLoCoConfig
from repro_torch.core import sync
from repro_torch.launch import comm_sim, train

N_PARAMS = 3_456_789
STEPS = 40
TIMES = (0.011, 0.01, 0.015, 0.03)
# a slow link, so transfers stall the step clocks
LINK = dict(bandwidth=2e8, latency=2e-3)


def _strategies(mod):
    return {
        "ddp": mod.DDPSync(),
        "diloco": mod.DiLoCoSync(h=8),
        "streaming": mod.StreamingSync(num_fragments=4),
        "overlapped": mod.OverlappedSync(h=8, delay=3, jitter=1, seed=2),
        "pipelined": mod.PipelinedSync(h=8, num_fragments=2, delay=2),
        "gossip": mod.GossipSync(h=8),
        "gossip_full": mod.GossipSync(h=8, topology="full"),
        "async_gossip": mod.AsyncGossipSync(h=8, jitter=2,
                                            staleness_bound=2, seed=7),
    }


def _events(name, codec="int8", k=4):
    port = _strategies(sync)[name].payload_schedule(
        N_PARAMS, STEPS, DiLoCoConfig(num_workers=k, h_inner_steps=8,
                                      delta_dtype=codec))
    ref = _strategies(jax_sync)[name].payload_schedule(
        N_PARAMS, STEPS, JaxDiLoCoConfig(num_workers=k, h_inner_steps=8,
                                         delta_dtype=codec))
    return port, ref


@pytest.mark.parametrize("codec", ["float32", "int8", "fp8"])
@pytest.mark.parametrize("name", list(_strategies(sync)))
def test_simulators_match_the_reference(name, codec):
    port, ref = _events(name, codec)
    assert [dataclasses.astuple(e) for e in port] == \
        [dataclasses.astuple(e) for e in ref]
    pm, rm = comm_sim.CommModel(**LINK), jax_sim.CommModel(**LINK)
    assert comm_sim.simulate_schedule(port, STEPS, TIMES[0], pm) == \
        jax_sim.simulate_schedule(ref, STEPS, TIMES[0], rm)
    for staleness in (0, 2):
        assert comm_sim.simulate_heterogeneous(
            port, STEPS, TIMES, pm, staleness_steps=staleness) == \
            jax_sim.simulate_heterogeneous(ref, STEPS, TIMES, rm,
                                           staleness_steps=staleness)


@pytest.mark.parametrize("name", ["gossip", "gossip_full", "async_gossip"])
def test_simulate_gossip_matches_the_reference(name):
    pm, rm = comm_sim.CommModel(**LINK), jax_sim.CommModel(**LINK)
    for k in (3, 4):
        port = _strategies(sync)[name].gossip_rounds(
            N_PARAMS, STEPS, DiLoCoConfig(num_workers=k, h_inner_steps=8,
                                          delta_dtype="int8"))
        ref = _strategies(jax_sync)[name].gossip_rounds(
            N_PARAMS, STEPS, JaxDiLoCoConfig(num_workers=k, h_inner_steps=8,
                                             delta_dtype="int8"))
        for staleness in (0, 1, 4):
            got = comm_sim.simulate_gossip(port, STEPS, TIMES[:k], pm,
                                           staleness_steps=staleness)
            assert got == jax_sim.simulate_gossip(
                ref, STEPS, TIMES[:k], rm, staleness_steps=staleness)
            assert got["wall_clock_s"] > got["compute_s"]


def test_step_time_and_calibration_match_the_reference(tmp_path):
    """With a measured step and the outer step's wire bytes in the dump,
    ``load_calibration`` gives the reference's calibration, and
    ``modeled_step_time`` the same seconds at the same peak; a dump with
    only analytic terms is read at the port's H100 rates."""
    entries = [
        {"arch": "a", "step_kind": "decode", "measured_step_s": 9.0},
        {"arch": "a", "step_kind": "train", "measured_step_s": 0.37},
        {"arch": "a", "step_kind": "diloco-outer", "shape": "outer[int8]",
         "collectives": {"wire_bytes_per_device": 123456.0}},
        {"arch": "b", "step_kind": "diloco-inner",
         "analytic": {"total_flops": 3e15, "bytes": 2e12}}]
    path = str(tmp_path / "dryrun.json")
    with open(path, "w") as f:
        json.dump(entries, f)
    got = comm_sim.load_calibration(path, arch="a")
    want = jax_sim.load_calibration(path, arch="a")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.step_time_s == 0.37 and got.sync_dtype == "int8"
    assert comm_sim.load_calibration(str(tmp_path / "none.json")) is None
    b = comm_sim.load_calibration(path, arch="b")
    assert b.step_time_s == max(3e15 / 989e12, 2e12 / 3.35e12)
    assert b.step_time_s != jax_sim.load_calibration(path,
                                                     arch="b").step_time_s
    for cal in (None, got):
        assert comm_sim.modeled_step_time(
            5e14, mfu=0.35, peak_flops=2e15, calibration=cal) == \
            jax_sim.modeled_step_time(5e14, mfu=0.35, peak_flops=2e15,
                                      calibration=(None if cal is None
                                                   else want))
    assert comm_sim.modeled_step_time(4e14) == 4e14 / (989e12 * 0.4)


@pytest.mark.parametrize("method,dkw", [
    ("diloco", dict(delta_dtype="int8")), ("hybrid", dict()),
    ("overlapped", dict(sync_delay=3, h_jitter=2)),
    ("gossip", dict(delta_dtype="fp8", topology="random", sync_seed=3)),
    ("async_gossip", dict(delta_dtype="int8", h_jitter=2,
                          staleness_bound=2, sync_seed=7))])
def test_comm_report_matches_the_reference(monkeypatch, method, dkw):
    """Both packages' ``comm_report`` under the same link (each package's
    ``default_comm_model`` patched to it): the same report, and the port's
    names the link it assumed."""
    monkeypatch.setattr(comm_sim, "default_comm_model",
                        lambda: comm_sim.CommModel(**LINK))
    monkeypatch.setattr(jax_sim, "default_comm_model",
                        lambda: jax_sim.CommModel(**LINK))
    args = (method, N_PARAMS, STEPS, 8, 0.02, (1.0, 1.0, 1.5, 2.0))
    got = train.comm_report(DiLoCoConfig(num_workers=4, **dkw), *args)
    want = jax_train.comm_report(JaxDiLoCoConfig(num_workers=4, **dkw),
                                 *args)
    assert got.pop("link_bytes_per_s") == LINK["bandwidth"]
    assert got.pop("link_latency_s") == LINK["latency"]
    assert got == want
    assert ("gossip" in got) == method.endswith("gossip")


def test_constants_are_the_h100s_not_the_tpus():
    assert comm_sim.PEAK_FLOPS_BF16 == 989e12
    assert comm_sim.HBM_BW == 3.35e12
    assert comm_sim.LINK_BW == 12.5e9 and comm_sim.LINK_LATENCY == 1e-3
    assert comm_sim.PEAK_FLOPS_BF16 != jax_mesh.PEAK_FLOPS_BF16
    assert comm_sim.HBM_BW != jax_mesh.HBM_BW
    assert comm_sim.LINK_BW != jax_mesh.DCN_BW
    model = comm_sim.default_comm_model()
    assert (model.bandwidth, model.latency) == (12.5e9, 1e-3)
    rep = train.comm_report(DiLoCoConfig(num_workers=2), "diloco", N_PARAMS,
                            STEPS, 8, 0.02, (1.0, 1.5))
    assert rep["link_bytes_per_s"] == 12.5e9
