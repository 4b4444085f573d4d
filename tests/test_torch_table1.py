"""The port's Table-1 driver (``examples/torch_pipeline_table1.py``) and
drift benchmark (``benchmarks/torch_drift_analysis.py``) on the CPU at
the smallest sizes: the driver runs the pipeline and writes the
Table-1-shaped summary and ``table1.json`` with the JAX example's keys;
the benchmark prints the JAX benchmark's lines; neither imports JAX or
the JAX package."""
import ast
import importlib.util
import json
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = ("examples/torch_pipeline_table1.py",
           "benchmarks/torch_drift_analysis.py")


def _load(path):
    spec = importlib.util.spec_from_file_location(Path(path).stem,
                                                  REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for d in ("examples", "benchmarks")
    for p in (REPO / d).glob("torch_*.py")))
def test_torch_scripts_import_neither_jax_nor_the_reference(path):
    tree = ast.parse((REPO / path).read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    assert mods
    for mod in mods:
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def test_table1_driver_runs_and_writes_the_reference_keys(tmp_path, capsys):
    out = tmp_path / "t1"
    res = _load(SCRIPTS[0]).main(["--device", "cpu", "--methods", "diloco",
                                  "--steps", "2", "--workers", "2",
                                  "--out", str(out)])
    text = capsys.readouterr().out
    assert "stage   method        core" in text
    for stage in ("base", "mid", "sft"):
        assert f"{stage:7s} diloco " in text
    saved = json.loads((out / "table1.json").read_text())
    assert set(saved) == set(res) == {"diloco"}
    for stage in ("base", "mid", "sft"):
        e = saved["diloco"]["stages"][stage]
        assert {"core", "tasks", "loss_first", "loss_last", "losses",
                "method", "step_seconds", "port"} <= set(e)
        assert {"mc", "arith", "pattern", "chatcore"} <= set(e["tasks"])
        assert 0.0 < e["core"]["core_proxy"] <= 1.0
    assert (out / "diloco_final.npz").exists()


def test_drift_benchmark_prints_the_reference_lines(capsys):
    """No training steps: the final DiLoCo and DDP models are the initial
    one, so their CKA and subspace overlap are 1."""
    _load(SCRIPTS[1]).main(["--device", "cpu", "--steps", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    name, us, derived = lines[-1].split(",")
    assert name == "drift/final_diloco_vs_ddp" and us == "0.0"
    assert derived == "cka=1.0000 subspace_overlap_r8=1.0000"
