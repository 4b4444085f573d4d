"""The train CLI's wire-codec flags (``repro_torch.launch.train.main``)
against the reference's (``src/repro/launch/train.py``): ``--sync-dtype``
takes the reference's choices, is canonicalised through its map, and
overrides ``--delta-dtype``.  ``run_pipeline`` is replaced by a recorder,
so no stage runs."""
import pytest

from repro.launch import train as jax_train
from repro_torch.core.transport import make_codec
from repro_torch.launch import train

# the reference's choices of --sync-dtype, and its canonical names
SYNC = ["f32", "bf16", "int8", "fp8", "e5m2", "float32", "bfloat16",
        "fp8_e5m2"]
CANON = {"f32": "float32", "bf16": "bfloat16", "int8": "int8", "fp8": "fp8",
         "e5m2": "fp8_e5m2", "fp8_e5m2": "fp8_e5m2", "float32": "float32",
         "bfloat16": "bfloat16"}


@pytest.fixture
def calls(monkeypatch):
    seen = []
    monkeypatch.setattr(train, "run_pipeline",
                        lambda **kw: seen.append(kw) or {})
    return seen


def _delta_dtype(calls, argv):
    train.main(["--steps", "2", "--device", "cpu"] + argv)
    return calls.pop()["delta_dtype"]


def _reference_choices():
    """The choices of the reference's ``--sync-dtype``, read off its
    parser (its ``main`` builds it; ``run_pipeline`` is not reached)."""
    import argparse
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        for a in self._actions:
            if "--sync-dtype" in a.option_strings:
                seen["choices"] = list(a.choices)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = parse
    try:
        with pytest.raises(SystemExit):
            jax_train.main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen["choices"]


def test_sync_dtype_takes_the_references_choices():
    assert sorted(_reference_choices()) == sorted(SYNC)


@pytest.mark.parametrize("spelling", SYNC)
def test_sync_dtype_reaches_run_pipeline_as_delta_dtype(calls, spelling):
    """Each spelling reaches ``run_pipeline`` as the reference's canonical
    name, the same as the matching ``--delta-dtype``, and both build the
    same codec."""
    got = _delta_dtype(calls, ["--sync-dtype", spelling])
    assert got == CANON[spelling]
    assert got == _delta_dtype(calls, ["--delta-dtype", spelling])
    assert make_codec(got) == make_codec(spelling)


@pytest.mark.parametrize("sync,delta", [("int8", "float32"),
                                        ("f32", "int8"),
                                        ("e5m2", "bf16")])
def test_sync_dtype_overrides_delta_dtype(calls, sync, delta):
    got = _delta_dtype(calls, ["--delta-dtype", delta, "--sync-dtype", sync])
    assert got == CANON[sync]
    assert _delta_dtype(calls, ["--sync-dtype", sync, "--delta-dtype",
                                delta]) == CANON[sync]


def test_default_wire_is_float32(calls):
    assert _delta_dtype(calls, []) == "float32"


@pytest.mark.parametrize("flag", ["--sync-dtype", "--delta-dtype"])
def test_an_unknown_spelling_is_an_argparse_error(calls, flag, capsys):
    with pytest.raises(SystemExit) as e:
        train.main(["--steps", "2", flag, "int4"])
    assert e.value.code == 2
    assert "invalid choice: 'int4'" in capsys.readouterr().err
    assert not calls
