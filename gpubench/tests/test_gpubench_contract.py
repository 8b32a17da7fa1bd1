"""The run's last line, its refusals, and the JAX check by whole top-level
names."""

import ast
import json
import os

import pytest
import torch

from gpubench import run
from gpubench.harness import run_cell
from gpubench.manifest import PKG_DIR


def test_last_line(tiny_cell, cpu):
    m, cell = tiny_cell
    res = run_cell(m, cell, 7, 3.0, False, cpu, 0.0)
    lines, last = run.finish(res, {"kind": "NVIDIA H100 80GB HBM3",
                                   "power_limit_w": "700.00 W"}, 1)
    out = json.loads(last)
    assert list(out)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == "NVIDIA H100 80GB HBM3"
    assert "memory_peak_bytes" in dev
    for name, metric in out["metrics"].items():
        assert set(metric) == {"value", "unit"}
        assert isinstance(metric["value"], float)
    assert len(lines) == len(out["checks"])
    for line, (name, c) in zip(lines, out["checks"].items()):
        assert line.startswith(f"check {name}: ") and "limit" in line
        assert set(c) == {"value", "limit"}


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "default.models-b4", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_too_few_cards(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "default.models-b4", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("modules,found", [
    ({"inklayer_tpu_torch", "inklayer_tpu_torch.ops", "numpy"}, []),
    ({"inklayer_tpu", "inklayer_tpu.models.sam"},
     ["inklayer_tpu", "inklayer_tpu.models.sam"]),
    ({"jax.numpy", "jaxtyping", "jaxlib"}, ["jax.numpy", "jaxlib"]),
    ({"flax.linen", "flaxy"}, ["flax.linen"]),
])
def test_forbidden_modules_whole_names(modules, found):
    assert run.forbidden_modules(modules) == found


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_harness_imports_no_jax():
    for path in _sources(PKG_DIR):
        for name in _imports(path):
            assert name.split(".")[0] not in run.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(PKG_DIR, "reference")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in run.FORBIDDEN + ("inklayer_tpu_torch",), \
                (path, name)
