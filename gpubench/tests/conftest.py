"""Fixtures of the harness's tests: a tiny configuration and cell on the
CPU (the port's plain versions), run through the harness as the card
would run a cell."""

import os
import shutil

import pytest
import torch

from gpubench.manifest import Cell, Manifest, PKG_DIR, load_json

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads a test: the tests' windows are seconds long,
    and several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_cell():
    """A Cell at the tiny widths, over the real manifest's metrics."""
    m = Manifest()
    cfg = load_json(os.path.join(DATA, "tiny.json"))
    traffic = load_json(os.path.join(DATA, "tiny.models-b2.json"))
    entry = {"name": "inklayer-default", "file": "tiny.json"}
    return m, Cell(name="tiny.models-b2", chips=1, config=cfg,
                   config_entry=entry, traffic=traffic,
                   end_to_end=[e for e in m.data["end_to_end"]],
                   per_layer=[])


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def bench_copy(tmp_path):
    """A checkout holding a copy of the harness and BENCHMARK.json."""
    shutil.copytree(PKG_DIR, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(PKG_DIR), "BENCHMARK.json"),
                tmp_path / "BENCHMARK.json")
    return tmp_path


@pytest.fixture
def card():
    """The CUDA card, for the tests marked ``gpu``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
