"""A cell run on the card (marked ``gpu``; skips without one):
``python -m pytest gpubench/tests -m gpu`` on a machine with an H100."""

import json

import pytest

from gpubench import run


@pytest.mark.gpu
def test_cell_on_the_card(card, capsys):
    rc = run.main(["--workload", "default.models-b4", "--seed", "2147483999",
                   "--seconds", "3", "--trace", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0 and out["metrics"]
