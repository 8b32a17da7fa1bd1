"""The port's config sections mirror the JAX package's: same fields and
defaults, and a JSON file written by the JAX ``save_config`` loads into
the port's ``PipelineConfig``."""

import dataclasses

import pytest

from inklayer_tpu import config as J
from inklayer_tpu_torch import config as T
from tests.test_pipeline import TINY_PIPE


@pytest.mark.parametrize("name", ["SwinConfig", "BertConfig", "GDinoConfig",
                                  "SamConfig", "DepthConfig", "RefineConfig",
                                  "DiffusionConfig"])
def test_sections_match_jax_defaults(name):
    assert dataclasses.asdict(getattr(T, name)()) == \
        dataclasses.asdict(getattr(J, name)())


def test_jax_saved_json_loads_into_the_port(tmp_path):
    path = str(tmp_path / "tiny.json")
    J.save_config(TINY_PIPE, path)
    cfg = T.load_config(path)
    assert isinstance(cfg, T.PipelineConfig)
    assert isinstance(cfg.gdino.swin, T.SwinConfig)
    assert dataclasses.asdict(cfg.gdino) == dataclasses.asdict(TINY_PIPE.gdino)
    assert dataclasses.asdict(cfg.sam) == dataclasses.asdict(TINY_PIPE.sam)
    assert dataclasses.asdict(cfg.depth) == dataclasses.asdict(TINY_PIPE.depth)
    assert dataclasses.asdict(cfg.refine) == \
        dataclasses.asdict(TINY_PIPE.refine)


def test_jax_saved_diffusion_section_loads_into_the_port(tmp_path):
    from tests.test_diffusion import TINY

    path = str(tmp_path / "tiny.json")
    J.save_config(dataclasses.replace(TINY_PIPE, diffusion=TINY,
                                      inpaint=True), path)
    cfg = T.load_config(path)
    assert isinstance(cfg.diffusion, T.DiffusionConfig)
    assert dataclasses.asdict(cfg.diffusion) == dataclasses.asdict(TINY)
