"""Port parity: the inpainting slice as a whole, on the CPU.

* ``Inpainter.run_on_sketch_dir`` in both packages on one sketch directory
  whose ``masks_final/`` holds three overlapping depth-ordered masks
  (layers 1 and 2 need inpainting, so the batched backend runs), with the
  TINY diffusion pipelines of tests/test_torch_inpaint.py sharing params
  and noise: the same file tree, the layer images equal up to
  MAX_OFF_SHARE of pixels more than one grey level apart.  (The fp32
  pipelines agree to ~1e-6; the uint8 cast, the adaptive threshold and
  the unsharp mask turn a rare 1-level difference at a threshold into a
  larger one at single pixels: measured share 0 on this directory.)
* ``python -m inklayer_tpu_torch.main --img ... --inpaint --device cpu``
  at TINY configs writes ``complete_layers*`` beside the 12 outputs, and
  with ``--no_intermediate`` leaves exactly the keep-list.
* ``build_inpainter`` builds its models on first use, with GroupNorm
  scales 1, and refuses a CUDA device without a card.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

from inklayer_tpu.io.outputs import KEEP_LIST
from inklayer_tpu.pipeline.inpaint import orchestrate as JO
from inklayer_tpu_torch.pipeline.inpaint import orchestrate as TO
from tests.test_diffusion import TINY
from tests.test_torch_inpaint import layered_masks, multi_shape_sketch, pipelines

MAX_OFF_SHARE = 1e-3


def write_sketch_dir(path, rng):
    os.makedirs(os.path.join(path, "masks_final"))
    g = multi_shape_sketch(rng)
    Image.fromarray(np.repeat(g[..., None], 3, axis=2)).save(
        os.path.join(path, "input.png"))
    for i, m in enumerate(layered_masks()):
        Image.fromarray(m.astype(np.uint8) * 255).save(
            os.path.join(path, "masks_final", f"mask_{i}.png"))
    return str(path)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.fixture(scope="module")
def slice_dirs(tmp_path_factory):
    jax_pipe, port = pipelines()
    out = {}
    for name, pipe, mod in (("jax", jax_pipe, JO), ("torch", port, TO)):
        d = write_sketch_dir(tmp_path_factory.mktemp(name),
                             np.random.default_rng(0))
        calls = []
        batch_fn = pipe.inpaint_batch_fn()
        ink = mod.Inpainter(pipe.inpaint_fn(),
                            inpaint_batch_func=lambda p: (calls.append(len(p)),
                                                          batch_fn(p))[1])
        ink.run_on_sketch_dir(d)
        out[name] = (d, calls)
    return out


def test_run_on_sketch_dir_batches_two_layers(slice_dirs):
    assert slice_dirs["jax"][1] == slice_dirs["torch"][1] == [2]


def test_run_on_sketch_dir_writes_the_same_tree(slice_dirs):
    jax_tree, port_tree = (_tree(slice_dirs[k][0]) for k in ("jax", "torch"))
    assert port_tree == jax_tree
    for i in (1, 2):
        for f in ("sketch_layer", "debug_vis", "edit_mask", "inpainted_image",
                  "final_composited"):
            assert f"complete_layers_process/mask_{i}/{f}.png" in port_tree
    assert "complete_layers_rgba/layer_2.png" in port_tree


def test_run_on_sketch_dir_images_match_jax(slice_dirs):
    root_j, root_t = slice_dirs["jax"][0], slice_dirs["torch"][0]
    for rel in _tree(root_t):
        if not rel.endswith(".png"):
            continue
        got = np.asarray(Image.open(os.path.join(root_t, rel)), int)
        want = np.asarray(Image.open(os.path.join(root_j, rel)), int)
        assert got.shape == want.shape, rel
        if rel.startswith(("input.png", "masks_final")) or \
                rel.endswith(("sketch_layer.png", "debug_vis.png",
                              "edit_mask.png")):
            np.testing.assert_array_equal(got, want, err_msg=rel)
        else:
            assert (np.abs(got - want) > 1).mean() <= MAX_OFF_SHARE, rel


TINY_DIFFUSION = dataclasses.replace(TINY, num_steps=2)


def _tiny_config(tmp_path):
    from inklayer_tpu.config import save_config
    from tests.test_pipeline import TINY_PIPE

    path = str(tmp_path / "tiny.json")
    save_config(dataclasses.replace(TINY_PIPE, diffusion=TINY_DIFFUSION), path)
    return path


def test_cli_inpaint_writes_the_complete_layers(tmp_path):
    from inklayer_tpu_torch.main import main
    from tests.test_self_golden import _sketch
    from tests.test_torch_pipeline import PORT_OUTPUTS

    cfg_path, sketch = _tiny_config(tmp_path), _sketch(tmp_path)
    main(["--img", sketch, "--out_dir", str(tmp_path / "out"), "--config",
          cfg_path, "--device", "cpu", "--inpaint"])
    out = tmp_path / "out" / "golden_sketch"
    layers = ["complete_layers", "complete_layers_process",
              "complete_layers_rgba"]
    assert sorted(os.listdir(out)) == sorted(PORT_OUTPUTS + layers)
    n_final = len(os.listdir(out / "masks_final"))
    assert len(os.listdir(out / "complete_layers")) == n_final > 0
    assert sorted(os.listdir(out / "complete_layers_rgba")) == \
        sorted(os.listdir(out / "complete_layers"))
    rgba = np.asarray(Image.open(out / "complete_layers_rgba" / "layer_0.png"))
    assert rgba.shape[-1] == 4
    main(["--img", sketch, "--out_dir", str(tmp_path / "ni"), "--config",
          cfg_path, "--device", "cpu", "--inpaint", "--no_intermediate"])
    assert sorted(os.listdir(tmp_path / "ni" / "golden_sketch")) == sorted(
        set(KEEP_LIST) & set(PORT_OUTPUTS + layers))


def test_build_inpainter_builds_on_first_use(monkeypatch):
    from inklayer_tpu_torch import build
    from inklayer_tpu_torch.config import PipelineConfig

    built = []
    real = build.build_diffusion_models
    monkeypatch.setattr(build, "build_diffusion_models",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    cfg = PipelineConfig(diffusion=TINY_DIFFUSION)
    ink = build.build_inpainter(cfg, device="cpu", dtype=torch.float32)
    assert built == []
    pipe = ink.get_pipeline()
    assert ink.get_pipeline() is pipe and built == [1]
    norms = [m for m in pipe.unet.modules()
             if isinstance(m, torch.nn.GroupNorm)]
    assert norms and all(bool((m.weight == 1).all()) for m in norms)
    assert pipe.device.type == "cpu" and pipe.dtype == torch.float32


def test_build_inpainter_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from inklayer_tpu_torch.build import build_inpainter
    from inklayer_tpu_torch.config import PipelineConfig

    with pytest.raises(RuntimeError):
        build_inpainter(PipelineConfig(diffusion=TINY_DIFFUSION),
                        device="cuda")
