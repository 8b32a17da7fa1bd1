"""The port imports no jax or flax, nothing of the JAX package, no scipy
and no cv2 (the card's machine has neither): every module of
inklayer_tpu_torch imports in a fresh interpreter where jax, flax, scipy
and cv2 are blocked, and no inklayer_tpu module is loaded after it."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["scipy"] = None
sys.modules["cv2"] = None
import inklayer_tpu_torch
names = ["inklayer_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(inklayer_tpu_torch.__path__,
                                          "inklayer_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "jaxlib", "inklayer_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print(len(names))
"""


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 85  # every module was walked


def test_chip_smoke_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    code = ("import sys; sys.modules['jax'] = None; sys.modules['flax'] = None;"
            " sys.modules['scipy'] = None; sys.modules['cv2'] = None;"
            " sys.modules['inklayer_tpu'] = None; import chip_smoke;"
            " import inklayer_tpu_torch.build, inklayer_tpu_torch.main,"
            " inklayer_tpu_torch.models.diffusion,"
            " inklayer_tpu_torch.pipeline.inpaint.orchestrate,"
            " inklayer_tpu_torch.scripts.train,"
            " inklayer_tpu_torch.scripts.eval_inkscenes,"
            " inklayer_tpu_torch.pipeline.augment,"
            " inklayer_tpu_torch.io.export;"
            " sys.path.insert(0, 'scripts'); import torch_conv_ab")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
