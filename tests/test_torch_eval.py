"""Port parity: evaluation — the MAT-file reader against scipy, the
InkScenes instance metrics and the COCO AP evaluator against the JAX
package's, ``evaluate_sweep`` and the eval CLI against the JAX CLI on the
same synthetic directory, and the CLI's ``--sketch_dir`` run on the CPU.

Tolerance: none; both packages run the same numpy arithmetic, so metrics
and reports must be equal, and ``loadmat`` must return scipy's arrays
(with ``mat_dtype=True``: each array in its MATLAB class) exactly.
"""

import importlib.util
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image
from scipy.io import loadmat as scipy_loadmat
from scipy.io import savemat

from inklayer_tpu.pipeline import coco_eval as JC
from inklayer_tpu.pipeline import eval as JE
from inklayer_tpu_torch.io.matfile import loadmat
from inklayer_tpu_torch.pipeline import coco_eval as TC
from inklayer_tpu_torch.pipeline import eval as TE
from inklayer_tpu_torch.scripts import eval_inkscenes as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _element(mtype: int, data: bytes, order: str) -> bytes:
    tag = struct.pack(order + "II", mtype, len(data))
    return tag + data + b"\0" * (-len(data) % 8)


def matlab_style_mat(path, name: str, arr: np.ndarray, mi_type: int,
                     mx_class: int, order: str = "<",
                     compressed: bool = False) -> None:
    """A level-5 file as MATLAB writes one: the array's class apart from
    its storage type (a ``double`` stored as ``miUINT8``), the name as a
    small element."""
    codes = {2: "u1", 4: "u2", 9: "f8"}
    dt = np.dtype(codes[mi_type]).newbyteorder(order)
    body = _element(6, struct.pack(order + "II", mx_class, 0), order)
    body += _element(5, struct.pack(order + f"{arr.ndim}i", *arr.shape),
                     order)
    raw = name.encode()
    assert len(raw) <= 4
    body += struct.pack(order + "I", len(raw) << 16 | 1) + raw.ljust(4, b"\0")
    body += _element(mi_type, arr.astype(dt).tobytes(order="F"), order)
    matrix = struct.pack(order + "II", 14, len(body)) + body
    if compressed:
        z = zlib.compress(matrix)
        matrix = struct.pack(order + "II", 15, len(z)) + z
    head = b"MATLAB 5.0 MAT-file, written by a test".ljust(116, b" ")
    head += b"\0" * 8 + struct.pack(order + "H", 0x0100)
    head += b"IM" if order == "<" else b"MI"
    with open(path, "wb") as f:
        f.write(head + matrix)


# ---------------------------------------------------------------------------
# loadmat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compressed", [False, True])
def test_loadmat_matches_scipy(tmp_path, rng, compressed):
    data = {"INSTANCE_GT": rng.integers(0, 7, (13, 17)).astype(np.uint8),
            "u16": rng.integers(0, 60000, (5, 9)).astype(np.uint16),
            "dbl": rng.standard_normal((4, 6)),
            "i32": rng.integers(-5, 5, (3, 3)).astype(np.int32),
            "f32": rng.standard_normal((2, 7)).astype(np.float32),
            "logical": rng.random((3, 4)) > 0.5,
            "row": np.arange(5.0),
            "cube": rng.integers(0, 9, (2, 3, 4)).astype(np.int16),
            "text": "skipped", "cell": np.array([1, "a"], dtype=object)}
    path = str(tmp_path / "gt.mat")
    savemat(path, data, do_compression=compressed)
    got = loadmat(path)
    want = scipy_loadmat(path, mat_dtype=True)
    assert sorted(got) == sorted(k for k in data if k not in ("text", "cell"))
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("compressed", [False, True])
def test_loadmat_reads_matlab_style_storage(tmp_path, rng, order,
                                           compressed):
    lm = rng.integers(0, 5, (11, 14)).astype(np.uint8)
    path = str(tmp_path / "m.mat")
    matlab_style_mat(path, "GT", lm, mi_type=2, mx_class=6, order=order,
                     compressed=compressed)
    got = loadmat(path)["GT"]
    assert got.dtype == np.float64  # the double class, stored as uint8
    np.testing.assert_array_equal(got, lm)
    np.testing.assert_array_equal(
        got, scipy_loadmat(path, mat_dtype=True)["GT"])


def test_loadmat_refuses_v73_and_other_files(tmp_path):
    head = b"MATLAB 7.3 MAT-file".ljust(116, b" ") + b"\0" * 8
    v73 = tmp_path / "v73.mat"
    v73.write_bytes(head + struct.pack("<H", 0x0200) + b"IM" + b"\0" * 64)
    with pytest.raises(NotImplementedError, match="v7.3"):
        loadmat(str(v73))
    with pytest.raises(NotImplementedError):
        scipy_loadmat(str(v73))
    other = tmp_path / "x.mat"
    other.write_bytes(b"\0" * 200)
    with pytest.raises(ValueError, match="level-5"):
        loadmat(str(other))


# ---------------------------------------------------------------------------
# the metrics
# ---------------------------------------------------------------------------


def _masks(rng, n, hw=(24, 30)):
    out = []
    for _ in range(n):
        m = np.zeros(hw, bool)
        y, x = rng.integers(0, hw[0] - 6), rng.integers(0, hw[1] - 6)
        m[y:y + rng.integers(3, 10), x:x + rng.integers(3, 12)] = True
        out.append(m)
    return out


def test_instance_metrics_match_jax(rng):
    lm = rng.integers(0, 6, (24, 30))
    gt = TE.labels_to_masks(lm)
    for a, b in zip(gt, JE.labels_to_masks(lm)):
        np.testing.assert_array_equal(a, b)
    pred = _masks(rng, 7) + gt[:2]
    np.testing.assert_array_equal(TE.mask_iou_matrix(pred, gt),
                                  JE.mask_iou_matrix(pred, gt))
    iou = JE.mask_iou_matrix(pred, gt)
    assert TE.greedy_match(iou) == JE.greedy_match(iou)
    for p, g in ((pred, gt), ([], gt), (pred, [])):
        assert TE.instance_metrics(p, g) == JE.instance_metrics(p, g)
    np.testing.assert_array_equal(TE.visualize_label_matrix(lm),
                                  JE.visualize_label_matrix(lm))


@pytest.mark.parametrize("use_masks", [False, True])
def test_coco_eval_matches_jax(rng, use_masks):
    preds, gts = [], []
    for n_pred, n_gt in ((5, 3), (0, 2), (4, 0), (6, 6)):
        gb = rng.random((n_gt, 2)) * 50
        gts.append({"boxes": np.concatenate(
            [gb, gb + rng.random((n_gt, 2)) * 30 + 5], 1),
            "masks": _masks(rng, n_gt)})
        pb = rng.random((n_pred, 2)) * 50
        preds.append({"boxes": np.concatenate(
            [pb, pb + rng.random((n_pred, 2)) * 30 + 5], 1),
            "scores": rng.random(n_pred), "masks": _masks(rng, n_pred)})
    preds[3]["boxes"][:3] = gts[3]["boxes"][:3] + 1.0  # some hits
    preds[3]["masks"][:3] = gts[3]["masks"][:3]
    want = JC.evaluate_detections(preds, gts, use_masks=use_masks)
    got = TC.evaluate_detections(preds, gts, use_masks=use_masks)
    assert got == want
    assert 0.0 < got["AP50"] <= 1.0


# ---------------------------------------------------------------------------
# evaluate_sweep and the CLI
# ---------------------------------------------------------------------------


def _sweep_dir(tmp_path, rng):
    """outputs/{a,b,c}/masks_final/mask_*.png; GT .mat for a and b (and a
    GT with no outputs)."""
    out, gt = tmp_path / "outputs", tmp_path / "gt"
    gt.mkdir()
    for name, n in (("a", 3), ("b", 11), ("c", 2)):
        d = out / name / "masks_final"
        d.mkdir(parents=True)
        for i, m in enumerate(_masks(rng, n)):  # 11: mask_10 after mask_9
            Image.fromarray(m.astype(np.uint8) * 255).save(d / f"mask_{i}.png")
    for name in ("a", "b", "z"):
        lm = rng.integers(0, 4, (24, 30)).astype(np.uint8)
        savemat(str(gt / f"{name}.mat"), {"INSTANCE_GT": lm})
    (out / "stray.txt").write_text("not an output dir")
    return str(out), str(gt)


def test_evaluate_sweep_matches_jax(tmp_path, rng):
    out, gt = _sweep_dir(tmp_path, rng)
    got = TE.evaluate_sweep(out, gt, str(tmp_path / "port.json"))
    want = JE.evaluate_sweep(out, gt, str(tmp_path / "jax.json"))
    assert got == want and sorted(got["images"]) == ["a", "b"]
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()


def _jax_cli(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_eval_inkscenes", os.path.join(REPO, "scripts",
                                           "eval_inkscenes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["eval_inkscenes.py", *argv])
    mod.main()


def test_eval_cli_scores_as_the_jax_cli(tmp_path, rng, monkeypatch, capsys):
    out, gt = _sweep_dir(tmp_path, rng)
    cli.main(["--outputs", out, "--gt_dir", gt, "--report",
              str(tmp_path / "port.json")])
    port_out = capsys.readouterr().out
    _jax_cli(["--outputs", out, "--gt_dir", gt, "--report",
              str(tmp_path / "jax.json")], monkeypatch)
    jax_out = capsys.readouterr().out
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert port_out.split("report:")[0] == jax_out.split("report:")[0]
    # default report path
    cli.main(["--outputs", out, "--gt_dir", gt])
    assert os.path.exists(os.path.join(out, "inkscenes_eval.json"))
    with pytest.raises(SystemExit):
        cli.main(["--outputs", out])


def test_eval_cli_visualize_matches_the_jax_cli(tmp_path, rng, monkeypatch):
    lm = rng.integers(0, 5, (20, 26)).astype(np.uint8)
    mat = str(tmp_path / "scene.mat")
    savemat(mat, {"INSTANCE_GT": lm})
    cli.main(["--visualize", mat, "--out", str(tmp_path / "port.png")])
    _jax_cli(["--visualize", mat, "--out", str(tmp_path / "jax.png")],
             monkeypatch)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))


def test_eval_cli_runs_the_sketch_dir_on_the_cpu(tmp_path):
    from inklayer_tpu.config import save_config
    from tests.test_pipeline import TINY_PIPE

    cfg = str(tmp_path / "tiny.json")
    save_config(TINY_PIPE, cfg)
    sketches, gt = tmp_path / "sketches", tmp_path / "gt"
    sketches.mkdir()
    gt.mkdir()
    for i in range(2):
        g = np.full((96, 96, 3), 255, np.uint8)
        g[10 + 8 * i:40, 10:12] = 0
        g[10:40, 38 + 8 * i:40 + 8 * i] = 0
        g[60:80, 50:90] = 0
        Image.fromarray(g).save(sketches / f"s{i}.png")
        lm = np.zeros((96, 96), np.uint8)
        lm[10:40, 10:40] = 1
        lm[60:80, 50:90] = 2
        savemat(str(gt / f"s{i}.mat"), {"INSTANCE_GT": lm})
    out = str(tmp_path / "out")
    report = cli.main(["--sketch_dir", str(sketches), "--gt_dir", str(gt),
                       "--outputs", out, "--config", cfg, "--cpu"])
    assert sorted(report["images"]) == ["s0", "s1"]
    for name in ("s0", "s1"):
        assert report["images"][name]["n_gt"] == 2.0
        assert os.path.isdir(os.path.join(out, name, "masks_final"))
    with open(os.path.join(out, "inkscenes_eval.json")) as f:
        assert json.load(f) == report
