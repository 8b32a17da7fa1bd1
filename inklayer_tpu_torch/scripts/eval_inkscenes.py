"""InkScenes benchmark CLI of the PyTorch/CUDA port (port of the JAX
package's ``scripts/eval_inkscenes.py``).

Runs the default run over a directory of InkScenes sketches (optional),
then scores ``masks_final`` against the dataset's ``.mat`` instance GT
(INSTANCE_GT label matrices, reference InkScenes/read_GT_mat_file.py) and
writes a JSON report with per-image and aggregate mIoU / AP / AR.

Usage:
  # score existing pipeline outputs
  python -m inklayer_tpu_torch.scripts.eval_inkscenes --outputs OUT \
      --gt_dir DATASET/GT

  # run the pipeline first (on the card unless --cpu), then score
  python -m inklayer_tpu_torch.scripts.eval_inkscenes \
      --sketch_dir DATASET/sketches --gt_dir DATASET/GT --outputs OUT

  # visualize one GT .mat file (read_GT_mat_file.py equivalent)
  python -m inklayer_tpu_torch.scripts.eval_inkscenes \
      --visualize DATASET/GT/scene.mat --out viz.png

The JAX CLI's flags, plus the port CLI's ``--config``, ``--models_dir``
and ``--cpu`` for the ``--sketch_dir`` run.
"""

import argparse
import glob
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--outputs", help="pipeline output base dir to score")
    ap.add_argument("--gt_dir", help="directory of {name}.mat instance GT")
    ap.add_argument("--sketch_dir",
                    help="run the pipeline over these sketches first")
    ap.add_argument("--report", default=None,
                    help="report JSON path (default: OUTPUTS/inkscenes_eval.json)")
    ap.add_argument("--visualize", help="render one GT .mat to --out and exit")
    ap.add_argument("--out", default="gt_viz.png")
    ap.add_argument("--no_intermediate", action="store_true", default=True)
    ap.add_argument("--config", default=None,
                    help="JSON PipelineConfig for the --sketch_dir run")
    ap.add_argument("--models_dir", default=None,
                    help="directory of reference checkpoints")
    ap.add_argument("--cpu", action="store_true",
                    help="run the --sketch_dir pipeline on the CPU")
    args = ap.parse_args(argv)

    from inklayer_tpu_torch.pipeline import eval as ev

    if args.visualize:
        ev.visualize_label_matrix(ev.load_instance_gt(args.visualize),
                                  out_path=args.out)
        print(f"wrote {args.out}")
        return None

    if not (args.outputs and args.gt_dir):
        ap.error("--outputs and --gt_dir are required (or use --visualize)")

    if args.sketch_dir:
        import torch

        from inklayer_tpu_torch.build import build_pipeline
        from inklayer_tpu_torch.config import PipelineConfig, load_config

        paths = sorted(glob.glob(os.path.join(args.sketch_dir, "*.png")) +
                       glob.glob(os.path.join(args.sketch_dir, "*.jpg")))
        if not paths:
            raise SystemExit(f"no sketches in {args.sketch_dir}")
        cfg = load_config(args.config) if args.config else PipelineConfig()
        device = "cpu" if args.cpu else "cuda"
        pipe = build_pipeline(
            cfg, device=device,
            dtype=torch.float32 if args.cpu else torch.bfloat16,
            models_dir=args.models_dir)
        pipe.run_dir(paths, args.outputs,
                     no_intermediate=args.no_intermediate)

    report_path = args.report or os.path.join(args.outputs,
                                              "inkscenes_eval.json")
    report = ev.evaluate_sweep(args.outputs, args.gt_dir,
                               report_path=report_path)
    print(json.dumps(report["aggregate"], indent=2))
    print(f"report: {report_path}")
    return report


if __name__ == "__main__":
    main()
