"""Threaded WSGI server for the editing interface (port of
:mod:`inklayer_tpu.serve.server`; stdlib only):

    python -m inklayer_tpu_torch.serve.server --port 5002 [--host 0.0.0.0]
        [--models_dir DIR] [--device cuda] [--micro_batch]

The pipeline is built at the first ``/segment-sketch`` request, from the
checkpoints under ``--models_dir`` (placeholders where a file is missing),
on the card unless ``--device cpu`` is given; without a card the build
raises.  Each request runs on its own thread; the pipeline runs one
request at a time unless ``--micro_batch`` is given, which runs up to 4 at
once and batches their SAM encodes.
"""

from __future__ import annotations

import argparse
from socketserver import ThreadingMixIn
from wsgiref.simple_server import WSGIServer, make_server


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="InkLayer editing interface on PyTorch/CUDA")
    parser.add_argument("--port", type=int, default=5002)
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--models_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--micro_batch", action="store_true",
        help="run up to 4 /segment-sketch requests at once and share their "
             "SAM encoder launches (default: one at a time)")
    args = parser.parse_args(argv)

    import torch

    from inklayer_tpu_torch.runtime import resolve_device
    from inklayer_tpu_torch.serve.app import InkLayerApp

    resolve_device(args.device)  # no card: fail now, not at first request

    def factory():
        from inklayer_tpu_torch.build import build_pipeline
        from inklayer_tpu_torch.config import PipelineConfig

        dtype = torch.bfloat16 if args.device.startswith("cuda") \
            else torch.float32
        return build_pipeline(PipelineConfig(), device=args.device,
                              dtype=dtype, models_dir=args.models_dir)

    app = InkLayerApp(pipeline_factory=factory, micro_batch=args.micro_batch)
    server = make_server(args.host, args.port, app,
                         server_class=ThreadingWSGIServer)
    print(f"inklayer serving on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
