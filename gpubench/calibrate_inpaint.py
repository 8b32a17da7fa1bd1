"""The readings the ``inpaint`` entry's limits are set from, in one process:

    python3 -m gpubench.calibrate_inpaint --workload inpaint.layers-b4 \\
        --program-seeds 1 2 ... --control-seeds 101 102 103 [--requests N]

For each program seed: the port built from that seed, the traffic's
warm-up, ``N`` requests of the cell's own traffic in a closed loop, the
request a run of that seed would sample (the harness's reservoir), judged
against the plain fp32 reference.  For each control seed: the same request
through the control in the program's place (the reference with its models
rounded to fp8 and its solver carried in fp16, the precisions below the
configuration's bf16 models and fp32 solver), judged the same way.

On program seeds two planted faults are read too (``faults``): the
sampled request's noise prediction of one step times 1.01 in its recorded
state, step by step (``solver_gap``), and one more request with guidance
7 instead of 9 (``cfg_gap`` and ``eps_rel_l2``).

Prints one JSON line per seed (its readings; on program seeds also the
stage times of the last request, and ``cond_share``, the share of the
guided noise prediction that the prompt's conditioning makes: how much
``cfg_gap`` has to read) and a last line with, per number, the lower
reading (the largest of the program's), the upper reading (the smallest of
the control's) and the limit lower^(1/3) * upper^(2/3) where upper is at
least 3 * lower (null where it is not).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time

import torch

from gpubench.harness import Reservoir, sync
from gpubench.manifest import Manifest
from gpubench.traffic import Traffic


def sampled(seed: int, check_requests: int, requests: int) -> list:
    """The requests a run of ``seed`` samples among the first
    ``requests``."""
    pick = Reservoir(check_requests, seed)
    for r in range(requests):
        pick.offer(r)
    return pick.items


def program_readings(manifest, cell, seed, device, requests) -> dict:
    entry = manifest.entry(cell)
    traffic = Traffic(cell.traffic, seed)
    system = entry.build(cell, seed, device, traffic)
    for r in range(int(cell.traffic["warmup"])):
        entry.call(system, traffic.warmup(r))
    picks = set(sampled(seed, int(cell.traffic["check"]["requests"]),
                        requests))
    kept, seconds = [], []
    for r in range(requests):
        t0 = time.perf_counter()
        out = entry.call(system, traffic.request(r))
        seconds.append(time.perf_counter() - t0)
        if r in picks:
            kept.append((r, out))
    sync(device)
    stages = {**system.inpainter.stage_times, **system.pipe.stage_times}
    cfg = system.pipe.cfg
    system.pipe.cfg = dataclasses.replace(cfg, guidance_scale=7.0)
    r7 = kept[0][0]
    cfg7 = entry.call(system, traffic.request(r7))[0]
    system.pipe.cfg = cfg
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = {}
    for r, outs in kept:
        for out in outs:
            for k, v in entry.readings(cell.config, seed, r, out,
                                       device).items():
                got[k] = max(got.get(k, v), v)
    faults = {"cfg7": {k: v for k, v in entry.readings(
        cell.config, seed, r7, cfg7, device).items()
        if k in ("cfg_gap", "eps_rel_l2")}, "eps_x1.01": {}}
    r, (out,) = kept[0]
    rec = out["state"][0]
    for i in range(cell.config["num_steps"]):
        eps = list(rec["eps"])
        eps[i] = eps[i] * 1.01
        faulty = dict(out, state=[dict(rec, eps=eps)])
        faults["eps_x1.01"][i] = entry.solver_readings(
            cell.config, faulty["state"][0], len(out["inputs"]))[
                "solver_gap"]
    return {"readings": got, "faults": faults, "request_s": seconds,
            "stages_s": stages}


def control_readings(manifest, cell, seed, device, requests) -> dict:
    entry = manifest.entry(cell)
    traffic = Traffic(cell.traffic, seed)
    got = {}
    for r in sampled(seed, int(cell.traffic["check"]["requests"]),
                     requests):
        out = entry.control_output(cell.config, seed, traffic, r, device)
        for k, v in entry.readings(cell.config, seed, r, out,
                                   device).items():
            got[k] = max(got.get(k, v), v)
    return {"readings": got}


def limits(lower: dict, upper: dict) -> dict:
    """lower^(1/3) * upper^(2/3) where upper >= 3 * lower, else None."""
    out = {}
    for k in lower:
        lo, up = lower[k], upper.get(k)
        out[k] = (lo ** (1 / 3) * up ** (2 / 3)
                  if up is not None and up > 0 and up >= 3 * lo else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="inpaint.layers-b4")
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    manifest = Manifest()
    cell = manifest.cell(args.workload)
    if "host_threads" in cell.traffic:
        torch.set_num_threads(int(cell.traffic["host_threads"]))
    device = torch.device(args.device)
    lower, upper = {}, {}
    for kind, seeds, fn in (("program", args.program_seeds,
                             program_readings),
                            ("control", args.control_seeds,
                             control_readings)):
        for seed in seeds:
            t0 = time.perf_counter()
            got = fn(manifest, cell, seed, device, args.requests)
            print(json.dumps({"kind": kind, "seed": seed, **got,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            into, pick = (lower, max) if kind == "program" else (upper, min)
            for k, v in got["readings"].items():
                into[k] = pick(into.get(k, v), v)
    print(json.dumps({"lower": lower, "upper": upper,
                      "limits": limits(lower, upper)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
