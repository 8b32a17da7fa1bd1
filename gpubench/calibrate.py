"""The readings that a cell's limits are set from, in one process:

    python3 -m gpubench.calibrate --workload <cell> --program-seeds 1 2 ...
        --control-seeds 101 102 103 [--requests N]

For each program seed: the port built from that seed, the traffic's
warm-up, ``N`` requests of the cell's own traffic (its batch, sizes and
boxes) in a closed loop, the entry's ``follow`` on the seeded sample of
them (as a run draws it), the sample judged against the plain fp32
reference.  For each control seed: the same sample through the reference
rounded to fp8 (:mod:`gpubench.reference.lowp`) put in the program's place,
judged the same way.  Prints one JSON line per seed and a last line with,
per number, the lower reading (the largest of the program's) and the upper
reading (the smallest of the control's).

Besides the numbers a run compares, each line holds readings that only
the choice of a limit needs (:func:`extra_readings`): the mask number at
other margins, how many of the proposals decoded lie outside the
reference's own two-stage top-K, and, on program seeds, the same share
for two witnesses of its cause: the reference's proposal scores rounded to
bf16, and the reference with its activations rounded to bf16.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from gpubench.harness import Reservoir, sync
from gpubench.manifest import Manifest
from gpubench.traffic import Traffic

MARGINS = (0.125, 0.25, 0.5, 1.0, 2.0, 4.0)


def sample_requests(manifest, cell, seed: int, device, requests: int):
    """The program's sampled requests [(r, outputs)] for ``seed``, followed
    as a run follows them."""
    entry = manifest.entry(cell)
    traffic = Traffic(cell.traffic, seed)
    system = entry.build(cell, seed, device, traffic)
    for r in range(int(cell.traffic["warmup"])):
        entry.call(system, traffic.warmup(r))
    sample = Reservoir(int(cell.traffic["check"]["requests"]), seed)
    for r in range(requests):
        sample.offer((r, entry.call(system, traffic.request(r))))
    sync(device)
    entry.follow(system, sample.items, traffic)
    del system
    gc.collect()
    torch.cuda.empty_cache() if device.type == "cuda" else None
    return traffic, sample.items


def select_miss(select, enc_scores: np.ndarray, nq: int) -> int:
    """How many of the proposals ``select`` lie outside the top ``nq`` of
    ``enc_scores``."""
    own = np.argsort(-enc_scores.astype(np.float64), kind="stable")[:nq]
    return len(np.setdiff1d(select, own))


def extra_readings(entry, cell, outs, refs) -> dict:
    """Readings a limit's choice needs and no run compares."""
    nq = cell.config["models"]["gdino"]["num_queries"]
    got = {f"mask_sure_share.m{m:g}": entry.mask_sure_share(outs, refs, m)
           for m in MARGINS}
    miss = sum(select_miss(o["select"], r["enc_scores"], nq)
               for o, r in zip(outs, refs) if o.get("select") is not None)
    got["det_select_miss"] = miss / (nq * len(outs))
    got["det_rerun_gap"] = max(o.get("rerun_gap", 0.0) for o in outs)
    return got


def witness_readings(entry, cell, seed, sketches, device) -> dict:
    """The two-stage miss share of two witnesses on the program's sampled
    sketches: the fp32 reference's proposal scores rounded to bf16 (ties
    broken by index), and the reference with weights and activations
    rounded to bf16 (:func:`gpubench.reference.lowp.bf16_activations_`)
    against the fp32 reference."""
    from gpubench.reference.lowp import bf16_activations_

    nq = cell.config["models"]["gdino"]["num_queries"]
    ref = entry.reference_outputs(cell.config, seed,
                                  [(s, None) for s in sketches], device,
                                  names=("gdino",))
    low = entry.reference_outputs(cell.config, seed,
                                  [(s, None) for s in sketches], device,
                                  quantize=bf16_activations_,
                                  names=("gdino",))
    rounded = sum(select_miss(
        np.argsort(-torch.from_numpy(r["enc_scores"]).bfloat16().float()
                   .numpy(), kind="stable")[:nq], r["enc_scores"], nq)
        for r in ref)
    bf16 = sum(select_miss(w["select"], r["enc_scores"], nq)
               for w, r in zip(low, ref))
    n = nq * len(sketches)
    return {"witness_scores_bf16_miss": rounded / n,
            "witness_reference_bf16_miss": bf16 / n}


def program_readings(manifest, cell, seed, device, requests) -> dict:
    entry = manifest.entry(cell)
    traffic, samples = sample_requests(manifest, cell, seed, device,
                                       requests)
    outs, refs = entry.compare(cell, seed, samples, traffic, device)
    got = {**entry.readings(cell, outs, refs),
           **extra_readings(entry, cell, outs, refs)}
    del outs, refs
    sketches = [s for r, _ in samples for s in traffic.request(r)]
    return {**got, **witness_readings(entry, cell, seed, sketches, device)}


def control_readings(manifest, cell, seed, device, requests) -> dict:
    """The control on the requests a run of ``seed`` would sample."""
    entry = manifest.entry(cell)
    pick = Reservoir(int(cell.traffic["check"]["requests"]), seed)
    for r in range(requests):
        pick.offer(r)
    outs, refs = entry.control_outputs(cell, seed,
                                       Traffic(cell.traffic, seed),
                                       pick.items, device)
    return {**entry.readings(cell, outs, refs),
            **extra_readings(entry, cell, outs, refs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    manifest = Manifest()
    cell = manifest.cell(args.workload)
    device = torch.device(args.device)
    lower, upper = {}, {}
    for kind, seeds, fn in (("program", args.program_seeds,
                             program_readings),
                            ("control", args.control_seeds,
                             control_readings)):
        for seed in seeds:
            t0 = time.perf_counter()
            got = fn(manifest, cell, seed, device, args.requests)
            print(json.dumps({"kind": kind, "seed": seed, "readings": got,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            into, pick = (lower, max) if kind == "program" else (upper, min)
            for k, v in got.items():
                into[k] = pick(into.get(k, v), v)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
