"""Readings that the output check's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds S1,S2,... \
        [--control-seeds N] [--faults stale,half,...] [--fault-seeds N] \
        [--seconds 2] [--out PATH]

For each seed, one run of the cell (a short window at the cell's own load,
its chunks judged as a benchmark run judges them) gives the program's
numbers.  On the first `--control-seeds` seeds the control is read too: the
reference computed with its DSIs in bfloat16, the nearest precision below
the preset's float32, put in the program's place on the same judged chunks.
Each fault of `faults.py` is planted in `--fault-seeds` further runs.  Every
row (kind, seed, worst numbers over the judged chunks, the run's verdict) is
printed as a JSON line and appended to `--out`.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
sys.path.insert(0, ROOT)


def control_rows(outcome, device) -> list:
    """The control's numbers on each judged chunk of `outcome`."""
    import torch

    from benchmark import harness, judge

    rows = []
    for rec, ref in zip(outcome.judged, outcome.refs):
        ctl = outcome.reference.outputs(rec.k, device, dtype=torch.bfloat16)
        rows.append(judge.numbers(harness.as_program(ctl), ref, outcome.reference.depths))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    from benchmark import faults, harness, judge

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    def emit(row):
        row = dict(row, workload=args.workload)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    def one(seed, kind, keep):
        t0 = time.perf_counter()
        out = harness.run(cell, seed, args.seconds, False, device, log=lambda m: None,
                          keep_refs=keep)
        emit({"kind": kind, "seed": seed, "correct": out.result["correct"],
              "worst": judge.worst(out.rows), "metrics": out.result["metrics"],
              "seconds": time.perf_counter() - t0})
        return out

    for i, seed in enumerate(seeds):
        out = one(seed, "program", i < args.control_seeds)
        if i < args.control_seeds:
            rows = control_rows(out, device)
            emit({"kind": "control", "seed": seed, "worst": judge.worst(rows),
                  "correct": judge.verdict(judge.worst(rows), cell.limits)})
        del out
    fault_seeds = [s + 1_000_003 for s in seeds[:args.fault_seeds]]
    for name in filter(None, args.faults.split(",")):
        for seed in fault_seeds:
            with faults.planted(name):
                one(seed, f"fault:{name}", False)
    log("calibrate: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
