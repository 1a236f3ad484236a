"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> \
        [--spec PATH]

From the root of a checkout, on a machine with the cards the cell asks
for.  Progress, clocks and power, the window's counts and each judged
chunk's gaps go to standard error; the last line of standard output is the
result, one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with --trace 1 its per-layer ones),
`device`, with --trace 1 `breakdown`, and last `check`, each number the
output check compared beside its limit.  Without the cards, or when a JAX
module is loaded once the window has closed, it exits non-zero and prints
no result.  `--spec` runs a cell of another spec than BENCHMARK.json, with
its configs/, mixes/ and limits/ beside that file (a fixture such as
benchmark/tests/evimo2/spec.json).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed paths inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
# One intra-op thread: the port's host path is Python and numpy, and idle
# OpenMP workers only take cores from it.
os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spec", default="")
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(f"[{time.perf_counter() - T_START:8.3f}] {msg}", file=sys.stderr, flush=True)

    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)

    from benchmark import harness

    spec_path = args.spec or os.path.join(ROOT, "BENCHMARK.json")
    spec = json.load(open(spec_path))
    row = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if row is None:
        log(f"no workload {args.workload!r} in {spec_path}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < row["chips"]:
        log(f"{args.workload} needs {row['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    cell = harness.load_cell(args.workload, args.spec)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start=T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"JAX modules loaded in the run: {found}")
        return 3
    res = out.result
    for name, c in res["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
