#!/usr/bin/env python
"""Hold the butterfly merge against the flat merge, and the card against
the CPU, on a small golden-derived voting workload.

Port of scripts/bf_divergence_probe.py on dvs_mcemvs_torch: the same
workload (the first 131,072 events of each camera of the FULL golden
fixture) is voted by process_1 under the butterfly spec and the flat-merge
spec, on the card and on the CPU (the kernels' plain versions), in one
process.  It prints, for each spec, the card-against-CPU relative L1 and
argmax agreement of camera 0's DSI, and for each device the butterfly
against the flat merge.  `--device cpu` runs the CPU alone.  `--out
PATH.npz` dumps the DSIs; `--compare A.npz B.npz` compares two dumps as the
JAX script does.

Without a card the default `--device cuda` raises.

Usage:
  python scripts/bf_divergence_probe_torch.py [--out dsis.npz] [--device cuda|cpu]
  python scripts/bf_divergence_probe_torch.py --compare a.npz b.npz
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dvs_mcemvs_torch import pipeline  # noqa: E402
from dvs_mcemvs_torch.device import require_cuda  # noqa: E402
from dvs_mcemvs_torch.utils import golden  # noqa: E402

N_EV = 131072
SPECS = {"bf": "hist:g8,seg16,bf,pl", "flat": "hist:g8,seg16,pl"}


def run(device, cfg_name: str = "FULL", n_events: int = N_EV) -> dict:
    """{tag: camera 0's DSI as float32 numpy} for each spec of SPECS."""
    cfg = getattr(golden, cfg_name)
    mappers, events, trajs, _, ts_rv = golden.build_golden_fixture(cfg, device=device)
    events = [e.slice(0, n_events) for e in events]
    out = {}
    for tag, spec in SPECS.items():
        vopts = pipeline.VotingOptions(packet_size=1024, backend=spec, pad_policy="bucket")
        res = pipeline.process_1(mappers, events, trajs, ts_rv, stereo_fusion=2, vopts=vopts)
        out[tag] = res.dsis["camera0"].cpu().numpy().astype(np.float32)
    return out


def rel_l1(x: np.ndarray, y: np.ndarray) -> float:
    """sum |x - y| / sum y, in float64."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    return float(np.abs(x - y).sum() / max(y.sum(), 1e-9))


def argmax_agree(x: np.ndarray, y: np.ndarray) -> float:
    return float((x.argmax(0) == y.argmax(0)).mean())


def compare_runs(a: dict, b: dict, names=("A", "B")) -> dict:
    """Per spec, A against B; per run, butterfly against flat.  Prints each
    line and returns {"<tag>": rel_l1 A-vs-B, "bf_vs_flat_<name>": ...}."""
    out = {}
    for tag in SPECS:
        out[tag] = rel_l1(a[tag], b[tag])
        print(f"{tag:5s}: {names[0]}-vs-{names[1]} rel-L1 {out[tag]:.3e}  argmax agree "
              f"{argmax_agree(a[tag], b[tag]):.4f}  mass {names[0]} {a[tag].sum():.1f} "
              f"{names[1]} {b[tag].sum():.1f}", flush=True)
    for name, src in zip(names, (a, b)):
        out[f"bf_vs_flat_{name}"] = rel_l1(src["bf"], src["flat"])
        print(f"{name}: bf-vs-flat rel-L1 {out[f'bf_vs_flat_{name}']:.3e}  argmax agree "
              f"{argmax_agree(src['bf'], src['flat']):.4f}", flush=True)
    d = np.abs(a["bf"].astype(np.float64) - b["bf"].astype(np.float64)).sum(axis=(1, 2))
    print("bf delta planes (top |mass|):",
          [(int(i), round(float(d[i]), 1)) for i in np.argsort(d)[-6:][::-1]], flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the card and the CPU; cpu: the CPU alone")
    ap.add_argument("--cfg", default="FULL", choices=("FULL", "BENCH16", "SMALL"),
                    help="golden fixture profile (utils.golden)")
    ap.add_argument("--n_events", type=int, default=N_EV, help="events kept a camera")
    ap.add_argument("--out", default="", help="dump the DSIs to this .npz")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two dumps instead of running")
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (np.load(p) for p in args.compare)
        compare_runs(a, b, (str(a["device"]), str(b["device"])))
        return 0
    runs = {}
    if args.device == "cuda":
        runs["cuda"] = run(require_cuda(), args.cfg, args.n_events)
    runs["cpu"] = run(torch.device("cpu"), args.cfg, args.n_events)
    for name, dsis in runs.items():
        for tag in SPECS:
            print(f"{name} {tag}: mass={dsis[tag].sum():.1f}", flush=True)
    if "cuda" in runs:
        compare_runs(runs["cuda"], runs["cpu"], ("cuda", "cpu"))
    else:
        print(f"cpu: bf-vs-flat rel-L1 {rel_l1(runs['cpu']['bf'], runs['cpu']['flat']):.3e}",
              flush=True)
    if args.out:
        name = next(iter(runs))
        np.savez_compressed(args.out, device=name, **runs[name])
    return 0


if __name__ == "__main__":
    sys.exit(main())
