#!/usr/bin/env python
"""Score golden-fixture accuracy of backend spec variants on the card.

Port of scripts/golden_device_probe.py on dvs_mcemvs_torch: runs process_1
and the depth-map extraction of a golden fixture (BENCH16 by default) under
each spec and scores it against the fixture's committed exact-scatter
anchor through `utils.golden.score`: the share of the anchor's confident
pixels within 1 and 2 planes, the median plane error, the median metric
error against the analytic ground truth and each camera's vote mass
against the anchor's.  It reports; it gates nothing (chip_smoke.py phase 5
gates the literal spec).

Runs on the CUDA device unless `--device cpu` is given (the kernels then
run through their plain versions); without a card it raises.

Usage: python scripts/golden_device_probe_torch.py [spec ...] [--cfg BENCH16|FULL|SMALL]
                                                   [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from dvs_mcemvs_torch import pipeline  # noqa: E402
from dvs_mcemvs_torch.device import require_cuda  # noqa: E402
from dvs_mcemvs_torch.mapper import get_depth_map  # noqa: E402
from dvs_mcemvs_torch.ops import extract  # noqa: E402
from dvs_mcemvs_torch.utils import golden  # noqa: E402

# The JAX script's five specs.
DEFAULT = [
    "hist:g8,seg16,bf,pl",
    "hist:g8,seg16,bf,pl,f32",
    "hist:g8,seg16,pl",
    "hist:g8,seg8,bf,pl",
    "hist:g8,seg16,bf,pl,i8",
]
PACKET = 1024


def probe(specs, cfg_name: str = "BENCH16", device=None) -> list:
    """Score each spec on the fixture; a spec that raises is reported with
    its error.  Returns one dict a spec."""
    dev = require_cuda() if device is None else torch.device(device)
    cfg = getattr(golden, cfg_name)
    mappers, events, trajs, scene, ts_rv = golden.build_golden_fixture(cfg, device=dev)
    quantile = golden.BUDGET["confident_quantile"]
    out = []
    for spec in specs:
        t0 = time.perf_counter()
        try:
            vopts = pipeline.VotingOptions(packet_size=PACKET, backend=spec,
                                           pad_policy="bucket")
            res = pipeline.process_1(mappers, events, trajs, ts_rv, stereo_fusion=2,
                                     vopts=vopts)
            dm = get_depth_map(mappers[0], res.fused_dsi, extract.DepthMapOptions())
            row = dict(spec=spec, **golden.score(dm, res, scene, quantile))
        except Exception as e:  # report every spec, as the JAX script does
            row = {"spec": spec, "error": repr(e)}
        row["seconds"] = time.perf_counter() - t0
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("specs", nargs="*", default=DEFAULT)
    ap.add_argument("--cfg", default="BENCH16", choices=("BENCH16", "FULL", "SMALL"),
                    help="golden fixture profile (utils.golden)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the pipeline runs (cuda raises without a card)")
    args = ap.parse_args(argv)
    dev = require_cuda() if args.device == "cuda" else torch.device("cpu")
    print(f"device={dev} {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
          flush=True)
    for row in probe(args.specs, args.cfg, dev):
        if "error" in row:
            print(f"{row['spec']:28s} FAILED: {row['error']}", flush=True)
            continue
        mass = ", ".join(f"{m:.4f}" for m in row["cam_mass_rel"])
        print(f"{row['spec']:28s} within1={row['within1']:.4f} within2={row['within2']:.4f} "
              f"med={row['median_planes']:.1f} gt_rel={row['gt_median_rel_err']:.4f} "
              f"mass_rel=[{mass}] ({row['seconds']:.1f}s)", flush=True)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
