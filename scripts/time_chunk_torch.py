"""Seconds of the PyTorch port's headline chunk on a GPU, for one checkout:
chip_smoke.py's process_1 + get_depth_map (`run_chunk`, 2 x 1 Mi events,
640x480x100, `hist:g16,seg16,bf,pl`, ending in a device sync), the median
and quartiles of `--runs` chunks after `--warm-up` chunks, as one JSON line
with the card's name and power limit.

`--root DIR` times the port of another checkout (a `git archive` of another
commit, unpacked into a git-ignored directory; its kernels build under
DIR/build/).  To compare two commits, run it on both in one machine, in
turns (parent, change, change, parent), one process each:

    for r in build/parent . . build/parent; do python3 scripts/time_chunk_torch.py --root $r; done

Without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO, help="the checkout to time (default: this one)")
    parser.add_argument("--runs", type=int, default=20)
    parser.add_argument("--warm-up", type=int, default=3)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import chip_smoke as cs
    from dvs_mcemvs_torch.device import require_cuda
    from dvs_mcemvs_torch.kernels import _build, binning, resample

    dev = require_cuda()
    _build.build("binning", "resample")
    for lib in (binning, resample):
        lib._library()
    workload = cs.build_workload(dev)
    for _ in range(args.warm_up):
        cs.run_chunk(workload, cs.HEADLINE_SPEC)
    secs = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        cs.run_chunk(workload, cs.HEADLINE_SPEC)
        secs.append(time.perf_counter() - t0)
    q1, med, q3 = (float(np.percentile(secs, q)) for q in (25, 50, 75))
    print(json.dumps({"root": args.root, "port": os.path.dirname(cs.__file__),
                      "median_s": med, "q1_s": q1, "q3_s": q3, "samples_s": secs,
                      "nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
