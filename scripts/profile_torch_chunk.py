"""Where the time of one process_1 chunk of the PyTorch port goes, on a GPU.

Runs the headline chunk of chip_smoke.py (2 x 1 Mi events, 640x480x100,
`hist:g16,seg16,bf,pl`) under torch.profiler after two warm-up chunks and
prints: wall time, device busy time and idle share, device time by kernel
(grouped by name), and the host-to-device copies.  `--trace PATH` also
writes the Chrome trace.

    python3 scripts/profile_torch_chunk.py [--trace out/chunk_trace.json]
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", help="write the Chrome trace to this path")
    args = parser.parse_args()
    import chip_smoke as cs
    from dvs_mcemvs_torch import mapper as mappermod, pipeline
    from dvs_mcemvs_torch.device import require_cuda
    from dvs_mcemvs_torch.ops import extract

    dev = require_cuda()
    print(cs.nvidia_smi_line())
    mappers, events, trajs, _ = cs.build_workload(dev)
    vopts = pipeline.VotingOptions(packet_size=cs.PACKET, backend=cs.HEADLINE_SPEC,
                                   pad_policy="bucket")

    def chunk():
        res = pipeline.process_1(mappers, events, trajs, 0.5, stereo_fusion=2, vopts=vopts)
        mappermod.get_depth_map(mappers[0], res.fused_dsi, extract.DepthMapOptions())
        torch.cuda.synchronize()

    chunk()
    chunk()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk()
        wall_us = (time.perf_counter() - t0) * 1e6

    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in dev_events:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    print(f"chunk wall {wall_us / 1e3:.3f} ms (profiled); device busy "
          f"{busy / 1e3:.3f} ms; idle share {1 - busy / wall_us:.3f}")
    print(f"{'device ms':>10} {'calls':>6}  kernel")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:30]:
        print(f"{us / 1e3:10.3f} {n:6d}  {name[:110]}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
