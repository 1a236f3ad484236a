"""Write the golden fixtures' event streams to tests/golden/golden_events.npz.

The committed golden anchors were voted from events that the JAX package's
fixture code simulates in float32 poses; an event's pixel is a rounding
of a float32 projection, so a port that evaluates the same poses with other
float32 kernels moves a few events across a pixel boundary (about 1 in
20,000).  The PyTorch port therefore reads the JAX package's fixture events from
this file instead of re-simulating them, and its tests check that the file
still matches the JAX package's fixture.

    JAX_PLATFORMS=cpu python scripts/make_golden_events.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "golden", "golden_events.npz")


def main() -> None:
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from dvs_mcemvs_tpu.utils import golden

    arrays = {}
    for cfg in (golden.SMALL, golden.BENCH16):
        _, events, *_ = golden.build_golden_fixture(cfg=cfg)
        key = cfg.npz_name[:-len(".npz")]
        for cam, ev in enumerate(events):
            arrays[f"{key}__x{cam}"] = ev.x.astype(np.int16)
            arrays[f"{key}__y{cam}"] = ev.y.astype(np.int16)
            arrays[f"{key}__t{cam}"] = ev.t.astype(np.float64)
            arrays[f"{key}__p{cam}"] = ev.p.astype(np.int8)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 2**20:.2f} MiB)")


if __name__ == "__main__":
    main()
