"""The TUM-VIE bike-easy-3 cell of the benchmark (`tumvie_bike_easy3.replay_3m`)
at a small 16:9 size on the CPU: the port's timed full_seq path, as the
benchmark drives it, against the benchmark's plain reference, and the
tracer's count of the staged events and the bucket pad.

The cell's windows hold a count that lies off a bucket edge (3,000,000
events a camera, staged as 4,194,304), so the last packet is partial and
the bucket pad fills the rest.  At this size (96x54, 16 planes, packets of
1,024) the counts are 8,200 events (a last packet of 8 events, under half
full: its pose is the last real event's) and 9,000 (a last packet of 808,
over half full: its pose is its middle event's); both stage 16,384.
"""

import pytest

from benchmark import harness
from benchmark.tests import _cells
from dvs_mcemvs_torch import mapper, tracing

CELL = "tumvie_bike_easy3.replay_3m"
SEED = 2**31 + 2121


@pytest.fixture(autouse=True)
def tracer_off():
    yield
    tracing.disable()


@pytest.mark.parametrize("per_window", [8200, 9000],
                         ids=["last_packet_under_half", "last_packet_over_half"])
def test_cell_matches_the_reference_and_counts_the_pad(per_window):
    cell = _cells.tiny(CELL)
    cell.mix["events_per_window"] = per_window
    packet = int(harness.REFERENCE_DEFAULTS["packet_size"])
    tracing.enable("cpu")
    out = harness.run(cell, SEED, 0.3, False, "cpu", log=lambda m: None)
    tracing.disable()
    snap = tracing.snapshot()
    assert out.rows
    for row in out.rows:
        assert row["dsi_l1"] < 1e-4 and row["fused_l1"] < 1e-4, row
        assert row["maps_off"] < 0.02, row
    assert out.result["correct"] is True, out.result["check"]
    # Every camera-chunk, the warm-up's pass over the 28 windows and the
    # window's, staged the window's events and the pad up to the bucket, by the
    # host fill (the eager path of the CPU).
    camera_chunks = 2 * (28 + out.result["attempted"])
    bucket = mapper.bucket_capacity(per_window, packet)
    assert bucket == 16 * packet
    assert snap["counters"]["staged"] == {"events": camera_chunks * per_window,
                                          "pad": camera_chunks * (bucket - per_window),
                                          "dma_chunks": 0, "fill_chunks": camera_chunks,
                                          "registrations": 0, "locked_bytes": 0}
