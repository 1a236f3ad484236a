"""Device-busy ms a chunk over the profiled stretch: the milliseconds in
which at least one kernel or copy runs on the card, over its chunks."""


def read(trace):
    prof = trace["profile"]
    if prof is None or prof["chunks"] <= 0:
        return None
    return prof["busy_s"] * 1e3 / prof["chunks"]
