"""The share of the profiled stretch of chunks in which no kernel or copy
runs on the card, in %."""


def read(trace):
    prof = trace["profile"]
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
