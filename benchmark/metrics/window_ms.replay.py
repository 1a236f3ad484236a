"""Host ms a chunk that `pipeline.run_full_seq` spends outside `process`:
from the harness asking for the next chunk to the process function's
call (windowing by binary search, the slicing), mean over the window."""


def read(trace):
    xs = trace["spans"]["window"]
    return sum(xs) / len(xs) if xs else None
