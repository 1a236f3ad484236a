"""ms a chunk in `pipeline.process_1` / `process_2` (reference view, each
camera's staging and vote programs, fusion and temporal programs), the
span ending in a device sync; mean over the window's chunks."""


def read(trace):
    xs = trace["spans"]["process"]
    return sum(xs) / len(xs) if xs else None
