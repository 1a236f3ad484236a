"""ms a chunk in the save step: `mapper.get_depth_map` (the extraction
program) and the maps' copy to the host, on a save worker; mean over the
window's chunks."""


def read(trace):
    xs = trace["spans"]["extract"]
    return sum(xs) / len(xs) if xs else None
