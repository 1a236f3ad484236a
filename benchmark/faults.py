"""Faults planted in the timed path, to show that the output check fails
them (the benchmark's own tests, and `calibrate.py` on the card).

Each is a context manager that patches the program while a run is set up
and driven:

  - `stale`: each chunk's process call returns the previous chunk's result
    (a step that returns its state unchanged);
  - `half`: each camera's chunk loses its second half of events before it
    is voted (half of the batch left out);
  - `state`: process_2's temporal step stops accumulating after the first
    sub-interval (the temporal state left unchanged);
  - `altered`: each depth map's indices move three planes where
    `mapper.get_depth_map` produces them (an answer altered).
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("stale", "half", "state", "altered")


@contextlib.contextmanager
def _patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _stale(real):
    last = []

    def process(*args, **kw):
        res = real(*args, **kw)
        out = last[0] if last else res
        last[:] = [res]
        return out
    return process


def _half(real):
    def process(mps, evs, trs, ts, **kw):
        return real(mps, [e.slice(0, e.num // 2) for e in evs], trs, ts, **kw)
    return process


def _state(real):
    def temporal_step(acc, d0, d1, stereo_fusion, temporal_fusion, first):
        if first:
            return real(acc, d0, d1, stereo_fusion, temporal_fusion, first)
        from dvs_mcemvs_torch.ops import grid
        return grid.fuse_pair(d0, d1, stereo_fusion)
    return temporal_step


def _altered(real):
    def get_depth_map(mapper, dsi, options):
        res = real(mapper, dsi, options)
        idx = torch.clamp(res.depth_indices + 3, 0, mapper.depth_vec.n - 1)
        return res._replace(depth=mapper.depth_vec.depth_at_index(idx), depth_indices=idx)
    return get_depth_map


@contextlib.contextmanager
def planted(name: str):
    """Patch the program with fault `name` inside."""
    from dvs_mcemvs_torch import mapper, pipeline

    if name in ("stale", "half"):
        make = _stale if name == "stale" else _half
        with _patched(pipeline, "process_1", make), _patched(pipeline, "process_2", make):
            yield
    elif name == "state":
        with _patched(pipeline, "temporal_step", _state):
            yield
    elif name == "altered":
        with _patched(mapper, "get_depth_map", _altered):
            yield
    else:
        raise ValueError(f"unknown fault {name!r}")
