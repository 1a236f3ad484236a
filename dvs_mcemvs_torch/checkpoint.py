"""Checkpoint/resume for full-sequence runs.

The reference has no checkpointing; its recovery story is that full_seq
chunks are independent, so a crashed run can be restarted at any
`interval_start` by hand (SURVEY.md §5, main.cpp:177).  This module makes
that property operational: a JSON ledger next to the outputs records every
completed chunk (plus a config fingerprint so stale ledgers are never
reused), and the scheduler skips completed chunks on resume.

Port of dvs_mcemvs_tpu/checkpoint.py (host-side, copied so the port imports
nothing of the JAX package); `sync_multihost` broadcasts rank 0's ledger
over torch.distributed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import tempfile
from typing import Dict, Optional, Set

import torch.distributed as dist

log = logging.getLogger(__name__)

_FORMAT_VERSION = 1


def config_fingerprint(flag_text: str) -> str:
    """Stable fingerprint of the run configuration (the serialized flagfile
    minus pure-output knobs that don't change chunk results)."""
    keep = []
    for line in flag_text.splitlines():
        key = line.split("=", 1)[0].lstrip("-")
        # Excluded: pure-output / observability knobs, plus the coordinator
        # ADDRESS (a relaunch binds a new port; the decomposition-relevant
        # num_processes/process_id stay in).
        if key in ("out_path", "save_dsi", "save_mono", "save_conf_stats",
                   "save_dense", "platform", "use_event_store", "profile_dir",
                   "checkpoint", "timing_sync_every", "coordinator"):
            continue
        keep.append(line)
    return hashlib.sha256("\n".join(keep).encode()).hexdigest()[:16]


@dataclasses.dataclass
class RunCheckpoint:
    """Ledger of completed full_seq chunks."""

    path: str
    fingerprint: str = ""
    enabled: bool = True
    _done: Set[int] = dataclasses.field(default_factory=set)
    _meta: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.enabled:
            return
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    data = json.load(f)
            except (json.JSONDecodeError, OSError) as e:
                log.warning("checkpoint %s unreadable (%s); starting fresh",
                            self.path, e)
                return
            if data.get("version") != _FORMAT_VERSION:
                log.warning("checkpoint %s: unknown version; starting fresh",
                            self.path)
                return
            if self.fingerprint and data.get("fingerprint") != self.fingerprint:
                log.warning(
                    "checkpoint %s was written by a different configuration; "
                    "ignoring it (old %s != new %s)", self.path,
                    data.get("fingerprint"), self.fingerprint)
                return
            self._done = set(data.get("done", []))
            self._meta = data.get("meta", {})
            if self._done:
                log.info("resuming: %d chunks already complete (%s)",
                         len(self._done), self.path)

    def is_done(self, chunk: int) -> bool:
        return chunk in self._done

    def mark_done(self, chunk: int, ts: Optional[float] = None) -> None:
        if not self.enabled:
            return
        self._done.add(chunk)
        if ts is not None:
            self._meta[str(chunk)] = ts
        self._flush()

    def _flush(self) -> None:
        data = {
            "version": _FORMAT_VERSION,
            "fingerprint": self.fingerprint,
            "done": sorted(self._done),
            "meta": self._meta,
        }
        # Atomic replace so a crash mid-write never corrupts the ledger.
        d = os.path.dirname(self.path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @property
    def num_done(self) -> int:
        return len(self._done)


def sync_multihost(ckpt: RunCheckpoint) -> None:
    """Align resume decisions across the ranks of a multi-rank run.

    Every rank must skip the same chunks, or the per-chunk collectives of
    the sharded step pair up wrongly or hang: rank 0 (whose out_path holds
    the real ledger) would skip a completed chunk while its peers, whose
    outputs go to fresh scratch directories with no ledger, still vote it.
    Rank 0's done-set is broadcast and replaces every peer's before the
    chunk loop starts; peers still write their scratch ledgers.  Every rank
    of the group calls it; no-op without a group of more than one rank.
    """
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return
    done = [sorted(ckpt._done)]
    dist.broadcast_object_list(done, src=0)
    ckpt._done = set(done[0])
    if dist.get_rank() != 0:
        log.info("resume sync: %d chunks done per rank 0's ledger", len(ckpt._done))
