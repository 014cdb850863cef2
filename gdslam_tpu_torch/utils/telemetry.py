"""Structured per-frame metrics and profiling helpers (port of
gdslam_tpu.utils.telemetry).

JSONL per-frame records (track state, inliers, map sizes, stage timings), a
wall-clock stage timer, and `profile`, a context manager around
`torch.profiler` that writes a Chrome trace of the host and the card.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch


class MetricsLogger:
    """Append-only JSONL metrics sink."""

    def __init__(self, path: Optional[str] = None):
        self._f = open(path, "a") if path else None
        self.last: dict = {}

    def log(self, **kv) -> None:
        kv.setdefault("t_wall", time.time())
        self.last = kv
        if self._f:
            self._f.write(json.dumps(kv) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


def frame_metrics(tracker) -> dict:
    """Snapshot the tracker's per-frame state for logging (reads the map's
    counts from the card)."""
    return {
        "frame": tracker.frame_id,
        "state": tracker.state.name,
        "inliers": tracker.n_inliers,
        "n_kf": int(tracker.arena.n_kf),
        "n_pt": int(tracker.arena.n_pt),
        "ref_kf": tracker.ref_kf,
    }


@contextlib.contextmanager
def profile(trace_dir: Optional[str]):
    """torch.profiler scope over the host and, where there is one, the card;
    writes `trace.json` (Chrome trace format) into trace_dir on exit. A no-op
    when trace_dir is None."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class StageTimer:
    """Wall-clock stage timing (the reference's chrono tic/toc, structured)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {k: {"total_s": v, "mean_ms": 1000 * v / self.counts[k]}
                for k, v in self.totals.items()}
