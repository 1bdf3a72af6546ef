"""Tracing and profiling hooks.

Counterpart of ``spectral_tpu/utils/profiling.py``.  The reference relies
on PETSc's -log_summary (SURVEY.md section 5.1).  Here:

- ``PhaseTimer``: wall-clock time per named phase, the -log_summary stage
  table, synchronized with the CUDA device at the end of each phase;
- ``trace``: a ``torch.profiler`` trace exported as a Chrome trace
  (chrome://tracing, Perfetto);
- ``trace_summary``: a callable run under ``torch.profiler``, with the
  device's busy time (the union of its kernel and copy intervals) split
  from the wall time.

The JAX package's ``enable_compile_cache`` (XLA's persistent compilation
cache) has no counterpart: the CUDA kernels are built once per source hash
(``ops/_build.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulates wall time per named phase; ``summary()`` prints a
    -log_summary-like table.  ``device``: the CUDA device a phase waits
    for at its end (default: the current one, when CUDA has been
    initialized in this process); a CPU device adds no synchronization.
    A phase must not run inside a CUDA-graph capture, where the host clock
    measures nothing of the replays (it raises there)."""

    def __init__(self, device: torch.device | str | None = None):
        self.device = None if device is None else torch.device(device)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def _cuda(self) -> bool:
        if self.device is None:
            return torch.cuda.is_initialized()
        return self.device.type == "cuda"

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        if self._cuda() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"PhaseTimer phase {name!r} inside a CUDA-graph capture")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and self._cuda():
                torch.cuda.synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [f"{'phase':<24s} {'count':>8s} {'total s':>12s} {'avg ms':>12s}"]
        for name in sorted(self.totals, key=lambda k: -self.totals[k]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<24s} {c:>8d} {t:>12.4f} {1e3 * t / c:>12.4f}")
        return "\n".join(lines)


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _export(prof, log_dir: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (host operators and, with
    CUDA, the device's kernels and copies), written into ``log_dir`` as a
    Chrome trace ``trace-<pid>-<ns>.json``.  Yields the profiler."""
    from torch.profiler import profile

    with profile(activities=_activities()) as prof:
        yield prof
    _export(prof, log_dir)


def _union_ns(intervals) -> int:
    """Length of the union of [start, end) intervals."""
    busy, last = 0, None
    for s, e in sorted(intervals):
        if last is None or s >= last:
            busy, last = busy + e - s, e
        elif e > last:
            busy, last = busy + e - last, e
    return busy


def trace_summary(fn, *, trace_dir: str | None = None) -> dict:
    """Run ``fn()`` under ``torch.profiler`` and split the device's time
    from the host's.  A plane is a device (``/device:cuda:<i>``, its
    kernels, copies and fills) or the host (``/host:CPU``, its operators);
    its busy time is the union of its event intervals, so overlapping
    events count once.  With ``trace_dir`` the Chrome trace is written
    there.  The device is synchronized before the profiler stops.

    Returns {"wall_ms", "device_busy_ms", "device_event_count",
    "top_ops": [(name, ms), ...] (device time by name, the 8 largest),
    "planes": {name: busy_ms}}."""
    from torch.profiler import profile

    cuda = torch.cuda.is_available()
    with profile(activities=_activities()) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_dir is not None:
        _export(prof, trace_dir)
    intervals: dict[str, list] = defaultdict(list)
    top: dict[str, float] = defaultdict(float)
    n_events = 0
    for ev in prof.profiler.kineto_results.events():
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            intervals["/host:CPU"].append((start, start + dur))
            continue
        plane = f"/device:{str(ev.device_type()).split('.')[-1].lower()}:{ev.device_index()}"
        intervals[plane].append((start, start + dur))
        top[ev.name()] += dur / 1e6
        n_events += 1
    planes = {k: _union_ns(v) / 1e6 for k, v in intervals.items()}
    device_busy = sum(v for k, v in planes.items() if k.startswith("/device:"))
    top_ops = sorted(top.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": device_busy,
            "device_event_count": n_events,
            "top_ops": [(k, round(v, 4)) for k, v in top_ops],
            "planes": {k: round(v, 4) for k, v in planes.items()}}
