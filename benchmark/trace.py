"""Spans and a bounded device trace of the benchmark's own calls.

A traced run profiles one bounded slice of its window (a few sweep
passes, or one whole fan-out) with ``torch.profiler``, in memory, and
reduces it here to plain numbers:

* ``busy_s``: the union of the device's activity intervals (kernels,
  copies, sets) inside the slice, so overlapping streams count once;
* ``window_s``: the slice's length;
* the device time under each of the benchmark's spans (the union of the
  device intervals that lie inside the span's host interval);
* ``device_ops``: the device operations that took the most time;
* ``idle_gaps``: the longest stretches with nothing on the device, each
  named by the innermost span the host was in when it began.

Spans are ``torch.profiler.record_function`` ranges around each call the
benchmark makes into a layer of the program ("draw", "solve/T=744",
"DERVET.solve"); outside a traced slice they cost nothing.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

SPAN_PREFIX = "bench/"
# device operations are named by their first characters in the breakdown
NAME_CHARS = 160


def span(name: str, on: bool):
    """A named range on the profiler's timeline while a slice is traced."""
    if not on:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + name)


def union(iv: np.ndarray) -> np.ndarray:
    """Disjoint, sorted intervals covering the (k, 2) intervals ``iv``."""
    if not len(iv):
        return np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    first = np.flatnonzero(np.r_[True, iv[1:, 0] > reach[:-1]])
    return np.stack([iv[first, 0], np.maximum.reduceat(iv[:, 1], first)], 1)


def covered(iv: np.ndarray, lo: float, hi: float) -> float:
    """Length of the disjoint intervals ``iv`` inside [lo, hi]."""
    if not len(iv):
        return 0.0
    return float(np.clip(np.minimum(iv[:, 1], hi) - np.maximum(iv[:, 0], lo),
                         0.0, None).sum())


def reduce(device: list, spans: list, t0: float, t1: float) -> dict:
    """The slice's numbers from its device events ``device`` [(name, start,
    end)] and spans [(name, start, end)], in seconds on one clock, over
    the slice [t0, t1]."""
    dev = np.asarray([(s, e) for _, s, e in device], float).reshape(-1, 2)
    dev = np.clip(dev, t0, t1)
    busy = union(dev)
    by_op: dict = {}
    for name, s, e in device:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    span_dev: dict = {}
    for name, s, e in spans:
        span_dev[name] = span_dev.get(name, 0.0) + covered(busy, s, e)
    # idle gaps: between t0, the busy intervals and t1
    edges = np.concatenate([[t0], busy.ravel(), [t1]]).reshape(-1, 2)
    gaps = sorted(((s, e) for s, e in edges if e > s),
                  key=lambda g: g[0] - g[1])[:10]
    longest = []
    for s, e in gaps:
        inner = [sp for sp in spans if sp[1] <= s < sp[2]]
        name = (min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner
                else "outside spans")
        longest.append((name, e - s))
    return {"busy_s": float((busy[:, 1] - busy[:, 0]).sum()) if len(busy)
            else 0.0,
            "window_s": float(t1 - t0),
            "span_device_s": span_dev,
            "device_ops": [[n, float(v)] for n, v in top],
            "idle_gaps": [[n, float(g)] for n, g in longest]}


class Slice:
    """Profile what runs inside the ``with`` block: CPU and CUDA activity,
    in memory.  ``result`` holds :func:`reduce`'s numbers afterwards, or
    None where the profiler recorded no device activity."""

    def __init__(self):
        self.result = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.result = self._read()
        return False

    def _read(self):
        from torch.autograd import DeviceType
        events = self.prof.profiler.kineto_results.events()
        device, spans, cpu = [], [], []
        for ev in events:
            try:
                s, d = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
            except AttributeError:
                s, d = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
            name = ev.name()
            if name.startswith(SPAN_PREFIX):
                # a span shows on the device's timeline too, as an
                # annotation: only its host interval is the span
                if ev.device_type() != DeviceType.CUDA:
                    spans.append((name[len(SPAN_PREFIX):], s, s + d))
            elif ev.device_type() == DeviceType.CUDA:
                if d > 0:
                    device.append((name[:NAME_CHARS], s, s + d))
            else:
                cpu.append((s, s + d))
        if not device:
            return None
        # the slice on the profiler's clock: from the first to the last
        # activity of any kind, held to the host's own length of it
        starts = [s for _, s, _ in device] + [s for _, s, _ in spans] + \
            [s for s, _ in cpu]
        t0 = min(starts)
        t1 = max(t0 + (self.t1 - self.t0), max(e for _, _, e in device))
        return reduce(device, spans, t0, t1)
