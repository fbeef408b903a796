"""The profiled slice read back: the device's operations (kernels, copies,
memsets) with their intervals, the host's operators, the busy time as the
union of device intervals, and the breakdown that goes into the result.

The slice is written by ``torch.profiler`` as a Chrome trace into the
temporary directory (``TMPDIR``), read, and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import Counter
from dataclasses import dataclass, field
from typing import List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Profile:
    window_s: float
    device_ops: List[Tuple[str, float, float]]  # (name, start us, duration us)
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return union_us([(s, s + d) for _, s, d in self.device_ops]) / 1e6


def union_us(spans) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def read(prof, window_s: float) -> Profile:
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        item = (e.get("name", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0)))
        if e.get("cat") in DEVICE_CATS:
            dev.append(item)
        elif e.get("cat") == "cpu_op":
            host.append(item)
    return Profile(window_s, dev, host)


def breakdown(p: Profile, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps between
    device operations summed by the innermost host operator running at each
    gap's middle (``host idle`` where none runs; gaps under 10 us, the
    launch gaps inside a graph, together), seconds each."""
    tot: Counter = Counter()
    for name, _, d in p.device_ops:
        tot[name] += d / 1e6
    merged: List[list] = []
    for a, b in sorted((s, s + d) for _, s, d in p.device_ops):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    hosts = sorted(p.host_ops, key=lambda h: h[1])
    starts = [h[1] for h in hosts]
    gaps: Counter = Counter()
    for (_, end), (start, _) in zip(merged, merged[1:]):
        if start - end < 10.0:
            gaps["gaps under 10 us"] += (start - end) / 1e6
            continue
        mid = 0.5 * (end + start)
        i = bisect.bisect_right(starts, mid)
        inside = [h for h in hosts[max(0, i - 4000):i] if mid <= h[1] + h[2]]
        label = min(inside, key=lambda h: h[2])[0] if inside else "host idle"
        gaps[label] += (start - end) / 1e6
    return {"device_ops": [[n[:160], s] for n, s in tot.most_common(top)],
            "idle_gaps": [[n[:160], s] for n, s in gaps.most_common(top)]}
