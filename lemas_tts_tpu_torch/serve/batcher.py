"""The pure-Python shape-bucketed micro-batching queue (counterpart of
``lemas_tts_tpu/native/batcher.py``'s ``_PyBatcher``), with the semantics of
the C++ queue ``csrc/host/scheduler.cpp``. The serving engine takes the C++
queue (``native/batcher.py:Batcher``); ``Batcher(native=False)`` is this one.

    b = PyBatcher(max_batch=8, max_wait_ms=20)
    rid = b.submit(bucket=1024, cost=duration_frames)   # request threads
    ids, bucket = b.next_batch(timeout_ms=100)          # the device loop

A batch holds requests of one bucket. The bucket whose head waited longest
goes first; once picked, it waits up to ``max_wait_ms`` from its head's
arrival for more requests, or until ``max_batch`` have come.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple


class PyBatcher:
    def __init__(self, max_batch: int = 8, max_cost: int = 0, max_wait_ms: float = 20.0):
        self.max_batch = max(1, int(max_batch))
        self.max_cost = max_cost
        self.max_wait_us = int(max_wait_ms * 1000)
        self._mu = threading.Condition()
        self._queues: Dict[int, deque] = {}
        self._next_id = 1
        self._closed = False

    def submit(self, bucket: int, cost: int = 1) -> int:
        """Enqueue one request; returns its id, or 0 once closed."""
        with self._mu:
            if self._closed:
                return 0
            rid = self._next_id
            self._next_id += 1
            self._queues.setdefault(bucket, deque()).append(
                (rid, max(1, cost), time.monotonic_ns() // 1000))
            self._mu.notify_all()
            return rid

    def _pick(self) -> Optional[int]:
        best, best_ts = None, None
        for b, q in self._queues.items():
            if q and (best_ts is None or q[0][2] < best_ts):
                best, best_ts = b, q[0][2]
        return best

    def next_batch(self, timeout_ms: float = 100.0) -> Tuple[List[int], int]:
        """``(request ids, bucket)``; ``([], 0)`` on timeout or close."""
        with self._mu:
            deadline = time.monotonic() + timeout_ms / 1e3
            while self._pick() is None:
                remain = deadline - time.monotonic()
                if remain <= 0 or self._closed:
                    return [], 0
                self._mu.wait(remain)
            bucket = self._pick()
            if bucket is None:
                return [], 0
            if self.max_wait_us > 0:
                while not self._closed:
                    bq = self._queues.get(bucket)
                    if not bq:  # drained by another consumer: pick again
                        bucket = self._pick()
                        if bucket is None:
                            return [], 0
                        continue
                    if len(bq) >= self.max_batch:
                        break
                    # the wait runs from the current pick's head
                    remain = bq[0][2] + self.max_wait_us - time.monotonic_ns() // 1000
                    if remain <= 0:
                        break
                    self._mu.wait(remain / 1e6)
                    repick = self._pick()
                    if repick is not None:
                        bucket = repick
                if bucket is None or not self._queues.get(bucket):
                    return [], 0
            q = self._queues[bucket]
            ids, cost = [], 0
            while q and len(ids) < self.max_batch:
                if self.max_cost > 0 and ids and cost + q[0][1] > self.max_cost:
                    break
                rid, c, _ = q.popleft()
                ids.append(rid)
                cost += c
            return ids, bucket

    def cancel(self, rid: int) -> bool:
        """Remove a still-queued request; False if it is unknown or taken."""
        with self._mu:
            for q in self._queues.values():
                for i, (r, _, _) in enumerate(q):
                    if r == rid:
                        del q[i]
                        return True
        return False

    def depth(self) -> int:
        with self._mu:
            return sum(len(q) for q in self._queues.values())

    def close(self) -> None:
        with self._mu:
            self._closed = True
            self._mu.notify_all()
