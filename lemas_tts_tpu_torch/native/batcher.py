"""The serving micro-batcher (counterpart of
``lemas_tts_tpu/native/batcher.py``): the C++ queue of
``csrc/host/scheduler.cpp`` through ``ctypes`` by default, or the
pure-Python one of ``serve/batcher.py`` (the same semantics) when asked
for with ``native=False``.

    b = Batcher(max_batch=8, max_wait_ms=20)
    rid = b.submit(bucket=1024, cost=duration_frames)   # request threads
    ids, bucket = b.next_batch(timeout_ms=100)          # the device loop

A failed build of the library raises; nothing falls back to the Python
queue unless ``native=False`` says so (the JAX class falls back silently,
and names the Python queue with ``force_python=True``).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

from lemas_tts_tpu_torch.native import load_library
from lemas_tts_tpu_torch.serve.batcher import PyBatcher

_typed = None


def _lib() -> ctypes.CDLL:
    global _typed
    if _typed is None:
        lib = load_library("scheduler")
        vp, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
        for name, restype, argtypes in (
                ("batcher_create", vp, [i64, i64, i64]),
                ("batcher_destroy", None, [vp]),
                ("batcher_close", None, [vp]),
                ("batcher_submit", u64, [vp, i64, i64]),
                ("batcher_next_batch", i64, [vp, ctypes.POINTER(u64), ctypes.POINTER(i64), i64]),
                ("batcher_cancel", i64, [vp, u64]),
                ("batcher_depth", i64, [vp]),
                ("batcher_version", ctypes.c_char_p, [])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _typed = lib
    return _typed


class Batcher:
    """Shape-bucketed micro-batching queue: native unless ``native=False``."""

    def __init__(self, max_batch: int = 8, max_cost: int = 0, max_wait_ms: float = 20.0,
                 native: bool = True):
        # the C++ side clamps the same way; the Python-held max_batch sizes
        # the ctypes output arrays, so it is never < 1
        self.max_batch = max(1, int(max_batch))
        self._py = None if native else PyBatcher(self.max_batch, max_cost, max_wait_ms)
        if native:
            self._c = _lib()
            self._h = ctypes.c_void_p(self._c.batcher_create(self.max_batch, max_cost,
                                                             int(max_wait_ms * 1000)))

    @property
    def is_native(self) -> bool:
        return self._py is None

    def submit(self, bucket: int, cost: int = 1) -> int:
        """Enqueue one request; returns its id, or 0 once closed."""
        if self._py is not None:
            return self._py.submit(bucket, cost)
        return int(self._c.batcher_submit(self._h, bucket, cost))

    def next_batch(self, timeout_ms: float = 100.0) -> Tuple[List[int], int]:
        """``(request ids, bucket)``; ``([], 0)`` on timeout or close."""
        if self._py is not None:
            return self._py.next_batch(timeout_ms)
        ids = (ctypes.c_uint64 * self.max_batch)()
        buckets = (ctypes.c_int64 * self.max_batch)()
        n = self._c.batcher_next_batch(self._h, ids, buckets, int(timeout_ms * 1000))
        if n <= 0:
            return [], 0
        return [int(ids[i]) for i in range(n)], int(buckets[0])

    def cancel(self, rid: int) -> bool:
        """Remove a still-queued request; False if it is unknown or taken."""
        if self._py is not None:
            return self._py.cancel(rid)
        return bool(self._c.batcher_cancel(self._h, rid))

    def depth(self) -> int:
        if self._py is not None:
            return self._py.depth()
        return int(self._c.batcher_depth(self._h))

    def close(self) -> None:
        if self._py is not None:
            self._py.close()
        else:
            self._c.batcher_close(self._h)

    def __del__(self):
        if getattr(self, "_py", 0) is None and getattr(self, "_h", None) is not None:
            self._c.batcher_destroy(self._h)
