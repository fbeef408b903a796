"""The sampler as one CUDA graph per bucket: the port's counterpart of the
JAX package's compiled sampler program (``make_sampler``, one program per
settings and shape bucket).

A ``GraphedSampler`` holds, for one ``SamplerSettings`` and one (batch,
duration, text) bucket, static input buffers (with a ``prosody_text``
buffer ``[B, nt, 512]`` when it is a prosody graph: a prosody request and a
plain request of the same shapes never share a graph) and a ``torch.cuda.CUDAGraph``
of the whole ``sample_mel`` loop over them: the CFG prefix, the cond-only
tail, the cached steps. A call copies its inputs into the buffers, replays
the graph and clones the static output, all on the current stream without
a host sync. The first call for a bucket (or ``capture`` from
``Synthesizer.warmup``) runs ``sample_mel`` eagerly on a side stream, which
loads every kernel library and sets up cuBLAS, then captures; that first
call returns the eager result. The eager run's launches are counted as
launches; the capture's go to its thread's record (``ops/launches.py``),
which every replay adds to the counters, so launches that other threads
make meanwhile are not mixed in. The graph holds whatever the model's
attention route launched: K1-K3 under ``"vmem"``, K6 under ``"splash"``,
no kernel of the port under ``"xla"``.

The graphs of one ``Synthesizer`` capture into one memory pool
(``GraphPool``), so its cache holds one sampler workspace (the largest
bucket's), not one a graph. That is safe because the graphs run one at a
time in the order they are queued on one stream, each reads only what it
wrote in the same replay or its static inputs, and each output is cloned
right after its replay. A ``return_trajectory`` graph returns the pair
(mel, trajectory), both cloned.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings, device_time_grid, sample_mel
from lemas_tts_tpu_torch.ops import launches
from lemas_tts_tpu_torch.utils.profiling import TIMERS


class Captures:
    """Every graph capture of the process: a count, and the
    ``time.perf_counter()`` start and bucket key of the last ``keep``, so a
    reader can count the captures that began inside a window (a capture
    after warm-up stalls its request for the eager run and the capture)."""

    def __init__(self, keep: int = 4096):
        self._lock = threading.Lock()
        self.count = 0
        self._log: collections.deque = collections.deque(maxlen=keep)

    def add(self, key: tuple) -> None:
        with self._lock:
            self.count += 1
            self._log.append((time.perf_counter(), key))

    def since(self, t0: float, t1: float = float("inf")) -> List[Tuple[float, tuple]]:
        """``(start, key)`` of the kept captures that began in ``[t0, t1]``."""
        with self._lock:
            return [c for c in self._log if t0 <= c[0] <= t1]


CAPTURES = Captures()


def _tensors(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


class GraphPool:
    """The memory pool that a set of graphs shares: the first capture makes
    it, later captures join it, and it lives while one of its graphs does."""

    def __init__(self):
        self.handle = None


class GraphedSampler:
    """``sample_mel`` of one settings and one [B, N, D] / [B, nt] bucket as a
    CUDA graph. Thread-safe: a lock covers copy-in, replay and copy-out, and
    one lock for all graphs lets one capture run at a time."""

    _capture_lock = threading.Lock()

    def __init__(self, model, settings: SamplerSettings, time_grid: np.ndarray, B: int, N: int,
                 D: int, nt: int, device: torch.device, pool: GraphPool,
                 prosody_dim: Optional[int] = None):
        self.model, self.settings, self.time_grid, self.pool = model, settings, time_grid, pool
        zeros = torch.zeros(B, N, D, device=device)
        self.inputs = dict(cond=zeros,
                           cond_mask=torch.zeros(B, N, dtype=torch.bool, device=device),
                           text_ids=torch.full((B, nt), -1, dtype=torch.int32, device=device),
                           duration=torch.full((B,), N, dtype=torch.int64, device=device),
                           y0=torch.zeros_like(zeros), step_cond=torch.zeros_like(zeros))
        if prosody_dim is not None:
            self.inputs["prosody_text"] = torch.zeros(B, nt, prosody_dim, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches_per_replay: dict = {}
        self._lock = threading.Lock()

    def _sample(self) -> torch.Tensor:
        return sample_mel(self.model, time_grid=self.time_grid, settings=self.settings,
                          **self.inputs)

    def _capture(self) -> torch.Tensor:
        """Eager run on a side stream (the result), then the capture."""
        cond, text_ids = self.inputs["cond"], self.inputs["text_ids"]
        CAPTURES.add((*cond.shape[:2], text_ids.shape[1], "prosody_text" in self.inputs))
        with TIMERS.stage("graph.capture"):
            return self._eager_then_capture()

    def _eager_then_capture(self) -> torch.Tensor:
        dev = self.inputs["cond"].device
        device_time_grid(self.time_grid, dev)  # made before capture, not in it
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            eager = self._sample()
        cur.wait_stream(side)
        for t in _tensors(eager):
            t.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with GraphedSampler._capture_lock, launches.recording() as record:
            with torch.cuda.graph(graph, pool=self.pool.handle, capture_error_mode="thread_local"):
                self.out = self._sample()
            if self.pool.handle is None:
                self.pool.handle = graph.pool()
        self.launches_per_replay, self.graph = record, graph
        return eager

    def capture(self) -> bool:
        """Capture on the buffers as they are (a warm-up); False if the graph
        was already there."""
        with self._lock:
            if self.graph is not None:
                return False
            self._capture()
            return True

    def __call__(self, cond, cond_mask, text_ids, duration, y0, step_cond=None,
                 prosody_text=None) -> torch.Tensor:
        given = dict(cond=cond, cond_mask=cond_mask, text_ids=text_ids, duration=duration, y0=y0,
                     step_cond=cond if step_cond is None else step_cond)
        if prosody_text is not None:
            given["prosody_text"] = prosody_text
        if given.keys() != self.inputs.keys():
            raise ValueError("prosody_text given to a plain graph, or missing for a prosody "
                             "graph")
        with self._lock:
            for k, v in given.items():
                buf = self.inputs[k]
                if tuple(v.shape) != tuple(buf.shape):
                    raise ValueError(f"{k}: shape {tuple(v.shape)}, graph bucket "
                                     f"{tuple(buf.shape)}")
                buf.copy_(v)
            if self.graph is None:
                return self._capture()
            self.graph.replay()
            launches.add(self.launches_per_replay)
            if isinstance(self.out, tuple):  # return_trajectory: (mel, trajectory)
                return tuple(t.clone() for t in self.out)
            return self.out.clone()
