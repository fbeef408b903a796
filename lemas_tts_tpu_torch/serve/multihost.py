"""Multi-process serving: requests enter on process 0, and every sampler
call runs on every process of the job's mesh (counterpart of
``lemas_tts_tpu/serve/multihost.py``).

The mesh's collectives must be entered by every process, in the same order,
with the same shapes. Requests arrive at one front end, so:

- process 0 runs the :class:`~lemas_tts_tpu_torch.serve.engine.ServingEngine`
  (and the HTTP front end, ``scripts/serve_http.py --multihost``) over a
  :class:`BroadcastSynthesizer`, which broadcasts each call's inputs to the
  other processes before making the call itself;
- every other process runs :func:`follower_serve`, a loop that receives
  each call and makes the same ``Synthesizer`` call, so the processes stay
  in lockstep.

The control channel is a length-prefixed pickle, broadcast from process 0
on a gloo process group made for it (``torch.distributed.new_group``), so on
CUDA it never queues behind compute on NCCL. One lock on process 0 orders
every operation on the channel (the engine's worker, streams, stats,
shutdown). Process 0 fills in missing per-request seeds before it
broadcasts, so every process draws the same noise. A stream is a sequence
of (dispatch, finalize) pairs, so batched ``/tts`` calls interleave between
a stream's mini-batches; the close is sent whether the stream ends or is
abandoned.

Liveness: a collective cannot time out on its own, so a dead follower would
block process 0 (and ``/stats`` behind the same lock) for ever. A plain TCP
side channel carries heartbeats (:class:`_HeartbeatServer` on process 0, one
sender thread on each follower): a follower's death is seen within
``heartbeat_timeout`` seconds and puts the dispatch into a terminal
``degraded`` state, which fires the ``on_degraded`` callbacks
(``ServingEngine.poison``: 503 for every request), makes every later
operation fail at once, and makes ``aggregated_stats`` answer from the
heartbeat table. A watchdog of ``op_timeout`` seconds around every
operation covers a fleet that hangs with its heartbeats still flowing. A
follower that loses its heartbeat connection to process 0 calls
``on_leader_lost`` (default: exit with code 3).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import socket as socket_mod
import struct
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["MultiHostDispatch", "BroadcastSynthesizer", "follower_serve"]

# control-channel opcodes (int64 header: [op, payload length])
_OP_DISPATCH = 1  # pickle((requests, cfg)) -> synthesize_requests
_OP_WARMUP = 2  # pickle((cfg, kwargs)) -> Synthesizer.warmup
_OP_STATS = 3  # every process joins a stats all_gather
_OP_SHUTDOWN = 4  # followers return from follower_serve
_OP_STREAM_DISPATCH = 5  # pickle((sid, ref_wav, ref_sr, ref_units, chunks, bcfg, prep_cfg, seed))
_OP_STREAM_FINALIZE = 6  # pickle(sid) -> _finalize_chunks
_OP_STREAM_CLOSE = 7  # pickle(sid) -> drop the stream's state


def _leader_host() -> str:
    """The host process 0 advertises for the heartbeat channel: the
    rendezvous host (``MASTER_ADDR``) unless ``LEMAS_MH_HEARTBEAT_HOST``
    names another."""
    return (os.environ.get("LEMAS_MH_HEARTBEAT_HOST") or os.environ.get("MASTER_ADDR")
            or socket_mod.gethostname())


class _HeartbeatServer:
    """Process 0's side of the liveness channel: one reader thread per
    follower connection; a ``recv`` timeout catches both a dead peer
    (FIN/RST) and a hung one. ``on_dead`` fires once per dead follower; a
    follower that never connects within ``connect_grace`` is dead too."""

    def __init__(self, n_followers: int, timeout: float, on_dead: Callable[[int, str], None],
                 connect_grace: float = 60.0):
        self.timeout = timeout
        self.on_dead = on_dead
        self.connect_grace = connect_grace
        self.last_seen: Dict[int, float] = {}
        self.dead: Dict[int, str] = {}
        self._lock = threading.Lock()
        self._closing = False
        self._expected = n_followers
        self.sock = socket_mod.socket()
        self.sock.setsockopt(socket_mod.SOL_SOCKET, socket_mod.SO_REUSEADDR, 1)
        self.sock.bind(("0.0.0.0", 0))
        self.sock.listen(max(1, n_followers))
        self.port = self.sock.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="mh-heartbeat-accept").start()
        grace = threading.Timer(connect_grace, self._check_connected)
        grace.daemon = True
        grace.start()

    def _check_connected(self) -> None:
        with self._lock:
            missing = self._expected - len(self.last_seen)
            closing = self._closing
        if missing > 0 and not closing:
            self._mark_dead(-1, f"{missing} follower(s) never connected within "
                                f"{self.connect_grace}s")

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return  # closed
            threading.Thread(target=self._reader, args=(conn,), daemon=True,
                             name="mh-heartbeat-read").start()

    def _reader(self, conn: socket_mod.socket) -> None:
        pid = None
        try:
            conn.settimeout(self.timeout)
            hdr = b""
            while len(hdr) < 4:
                b = conn.recv(4 - len(hdr))
                if not b:
                    return
                hdr += b
            pid = struct.unpack("<i", hdr)[0]
            with self._lock:
                self.last_seen[pid] = time.monotonic()
            while True:
                if not conn.recv(1):
                    self._mark_dead(pid, "heartbeat connection closed")
                    return
                with self._lock:
                    self.last_seen[pid] = time.monotonic()
        except socket_mod.timeout:
            self._mark_dead(pid, f"no heartbeat for {self.timeout}s")
        except OSError as e:
            self._mark_dead(pid, f"heartbeat connection error: {e}")
        finally:
            with contextlib.suppress(OSError):
                conn.close()

    def _mark_dead(self, pid: Optional[int], reason: str) -> None:
        key = -1 if pid is None else pid
        with self._lock:
            if self._closing or key in self.dead:
                return
            self.dead[key] = reason
        self.on_dead(key, reason)

    def liveness(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            return {"followers_expected": self._expected,
                    "followers_connected": len(self.last_seen),
                    "last_seen_age_s": {str(p): round(now - t, 3)
                                        for p, t in self.last_seen.items()},
                    "dead": {str(p): r for p, r in self.dead.items()}}

    def quiesce(self) -> None:
        """Stop reading disconnects as deaths (a clean shutdown)."""
        with self._lock:
            self._closing = True

    def close(self) -> None:
        self.quiesce()
        with contextlib.suppress(OSError):
            self.sock.close()


def _heartbeat_client(addr: "tuple[str, int]", pid: int, interval: float,
                      on_leader_lost: Callable[[str], None],
                      stop: threading.Event) -> threading.Thread:
    """A follower's sender: connect to process 0 and send one byte an
    ``interval``. A failure before ``stop`` is set means process 0 is
    gone."""

    def run():
        try:
            conn = socket_mod.create_connection(addr, timeout=30)
            conn.sendall(struct.pack("<i", pid))
            while not stop.is_set():
                conn.sendall(b"\x01")
                stop.wait(interval)
        except OSError as e:
            if not stop.is_set():
                on_leader_lost(f"heartbeat to process 0 failed: {e}")

    t = threading.Thread(target=run, daemon=True, name="mh-heartbeat-send")
    t.start()
    return t


def _default_leader_lost(reason: str) -> None:  # pragma: no cover - fatal
    print(f"[multihost] leader lost ({reason}); follower exiting", file=sys.stderr, flush=True)
    os._exit(3)


class MultiHostDispatch:
    """The control channel and the dispatch counters, on every process.

    Process 0 sends operations under :attr:`lock`; followers receive them in
    :func:`follower_serve`. Both sides count the dispatches they joined, so
    :meth:`aggregated_stats` shows lockstep. ``op_timeout`` bounds every
    operation on process 0 (a watchdog: the stuck thread stays stuck, but
    the fleet turns ``degraded``); ``heartbeat_timeout`` bounds the time to
    see a follower's death. ``degraded`` is terminal: restart the job."""

    def __init__(self, synth, *, op_timeout: float = 600.0, heartbeat_interval: float = 0.5,
                 heartbeat_timeout: float = 5.0, stats_lock_timeout: float = 2.0,
                 on_leader_lost: Callable[[str], None] = _default_leader_lost):
        if not dist.is_initialized():
            raise RuntimeError("multi-process serving needs the job's process group "
                               "(parallel.distributed.initialize)")
        self.synth = synth
        self.lock = threading.Lock()  # orders every channel operation on process 0
        self.dispatches = 0
        self.warmups = 0
        self.op_timeout = op_timeout
        self.stats_lock_timeout = stats_lock_timeout
        self.degraded: Optional[str] = None
        self.on_degraded: List[Callable[[BaseException], None]] = []
        self._degrade_lock = threading.Lock()
        self._stream_seq = 0
        self._hb: Optional[_HeartbeatServer] = None
        self._hb_stop = threading.Event()  # a follower's clean-shutdown signal
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        # every process makes the control group, in the same order
        self.group = dist.new_group(backend="gloo")
        if self.world > 1:  # a job of one needs no heartbeats
            if self.rank == 0:
                self._hb = _HeartbeatServer(
                    self.world - 1, heartbeat_timeout,
                    on_dead=lambda pid, reason: self._mark_degraded(
                        f"follower process {pid}: {reason}"))
                self._broadcast_bytes(f"{_leader_host()}:{self._hb.port}".encode())
            else:
                host, port = self._broadcast_bytes().decode().rsplit(":", 1)
                _heartbeat_client((host, int(port)), self.rank, heartbeat_interval,
                                  on_leader_lost, self._hb_stop)

    # ---------------------------------------------------------- degradation
    def _mark_degraded(self, reason: str) -> None:
        with self._degrade_lock:
            if self.degraded is not None:
                return
            self.degraded = reason
        print(f"[multihost] fleet DEGRADED: {reason} — restart required", file=sys.stderr,
              flush=True)
        exc = RuntimeError(f"multihost fleet degraded: {reason}")
        for cb in list(self.on_degraded):
            with contextlib.suppress(Exception):  # a callback must not hide the others
                cb(exc)

    @contextlib.contextmanager
    def _bounded_op(self, what: str):
        """Fail at once when degraded; else arm a watchdog that degrades the
        fleet if the operation has not ended within ``op_timeout``."""
        if self.degraded is not None:
            raise RuntimeError(f"multihost fleet degraded: {self.degraded}")
        timer = threading.Timer(self.op_timeout, lambda: self._mark_degraded(
            f"{what} did not complete within op_timeout={self.op_timeout}s"))
        timer.daemon = True
        timer.start()
        try:
            yield
        finally:
            timer.cancel()

    # --------------------------------------------------------- byte channel
    def _broadcast_bytes(self, payload: Optional[bytes] = None) -> bytes:
        """Process 0 gives ``payload``; every process returns it."""
        n = torch.tensor([0 if payload is None else len(payload)], dtype=torch.int64)
        dist.broadcast(n, src=0, group=self.group)
        buf = (torch.frombuffer(bytearray(payload), dtype=torch.uint8) if payload
               else torch.empty(int(n), dtype=torch.uint8))
        if int(n):
            dist.broadcast(buf, src=0, group=self.group)
        return bytes(buf.numpy())

    def send(self, op: int, payload: bytes = b"") -> None:
        """Process 0: broadcast one (op, payload). The caller holds the lock."""
        dist.broadcast(torch.tensor([op, len(payload)], dtype=torch.int64), src=0,
                       group=self.group)
        if payload:
            dist.broadcast(torch.frombuffer(bytearray(payload), dtype=torch.uint8), src=0,
                           group=self.group)

    def recv(self) -> "tuple[int, bytes]":
        """A follower: wait for the next (op, payload)."""
        header = torch.zeros(2, dtype=torch.int64)
        dist.broadcast(header, src=0, group=self.group)
        op, n = int(header[0]), int(header[1])
        payload = b""
        if n:
            buf = torch.empty(n, dtype=torch.uint8)
            dist.broadcast(buf, src=0, group=self.group)
            payload = bytes(buf.numpy())
        return op, payload

    # ------------------------------------------------------------ stats op
    def _stats_gather(self) -> np.ndarray:
        """The stats op's collective: every process gives [rank, dispatches,
        warmups, local devices]."""
        row = torch.tensor([self.rank, self.dispatches, self.warmups,
                            torch.cuda.device_count() if torch.cuda.is_available() else 1],
                           dtype=torch.int64)
        rows = [torch.empty_like(row) for _ in range(self.world)]
        dist.all_gather(rows, row, group=self.group)
        return torch.stack(rows).numpy()

    def aggregated_stats(self) -> Dict[str, Any]:
        """Process 0: one stats round over the fleet plus the heartbeat table.
        The lock is taken with a bounded wait, so a stuck dispatch (or a
        degraded fleet) never hangs ``/stats``: the answer then comes from
        the heartbeat table alone."""
        base: Dict[str, Any] = {"processes": self.world, "global_devices": self.world,
                                "fleet": self._hb.liveness() if self._hb else None,
                                "degraded": self.degraded}
        if self.degraded is not None:
            return {**base, "in_lockstep": False}
        if not self.lock.acquire(timeout=self.stats_lock_timeout):
            return {**base, "in_lockstep": None, "busy": True}
        try:
            if self.degraded is not None:  # degraded while we waited
                return {**base, "degraded": self.degraded, "in_lockstep": False}
            with self._bounded_op("stats all_gather"):
                self.send(_OP_STATS)
                rows = self._stats_gather()
        finally:
            self.lock.release()
        per_proc = [{"process": int(r[0]), "dispatches": int(r[1]), "warmups": int(r[2]),
                     "local_devices": int(r[3])} for r in rows]
        return {**base, "per_process": per_proc,
                "in_lockstep": len({p["dispatches"] for p in per_proc}) == 1}

    def shutdown_followers(self) -> None:
        """Process 0: release every ``follower_serve`` loop. On a degraded
        fleet the broadcast would hang, so only the heartbeat channel
        closes."""
        if self._hb is not None:
            # first: a follower that exits on the shutdown op is not a death
            self._hb.quiesce()
        if self.degraded is None and self.lock.acquire(timeout=5.0):
            try:
                if self.degraded is None:
                    self.send(_OP_SHUTDOWN)
            finally:
                self.lock.release()
        if self._hb is not None:
            self._hb.close()


class BroadcastSynthesizer:
    """The engine's synthesizer on process 0: the ``Synthesizer`` calls the
    engine and ``serve_http`` make (``estimate_bucket``,
    ``synthesize_requests``, ``synthesize_stream``, ``warmup``), each call
    that reaches the device broadcast first so the followers join it."""

    def __init__(self, dispatch: MultiHostDispatch):
        self._d = dispatch
        self.synth = dispatch.synth
        self._entropy = np.random.default_rng()

    @property
    def mel_cfg(self):  # read by infer/pipeline.py:dispatch_warmup
        return self.synth.mel_cfg

    def estimate_bucket(self, *args, **kwargs) -> int:  # host only: no broadcast
        return self.synth.estimate_bucket(*args, **kwargs)

    def warmup(self, cfg, **kwargs) -> int:
        payload = pickle.dumps((cfg, kwargs))
        with self._d.lock, self._d._bounded_op("warmup"):
            self._d.send(_OP_WARMUP, payload)
            self._d.warmups += 1
            return self.synth.warmup(cfg, **kwargs)

    def synthesize_requests(self, requests, cfg) -> List:
        # seeds before the broadcast: an unseeded row would draw each
        # process's own entropy, and the processes would sample other noise
        reqs = []
        for r in requests:
            r = dict(r)
            if r.get("seed") is None:
                r["seed"] = int(self._entropy.integers(2 ** 31 - 1))
            reqs.append(r)
        payload = pickle.dumps((reqs, cfg))
        # the watchdog covers the broadcast and the compute: a follower that
        # dies mid-call hangs the mesh's collectives too
        with self._d.lock, self._d._bounded_op("dispatch"):
            self._d.send(_OP_DISPATCH, payload)
            self._d.dispatches += 1
            return self.synth.synthesize_requests(reqs, cfg=cfg)

    def synthesize_stream(self, ref_wav, ref_sr, ref_text_units, gen_chunks, cfg, seed=None,
                          chunk_batch: int = 2, first_chunk_batch: Optional[int] = None,
                          first_chunk_cfg=None):
        """``Synthesizer.synthesize_stream`` over the fleet: each mini-batch
        is a dispatch op (the sampler and the decode, joined by every
        process) and a finalize op, the seed fixed before the first
        broadcast, the mini-batches from the shared ``_stream_plan``."""
        synth, d = self.synth, self._d
        gen_chunks = list(gen_chunks)
        if not gen_chunks:
            return
        if seed is None:
            seed = int(self._entropy.integers(2 ** 31 - 1))
        with d.lock:
            d._stream_seq += 1
            sid = d._stream_seq
        plan = synth._stream_plan(len(gen_chunks), cfg, chunk_batch, first_chunk_batch,
                                  first_chunk_cfg)
        ref_prep = synth._prepare_ref(ref_wav, ref_sr, cfg)  # host prep, once a stream

        def finalize(p):
            with d.lock, d._bounded_op("stream finalize"):
                d.send(_OP_STREAM_FINALIZE, pickle.dumps(sid))
                return synth._finalize_chunks(p[0], p[1], return_parts=True)

        pending = None
        try:
            for start, size, bcfg in plan:
                batch = list(gen_chunks[start:start + size])
                payload = pickle.dumps((sid, ref_wav, ref_sr, ref_text_units, batch, bcfg, cfg,
                                        seed))
                with d.lock, d._bounded_op("stream dispatch"):
                    d.send(_OP_STREAM_DISPATCH, payload)
                    d.dispatches += 1
                    nxt = (synth._dispatch_chunks(ref_wav, ref_sr, ref_text_units, batch,
                                                  cfg=bcfg, seed=seed, ref_prep=ref_prep), bcfg)
                    synth._start_fetch(nxt[0])
                if pending is not None:
                    waves, sr, _ = finalize(pending)
                    pending = None
                    for w in waves:
                        yield w, sr
                pending = nxt
            waves, sr, _ = finalize(pending)
            pending = None
            for w in waves:
                yield w, sr
        finally:
            # the close frees the followers' stream state, also when the
            # client leaves; on a degraded fleet the fast failure is swallowed
            with contextlib.suppress(Exception):
                with d.lock, d._bounded_op("stream close"):
                    d.send(_OP_STREAM_CLOSE, pickle.dumps(sid))


def follower_serve(dispatch: MultiHostDispatch) -> Dict[str, int]:
    """Run on every process but 0: join each broadcast operation until the
    shutdown op. Returns the final counters."""
    synth = dispatch.synth
    streams: Dict[int, Dict[str, Any]] = {}  # sid -> reference prep, pending mini-batches
    while True:
        op, payload = dispatch.recv()
        if op == _OP_SHUTDOWN:
            # a clean shutdown: the closing heartbeat connection is no lost leader
            dispatch._hb_stop.set()
            return {"dispatches": dispatch.dispatches, "warmups": dispatch.warmups}
        if op == _OP_DISPATCH:
            reqs, cfg = pickle.loads(payload)
            dispatch.dispatches += 1
            synth.synthesize_requests(reqs, cfg=cfg)  # same call, same collectives
        elif op == _OP_WARMUP:
            cfg, kwargs = pickle.loads(payload)
            dispatch.warmups += 1
            synth.warmup(cfg, **kwargs)
        elif op == _OP_STATS:
            dispatch._stats_gather()
        elif op == _OP_STREAM_DISPATCH:
            sid, ref_wav, ref_sr, ref_units, chunks, bcfg, prep_cfg, seed = pickle.loads(payload)
            st = streams.setdefault(sid, {"prep": None, "pending": deque()})
            if st["prep"] is None:
                st["prep"] = synth._prepare_ref(ref_wav, ref_sr, prep_cfg)
            dispatch.dispatches += 1
            st["pending"].append((synth._dispatch_chunks(ref_wav, ref_sr, ref_units, chunks,
                                                         cfg=bcfg, seed=seed,
                                                         ref_prep=st["prep"]), bcfg))
            synth._start_fetch(st["pending"][-1][0])
        elif op == _OP_STREAM_FINALIZE:
            p, bcfg = streams[pickle.loads(payload)]["pending"].popleft()
            synth._finalize_chunks(p, bcfg, return_parts=True)
        elif op == _OP_STREAM_CLOSE:
            streams.pop(pickle.loads(payload), None)
        else:  # a protocol fault must fail loudly, not desynchronise
            raise RuntimeError(f"unknown multihost serving op {op}")
