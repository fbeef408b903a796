"""HTTP serving endpoint on the continuous-batching engine (counterpart of
``lemas_tts_tpu/scripts/serve_http.py``). Standard library only: a threaded
``http.server`` whose request threads wait on engine futures while the
engine's one worker thread drives the card.

Endpoints:
  POST /tts     JSON {"ref_b64": <base64 WAV> | "ref_path": <server-local
                path>, "ref_text": str, "text": str, "seed": int?} -> audio/wav.
                Optional per-request sampler overrides: "nfe_step",
                "cfg_strength", "sway_sampling_coef", "speed", "cfg_cutoff",
                "block_cache" ("lo-hi:every" or "0"), "ode_method"; the
                engine batches same-settings requests together.
                "queue_timeout_s": still queued past it -> shed, 504. A
                client that disconnects while queued cancels its request; one
                that half-closes its write side sends "half_close": true.
  POST /tts_stream  the same JSON (+ "max_chars", "chunk_batch",
                "first_chunk_chars", default 40, 0 off, "ttfb_nfe") ->
                chunked audio/L16 PCM, one HTTP chunk per text chunk as it
                completes, on the request thread
                (``Synthesizer.synthesize_stream``).
  GET  /healthz -> {"ok": true, "degraded": null, "queue_depth": N}; 503
                with "ok": false once the engine is degraded (a
                multi-process fleet lost a process)
  GET  /stats   -> engine stats JSON (queue depth, timers, latencies,
                recent batch sizes; under --multihost a "multihost" block:
                per-process dispatch counts, lockstep, heartbeats)
  GET  /config  -> the live serving defaults

Run: ``python -m lemas_tts_tpu_torch.scripts.serve_http --port 8080
--vocab_file vocab.txt`` (on CUDA; ``--device cpu`` serves on the CPU).
Defaults as in the JAX server: NFE 32, CFG 3, sway 1, CFG cutoff 0.5, block
cache "0-22:2+t2", int8 (``config.SERVING_*``); a distilled student's
checkpoint (``student.json``) pins its own settings instead, and ``/config``
reports the sidecar under ``student``.

``--multihost`` serves from every process of a ``torchrun`` job (one
process per GPU; ``--device cpu`` runs the job on gloo)::

    torchrun --nproc_per_node 8 -m lemas_tts_tpu_torch.scripts.serve_http --multihost ...

Every process builds the model on the job's ``("data", "model")`` mesh;
process 0 serves HTTP and broadcasts each batch (``serve/multihost.py``),
the others join every call in ``follower_serve``. Batches shard over the
processes. Without a configured job (torchrun's ``MASTER_ADDR``/
``MASTER_PORT``/``WORLD_SIZE``/``RANK``) it exits with a message.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import io
import json
import select
import socket
import sys
import threading
import time
import wave as wave_mod
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np


class HTTPServer(ThreadingHTTPServer):
    """A thread per connection, with room for a burst of connects: the
    standard library's listen backlog of 5 is less than one wave of
    ``--max_batch`` 8 clients, and a network stack that answers a connect
    past the backlog with a reset (not a retry) drops a request of the
    wave."""

    request_queue_size = 128


def _wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    pcm = (np.clip(np.asarray(wav, np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _decode_ref(payload: dict):
    """(mono wave [T] float32, sr) from ``ref_b64`` WAV bytes or a
    server-local ``ref_path``."""
    from lemas_tts_tpu_torch.native.audio import wav_decode
    from lemas_tts_tpu_torch.utils.audio_io import decode_wav, read_audio

    if payload.get("ref_b64"):
        raw = base64.b64decode(payload["ref_b64"])
        # the C++ codec, and the numpy decoder for what it does not take
        wav, sr = wav_decode(raw) or decode_wav(raw, "ref_b64")
    elif payload.get("ref_path"):
        wav, sr = read_audio(payload["ref_path"])
    else:
        raise ValueError("request needs ref_b64 or ref_path")
    return wav.mean(axis=0), sr


# per-request sampler overrides: name -> (SamplerConfig field, cast, (lo, hi)
# inclusive range or choices). Ranges and 3-decimal floats bound the number
# of distinct settings, each of which captures its own graphs.
_CFG_FIELDS = {
    "nfe_step": ("nfe_steps", int, (1, 256)),
    "nfe_steps": ("nfe_steps", int, (1, 256)),
    "cfg_strength": ("cfg_strength", float, (0.0, 20.0)),
    "sway_sampling_coef": ("sway_sampling_coef", float, (-20.0, 20.0)),
    "speed": ("speed", float, (0.1, 10.0)),
    "cfg_cutoff": ("cfg_cutoff", float, (0.0, 100.0)),
    "ode_method": ("ode_method", str, ("euler", "midpoint")),
    "block_cache": ("block_cache", str, None),
}


def _request_cfg(base, payload: dict):
    """``base`` with the payload's overrides, or None when it has none.
    Raises ValueError on a value out of range or aliases that disagree."""
    from lemas_tts_tpu_torch.cfm.sampler import parse_block_cache

    over = {}
    for key, (field_name, cast, rng) in _CFG_FIELDS.items():
        if key not in payload or payload[key] is None:
            continue
        try:
            v = cast(payload[key])
        except (TypeError, ValueError):
            raise ValueError(f"{key!r} must be {cast.__name__}")
        if key == "block_cache":
            parsed = parse_block_cache(v)  # raises on a malformed spec
            if parsed is not None:
                (_, hi), every, head, tail = parsed
                if hi > 64 or every > 8 or head > 64 or tail > 64:
                    raise ValueError("block_cache spec out of range")
            v = v if parsed is not None else None
        elif cast is str:
            if v not in rng:
                raise ValueError(f"{key!r} must be one of {rng}")
        else:
            lo, hi = rng
            if not (lo <= v <= hi):
                raise ValueError(f"{key!r} must be in [{lo}, {hi}]")
            if cast is float:
                v = round(v, 3)
        if field_name in over and over[field_name] != v:
            raise ValueError(f"conflicting values for {field_name!r} aliases")
        over[field_name] = v
    return dataclasses.replace(base, **over) if over else None


def make_handler(tts, engine, max_streams: int = 2, multihost=None):
    """The request handler over the shared TTS facade and engine;
    ``max_streams`` bounds concurrent /tts_stream requests (more get 503);
    ``multihost``, a ``serve.multihost.MultiHostDispatch``, adds its block
    to /stats."""
    from lemas_tts_tpu_torch.infer.pipeline import chunk_text
    from lemas_tts_tpu_torch.serve.engine import TTSRequest
    from lemas_tts_tpu_torch.utils.profiling import trace_record

    stream_slots = threading.BoundedSemaphore(max(1, max_streams))

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            engine.log.log("http", line=(fmt % args))

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj):
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def _payload(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("the request body must be a JSON object")
            return payload

        def _await_or_cancel(self, fut, timeout: float, watch_socket: bool = True):
            """Wait on the engine future, watching the client socket: a
            disconnect (EOF) while queued cancels the request. A future that
            failed with TimeoutError (shed) re-raises at once."""
            deadline = time.monotonic() + timeout
            while True:
                try:
                    return fut.result(timeout=0.25)
                except (FuturesTimeout, TimeoutError):
                    if fut.done():
                        return fut.result(timeout=0)
                    if time.monotonic() > deadline:
                        engine.cancel(fut)
                        raise
                if not watch_socket:
                    continue
                readable, _, _ = select.select([self.connection], [], [], 0)
                if readable:
                    try:
                        peek = self.connection.recv(1, socket.MSG_PEEK)
                    except OSError:
                        peek = b""
                    if peek == b"":
                        engine.cancel(fut)
                        raise ConnectionResetError("client disconnected while queued")

        def do_GET(self):
            if self.path == "/healthz":
                degraded = engine.stats()["degraded"]
                self._reply_json(503 if degraded else 200,
                                 {"ok": not degraded, "degraded": degraded,
                                  "queue_depth": engine.batcher.depth()})
            elif self.path == "/stats":
                stats = engine.stats()
                if multihost is not None:
                    stats["multihost"] = multihost.aggregated_stats()
                self._reply_json(200, stats)
            elif self.path == "/config":
                c = engine.cfg
                self._reply_json(200, {
                    "nfe_steps": c.nfe_steps, "cfg_strength": c.cfg_strength,
                    "sway_sampling_coef": c.sway_sampling_coef, "cfg_cutoff": c.cfg_cutoff,
                    "block_cache": c.block_cache, "ode_method": c.ode_method,
                    "quant": tts.quant, "max_batch": engine.batcher.max_batch,
                    "max_streams": max_streams, "student": tts.student,
                    "device": str(tts.device), "multihost": multihost is not None})
            else:
                self._reply_json(404, {"error": "not found"})

        def _stream_tts(self, payload):
            """Sets ``self._stream_headers_sent`` once the 200 is committed;
            after that an error can only abort the connection."""
            t0 = time.perf_counter()
            ref_wav, ref_sr = _decode_ref(payload)
            gen_text = payload.get("text", "")
            if not gen_text:
                raise ValueError("request needs non-empty 'text'")
            max_chars = max(1, int(payload.get("max_chars", 135)))
            chunks = [c for part in gen_text.split("\n")
                      for c in chunk_text(part, max_chars=max_chars)]
            # a short first chunk: the first sampler call lands in a small bucket
            fc_chars = int(payload.get("first_chunk_chars", 40))
            if fc_chars > 0 and chunks and len(chunks[0]) > fc_chars:
                chunks = chunk_text(chunks[0], max_chars=fc_chars) + chunks[1:]
            gen_units = [tts.prepare_units(c) for c in chunks]
            ref_units = tts.prepare_units(payload.get("ref_text", ""))
            cfg = _request_cfg(engine.cfg, payload) or engine.cfg
            engine.register_cfg(cfg)  # streams share the engine's settings cap
            first_cfg = None
            ttfb_nfe = payload.get("ttfb_nfe")
            if ttfb_nfe is not None:
                ttfb_nfe = int(ttfb_nfe)
                if not (1 <= ttfb_nfe <= 256):
                    raise ValueError("'ttfb_nfe' must be in [1, 256]")
                first_cfg = dataclasses.replace(cfg, nfe_steps=ttfb_nfe)
                engine.register_cfg(first_cfg)
            chunk_batch = max(1, int(payload.get("chunk_batch", 2)))
            stream = engine.synth.synthesize_stream(
                ref_wav, ref_sr, ref_units, gen_units, cfg=cfg, seed=payload.get("seed"),
                chunk_batch=chunk_batch, first_chunk_batch=1, first_chunk_cfg=first_cfg)
            # the first chunk before the 200: a synthesis error is still JSON
            first = next(stream, None)
            if first is None:
                raise ValueError("no synthesizable chunks in 'text'")
            ttfb = time.perf_counter() - t0
            engine.record_latency("stream_ttfb", ttfb)
            sr = int(first[1])
            self.send_response(200)
            self.send_header("Content-Type", f"audio/L16; rate={sr}; channels=1")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._stream_headers_sent = True

            def write_chunk(wav):
                pcm = (np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
                       * 32767.0).astype("<i2").tobytes()
                if pcm:
                    self.wfile.write(f"{len(pcm):X}\r\n".encode())
                    self.wfile.write(pcm + b"\r\n")
                    self.wfile.flush()

            n_chunks, outcome = 1, "aborted"
            try:
                write_chunk(first[0])
                for wav, _sr in stream:
                    write_chunk(wav)
                    n_chunks += 1
                self.wfile.write(b"0\r\n\r\n")
                outcome = "ok"
            finally:
                if engine.trace_requests:
                    trace_record(engine.log, "stream_trace", ttfb_ms=round(ttfb * 1e3, 2),
                                 n_chunks=n_chunks,
                                 total_ms=round((time.perf_counter() - t0) * 1e3, 2),
                                 chunk_batch=chunk_batch, outcome=outcome)

        def do_POST(self):
            if self.path == "/tts_stream":
                if not stream_slots.acquire(blocking=False):
                    self._reply_json(503, {"error": "stream capacity reached"})
                    return
                self._stream_headers_sent = False
                try:
                    self._stream_tts(self._payload())
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True  # client hung up mid-stream
                except Exception as e:
                    if self._stream_headers_sent:
                        # a second status line would corrupt the chunked body
                        engine.log.log("stream_aborted", error=str(e))
                        self.close_connection = True
                    else:  # settings cap -> 503, a bad request -> 400
                        self._reply_json(503 if isinstance(e, RuntimeError) else 400,
                                         {"error": str(e)})
                finally:
                    stream_slots.release()
                return
            if self.path != "/tts":
                self._reply_json(404, {"error": "not found"})
                return
            try:
                payload = self._payload()
                ref_wav, ref_sr = _decode_ref(payload)
                gen_text = payload.get("text", "")
                if not gen_text:
                    raise ValueError("request needs non-empty 'text'")
                half_close = payload.get("half_close", False)
                if not isinstance(half_close, bool):
                    raise ValueError("'half_close' must be a boolean")
                qt = payload.get("queue_timeout_s")
                fut = engine.submit(TTSRequest(
                    ref_wav=ref_wav, ref_sr=ref_sr,
                    ref_units=tts.prepare_units(payload.get("ref_text", "")),
                    gen_units=tts.prepare_units(gen_text), seed=payload.get("seed"),
                    cfg=_request_cfg(engine.cfg, payload),
                    timeout=float(qt) if qt is not None else None))
                wav, sr, _mel = self._await_or_cancel(
                    fut, timeout=float(payload.get("timeout_s", 300)),
                    watch_socket=not half_close)
                self._reply(200, _wav_bytes(wav, int(sr)), "audio/wav")
            except (FuturesTimeout, TimeoutError) as e:
                self._reply_json(504, {"error": f"synthesis timed out: {e}"})
            except CancelledError:
                self._reply_json(503, {"error": "request cancelled"})
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True  # client already gone
            except RuntimeError as e:  # queue full, settings cap: backpressure
                self._reply_json(503, {"error": str(e)})
            except Exception as e:
                self._reply_json(400, {"error": str(e)})

    return Handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HTTP TTS serving endpoint (PyTorch/CUDA).")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--model", type=str, default="multilingual")
    p.add_argument("--ckpt_file", type=str, default="")
    p.add_argument("--vocab_file", type=str, default="")
    p.add_argument("--frontend", type=str, default="phone", choices=["phone", "char", "none"])
    p.add_argument("--nfe_step", type=int, default=32)
    p.add_argument("--cfg_strength", type=float, default=3.0)
    p.add_argument("--sway_sampling_coef", type=float, default=1.0)
    p.add_argument("--cfg_cutoff", type=float, default=-1.0,
                   help="CFG truncation threshold; <0 uses the serving default "
                        "(config.SERVING_CFG_CUTOFF), 0 disables it.")
    p.add_argument("--block_cache", type=str, default="default",
                   help="Block-range residual cache spec 'lo-hi:every'; 'default' is "
                        "config.SERVING_BLOCK_CACHE, '0' disables it.")
    p.add_argument("--quant", type=str, default="default",
                   help="DiT W8A8 quantization: 'default' is config.SERVING_QUANT (int8), "
                        "'int8' / 'int8_ff' explicit, 'none' float.")
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--max_wait_ms", type=float, default=15.0,
                   help="How long a non-full batch waits for more requests, from its "
                        "first request's arrival.")
    p.add_argument("--max_streams", type=int, default=2,
                   help="Concurrent /tts_stream requests (more get 503).")
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--warmup_batches", default="",
                   help="Comma list of batch sizes (or 'auto': every batch bucket up to the "
                        "one --max_batch pads to) to warm through the request path at start, "
                        "per --warmup_durations bucket (infer/pipeline.py:dispatch_warmup).")
    p.add_argument("--warmup_durations", default="1024",
                   help="Comma list of duration buckets for --warmup_batches.")
    p.add_argument("--trace_requests", action="store_true",
                   help="One request_trace/stream_trace JSON record per request "
                        "(utils/profiling.py schema: queue_wait_ms, batch_ms, total_ms); also "
                        "LEMAS_REQUEST_TRACE=1. Stage walls are always in /stats['timers'] "
                        "(serve.batch, synth.request, synth.prep, synth.sample, synth.vocode, "
                        "synth.fetch, synth.finish, graph.capture); under any torch.profiler "
                        "session (utils/profiling.py:profile_card) they are ranges on the "
                        "card's timeline.")
    p.add_argument("--device", type=str, default=None,
                   help="cuda | cpu (default: cuda; never falls back to the CPU).")
    p.add_argument("--multihost", action="store_true",
                   help="Multi-process serving under torchrun (serve/multihost.py): batches "
                        "shard over every process's device; process 0 serves HTTP.")
    return p


def sampler_config_from_args(args):
    """The server's default SamplerConfig: ``--cfg_cutoff`` < 0 is
    ``config.SERVING_CFG_CUTOFF`` and 0 turns truncation off; ``--block_cache
    default`` is ``config.SERVING_BLOCK_CACHE``."""
    from lemas_tts_tpu_torch.cfm.sampler import parse_block_cache
    from lemas_tts_tpu_torch.config import (SERVING_BLOCK_CACHE, SERVING_CFG_CUTOFF,
                                            SamplerConfig)

    cutoff = args.cfg_cutoff
    bc = args.block_cache
    if bc == "default":
        bc = SERVING_BLOCK_CACHE
    bc = bc if parse_block_cache(bc) is not None else None  # validates, or off
    return SamplerConfig(nfe_steps=args.nfe_step, cfg_strength=args.cfg_strength,
                         sway_sampling_coef=args.sway_sampling_coef,
                         cfg_cutoff=SERVING_CFG_CUTOFF if cutoff < 0 else (cutoff or None),
                         block_cache=bc)


def warmup_batches(args) -> tuple:
    """The batch buckets ``--warmup_batches`` asks for; ``auto`` is every
    bucket up to the one ``--max_batch`` pads to."""
    from lemas_tts_tpu_torch.infer.pipeline import BATCH_BUCKETS, pick_bucket

    if args.warmup_batches.strip().lower() == "auto":
        top = pick_bucket(args.max_batch, BATCH_BUCKETS)
        return tuple(b for b in BATCH_BUCKETS if b <= top)
    return tuple(int(x) for x in args.warmup_batches.split(","))


def serve(args, *, ready_event: Optional[threading.Event] = None,
          server_box: Optional[list] = None) -> Optional[dict]:
    """Build the model and the engine, then serve until shut down.
    ``ready_event``/``server_box`` let a caller start and stop the server
    from another thread. A ``--multihost`` follower returns its counters
    (``follower_serve``) once process 0 shuts down."""
    from lemas_tts_tpu_torch.api import TTS
    from lemas_tts_tpu_torch.cfm.sampler import DURATION_BUCKETS, pick_bucket
    from lemas_tts_tpu_torch.config import resolve_quant
    from lemas_tts_tpu_torch.infer.pipeline import dispatch_warmup
    from lemas_tts_tpu_torch.serve.engine import ServingEngine

    # multi-process serving: every process builds the same model over the
    # job's mesh; process 0 serves HTTP, the others join each broadcast call
    mesh = dispatch = None
    if args.multihost:
        from lemas_tts_tpu_torch.parallel.distributed import initialize
        from lemas_tts_tpu_torch.parallel.mesh import make_mesh

        if not initialize(device_type=args.device):
            raise SystemExit("--multihost needs a configured multi-process job: run under "
                             "torchrun (it sets MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK)")
        mesh = make_mesh(device_type=args.device)
    qv = args.quant
    quant = resolve_quant(qv)
    kwargs = dict(model=args.model, ckpt_file=args.ckpt_file, vocab_file=args.vocab_file,
                  frontend=None if args.frontend == "none" else args.frontend,
                  device=args.device, mesh=mesh)
    try:
        tts = TTS(quantization=quant, **kwargs)
    except ValueError as e:
        # only the serving default on a backbone without int8 falls back to float
        if quant is None or qv != "default" or "quantization is only supported" not in str(e):
            raise
        print("[serve_http] backbone does not support quantization — serving float")
        tts = TTS(**kwargs)
    cfg = sampler_config_from_args(args)
    if tts.student:
        # a distilled student: the server's defaults pin its settings (steps=K,
        # cfg 0); per-request overrides still work, off its training grid
        cfg = tts.apply_student_settings(cfg, show_info=print)
    synth = tts.synth
    if mesh is not None:
        import torch.distributed as dist

        from lemas_tts_tpu_torch.serve.multihost import (BroadcastSynthesizer,
                                                         MultiHostDispatch, follower_serve)

        dispatch = MultiHostDispatch(tts.synth)
        if dist.get_rank() != 0:
            print(f"[serve_http] follower process {dist.get_rank()}/{dist.get_world_size()} "
                  "joining dispatches", flush=True)
            return follower_serve(dispatch)
        synth = BroadcastSynthesizer(dispatch)
    if not args.no_warmup:
        print(f"[serve_http] warmup: {synth.warmup(cfg)} sampler graphs captured")
    if args.warmup_batches:
        dd = tuple(pick_bucket(int(x), DURATION_BUCKETS)
                   for x in args.warmup_durations.split(","))
        n = dispatch_warmup(synth, cfg, duration_buckets=dd, batch_buckets=warmup_batches(args))
        print(f"[serve_http] dispatch-path warmup: {n} dispatches")
    engine = ServingEngine(synth, cfg=cfg, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms,
                           trace_requests=True if args.trace_requests else None)
    if dispatch is not None:
        # a follower's death poisons the engine: its futures fail, requests get 503
        dispatch.on_degraded.append(engine.poison)
    httpd = HTTPServer((args.host, args.port),
                       make_handler(tts, engine, max_streams=args.max_streams,
                                    multihost=dispatch))
    if server_box is not None:
        server_box.append((httpd, engine))
    print(f"[serve_http] listening on {args.host}:{httpd.server_address[1]}", flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        engine.shutdown()
        if dispatch is not None:
            dispatch.shutdown_followers()
    return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    serve(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
