"""Serving latency probe: request-latency percentiles under load
(counterpart of ``lemas_tts_tpu/scripts/latency_probe.py``).

Drives a live ``ServingEngine`` (the runtime ``serve_http`` mounts) with a
closed loop (one request at a time: the single-stream floor) or an open
loop (Poisson arrivals at ``--qps`` for ``--secs``, requests the engine
refuses counted as shed), and prints p50/p90/p99 submit -> result per
request and the aggregate real-time factor. ``--stream N`` measures the
first-chunk time and steady rate of ``Synthesizer.synthesize_stream``
against a serial per-mini-batch loop and one batched call;
``--loaded_ttfb`` mixes Poisson batched traffic with ``--loaded_streams``
concurrent streams (the ``serve_http`` stream cap) and reports stream TTFB
p50/p99 beside batched p50/p99.

Latencies are host wall times of requests (what a client waits), each
ending when its result is on the host. Before measuring, the probe warms
every (duration, batch, text) bucket its request mix can land in through
the dispatch path itself, so no CUDA graph capture lands inside the
percentiles. The last line is one JSON record of the run.

    python -m lemas_tts_tpu_torch.scripts.latency_probe --nfe 32 --qps 2 --secs 30
    python -m lemas_tts_tpu_torch.scripts.latency_probe --loaded_ttfb --qps 1 --secs 10
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time

import numpy as np

from lemas_tts_tpu_torch.scripts._probe_common import add_device_arg

TEXTS = (
    "i have been a silent spectator, watching species evolve.",
    "the quick brown fox jumps over the lazy dog near the river bank.",
    "synthesis latency is measured from submit to result future.",
    "a shorter request.",
)
REF_TEXT = "some call me nature, others call me mother nature."
REF_SECONDS = 4.0  # the synthetic reference's length


def _percentiles(xs):
    # the engine's nearest-rank formula: the probe's table and the engine's
    # /stats table must not differ by their rank rule
    from lemas_tts_tpu_torch.serve.engine import ServingEngine

    return ServingEngine._percentiles(xs)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="multilingual")
    p.add_argument("--ckpt", default="", help="checkpoint (blank: random init)")
    p.add_argument("--vocab", default="", help="vocab.txt (blank: byte tokenizer)")
    p.add_argument("--quant", default="default",
                   help="'default' = config.SERVING_QUANT (as serve_http), 'int8' explicit, "
                        "'none' = float")
    p.add_argument("--nfe", type=int, default=32)
    p.add_argument("--cfg_strength", type=float, default=2.0)
    p.add_argument("--cfg_cutoff", type=float, default=-1.0,
                   help="CFG truncation; <0 = serving default (config.SERVING_CFG_CUTOFF), "
                        "0 = exact full CFG")
    p.add_argument("--block_cache", type=str, default="default",
                   help="block-cache spec 'lo-hi:every[+hN][+tN]'; 'default' = "
                        "config.SERVING_BLOCK_CACHE, '0' = off")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--qps", type=float, default=0.0,
                   help="open-loop arrival rate; 0 = closed loop (B=1 floor)")
    p.add_argument("--stream", type=int, default=0,
                   help="stream-mode probe: this many text chunks through "
                        "Synthesizer.synthesize_stream, TTFB and steady-state RTF against the "
                        "serial and fully-batched paths (0 = off; ignores --qps/--requests)")
    p.add_argument("--chunk_batch", type=int, default=2,
                   help="stream-mode mini-batch size (chunks per sampler call)")
    p.add_argument("--ttfb_nfe", type=int, default=0,
                   help="stream-mode first-chunk NFE ramp (0 = same NFE as --nfe)")
    p.add_argument("--first_chunk_chars", type=int, default=40,
                   help="re-split chunk 0 to this many chars (0 disables the re-split)")
    p.add_argument("--secs", type=float, default=30.0, help="measurement window (open loop)")
    p.add_argument("--requests", type=int, default=16, help="request count (closed loop)")
    p.add_argument("--loaded_ttfb", action="store_true",
                   help="loaded-TTFB probe: open-loop Poisson batched traffic at --qps with "
                        "--loaded_streams concurrent streams; stream TTFB p50/p99 next to "
                        "batched p50/p99")
    p.add_argument("--loaded_streams", type=int, default=2,
                   help="concurrent stream clients in --loaded_ttfb mode (serve_http "
                        "--max_streams default: 2)")
    p.add_argument("--stream_think", type=float, default=0.0,
                   help="mean exponential think time (s) between a stream worker's streams "
                        "in --loaded_ttfb mode; 0 = back to back")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    return p


def warm_buckets(synth, ref, sr, ref_units, gen_units, cfg, max_batch: int) -> list:
    """Warm, through ``synth.synthesize_requests`` itself, every (duration
    bucket, text bucket) that ``gen_units`` land in at every batch bucket up
    to the one a full ``max_batch`` collection pads into (the engine batches
    by duration bucket only, so a batch's text bucket varies with its mix).
    Returns the warmed ``(duration, text, batch)`` buckets."""
    from lemas_tts_tpu_torch.infer.pipeline import BATCH_BUCKETS, TEXT_BUCKETS, pick_bucket
    from lemas_tts_tpu_torch.utils.vocab import text_to_ids

    rep_by_bucket = {}
    for i, g in enumerate(gen_units):
        b = synth.estimate_bucket(ref, sr, ref_units, g, cfg)
        full = ref_units + g if isinstance(g, str) else list(ref_units) + list(g)
        nt = pick_bucket(len(text_to_ids(full, synth.vocab)), TEXT_BUCKETS)
        rep_by_bucket.setdefault((b, nt), i)
    top = pick_bucket(max_batch, BATCH_BUCKETS)
    warmed = []
    for (b, nt), i in sorted(rep_by_bucket.items()):
        for k in (k for k in BATCH_BUCKETS if k <= top):
            synth.synthesize_requests(
                [dict(ref_wav=ref, ref_sr=sr, ref_units=ref_units, gen_units=gen_units[i],
                      seed=j) for j in range(k)], cfg=cfg)
            warmed.append((b, nt, k))
    return warmed


def _stream_probe(tts, ref, sr, ref_units, gen_units, cfg, args) -> dict:
    """TTFB and steady-state RTF of the double-buffered ``synthesize_stream``
    against (a) a serial per-mini-batch loop and (b) one fully-batched
    ``synthesize_chunks`` call over all chunks."""
    from lemas_tts_tpu_torch.infer.pipeline import chunk_text

    chunks = [gen_units[i % len(gen_units)] for i in range(args.stream)]
    synth, cb = tts.synth, max(1, args.chunk_batch)

    def timed_stream(chs, **kw):
        marks, audio = [], []
        t0 = time.perf_counter()
        for wave, wsr in synth.synthesize_stream(ref, sr, ref_units, chs, cfg=cfg,
                                                 seed=args.seed, chunk_batch=cb, **kw):
            marks.append(time.perf_counter() - t0)
            audio.append(wave.shape[-1] / wsr)
        return marks, audio

    def run_serial():
        marks, audio = [], []
        t0 = time.perf_counter()
        for i in range(0, len(chunks), cb):
            waves, wsr, _ = synth.synthesize_chunks(ref, sr, ref_units, chunks[i:i + cb],
                                                    cfg=cfg, seed=args.seed, return_parts=True)
            for w in waves:
                marks.append(time.perf_counter() - t0)
                audio.append(w.shape[-1] / wsr)
        return marks, audio

    def run_batched():
        t0 = time.perf_counter()
        waves, wsr, _ = synth.synthesize_chunks(ref, sr, ref_units, chunks, cfg=cfg,
                                                seed=args.seed, return_parts=True)
        return time.perf_counter() - t0, sum(w.shape[-1] / wsr for w in waves)

    # the ttfb-optimised stream (serve_http's /tts_stream defaults): the first
    # mini-batch is one short chunk in its own small bucket, optionally at a lower NFE
    fcfg = dataclasses.replace(cfg, nfe_steps=args.ttfb_nfe) if args.ttfb_nfe else None
    tchunks = list(chunks)
    if (args.first_chunk_chars > 0 and isinstance(tchunks[0], str)
            and len(tchunks[0]) > args.first_chunk_chars):
        tchunks = chunk_text(tchunks[0], max_chars=args.first_chunk_chars) + tchunks[1:]
    ttfb_kw = dict(first_chunk_batch=1, first_chunk_cfg=fcfg)

    def report(tag, marks, audio):
        total, wall = sum(audio), marks[-1]
        k = min(cb, len(audio))  # steady state leaves out the first mini-batch
        steady = (sum(audio[k:]) / (wall - marks[k - 1]) if len(audio) > k else float("nan"))
        print(f"[stream] {tag}: ttfb={marks[0]:.3f}s total={total:.1f}s audio in "
              f"{wall:.2f}s = {total / wall:.1f}x RT (steady-state {steady:.1f}x)")
        return {"ttfb_s": round(marks[0], 4), "rtf_x": round(total / wall, 3)}

    print(f"[stream] {len(chunks)} chunks, chunk_batch={cb}, nfe={args.nfe}, "
          f"block_cache={cfg.block_cache!r}, cfg_cutoff={cfg.cfg_cutoff!r}, "
          f"ttfb_nfe={args.ttfb_nfe or args.nfe}")
    print("[stream] warming buckets ...", flush=True)
    timed_stream(chunks)            # every (duration bucket, chunk_batch) graph
    timed_stream(tchunks, **ttfb_kw)  # the B = 1 first-chunk bucket (+ the NFE ramp)
    run_batched()                   # the full-batch bucket of the one-call path
    rec = {"stream_ttfb_optimized": report("stream (ttfb-optimized) ",
                                           *timed_stream(tchunks, **ttfb_kw)),
           "stream": report("stream (double-buffered)", *timed_stream(chunks)),
           "serial": report("serial  (per mini-batch)", *run_serial())}
    wall, total = run_batched()
    print(f"[stream] batched (one call)  : total={total:.1f}s audio in {wall:.2f}s = "
          f"{total / wall:.1f}x RT")
    rec["batched"] = {"rtf_x": round(total / wall, 3)}
    return rec


def _loaded_ttfb_probe(tts, ref, sr, ref_units, gen_units, texts, cfg, args) -> dict:
    """TTFB under load: an open-loop Poisson batched workload drives the
    ``ServingEngine`` at ``--qps`` while ``--loaded_streams`` clients run
    ``serve_http``-like streams (B = 1 first bucket, optional ``--ttfb_nfe``
    ramp) back to back on their own threads. Reports stream TTFB and batched
    latency percentiles side by side."""
    from lemas_tts_tpu_torch.infer.pipeline import chunk_text
    from lemas_tts_tpu_torch.serve.engine import ServingEngine, TTSRequest

    synth = tts.synth
    eng = ServingEngine(synth, cfg=cfg, max_batch=args.max_batch)
    chunks = chunk_text(" ".join(texts), max_chars=60)
    fc = args.first_chunk_chars
    if fc > 0 and len(chunks[0]) > fc:
        chunks = chunk_text(chunks[0], max_chars=fc) + chunks[1:]
    s_units = [tts.prepare_units(c) for c in chunks]
    fcfg = dataclasses.replace(cfg, nfe_steps=args.ttfb_nfe) if args.ttfb_nfe else None
    cb = max(1, args.chunk_batch)

    def make_req(i):
        return TTSRequest(ref_wav=ref, ref_sr=sr, ref_units=ref_units,
                          gen_units=gen_units[i % len(gen_units)], seed=args.seed + i)

    def one_stream(seed):
        t0 = time.perf_counter()
        gen = synth.synthesize_stream(ref, sr, ref_units, s_units, cfg=cfg, seed=seed,
                                      chunk_batch=cb, first_chunk_batch=1, first_chunk_cfg=fcfg)
        next(gen, None)
        ttfb = time.perf_counter() - t0
        for _ in gen:  # drain: streams occupy the card like real clients
            pass
        return ttfb

    try:
        warmed = warm_buckets(synth, ref, sr, ref_units, gen_units, cfg, args.max_batch)
        print(f"[loaded] warmed (duration, text, batch) buckets {warmed} through the "
              "dispatch path", flush=True)
        for i in range(len(gen_units)):  # every text through the engine
            eng.submit(make_req(i)).result(timeout=1800)
        one_stream(args.seed)  # the stream buckets, the B = 1 first chunk included

        stop = threading.Event()
        lock = threading.Lock()
        batched, ttfbs, shed = [], [], [0]

        def stream_worker(wid):
            s = args.seed + 1000 * (wid + 1)
            srng = np.random.default_rng(args.seed + wid)
            while not stop.is_set():
                ttfb = one_stream(s)
                s += 1
                with lock:
                    ttfbs.append(ttfb)
                if args.stream_think > 0:
                    stop.wait(float(srng.exponential(args.stream_think)))

        def fire(i):
            t0 = time.perf_counter()
            try:
                eng.submit(make_req(i)).result(timeout=600)
            except RuntimeError:
                with lock:
                    shed[0] += 1
                return
            with lock:
                batched.append(time.perf_counter() - t0)

        workers = [threading.Thread(target=stream_worker, args=(w,), daemon=True)
                   for w in range(max(1, args.loaded_streams))]
        for w in workers:
            w.start()
        print(f"[loaded] {args.loaded_streams} streams + Poisson {args.qps} req/s for "
              f"{args.secs}s", flush=True)
        rng = np.random.default_rng(args.seed)
        firers, i = [], 0
        t_end = time.time() + args.secs
        while time.time() < t_end:
            th = threading.Thread(target=fire, args=(i,), daemon=True)
            th.start()
            firers.append(th)
            i += 1
            time.sleep(float(rng.exponential(1.0 / max(args.qps, 1e-9))))
        stop.set()
        for th in firers + workers:
            th.join(timeout=600)
        rec = {"mode": "loaded_ttfb", "qps": args.qps, "secs": args.secs,
               "streams": args.loaded_streams, "fired": i, "shed": shed[0],
               "stream_ttfb": _percentiles(ttfbs) if ttfbs else None,
               "batched": _percentiles(batched) if batched else None}
        if ttfbs:
            ps = rec["stream_ttfb"]
            print(f"[loaded] stream TTFB ms: p50={ps['p50_ms']:.0f} p90={ps['p90_ms']:.0f} "
                  f"p99={ps['p99_ms']:.0f} max={ps['max_ms']:.0f} (n={ps['count']})")
        if batched:
            pb = rec["batched"]
            print(f"[loaded] batched ms:     p50={pb['p50_ms']:.0f} p90={pb['p90_ms']:.0f} "
                  f"p99={pb['p99_ms']:.0f} max={pb['max_ms']:.0f} (n={pb['count']}, "
                  f"shed={shed[0]})")
        print(f"[loaded] engine stats: {eng.stats()['latency']}")
    finally:
        eng.shutdown()
    return rec


def _engine_probe(tts, ref, sr, ref_units, gen_units, cfg, args) -> dict:
    """The closed loop (``--qps 0``) or the open Poisson loop."""
    from lemas_tts_tpu_torch.serve.engine import ServingEngine, TTSRequest

    eng = ServingEngine(tts.synth, cfg=cfg, max_batch=args.max_batch)

    def make_req(i):
        return TTSRequest(ref_wav=ref, ref_sr=sr, ref_units=ref_units,
                          gen_units=gen_units[i % len(gen_units)], seed=args.seed + i)

    try:
        # every (duration, text) bucket of the mix, at batch 1 for the closed
        # loop and at every batch bucket an open-loop collection can fill
        print("[latency] warming buckets ...", flush=True)
        warm_buckets(tts.synth, ref, sr, ref_units, gen_units, cfg,
                     args.max_batch if args.qps > 0 else 1)
        for i in range(len(gen_units)):
            eng.submit(make_req(i)).result(timeout=1800)

        lat, audio_s, shed = [], [], 0
        t_start = time.time()
        if args.qps <= 0:
            print(f"[latency] closed loop: {args.requests} requests")
            for i in range(args.requests):
                t0 = time.perf_counter()
                out = eng.submit(make_req(i)).result(timeout=600)
                lat.append(time.perf_counter() - t0)
                audio_s.append(np.asarray(out[0]).shape[-1] / sr)
        else:
            print(f"[latency] open loop: {args.qps} req/s for {args.secs}s")
            rng = np.random.default_rng(args.seed)
            done = []
            lock = threading.Lock()

            def fire(i):
                t0 = time.perf_counter()
                try:
                    out = eng.submit(make_req(i)).result(timeout=600)
                except RuntimeError:  # queue full: shed load
                    with lock:
                        done.append((None, 0.0))
                    return
                with lock:
                    done.append((time.perf_counter() - t0, np.asarray(out[0]).shape[-1] / sr))

            threads, i = [], 0
            t_end = time.time() + args.secs
            while time.time() < t_end:
                th = threading.Thread(target=fire, args=(i,), daemon=True)
                th.start()
                threads.append(th)
                i += 1
                time.sleep(float(rng.exponential(1.0 / args.qps)))
            for th in threads:
                th.join(timeout=600)
            shed = sum(1 for d in done if d[0] is None)
            lat = [d[0] for d in done if d[0] is not None]
            audio_s = [d[1] for d in done if d[0] is not None]
            if shed:
                print(f"[latency] shed (queue full): {shed}")
        wall = time.time() - t_start
        rec = {"mode": "closed" if args.qps <= 0 else "open", "qps": args.qps, "shed": shed,
               "latency": _percentiles(lat) if lat else None,
               "audio_s": round(sum(audio_s), 3), "wall_s": round(wall, 3),
               "rtf_x": round(sum(audio_s) / max(wall, 1e-9), 3)}
        if lat:
            pct = rec["latency"]
            print(f"[latency] latency ms: p50={pct['p50_ms']:.0f} p90={pct['p90_ms']:.0f} "
                  f"p99={pct['p99_ms']:.0f} max={pct['max_ms']:.0f} (n={pct['count']})")
        else:
            print("[latency] no completed requests — nothing to report")
        print(f"[latency] aggregate: {sum(audio_s):.1f}s audio in {wall:.1f}s = "
              f"{rec['rtf_x']:.1f}x RT")
        print(f"[latency] engine stats: {eng.stats()['latency']}")
    finally:
        eng.shutdown()
    return rec


def run(args, tts=None) -> dict:
    """The probe of ``args``' mode on ``tts`` (default: a ``TTS`` built from
    ``--model/--ckpt/--vocab/--quant/--device``); returns its record."""
    from lemas_tts_tpu_torch.cfm.sampler import parse_block_cache
    from lemas_tts_tpu_torch.config import (SERVING_BLOCK_CACHE, SERVING_CFG_CUTOFF,
                                            SamplerConfig, resolve_quant)

    if tts is None:
        from lemas_tts_tpu_torch import TTS

        tts = TTS(model=args.model, ckpt_file=args.ckpt, vocab_file=args.vocab,
                  quantization=resolve_quant(args.quant), device=args.device)
    sr = tts.target_sample_rate
    t = np.arange(int(REF_SECONDS * sr)) / sr
    ref = (0.3 * np.sin(2 * np.pi * 220 * t)
           * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    ref_units = tts.prepare_units(REF_TEXT)
    gen_units = [tts.prepare_units(s) for s in TEXTS]

    cutoff = SERVING_CFG_CUTOFF if args.cfg_cutoff < 0 else (args.cfg_cutoff or None)
    bc = SERVING_BLOCK_CACHE if args.block_cache == "default" else args.block_cache
    bc = bc if parse_block_cache(bc) is not None else None
    cfg = SamplerConfig(nfe_steps=args.nfe, cfg_strength=args.cfg_strength, cfg_cutoff=cutoff,
                        block_cache=bc)
    if args.loaded_ttfb:
        rec = _loaded_ttfb_probe(tts, ref, sr, ref_units, gen_units, TEXTS, cfg, args)
    elif args.stream > 0:
        rec = _stream_probe(tts, ref, sr, ref_units, gen_units, cfg, args)
    else:
        rec = _engine_probe(tts, ref, sr, ref_units, gen_units, cfg, args)
    rec = {"latency_probe": rec, "device": str(tts.device)}
    print(json.dumps(rec))
    return rec


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
