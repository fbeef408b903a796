#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, in order (any failure raises; the exit code is then non-zero):
  1. card: CUDA present, name and power limit from nvidia-smi, TF32 off;
  2. build: the kernels of ``lemas_tts_tpu_torch/csrc`` with nvcc (sm_90a);
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the flagship widths, with times, the bound and the library yardstick;
  4. DiT: a depth-2 flagship-width DiT on the card (kernels) against the same
     weights on the CPU (plain path), in f32 and bf16;
  5. slice: ``TTS.infer`` at the flagship ``multilingual`` config with random
     weights, three requests (one warm, two timed), counting kernel launches.
The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Needs only torch, numpy and the CUDA
toolkit: no JAX, no yaml.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12  # dense tensor-core peak (data sheet, SXM, 700 W)
H100_F32_FLOPS = 67e12  # non-tensor-core f32 peak
H100_BYTES = 3.35e12  # HBM3 bandwidth
TOL_REL_L2 = {"bf16": 2e-2, "f32": 1e-4}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def rel_l2(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def max_abs(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def time_ms(fns, iters: int = 20) -> float:
    """Mean ms per call over ``iters`` calls cycling through ``fns`` (input
    sets that together exceed the 50 MB L2, as the DiT's per-block weights
    do), with CUDA events after two warm-up rounds."""
    import torch

    for f in fns * 2:
        f()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fns[i % len(fns)]()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple:
    t_bytes, t_ops = nbytes / H100_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- phases
def phase_card() -> dict:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: no GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave no answer"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] {card}  torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return {"card": card, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from lemas_tts_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    took = _cuda.build()
    print(f"[build] {len(took)} libraries in {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items()) or 'cached'})", flush=True)
    for name in _cuda.SIGNATURES:
        log = _cuda.BUILD / f"{name}.ptxas.txt"
        if log.is_file():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")


def _kernel_inputs(torch, rows, n, d, f, heads, dim_head, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def rn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)

    inner = heads * dim_head
    valid = torch.tensor([n - n // 8 * (i % 2) - 37 * (i % 3) for i in range(rows)], device=dev)
    mask = torch.arange(n, device=dev)[None, :] < valid[:, None]
    pos = torch.arange(n, device=dev, dtype=torch.float32)
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim_head, 2, device=dev, dtype=torch.float32)
                             / dim_head))
    return dict(
        x=rn(rows, n, d), scale=rn(rows, d, s=0.1), shift=rn(rows, d, s=0.1),
        gate=rn(rows, d), wq=rn(inner, d, s=d ** -0.5), bq=rn(inner, s=0.1),
        wk=rn(inner, d, s=d ** -0.5), bk=rn(inner, s=0.1), wv=rn(inner, d, s=d ** -0.5),
        bv=rn(inner, s=0.1), w1=rn(f, d, s=d ** -0.5), b1=rn(f, s=0.1),
        w2=rn(d, f, s=f ** -0.5), b2=rn(d, s=0.1), q=rn(rows, n, inner), k=rn(rows, n, inner),
        v=rn(rows, n, inner), mask=mask, angles=torch.outer(pos, inv).contiguous())


def phase_kernels() -> list:
    """Each kernel against its plain version on the card. Returns the
    records of the main-path shape (rows 2, N 1024, bf16) for the kernels
    line."""
    import torch
    import torch.nn.functional as F

    from lemas_tts_tpu_torch.ops import attention, ffn

    D, FF, H, DH = 1024, 2048, 16, 64
    records = {}
    cases = [("bf16", torch.bfloat16, rows, n, H, DH) for rows in (2, 16) for n in (1024, 4096)]
    cases += [("f32", torch.float32, 2, 1024, H, DH), ("bf16", torch.bfloat16, 2, 1024, 8, 128),
              ("f32", torch.float32, 2, 1024, 8, 128)]
    for tag, dtype, rows, n, heads, dh in cases:
        main_shape = tag == "bf16" and rows == 2 and n == 1024 and dh == 64
        sets = [_kernel_inputs(torch, rows, n, D, FF, heads, dh, dtype, seed)
                for seed in range(3 if main_shape else 1)]
        t = sets[0]
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
        esz = t["x"].element_size()
        inner = heads * dh
        results = []
        if dh == 64:
            args = lambda s: (s["x"], s["scale"], s["shift"], s["wq"], s["bq"], s["wk"],
                              s["bk"], s["wv"], s["bv"])
            got = ffn.qkv_block(*args(t))
            ref = ffn.qkv_block_plain(*args(t))
            err = (max(rel_l2(a, b) for a, b in zip(got, ref)),
                   max(max_abs(a, b) for a, b in zip(got, ref)))
            nbytes = (rows * n * D + 2 * rows * D + 3 * inner * D + 3 * inner
                      + 3 * rows * n * inner) * esz
            flops = 2.0 * rows * n * D * 3 * inner
            results.append(("qkv_block", err, [lambda s=s: ffn.qkv_block(*args(s)) for s in sets],
                            [lambda: ffn.qkv_block_plain(*args(t))], None, nbytes, flops,
                            "lemas_tts_tpu_torch/csrc/qkv_block.cu",
                            "lemas_tts_tpu/ops/ffn.py:128"))
            fargs = lambda s: (s["x"], s["scale"], s["shift"], s["gate"], s["w1"], s["b1"],
                               s["w2"], s["b2"])
            got = ffn.ffn_block(*fargs(t))
            ref = ffn.ffn_block_plain(*fargs(t))
            err = (rel_l2(got, ref), max_abs(got, ref))
            nbytes = (2 * rows * n * D + 3 * rows * D + 2 * FF * D + FF + D) * esz
            flops = 4.0 * rows * n * D * FF
            results.append(("ffn_block", err, [lambda s=s: ffn.ffn_block(*fargs(s)) for s in sets],
                            [lambda: ffn.ffn_block_plain(*fargs(t))], None, nbytes, flops,
                            "lemas_tts_tpu_torch/csrc/ffn_block.cu",
                            "lemas_tts_tpu/ops/ffn.py:203"))
        aargs = lambda s: (s["q"][..., :inner].contiguous(), s["k"][..., :inner].contiguous(),
                           s["v"][..., :inner].contiguous(), s["mask"], s["angles"], heads)
        a_sets = [aargs(s) for s in sets]
        got = attention.vmem_attention_nhd(*a_sets[0])
        ref = attention.vmem_attention_nhd_plain(*a_sets[0])
        err = (rel_l2(got, ref), max_abs(got, ref))
        q, k, v, mask = a_sets[0][:4]
        # library yardstick: sdpa on pre-roped split-head q/k/v (the port never calls it)
        cos = torch.cos(t["angles"]).repeat_interleave(2, -1)[None, :, None, :]
        sin = torch.sin(t["angles"]).repeat_interleave(2, -1)[None, :, None, :]
        qs = attention._rope(q.view(rows, n, heads, dh), cos, sin).transpose(1, 2).contiguous()
        ks = attention._rope(k.view(rows, n, heads, dh), cos, sin).transpose(1, 2).contiguous()
        vs = v.view(rows, n, heads, dh).transpose(1, 2).contiguous()
        am = mask[:, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am)
        valid_keys = float(mask.sum())
        nbytes = 4 * rows * n * inner * esz + rows * n + n * dh // 2 * 4
        flops = 4.0 * heads * dh * n * valid_keys
        results.append(("vmem_attention_nhd", err,
                        [lambda a=a: attention.vmem_attention_nhd(*a) for a in a_sets],
                        [lambda: attention.vmem_attention_nhd_plain(*a_sets[0])], lib, nbytes,
                        flops, "lemas_tts_tpu_torch/csrc/attention_nhd.cu",
                        "lemas_tts_tpu/ops/attention.py:561"))
        for name, (rl2, mab), kern, plain, library, nbytes, flops, src, rep in results:
            ms = time_ms(kern)
            plain_ms = time_ms(plain, iters=3)
            lib_ms = time_ms([library]) if library is not None else None
            bms, by = bound_ms(nbytes, flops, peak)
            ok = rl2 <= TOL_REL_L2[tag]
            print(f"[kernels] {name:18s} {tag:4s} rows {rows:2d} N {n:4d} heads {heads}x{dh}: "
                  f"rel-L2 {rl2:.3e} max-abs {mab:.3e} (tol {TOL_REL_L2[tag]:.0e}) "
                  f"ms {ms:.4f} plain {plain_ms:.4f} "
                  f"library {'-' if lib_ms is None else f'{lib_ms:.4f}'} "
                  f"bound {bms:.4f} ({by}) {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"{name} {tag} rows {rows} N {n}: rel-L2 {rl2:.3e} over tolerance")
            if main_shape:
                records[name] = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                                 "launches": 0, "max_abs_err": mab, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                                 "library_ms": lib_ms}
        del sets, a_sets, t
        torch.cuda.empty_cache()
    return [records[k] for k in ("qkv_block", "vmem_attention_nhd", "ffn_block")]


def _dit_inputs(torch, B, N, mel, vocab, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2 * B, N, mel, generator=g)
    cond = torch.randn(2 * B, N, mel, generator=g)
    cond[B:] = 0  # the uncond half of the CFG batch
    text = torch.full((2 * B, 256), -1, dtype=torch.long)
    text[:, :180] = torch.randint(0, vocab, (2 * B, 180), generator=g)
    time_ = torch.rand(2 * B, generator=g)
    mask = torch.arange(N)[None, :] < torch.tensor([N - 124] * (2 * B))[:, None]
    return x, cond, text, time_, mask


def phase_dit() -> None:
    """A depth-2 DiT at the flagship width on the card (K1-K3) against the
    same weights on the CPU (plain versions), in f32 and bf16."""
    import dataclasses

    import torch

    from lemas_tts_tpu_torch.config import load_model_config
    from lemas_tts_tpu_torch.models.dit import DiT, cast_matrices

    cfg = load_model_config("multilingual")
    arch = dataclasses.replace(cfg.arch, depth=2)
    mel, vocab = cfg.mel_spec.n_mel_channels, 64
    torch.manual_seed(0)
    state = DiT(arch, mel_dim=mel, text_num_embeds=vocab).state_dict()
    inputs = _dit_inputs(torch, 1, 1024, mel, vocab, seed=0)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        outs = []
        for dev in ("cpu", "cuda"):
            dit = DiT(arch, mel_dim=mel, text_num_embeds=vocab, compute_dtype=dtype)
            dit.load_state_dict(state)
            dit = cast_matrices(dit, dtype).to(dev).eval()
            with torch.no_grad():
                outs.append(dit(*(t.to(dev) for t in inputs)).float().cpu())
        got, ref = outs[1], outs[0]
        rl2 = rel_l2(got, ref)
        print(f"[dit] flagship width, depth 2, rows 2, N 1024, {tag}: card (kernels) vs CPU "
              f"(plain) rel-L2 {rl2:.3e} max-abs {max_abs(got, ref):.3e} "
              f"(tol {TOL_REL_L2[tag]:.0e})", flush=True)
        check(bool(torch.isfinite(got).all()), f"DiT {tag} output not finite")
        check(rl2 <= TOL_REL_L2[tag], f"DiT {tag}: rel-L2 {rl2:.3e} over tolerance")


def _reference_wave(sr: int, seconds: float, seed: int):
    """A speech-like synthetic reference: a gliding harmonic tone with a
    syllable-rate envelope, plus a little noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    tone = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 4 * t)
    return (0.15 * env * tone + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def phase_slice(dev: dict) -> dict:
    """Three TTS.infer requests at the flagship config on the card; returns
    the kernel launch counts of the run."""
    import numpy as np
    import torch

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.config import SamplerConfig
    from lemas_tts_tpu_torch.infer.preprocess import preprocess_ref_audio_text
    from lemas_tts_tpu_torch.ops import attention, ffn
    from lemas_tts_tpu_torch.utils.audio_io import write_wav

    counters = {"qkv_block": ffn.qkv_block, "vmem_attention_nhd": attention.vmem_attention_nhd,
                "ffn_block": ffn.ffn_block}
    with tempfile.TemporaryDirectory() as d:
        vocab = Path(d) / "vocab.txt"
        vocab.write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz0123456789")
                                    + list(",.!?'-")) + "\n")
        ref_path = str(Path(d) / "ref.wav")
        write_wav(ref_path, _reference_wave(16000, 3.0, seed=0), 16000)
        ref_text = "some call me nature, others call me mother nature."
        gen_text = ("i have been a silent spectator, watching species evolve, "
                    "empires rise and fall, and always remember i am mighty.")
        t0 = time.perf_counter()
        tts = TTS(model="multilingual", vocab_file=str(vocab))  # device None: the card
        check(tts.device.type == "cuda" and next(tts.dit.parameters()).is_cuda,
              "TTS() did not place the model on the card")
        print(f"[slice] TTS(multilingual) built on {tts.device} in "
              f"{time.perf_counter() - t0:.1f} s (random weights, depth "
              f"{tts.config.arch.depth}, dim {tts.config.arch.dim})", flush=True)
        wav, sr, rtext = preprocess_ref_audio_text(ref_path, ref_text, show_info=lambda *_: None)
        bucket = tts.synth.estimate_bucket(wav, sr, rtext, gen_text, SamplerConfig())
        check(bucket == 1024, f"request lands in bucket {bucket}, not 1024")
        per_request = tts.config.arch.depth * 32
        for f in counters.values():
            f.launches = 0
        timed = []
        for i in range(3):
            before = {k: f.launches for k, f in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wave, out_sr, spec = tts.infer(ref_path, ref_text, gen_text, seed=i,
                                           show_info=lambda *_: None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            grew = {k: f.launches - before[k] for k, f in counters.items()}
            audio_s = len(wave) / out_sr
            print(f"[slice] request {i} ({'warm-up' if i == 0 else 'timed'}): "
                  f"{audio_s:.3f} audio-s in {wall:.3f} s = {audio_s / wall:.2f} audio-s/s "
                  f"on {dev['card']}; launches {grew}", flush=True)
            check(out_sr == 24000, f"sample rate {out_sr}")
            check(wave.ndim == 1 and wave.size > 0 and bool(np.isfinite(wave).all()),
                  "wave empty or not finite")
            check(spec.shape[0] == 100 and bool(np.isfinite(spec).all()), "mel bad")
            check(all(v == per_request for v in grew.values()),
                  f"launches per request {grew}, expected {per_request} each")
            if i:
                timed.append((audio_s, wall))
        launches = {k: f.launches for k, f in counters.items()}
        profile_request(tts, ref_path, ref_text, gen_text)
    audio = sum(a for a, _ in timed)
    wall = sum(w for _, w in timed)
    print(f"[slice] timed: {audio:.3f} audio-s in {wall:.3f} s wall = "
          f"{audio / wall:.2f} audio-s/s (NFE 32, CFG 2, B 1, bucket 1024) on {dev['card']}",
          flush=True)
    return launches


def profile_request(tts, ref_path: str, ref_text: str, gen_text: str) -> None:
    """One more request (after the counted run) under torch.profiler: the
    card's busy time by kernel, and its idle share of the request."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tts.infer(ref_path, ref_text, gen_text, seed=3, show_info=lambda *_: None)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[profile] one request under torch.profiler: wall {wall_us / 1e3:.1f} ms, card busy "
          f"{busy / 1e3:.1f} ms in {sum(r[1] for r in rows)} kernels, idle share "
          f"{1 - busy / wall_us:.3f}", flush=True)
    for us, count, key in rows[:12]:
        print(f"[profile] {us / 1e3:9.2f} ms {100 * us / max(busy, 1e-9):5.1f} % x{count:6d}  "
              f"{key[:90]}", flush=True)


def main() -> int:
    if not (REPO / "lemas_tts_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py must run from a checkout of the repository "
              "(lemas_tts_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = phase_card()
    phase_build()
    kernels = phase_kernels()
    phase_dit()
    launches = phase_slice(dev)
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
    print(dev["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
