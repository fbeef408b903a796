#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, in order (any failure raises; the exit code is then non-zero):
  1. card: CUDA present, name and power limit from nvidia-smi, TF32 off;
  2. build: the kernels of ``lemas_tts_tpu_torch/csrc`` with nvcc (sm_90a),
     one nvcc per source, all started together; the bf16 K1 (qkv_block), K5
     (attention_bhnd), K2 (ffn_block), K3/K4 (attention_nhd), K6
     (attention_splash) and conv position embedding (conv_taps) libraries
     must each hold wgmma (HGMMA) and TMA-load
     (UTMALDG) instructions in their SASS, K5 and K6 also the 128-wide wgmma
     and setmaxnreg (USETMAXREG), and K5's and K6's bf16 kernels must not
     spill;
  3. kernels: each kernel (K1-K6) against its plain PyTorch version on the
     card, at the shapes of the paths below (K5 also at N 1000, 1025 and
     1537, with the UNetT's mask at N 1025 and 1537, its counter of skipped
     key tiles held to ``vmem_key_tiles``, N 1025 timed in turns with N 1024; K1
     also at rows 3, N 1088, where 128-row tiles straddle batch rows; K1-K3
     at rows 1, a distilled student's, and K3 there also with 8 x 128 heads), with
     times, the bound and the library yardstick (sdpa for K3-K5, the cuBLAS
     products alone for K1 and K2); every design of the bf16 K1 timed (both
     LN-modulate forms, bit for bit equal, at each tile width); K4 also
     against K3 (bit for bit); K3, K4 and K5 with a batch row whose keys are
     all masked (the value the JAX kernels give); K6 (splash, segment ids)
     at N 1024 and 1280 with a partly masked row (its pad rows held too),
     an all-masked row and whole 128-key tiles of padding, a row mostly
     padding, at rows 1, with 8 x 128 heads and with no mask, its yardstick
     ``sdpa`` under the boolean segment mask, and K5 timed in turns with it
     at the two main shapes (the K6/K5 ratio printed); the conv position
     embedding's kernel (``[conv]`` lines: ``conv_taps_mish``, k 31, 16
     groups) timed at rows 2, N 1024 and 1536 and rows 16, N 1536 beside its
     bound, its plain version, cuDNN's ``F.conv1d`` + ``F.mish`` and the
     build of its taps, checked
     at N 1025, unpadded, short N and in f32; every DiT forward below and
     every request must launch it twice a forward;
  4. DiT: depth-2 models at full width on the card (kernels) against the same
     weights on the CPU (plain versions), in f32 and bf16, each counting its
     launches: the flagship DiT (K1-K3), the flagship under
     ``LEMAS_ATTN_PACK=1`` (K4 in place of K3), the F5-TTS v0 ``f5tts_base``
     DiT (K5 and K2), the MMDiT at the flagship's arch (K5), the flagship
     DiT and the MMDiT under ``attn_backend="splash"`` (K6 only) and the
     flagship under ``"xla"`` (no kernel);
  5. slice: ``TTS.infer`` at full depth with random weights, launches counted
     per path (counts set to 0 just before a path, read just after): the
     flagship ``multilingual`` config (one warm-up, two timed requests, then
     one request under ``LEMAS_ATTN_PACK=1``), ``f5tts_base`` and an MMDiT
     built from the flagship config (one warm-up and one timed request each),
     all with a character vocab and ``frontend=None``; one more request per
     path under ``torch.profiler``;
  6. frontend: the flagship with its default ``frontend="phone"`` on a phone
     vocab made by the port's ``TextNorm`` from the run's texts (one warm-up
     and one timed request in bucket 1024, one profiled; the live G2P tier and
     the host ms of ``prepare_units`` printed), four requests in turns as
     phone units and as the raw string (phone, raw, raw, phone), then one
     request with ``frontend="char"`` on the same model;
  7. edit: ``speech_edit_multilingual.main()`` with its defaults (NFE 64,
     CFG 5, sway 3) on a 10 s utterance at 24 kHz: depth x 64 launches of
     each of K1-K3, kept frames equal to the reference mel bit for bit,
     every regenerated frame different, a finite WAV written;
  8. graph: the flagship sampler as a CUDA graph (``Synthesizer.warmup``
     captures it): one B = 1 request replays it, launches = replays x the
     graph's launches, its mel against a direct ``sample_mel`` on the same
     inputs (bit for bit, or rel-L2 <= 1e-6), two more buckets' first calls
     in two threads at once (each eager run counted once, each graph
     recording only its own launches), eager and graphed B = 1 under
     ``torch.profiler`` (card busy = the union of kernel intervals, <=
     wall); then the serving modes: the block cache "0-22:2+t2" with CFG
     cutoff 0.5 (launches from ``block_cache_flags`` and
     ``cfg_active_steps``), midpoint at NFE 16 (2 x 16 forwards), ``int8``
     and ``int8_ff`` against bf16 on the same noise (rel-L2 printed, within
     ``INT8_REL_L2``) with their kernels, and ``int8_dense`` on the card
     equal to its CPU integer math;
  9. serve: ``serve_http`` in-process at its defaults (NFE 32, CFG 3, sway 1,
     cutoff 0.5, block cache, int8) with ``--max_batch 8 --warmup_batches
     1,8``: two waves of 8 concurrent ``/tts`` requests, each one batch of 8
     (``/stats``), two ``/tts_stream`` requests of 3 chunks (the first
     captures, the second replays) equal, in order, to ``synthesize_stream``'s,
     ``/healthz`` and ``/config``, one B = 8 batch under ``torch.profiler``,
     the card's reserved memory after warmup and after the waves;
 10. prosody: the kaldi fbank and the ECAPA-TDNN encoder at its default widths
     on the card against the CPU (f32) with their card ms;
     ``multilingual_prosody`` with its default phone frontend: a warmed B = 1
     request replaying its prosody graph (K1-K3 depth x 32 each, the mel
     equal to a direct ``sample_mel`` with the same prosody text), the
     request with ``use_prosody_encoder=False`` (its mel must differ by
     ``PROSODY_MIN_REL_L2``), a profiled request, and
     ``speech_edit_multilingual.main() --use_prosody_encoder`` (kept frames
     equal to the reference mel plus the prosody offset, bit for bit);
 11. bigvgan: ``bigvgan_mel_spectrogram`` and the full-width generator
     (112 M parameters) on the card against the CPU (f32, 64 frames), the
     bf16 generator against f32 (bf16 tolerance), the vocoder's card ms for a 1024-frame mel
     (profiled), then ``f5tts_base_bigvgan`` requests (K5 and K2 depth x 32
     each, wave = frames x 256 samples) and a profiled request;
 12. unett: a depth-2 full-width ``e2tts_base`` UNetT card against CPU (K5
     once a block at N 1025), then requests at full depth (K5 24 x 32 = 768
     times) and a profiled request.
 13. uvr5: the MDX STFT pair (n_fft 7680, hop 1024, symmetric Hann) and
     ``ConvTDFNet`` at ``MDXConfig()`` on 2 chunk rows, card against CPU
     (f32); ``UVR5.denoise`` of a 10 s 24 kHz reference with seeded weights
     from a ``.pt`` (the 44.1 kHz length, finite; the match-mix demix returns
     its input; wall, the network's card ms, a profiled call); the flagship
     ``tts_multilingual.main --denoise --uvr5_model`` (exit 0, the 44.1 kHz
     ``_vocal.wav``, K1-K3 depth x 32 each); ``scripts/denoise.main -b`` over
     3 WAVs (3 vocal and 3 background stems, then a run with nothing left);
     ``CascadedNet`` and ``CascadedASPPNet(123821)`` on one 512-frame window
     card against CPU (masks and logits), ``VRSeparator.separate_full``
     single-band and 2-band (``2band_48000``) on the reference, each
     profiled.
 14. train: a K1 call on CUDA inputs that require grad raises (the kernels
     define no backward); ``cfm_training_loss`` (accent and CTC heads) and
     a ``Distiller`` loss at the flagship's width, depth 2, f32, card
     against CPU with the same weights, batch and draws (loss and the worst
     per-parameter gradient rel-L2); ``Trainer`` at full width and depth
     on one repeated batch (the loss falls), and timed at a 39 x 1024-frame
     batch (the 40,000-frame budget); ``scripts/train.main`` at full
     width on ``--synthetic`` data at the reference's 40,000-frame budget
     with ``--checkpoint_activations`` (step time, frames/s, TFLOP/s, peak
     memory), its ``model_last`` restored bit for bit, ``--resume`` carrying
     the step count on; ``scripts/distill.main`` from it (stages 16, 8, and
     an 8 x 128 wide-head stage 8); ``TTS`` on each student directory
     (pinned to steps K, CFG 0; K1-K3 depth x K launches per request, eager
     and graphed, the graphed mel equal to the eager one); and
     ``scripts/evaluate.main`` over their output with a random-init speaker
     encoder (finite metrics).
 15. splash: ``attn_backend="splash"`` at full depth: the flagship (a
     warmed graph, one warm-up and two timed B = 1 requests with K6 depth x
     32 each and no other kernel, a graphed request equal to a direct
     ``sample_mel``, a profiled request; its duration printed and K6 held
     to its plain version at that valid length), the MMDiT built from the
     flagship config (K6 at N 1280), ``e2tts_base`` (K5 at N 1025, where JAX hands
     splash to its sdpa), ``tts_multilingual.main --attn_backend splash``
     (NFE 16: K6 depth x 16, a WAV written) and
     ``speech_edit_multilingual.main --attn_backend splash`` (K6 depth x 64,
     kept frames equal to the reference mel); a flagship request under
     ``"xla"`` launching no kernel, its mel against the ``"vmem"`` route's
     on the same noise (rel-L2 printed, not gated);
 16. asr: an empty reference text on the flagship: where ``transformers``
     is installed, a random-init tiny Whisper on the card transcribes it
     (``TTS.transcribe``, and ``TTS.infer`` with K1-K3 depth x 32 each);
     with ``transformers`` absent or hidden, ``TTS.infer`` raises an
     ``ImportError`` naming it and runs nothing; two requests on one
     reference call an injected ``transcribe_fn`` once (the md5 cache),
     K1-K3 depth x 32 each a request;
 17. mesh: multi-GPU serving on one card, an NCCL job of one process set up
     from torchrun's variables (``parallel.distributed.initialize``): the
     flagship unmeshed, on a data mesh (``TTS(mesh=make_mesh())``: K1-K3
     depth x 32 a request, mels bit-equal to the unmeshed ones, B 1 and a
     B 8 batch); the sequence-parallel sampler on a seq mesh
     (``make_seq_mesh(seq_parallel=1)``: ring attention and the conv halo,
     K2 only, depth x 32) on the unmeshed request's sampler inputs, its mel
     within ``MESH_REL_L2`` of the unmeshed sampler's; the same sampler at
     depth 2 in f32 against ``sample_mel``; ``serve_http --multihost``
     in-process (its warm-up and a dispatch-path warm-up batch through the
     broadcast, a wave of 8 ``/tts`` as one batch, a ``/tts_stream``,
     ``/stats``' multihost block in lockstep); ``denoise --data_parallel``
     equal to the plain run. Then, on the same job of one:
 18. train_mesh: multi-GPU training at the flagship's full width and depth
     (f32, ``checkpoint_activations``), on the 39 x 1024-frame batch of
     ``[train]``: one ``Trainer(mesh=make_mesh(), fsdp=True)`` step against
     the unmeshed ``Trainer``'s from the same state and draws, dropout live
     (parameters within ``TRAIN_MESH_BAR["fsdp"]``), two timed steps of each
     and their peak memory; on a 40 x 1000-frame batch (the budget, split in
     4) one ``PipelinedTrainer`` step (``make_pipe_mesh(pipe_parallel=1)``,
     4 microbatches) against the plain step at the JAX pipeline test's
     setting (dropout 0, the first update at lr 0: loss and parameters
     within ``TRAIN_MESH_BAR``, the gradients through AdamW's first
     moments);
     ``scripts/train.main --fsdp`` (2 steps, restored bit for bit,
     ``--resume`` to 3) and ``scripts/distill.main --model_parallel 1``
     (one NFE-8 stage) under the job; ``TTS`` on that student (K1-K3 depth
     x 8 each a request, eager and graphed). The phase then destroys its
     process group.
 19. probes: the measurement tools of ``lemas_tts_tpu_torch/scripts/`` at
     flagship width, each printing its JSON lines: ``kernel_check`` (K1-K3
     under ``vmem`` against ``xla``, N 1024, B 1 and 8, rel-L2 <= 5e-2);
     ``profile_sampler`` on the graphed B 1 sampler (card busy, idle share,
     ``mfu`` from ``utils/flops.py``, in (0, 1.05]); ``latency_probe`` at the
     serving defaults, a closed loop of 4 requests and ``--loaded_ttfb``
     for 10 s with nothing shed; ``cutoff_probe``, ``blockcache_probe`` and
     ``quant_probe`` at two settings each, their launches equal to the
     blocks their settings run; ``attn_pack_probe`` (K4 bit-equal to K3),
     ``widehead_probe --no_e2e``, ``distill_probe --stages 8 --steps 2`` and
     ``student_stack_probe`` with one spec.
 20. assets: the flagship ``multilingual`` model with a seeded ``TTS``'s
     random weights written as a reference checkpoint (``ema_model.``
     keys) and a Vocos ``pytorch_model.bin``; ``validate_assets`` on them
     (parity and the phone goldens skipped: no reference repository, no
     espeak): ``convert_*`` where ``tensorstore`` imports (skipped with the
     reason where not), ``smoke_infer`` at NFE 32 (K1-K3 22 x 32 each, its
     wave the seeded model's byte for byte, a TTS on what it loaded giving
     the seeded mel bit for bit), the three reprobes with the launches their
     settings run; ``export_wav(remove_silence=True)``; the Gradio
     ``infer_fn`` plain (704 each) and in fast mode (the block cache's
     count); ``serve_http`` on the native scheduler (``csrc/host``), one
     wave of 8 ``/tts`` with ``ref_b64`` as one batch of 8; ``read_audio``
     of a FLAC where ``ffmpeg`` is.
On CUDA every request's sampler is a graph replay (its first request of a
bucket runs eagerly and captures), so every count above is launches on the
card. The line before the last is the ``kernels`` JSON record; the last line
is ``{"ok": true, "device": {...}}``. Needs only torch, numpy, the CUDA
toolkit and ``g++`` (and ``transformers`` where it is installed, for
``[asr]``'s tiny Whisper, ``tensorstore`` for ``[assets]``' orbax steps):
no JAX, no yaml.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
try:  # the card's timing: CUDA events behind a spin, busy as a union of kernel intervals
    from lemas_tts_tpu_torch.utils.profiling import device_ms, profile_card
except ImportError:  # not in a checkout: main() says so and exits 2
    device_ms = profile_card = None
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
    for name in _cuda.ENTRY_POINTS:
        log = _cuda.BUILD / f"{name}.ptxas.txt"
        if log.is_file():
            # one line a kernel: its (mangled) name, registers and spills
            entry, facts = "?", []
            for line in log.read_text().splitlines() + ["Compiling entry function 'end'"]:
                if "Compiling entry function" in line:
                    if facts:
                        print(f"[build] {name} {entry}: {'; '.join(facts)}")
                    entry, facts = line.split("'")[1], []
                elif "registers" in line or "spill" in line:
                    facts.append(line.replace("ptxas info    :", "").strip())
    # the bf16 K1, K5, K2, K3/K4 and K6 must run on wgmma and TMA: count their
    # SASS instructions (0 would mean a fallback to mma.sync or to plain loads);
    # K5's and K6's S = Q K^T must be the 128-wide form and their warpgroups
    # must trade registers (setmaxnreg)
    cuobjdump = Path(_cuda.nvcc_path()).with_name("cuobjdump")
    persistent = {"attention_bhnd": "attn_bhnd_sm90_kernel",
                  "attention_splash": "splash_sm90_kernel"}  # library: bf16 kernel
    for name in ("qkv_block", "attention_bhnd", "ffn_block", "attention_nhd",
                 "attention_splash", "conv_taps"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_cuda.library_path(name))],
                              capture_output=True, text=True, timeout=300).stdout
        ops = ("HGMMA", "UTMALDG") + (("HGMMA.64x128x16", "USETMAXREG")
                                      if name in persistent else ())
        counts = {op: sum(op in line for line in sass.splitlines()) for op in ops}
        print(f"[build] {name} SASS: {counts['HGMMA']} HGMMA (wgmma), "
              f"{counts['UTMALDG']} UTMALDG (TMA loads)"
              + (f", {counts['HGMMA.64x128x16']} of them 64x128x16, {counts['USETMAXREG']} "
                 f"USETMAXREG" if name in persistent else ""), flush=True)
        check(all(counts.values()), f"{name} lacks an instruction it must hold: {counts}")
    # K5's and K6's bf16 kernels: ptxas' registers and spills (the consumers'
    # 232 come from setmaxnreg at run time; ptxas reports the 168 a thread at
    # launch)
    for name, kernel in persistent.items():
        log = (_cuda.BUILD / f"{name}.ptxas.txt").read_text().split("Compiling entry")
        for part in log:
            if kernel in part.split("\n", 1)[0]:
                regs = next(line for line in part.splitlines() if "registers" in line)
                spills = next(line for line in part.splitlines() if "spill" in line)
                print(f"[build] {name} {part.split(chr(39))[1]}: "
                      f"{regs.split(':', 1)[1].strip()}; {spills.strip()}", flush=True)
                check(" 0 bytes spill stores, 0 bytes spill loads" in spills,
                      f"the bf16 kernel of {name} spills: {spills.strip()}")


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


def _report(results, tag: str, shape: str, peak: float, records: dict = None) -> None:
    """Time each kernel of ``results`` (tuples: name, (rel-L2, max-abs),
    kernel calls, plain call, (library name, library call) or None, bytes,
    FLOP, source, replaced TPU kernel), print it, fail if over tolerance;
    with ``records``, keep its record for the kernels line. ms, plain and
    library are card time (``device_ms``); wall is ``time_ms`` of the kernel
    calls, host issue included."""
    for name, (rl2, mab), kern, plain, library, nbytes, flops, src, rep in results:
        wall = time_ms(kern)
        ms = device_ms(kern)
        plain_ms = device_ms(plain, iters=3)
        lib_name, lib_ms = "-", None
        if library is not None:
            lib_name, lib_ms = library[0], device_ms([library[1]])
        bms, by = bound_ms(nbytes, flops, peak)
        ok = rl2 <= TOL_REL_L2[tag]
        print(f"[kernels] {name:23s} {tag:4s} {shape}: "
              f"rel-L2 {rl2:.3e} max-abs {mab:.3e} (tol {TOL_REL_L2[tag]:.0e}) "
              f"ms {ms:.4f} (wall {wall:.4f}) plain {plain_ms:.4f} "
              f"library {lib_name} {'-' if lib_ms is None else f'{lib_ms:.4f}'} "
              f"bound {bms:.4f} ({by}) {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name} {tag} {shape}: rel-L2 {rl2:.3e} over tolerance")
        if records is not None:
            records[name] = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                             "launches": 0, "max_abs_err": mab, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                             "library_ms": lib_ms}


def _qkv_args(s) -> tuple:
    return (s["x"], s["scale"], s["shift"], s["wq"], s["bq"], s["wk"], s["bk"], s["wv"],
            s["bv"])


def _qkv_designs(sets) -> None:
    """Card time of both LN-modulate forms of the bf16 K1 on ``sets`` (the
    flagship shape): the pass that writes m once and the GEMM's prologue,
    each against the plain version; the two must agree bit for bit."""
    import re

    from lemas_tts_tpu_torch.ops import _cuda, ffn

    ref = ffn.qkv_block_plain(*_qkv_args(sets[0]))
    times, outs = {}, {}
    for ln_pass in (True, False):
        outs[ln_pass] = got = ffn.qkv_block(*_qkv_args(sets[0]), ln_pass=ln_pass)
        err = max(rel_l2(a, b) for a, b in zip(got, ref))
        check(err <= TOL_REL_L2["bf16"], f"qkv_block ln_pass={ln_pass}: rel-L2 {err:.3e}")
        times[ln_pass] = device_ms([lambda s=s, lp=ln_pass: ffn.qkv_block(*_qkv_args(s),
                                                                          ln_pass=lp)
                                    for s in sets])
    same = all(a.equal(b) for a, b in zip(outs[True], outs[False]))
    check(same, "qkv_block: LN pass and prologue differ")
    src = (_cuda.CSRC / "qkv_block.cu").read_text()
    tile_n = re.search(r"constexpr int kTileN = (\d+);", src).group(1)
    form = {True: "LN pass", False: "prologue"}
    print(f"[kernels] qkv_block bf16 rows  2 N 1024 LN-modulate forms, card ms (equal bit for "
          f"bit), tile 128 x {tile_n}: LN pass {times[True]:.4f}; prologue {times[False]:.4f}; "
          f"chosen: {form[ffn.QKV_LN_PASS]}", flush=True)


def _qkv_straddle() -> None:
    """K1 in both types at rows 3, N 1088 against its plain version: 128-row
    tiles straddle two batch rows (N % 128 == 64) and the last tile holds
    rows past B*N (3 * 1088 % 128 == 64)."""
    import torch

    from lemas_tts_tpu_torch.ops import ffn

    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        t = _kernel_inputs(torch, 3, 1088, 1024, 128, 16, 64, dtype, seed=5)
        got, ref = ffn.qkv_block(*_qkv_args(t)), ffn.qkv_block_plain(*_qkv_args(t))
        rl2 = max(rel_l2(a, b) for a, b in zip(got, ref))
        mab = max(max_abs(a, b) for a, b in zip(got, ref))
        ok = rl2 <= TOL_REL_L2[tag]
        print(f"[kernels] qkv_block {tag:4s} rows  3 N 1088 (tiles straddle batch rows, rows "
              f"past B*N): rel-L2 {rl2:.3e} max-abs {mab:.3e} (tol {TOL_REL_L2[tag]:.0e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"qkv_block {tag} rows 3 N 1088: rel-L2 {rl2:.3e} over tolerance")
        del t, got, ref


def phase_kernels() -> dict:
    """K1-K4 against their plain versions on the card (K4 also against K3).
    Returns the records of the flagship path's shape (rows 2, N 1024, bf16)
    for the kernels line."""
    import torch
    import torch.nn.functional as F

    from lemas_tts_tpu_torch.ops import attention, ffn

    D, FF, H, DH = 1024, 2048, 16, 64
    records = {}
    cases = [("bf16", torch.bfloat16, rows, n, H, DH) for rows in (2, 16) for n in (1024, 4096)]
    cases += [("f32", torch.float32, 2, 1024, H, DH), ("bf16", torch.bfloat16, 2, 1024, 8, 128),
              ("f32", torch.float32, 2, 1024, 8, 128)]
    # a distilled student's rows (no CFG), 16 x 64 and the wide 8 x 128 heads
    cases += [("bf16", torch.bfloat16, 1, 1024, H, DH), ("bf16", torch.bfloat16, 1, 1024, 8, 128)]
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
            args = _qkv_args
            got = ffn.qkv_block(*args(t))
            ref = ffn.qkv_block_plain(*args(t))
            err = (max(rel_l2(a, b) for a, b in zip(got, ref)),
                   max(max_abs(a, b) for a, b in zip(got, ref)))
            nbytes = (rows * n * D + 2 * rows * D + 3 * inner * D + 3 * inner
                      + 3 * rows * n * inner) * esz
            flops = 2.0 * rows * n * D * 3 * inner
            # yardstick: the cuBLAS product alone, against the [3I, D] concatenated
            # weight, on a pre-made m (no LN, modulation or bias)
            m = ffn.ln_modulate(t["x"], t["scale"], t["shift"])
            wqkv = torch.cat([t["wq"], t["wk"], t["wv"]])
            k1_lib = ("cuBLAS products alone", lambda: torch.matmul(m, wqkv.t()))
            results.append(("qkv_block", err, [lambda s=s: ffn.qkv_block(*args(s)) for s in sets],
                            [lambda: ffn.qkv_block_plain(*args(t))], k1_lib, nbytes, flops,
                            "lemas_tts_tpu_torch/csrc/qkv_block.cu",
                            "lemas_tts_tpu/ops/ffn.py:128"))
            fargs = lambda s: (s["x"], s["scale"], s["shift"], s["gate"], s["w1"], s["b1"],
                               s["w2"], s["b2"])
            got = ffn.ffn_block(*fargs(t))
            ref = ffn.ffn_block_plain(*fargs(t))
            err = (rel_l2(got, ref), max_abs(got, ref))
            nbytes = (2 * rows * n * D + 3 * rows * D + 2 * FF * D + FF + D) * esz
            flops = 4.0 * rows * n * D * FF
            # yardstick: the two cuBLAS products alone, on pre-made m and h (no
            # LN, GELU, bias or residual)
            h = F.gelu(torch.matmul(m, t["w1"].t()), approximate="tanh")
            k2_lib = ("cuBLAS products alone", lambda: (torch.matmul(m, t["w1"].t()),
                                                        torch.matmul(h, t["w2"].t())))
            results.append(("ffn_block", err, [lambda s=s: ffn.ffn_block(*fargs(s)) for s in sets],
                            [lambda: ffn.ffn_block_plain(*fargs(t))], k2_lib, nbytes, flops,
                            "lemas_tts_tpu_torch/csrc/ffn_block.cu",
                            "lemas_tts_tpu/ops/ffn.py:203"))
        aargs = lambda s: (s["q"][..., :inner].contiguous(), s["k"][..., :inner].contiguous(),
                           s["v"][..., :inner].contiguous(), s["mask"], s["angles"], heads)
        a_sets = [aargs(s) for s in sets]
        got = attention.vmem_attention_nhd(*a_sets[0])
        k3_plain = lambda a: attention.vmem_attention_nhd_plain(
            *a, start_max=attention.nhd_start_max(n))
        ref = k3_plain(a_sets[0])
        err = (rel_l2(got, ref), max_abs(got, ref))
        q, k, v, mask = a_sets[0][:4]
        # library yardstick: sdpa on pre-roped split-head q/k/v (the port never calls it)
        cos = torch.cos(t["angles"]).repeat_interleave(2, -1)[None, :, None, :]
        sin = torch.sin(t["angles"]).repeat_interleave(2, -1)[None, :, None, :]
        qs = attention._rope(q.view(rows, n, heads, dh), cos, sin).transpose(1, 2).contiguous()
        ks = attention._rope(k.view(rows, n, heads, dh), cos, sin).transpose(1, 2).contiguous()
        vs = v.view(rows, n, heads, dh).transpose(1, 2).contiguous()
        am = mask[:, None, None, :]
        lib = ("sdpa", lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am))
        valid_keys = float(mask.sum())
        nbytes = 4 * rows * n * inner * esz + rows * n + n * dh // 2 * 4
        flops = 4.0 * heads * dh * n * valid_keys
        results.append(("vmem_attention_nhd", err,
                        [lambda a=a: attention.vmem_attention_nhd(*a) for a in a_sets],
                        [lambda: k3_plain(a_sets[0])], lib, nbytes,
                        flops, "lemas_tts_tpu_torch/csrc/attention_nhd.cu",
                        "lemas_tts_tpu/ops/attention.py:561"))
        if dh == 64 and rows == 2 and n == 1024:  # K4 at the flagship shape
            got4 = attention.vmem_attention_nhd_pack(*a_sets[0])
            k4_k3 = max_abs(got4, got)
            print(f"[kernels] vmem_attention_nhd_pack {tag} vs vmem_attention_nhd: max-abs "
                  f"{k4_k3:.3e} (the same arithmetic on the same staged values: 0)", flush=True)
            check(torch.equal(got4, got), f"K4 differs from K3 ({tag}): max-abs {k4_k3:.3e}")
            results.append(("vmem_attention_nhd_pack", (rel_l2(got4, ref), max_abs(got4, ref)),
                            [lambda a=a: attention.vmem_attention_nhd_pack(*a) for a in a_sets],
                            [lambda: attention.vmem_attention_nhd_plain(
                                *a_sets[0], start_max=attention.nhd_start_max(n, True))], lib,
                            nbytes, flops, "lemas_tts_tpu_torch/csrc/attention_nhd.cu",
                            "lemas_tts_tpu/ops/attention.py:528"))
        _report(results, tag, f"rows {rows:2d} N {n:4d} heads {heads}x{dh}", peak,
                records if main_shape else None)
        if main_shape:
            _qkv_designs(sets)
        if dh == 64 and rows == 2:
            _nhd_masked_row(torch, tag, a_sets[0], n)
        del sets, a_sets, t
        torch.cuda.empty_cache()
    _qkv_straddle()
    return records


CONV_TOL_REL_L2 = {"bf16": 4e-3, "f32": 2e-4}


def conv_case(tag: str, rows: int, n: int, padding, seed: int = 0, timed: bool = False):
    """``conv_taps_mish`` (the conv position embedding's kernel) at dim 1024,
    16 groups, k 31 against its plain version on the card; with ``timed``,
    its card time beside the bound, the plain version's and the library's
    (cuDNN's grouped ``F.conv1d`` and ``F.mish``, the chain the port ran
    before the kernel and never calls on this path now), and the card time
    of making its taps from a weight in the compute dtype (``conv_taps``, as
    ``ConvPositionEmbedding`` does before each launch). Returns the record
    for the kernels line."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from lemas_tts_tpu_torch.models.modules import conv1d
    from lemas_tts_tpu_torch.ops import conv

    dtype = torch.bfloat16 if tag == "bf16" else torch.float32
    C, G, K = 1024, 16, 31
    g = torch.Generator(device="cuda").manual_seed(seed)
    sets = []
    for _ in range(3 if timed else 1):
        w = torch.randn(C, C // G, K, generator=g, device="cuda") * (C // G * K) ** -0.5
        b = torch.randn(C, generator=g, device="cuda") * 0.1
        x = torch.randn(rows, n, C, generator=g, device="cuda").to(dtype)
        sets.append((x, conv.conv_taps(w, G, dtype), b.to(dtype), w.to(dtype)))
    x, taps, b, w = sets[0]
    before = conv.conv_taps_mish.launches
    got = conv.conv_taps_mish(x, taps, b, padding)
    check(conv.conv_taps_mish.launches == before + 1, "conv_taps_mish did not count its launch")
    ref = conv.conv_taps_mish_plain(x, taps, b, padding)
    rl2, mab = rel_l2(got, ref), max_abs(got, ref)
    ok = rl2 <= CONV_TOL_REL_L2[tag] and got.shape == ref.shape
    shape = f"rows {rows:2d} N {n:4d} padding {padding}"
    line = (f"[conv] conv_taps_mish {tag:4s} {shape}: rel-L2 {rl2:.3e} max-abs {mab:.3e} "
            f"(tol {CONV_TOL_REL_L2[tag]:.0e})")
    if not timed:
        print(f"{line} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"conv_taps_mish {tag} {shape}: rel-L2 {rl2:.3e} over tolerance")
        return None
    kern = [lambda s=s: conv.conv_taps_mish(s[0], s[1], s[2], padding) for s in sets]
    lib_convs = []
    for xs, _, bs, ws in sets:
        m = nn.Conv1d(C, C, K, groups=G, device="cuda", dtype=dtype)
        with torch.no_grad():
            m.weight.copy_(ws)
            m.bias.copy_(bs)
        lib_convs.append((xs, m))
    lib = [lambda c=c: F.mish(conv1d(c[0], c[1], padding)) for c in lib_convs]
    ms, wall = device_ms(kern), time_ms(kern)
    plain_ms = device_ms([lambda: conv.conv_taps_mish_plain(x, taps, b, padding)], iters=3)
    lib_ms = device_ms(lib)
    taps_ms = device_ms([lambda s=s: conv.conv_taps(s[3], G, dtype) for s in sets])
    n_out = got.shape[1]
    esz = x.element_size()
    nbytes = (rows * n * C + rows * n_out * C + taps.numel() + C) * esz
    flops = 2.0 * rows * n_out * C * (C // G) * K
    peak = H100_BF16_FLOPS if tag == "bf16" else H100_F32_FLOPS
    bms, by = bound_ms(nbytes, flops, peak)
    print(f"{line} ms {ms:.4f} (wall {wall:.4f}) plain {plain_ms:.4f} library "
          f"cuDNN conv1d+mish {lib_ms:.4f} bound {bms:.4f} ({by}, {100 * bms / ms:.1f} % of it) "
          f"taps build {taps_ms:.4f} {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"conv_taps_mish {tag} {shape}: rel-L2 {rl2:.3e} over tolerance")
    return {"name": "conv_taps_mish", "route": "cuda",
            "source": "lemas_tts_tpu_torch/csrc/conv_taps.cu",
            "replaces": "none (JAX: XLA taps, lemas_tts_tpu/models/modules.py:GroupedConvTaps)",
            "launches": 0, "max_abs_err": mab, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms}


def phase_conv() -> dict:
    """The conv position embedding's kernel on the card: timed at the
    flagship's shapes (rows 2 at N 1024 and 1536, a served batch of rows 16
    at N 1536), checked at ragged N 1025, unpadded (the sequence-parallel
    halo form), fewer frames than a tile, and in f32 (TF32 off). Returns the
    record of rows 2, N 1024, bf16 for the kernels line."""
    import torch

    same = (15, 15)
    record = conv_case("bf16", 2, 1024, same, timed=True)
    conv_case("bf16", 2, 1536, same, timed=True)
    conv_case("bf16", 16, 1536, same, timed=True)
    for tag, rows, n, padding in (("bf16", 2, 1025, same), ("bf16", 2, 1084, (0, 0)),
                                  ("bf16", 1, 40, same), ("bf16", 3, 200, (3, 27)),
                                  ("f32", 2, 1024, same), ("f32", 2, 1025, same),
                                  ("f32", 2, 1084, (0, 0))):
        conv_case(tag, rows, n, padding)
    torch.cuda.empty_cache()
    return {"conv_taps_mish": record}


def _nhd_masked_row(torch, tag: str, args, n: int) -> None:
    """K3 and K4 with batch row 1's keys all masked, against their plain
    versions and against what the JAX kernels give such a row: the mean of v,
    or 0 from K3 where its softmax is chunked (N > 2048, N % 512 == 0). At
    N 1024 K4 must still equal K3 bit for bit."""
    from lemas_tts_tpu_torch.ops import attention

    q, k, v, mask, angles, heads = args
    mask = mask.clone()
    mask[1] = False
    a = (q, k, v, mask, angles, heads)
    mean_v = v[1].float().mean(0).expand(n, -1)
    outs = {}
    for name, pack in (("vmem_attention_nhd", False), ("vmem_attention_nhd_pack", True)):
        start = attention.nhd_start_max(n, pack)
        got = attention.vmem_attention_nhd(*a, pack_pair=pack)
        err = rel_l2(got, attention.vmem_attention_nhd_plain(*a, start_max=start))
        if start == attention.M_FLOOR:
            want, row_err = "0", max_abs(got[1], torch.zeros_like(mean_v))
            ok = row_err == 0.0
        else:
            want, row_err = "the mean of v", rel_l2(got[1], mean_v)
            ok = row_err <= TOL_REL_L2[tag]
        print(f"[kernels] {name:23s} {tag:4s} rows  2 N {n:4d}, row 1 all masked: rel-L2 "
              f"{err:.3e} against the plain version; row 1 against {want}: "
              f"{row_err:.3e} {'ok' if ok and err <= TOL_REL_L2[tag] else 'FAIL'}", flush=True)
        check(err <= TOL_REL_L2[tag], f"{name} {tag} N {n}, row all masked: rel-L2 {err:.3e}")
        check(ok, f"{name} {tag} N {n}: an all-masked row is not {want} ({row_err:.3e})")
        outs[name] = got
    if n == 1024:
        check(torch.equal(outs["vmem_attention_nhd_pack"], outs["vmem_attention_nhd"]),
              f"K4 differs from K3 ({tag}) with a row all masked")


# K5's cases: (N, heads, dim_head, mask). "partial": valid lengths [N - 37,
# N]; "row": row 1 also all masked (the mean of v); "unett": the UNetT's
# mask at N + 1, the time token and the middle of the bucket's frames kept
# (896 of 1024, 1280 of 1536), the rest padded, both CFG rows alike.
K5_CASES = [(1024, 16, 64, "partial"), (1280, 16, 64, "partial"), (1088, 16, 64, "partial"),
            (1000, 16, 64, "partial"), (1025, 16, 64, "partial"), (1024, 8, 128, "partial"),
            (1024, 16, 64, "row"), (1025, 16, 64, "row"), (1537, 16, 64, "partial"),
            (1025, 16, 64, "unett"), (1537, 16, 64, "unett")]
K5_UNETT_FRAMES = {1025: 896, 1537: 1280}


def _k5_mask(torch, n: int, kind: str):
    pos = torch.arange(n, device="cuda")
    if kind == "unett":
        return (pos < 1 + K5_UNETT_FRAMES[n])[None].expand(2, n).contiguous()
    mask = pos[None, :] < torch.tensor([n - 37, n], device="cuda")[:, None]
    if kind == "row":
        mask[1] = False
    return mask


def phase_split_attention() -> dict:
    """K5 against its plain version on the card (``K5_CASES``), with sdpa as
    its yardstick: the v0 path's shape (rows 2, 16 x 64, N 1024), the
    MMDiT's joint length (1024 frames + 256 text), ragged N (1088; 1000,
    1025 and 1537, off the 128-key tiles and off the 16-byte rows a TMA map
    of the mask would need), d128 heads, a batch row whose keys are all
    masked (which must give the mean of v) at N 1024 and 1025, and the
    UNetT's mask at N 1025 and 1537. In bf16 the kernel's counter gives the
    share of key tiles it skipped, held to ``vmem_key_tiles``; K5 at N 1025
    is timed in turns with N 1024. Returns the record of the v0 shape in
    bf16."""
    import torch
    import torch.nn.functional as F

    from lemas_tts_tpu_torch.ops import attention

    records, ragged = {}, {}
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
        for n, heads, dh, kind in K5_CASES:
            main_shape = tag == "bf16" and n == 1024 and dh == 64 and kind == "partial"
            rows = 2
            g = torch.Generator(device="cuda").manual_seed(n + dh)
            sets = []
            for _ in range(3 if main_shape or (tag, n, kind) == ("bf16", 1025, "partial")
                           else 1):
                q, k, v = (torch.randn(rows, heads, n, dh, generator=g, device="cuda").to(dtype)
                           for _ in range(3))
                sets.append((q, k, v, _k5_mask(torch, n, kind)))
            q, k, v, mask = sets[0]
            counts = torch.zeros(2, dtype=torch.int64, device="cuda") if tag == "bf16" else None
            got = attention.vmem_attention(*sets[0], counts=counts)
            ref = attention.vmem_attention_plain(*sets[0])
            shape = f"rows {rows:2d} N {n:4d} heads {heads}x{dh}"
            if kind == "row":
                mean_v = v[1].float().mean(dim=1, keepdim=True).expand(heads, n, dh)
                row_err = rel_l2(got[1], mean_v)
                print(f"[kernels] vmem_attention {tag} {shape}, row 1 all masked: rel-L2 "
                      f"{row_err:.3e} against the mean of v (tol {TOL_REL_L2[tag]:.0e})",
                      flush=True)
                check(row_err <= TOL_REL_L2[tag], f"K5 {tag}: all-masked row is not mean(v)")
                shape += ", row 1 all masked"
            if kind == "unett":
                shape += f", UNetT mask ({K5_UNETT_FRAMES[n]} frames)"
            if counts is not None:
                walked, total = counts.tolist()
                want = attention.vmem_key_tiles(mask, n, heads, rows)
                print(f"[kernels] vmem_attention {tag} {shape}: key tiles walked {walked} of "
                      f"{total}, {100 * (1 - walked / total):.1f} % skipped "
                      f"(vmem_key_tiles: {want[0]} of {want[1]})", flush=True)
                check([walked, total] == list(want), f"K5 {shape}: tile counter {counts.tolist()}"
                      f" is not vmem_key_tiles' {want}")
            esz = q.element_size()
            nbytes = 4 * rows * heads * n * dh * esz + rows * n
            flops = 4.0 * heads * dh * n * float(mask.sum())
            am = mask[:, None, None, :]
            lib = ("sdpa", lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am))
            _report([("vmem_attention", (rel_l2(got, ref), max_abs(got, ref)),
                      [lambda a=a: attention.vmem_attention(*a) for a in sets],
                      [lambda: attention.vmem_attention_plain(*sets[0])], lib, nbytes, flops,
                      "lemas_tts_tpu_torch/csrc/attention_bhnd.cu",
                      "lemas_tts_tpu/ops/attention.py:162")],
                    tag, shape, peak, records if main_shape else None)
            if tag == "bf16" and dh == 64 and kind == "partial" and n in (1024, 1025):
                ragged[n] = [lambda a=a: attention.vmem_attention(*a) for a in sets]
            else:
                del sets
            del q, k, v, got, ref
            torch.cuda.empty_cache()
    t = [device_ms(ragged[n], iters=60) for n in (1024, 1025, 1025, 1024)]
    at_1024, at_1025 = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"[kernels] vmem_attention bf16 rows  2 heads 16x64, valid [N - 37, N]: N 1025 "
          f"{at_1025:.4f} ms, N 1024 {at_1024:.4f} ms in turns (1024, 1025, 1025, 1024: "
          f"{', '.join(f'{x:.4f}' for x in t)}), N 1025 / N 1024 {at_1025 / at_1024:.3f}",
          flush=True)
    del ragged
    torch.cuda.empty_cache()
    return records


# K6's cases: (rows, N, heads, dim_head, masking, valid lengths or None). A
# "partial" mask has valid lengths [N - 37, N]; "all_masked" also masks
# row 1 wholly; "none" passes no mask; "tiles" leaves whole 128-key tiles of
# padding in row 0 (600 of 1024, 700 of 1280), "mostly" a row that is mostly
# padding (100 of 1024), where the kernel skips key tiles that no row of a
# query tile sees.
SPLASH_CASES = [(2, 1024, 16, 64, "partial", None), (2, 1280, 16, 64, "partial", None),
                (2, 1024, 16, 64, "all_masked", None), (2, 1280, 16, 64, "all_masked", None),
                (1, 1024, 16, 64, "partial", None), (2, 1024, 8, 128, "partial", None),
                (2, 1024, 16, 64, "none", None), (2, 1024, 16, 64, "tiles", [600, 1024]),
                (2, 1280, 16, 64, "tiles", [700, 1280]), (2, 1024, 16, 64, "mostly", [100, 1024]),
                (2, 1024, 8, 128, "tiles", [600, 100])]


def splash_case(tag: str, rows: int, n: int, heads: int, dh: int, masking: str,
                valid=None, records: dict = None) -> None:
    """K6 on one case against its plain version (its pad query rows alone
    too), timed with its bound over the visible (query, key) pairs and
    ``sdpa`` under the boolean segment mask as the yardstick; with
    ``records``, the case is the flagship shape in bf16 and its record is
    kept. At rows 2, 16 x 64 heads with a partial mask in bf16 (the flagship
    and MMDiT shapes) K5 runs on the same inputs in turns with K6 (K5, K6,
    K6, K5) and the K6/K5 ratio is printed."""
    import torch
    import torch.nn.functional as F

    from lemas_tts_tpu_torch.ops import attention

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[tag]
    peak = H100_BF16_FLOPS if tag == "bf16" else H100_F32_FLOPS
    main_shape = records is not None
    g = torch.Generator(device="cuda").manual_seed(n + dh + rows)
    sets = []
    for _ in range(3 if main_shape else 1):
        q, k, v = (torch.randn(rows, heads, n, dh, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        lens = valid or [n - 37, n][:rows]
        mask = torch.arange(n, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None]
        if masking == "all_masked":
            mask[1] = False
        sets.append((q, k, v, None if masking == "none" else mask))
    q, k, v, mask = sets[0]
    got = attention.splash_attention(*sets[0])
    ref = attention.splash_attention_plain(*sets[0])
    shape = f"rows {rows:2d} N {n:4d} heads {heads}x{dh} mask {masking}" + (
        f" (valid {valid})" if valid else "")
    pad = torch.zeros(rows, n, dtype=torch.bool, device="cuda") if mask is None else ~mask
    if bool(pad.any()):
        pad_err = rel_l2(got.transpose(1, 2)[pad], ref.transpose(1, 2)[pad])
        print(f"[kernels] splash_attention {tag} {shape}: pad query rows alone rel-L2 "
              f"{pad_err:.3e} (tol {TOL_REL_L2[tag]:.0e})", flush=True)
        check(pad_err <= TOL_REL_L2[tag], f"K6 {tag} {shape}: pad rows over tolerance")
    seg = torch.ones(rows, n, dtype=torch.bool, device="cuda") if mask is None else mask
    c1 = seg.sum(dim=1).double()
    pairs = float((c1 * c1 + (n - c1) * (n - c1)).sum())  # visible (query, key) pairs
    nbytes = 4 * rows * heads * n * dh * q.element_size() + (0 if mask is None else rows * n)
    flops = 4.0 * heads * dh * pairs
    same = (seg[:, :, None] == seg[:, None, :])[:, None]
    lib = ("sdpa", lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=same))
    kern = [lambda a=a: attention.splash_attention(*a) for a in sets]
    _report([("splash_attention", (rel_l2(got, ref), max_abs(got, ref)), kern,
              [lambda: attention.splash_attention_plain(*sets[0])], lib, nbytes, flops,
              "lemas_tts_tpu_torch/csrc/attention_splash.cu", "lemas_tts_tpu/ops/attention.py:60")],
            tag, shape, peak, records)
    if (tag, rows, heads, dh, masking) == ("bf16", 2, 16, 64, "partial") and n in (1024, 1280):
        k5 = [lambda a=a: attention.vmem_attention(*a) for a in sets]
        t = [device_ms(f, iters=50) for f in (k5, kern, kern, k5)]
        k5_ms, k6_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        print(f"[kernels] splash_attention bf16 {shape}: K6 {k6_ms:.4f} ms, K5 (vmem_attention) "
              f"on the same inputs {k5_ms:.4f} ms in turns (K5, K6, K6, K5: "
              f"{', '.join(f'{x:.4f}' for x in t)}), K6/K5 {k6_ms / k5_ms:.3f}", flush=True)
    del sets, q, k, v, got, ref, same
    torch.cuda.empty_cache()


def phase_splash_attention() -> dict:
    """K6 against its plain version on the card (``splash_case``) at every
    case of ``SPLASH_CASES`` in bf16 and f32: the flagship's shape under
    ``attn_backend="splash"`` (rows 2, 16 x 64, N 1024) and the MMDiT's
    joint length (N 1280), each with batch row 0 partly masked (its pad rows
    compared too: they attend the pad keys), with row 1 all masked (it
    attends every key) and with whole 128-key tiles of padding; a row mostly
    padding; rows 1, 8 x 128 heads, and no mask (one segment). ``phase_splash``
    adds the flagship request's own valid length. Returns the record of the
    flagship shape in bf16."""
    records = {}
    for tag in ("bf16", "f32"):
        for rows, n, heads, dh, masking, valid in SPLASH_CASES:
            main_shape = (tag, rows, n, dh, masking) == ("bf16", 2, 1024, 64, "partial")
            splash_case(tag, rows, n, heads, dh, masking, valid, records if main_shape else None)
    return records


CONV = "conv_taps_mish"
CONVS_PER_FORWARD = 2  # the conv position embedding's two convs, once a model forward


def kernel_counters() -> dict:
    """The launch counter of every kernel wrapper, by kernel name."""
    from lemas_tts_tpu_torch.ops import launches

    return launches.counters()


def reset_counters() -> None:
    for f in kernel_counters().values():
        f.launches = 0


def read_counters() -> dict:
    return {k: f.launches for k, f in kernel_counters().items()}


@contextlib.contextmanager
def attn_pack(on: bool):
    """``LEMAS_ATTN_PACK=1`` (the head-pair kernel K4) inside, when ``on``;
    unset otherwise."""
    old = os.environ.pop("LEMAS_ATTN_PACK", None)
    if on:
        os.environ["LEMAS_ATTN_PACK"] = "1"
    try:
        yield
    finally:
        os.environ.pop("LEMAS_ATTN_PACK", None)
        if old is not None:
            os.environ["LEMAS_ATTN_PACK"] = old


def expected_launches(kernels, blocks: int, forwards: int) -> dict:
    """The launches of a run of ``blocks`` transformer blocks in ``forwards``
    model forwards: each block kernel of ``kernels`` once a block, the conv
    position embedding's kernel twice a forward (on every path of the
    inference route), no other."""
    want = {k: (blocks if k in kernels else 0) for k in kernel_counters()}
    want[CONV] = CONVS_PER_FORWARD * forwards
    return want


# int8 / int8_ff flagship mel against bf16, same weights and noise: the H100
# read 1.97e-3 / 1.87e-3 (PERF.md). The band is a quarter to three times
# that: above it, the quantized path is wrong; below it, it did not quantize
# (the bf16 path is deterministic, so it would read 0).
INT8_REL_L2 = (5e-4, 6e-3)

FLAGSHIP_KERNELS = ("qkv_block", "vmem_attention_nhd", "ffn_block")
PACK_KERNELS = ("qkv_block", "vmem_attention_nhd_pack", "ffn_block")
V0_KERNELS = ("vmem_attention", "ffn_block")
MMDIT_KERNELS = ("vmem_attention",)
SPLASH_KERNELS = ("splash_attention",)


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
    """Depth-2 models at full width on the card (kernels) against the same
    weights on the CPU (plain versions), in f32 and bf16; each card forward
    must launch its path's kernels once per block and no other."""
    from lemas_tts_tpu_torch.config import load_model_config
    from lemas_tts_tpu_torch.models.dit import DiT
    from lemas_tts_tpu_torch.models.mmdit import MMDiT

    flagship, v0 = load_model_config("multilingual"), load_model_config("f5tts_base")
    cases = [("flagship DiT", DiT, flagship, False, FLAGSHIP_KERNELS, "vmem"),
             ("flagship DiT, LEMAS_ATTN_PACK=1", DiT, flagship, True, PACK_KERNELS, "vmem"),
             ("f5tts_base DiT (v0)", DiT, v0, False, V0_KERNELS, "vmem"),
             ("MMDiT, flagship arch, text 256", MMDiT, flagship, False, MMDIT_KERNELS, "vmem"),
             ("flagship DiT, attn_backend=splash", DiT, flagship, False, SPLASH_KERNELS,
              "splash"),
             ("MMDiT, flagship arch, text 256, attn_backend=splash", MMDiT, flagship, False,
              SPLASH_KERNELS, "splash"),
             ("flagship DiT, attn_backend=xla", DiT, flagship, False, (), "xla")]
    for label, cls, cfg, pack, kernels, backend in cases:
        depth2_forward("dit", label, cls, cfg, pack, kernels, backend)


def depth2_forward(tag: str, label: str, cls, cfg, pack: bool, kernels,
                   attn_backend: str = "vmem") -> None:
    """A depth-2 model of ``cfg``'s arch at full width on the card (kernels)
    against the same weights on the CPU (plain versions), in f32 and bf16;
    each card forward must launch ``kernels`` once per block and no other."""
    import dataclasses

    import torch

    from lemas_tts_tpu_torch.models.dit import cast_matrices

    mel, vocab = cfg.mel_spec.n_mel_channels, 64
    inputs = _dit_inputs(torch, 1, 1024, mel, vocab, seed=0)
    arch = dataclasses.replace(cfg.arch, depth=2)
    torch.manual_seed(0)
    state = cls(arch, mel_dim=mel, text_num_embeds=vocab).state_dict()
    for dtype, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        outs = []
        for dev in ("cpu", "cuda"):
            model = cls(arch, mel_dim=mel, text_num_embeds=vocab, compute_dtype=dtype,
                        attn_backend=attn_backend)
            model.load_state_dict(state)
            model = cast_matrices(model, dtype).to(dev).eval()
            reset_counters()
            with attn_pack(pack), torch.no_grad():
                outs.append(model(*(t.to(dev) for t in inputs)).float().cpu())
            launches = read_counters()
        got, ref = outs[1], outs[0]
        rl2 = rel_l2(got, ref)
        print(f"[{tag}] {label}, depth 2, rows 2, N 1024, {dt}: card (kernels) vs CPU "
              f"(plain) rel-L2 {rl2:.3e} max-abs {max_abs(got, ref):.3e} "
              f"(tol {TOL_REL_L2[dt]:.0e}); card launches {launches}", flush=True)
        check(bool(torch.isfinite(got).all()), f"{label} {dt} output not finite")
        check(rl2 <= TOL_REL_L2[dt], f"{label} {dt}: rel-L2 {rl2:.3e} over tolerance")
        want = expected_launches(kernels, arch.depth, 1)
        check(launches == want, f"{label} {dt}: launches {launches}, expected {want}")


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


REF_TEXT = "some call me nature, others call me mother nature."
GEN_TEXT = ("i have been a silent spectator, watching species evolve, "
            "empires rise and fall, and always remember i am mighty.")


def run_requests(tts, label: str, n: int, kernels, dev: dict, ref_path: str, ref_text: str,
                 gen_text: str, bucket: int = 1024, tag: str = "slice") -> tuple:
    """``n`` TTS.infer requests (the first a warm-up) with the launch counts
    set to 0 just before and read just after; every request must launch each
    kernel of ``kernels`` depth x 32 times and no other kernel. Returns the
    counts and the (audio seconds, wall seconds) of the timed requests."""
    import numpy as np
    import torch

    want = expected_launches(kernels, tts.config.arch.depth * 32, 32)
    reset_counters()
    timed = []
    for i in range(n):
        before = read_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave, out_sr, spec = tts.infer(ref_path, ref_text, gen_text, seed=i,
                                       show_info=lambda *_: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in read_counters().items()}
        audio_s = len(wave) / out_sr
        print(f"[{tag}] {label} request {i} ({'warm-up' if i == 0 and n > 1 else 'timed'}): "
              f"{audio_s:.3f} audio-s in {wall:.3f} s = {audio_s / wall:.2f} audio-s/s "
              f"on {dev['card']}; launches {grew}", flush=True)
        check(out_sr == 24000, f"sample rate {out_sr}")
        check(wave.ndim == 1 and wave.size > 0 and bool(np.isfinite(wave).all()),
              "wave empty or not finite")
        check(spec.shape[0] == 100 and bool(np.isfinite(spec).all()), "mel bad")
        check(grew == want, f"{label}: launches per request {grew}, expected {want}")
        if i or n == 1:
            timed.append((audio_s, wall))
    launches = read_counters()
    audio = sum(a for a, _ in timed)
    wall = sum(w for _, w in timed)
    print(f"[{tag}] {label} timed: {audio:.3f} audio-s in {wall:.3f} s wall = "
          f"{audio / wall:.2f} audio-s/s (NFE 32, CFG 2, B 1, bucket {bucket}) on {dev['card']}",
          flush=True)
    return launches, timed


def phase_slice(dev: dict) -> dict:
    """TTS.infer at full depth on the card along each path: the flagship
    config (then the same model under LEMAS_ATTN_PACK=1), F5-TTS v0
    ``f5tts_base``, and the MMDiT backbone at the flagship's arch. Returns the
    launch counts summed over the paths' counted runs."""
    import torch

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.config import SamplerConfig
    from lemas_tts_tpu_torch.infer.pipeline import TEXT_BUCKETS, pick_bucket
    from lemas_tts_tpu_torch.infer.preprocess import preprocess_ref_audio_text
    from lemas_tts_tpu_torch.utils.audio_io import write_wav
    from lemas_tts_tpu_torch.utils.vocab import text_to_ids

    totals = dict.fromkeys(kernel_counters(), 0)
    with tempfile.TemporaryDirectory() as d:
        vocab = Path(d) / "vocab.txt"
        vocab.write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz0123456789")
                                    + list(",.!?'-")) + "\n")
        ref_path = str(Path(d) / "ref.wav")
        write_wav(ref_path, _reference_wave(16000, 3.0, seed=0), 16000)
        ref_text, gen_text = REF_TEXT, GEN_TEXT
        mmdit_path = _flagship_as_mmdit(Path(d))
        paths = [("multilingual", [("flagship", 3, False, FLAGSHIP_KERNELS),
                                   ("flagship LEMAS_ATTN_PACK=1", 1, True, PACK_KERNELS)]),
                 ("f5tts_base", [("v0 f5tts_base", 2, False, V0_KERNELS)]),
                 (str(mmdit_path), [("MMDiT", 2, False, MMDIT_KERNELS)])]
        for model, runs in paths:
            t0 = time.perf_counter()
            # device None: the card; a character vocab, so no text frontend
            tts = TTS(model=model, vocab_file=str(vocab), frontend=None)
            check(tts.device.type == "cuda" and next(tts.dit.parameters()).is_cuda,
                  "TTS() did not place the model on the card")
            a = tts.config.arch
            wav, sr, rtext = preprocess_ref_audio_text(ref_path, ref_text,
                                                       show_info=lambda *_: None)
            bucket = tts.synth.estimate_bucket(wav, sr, rtext, gen_text, SamplerConfig())
            nt = pick_bucket(len(text_to_ids(rtext + gen_text, tts.vocab)), TEXT_BUCKETS)
            print(f"[slice] TTS({Path(model).stem}) built on {tts.device} in "
                  f"{time.perf_counter() - t0:.1f} s ({tts.config.backbone}, random weights, "
                  f"depth {a.depth}, dim {a.dim}, {a.heads}x{a.dim_head} heads, pe_attn_head "
                  f"{a.pe_attn_head}); duration bucket {bucket}, text bucket {nt}", flush=True)
            check(bucket == 1024, f"request lands in bucket {bucket}, not 1024")
            for label, n, pack, kernels in runs:
                with attn_pack(pack):
                    launches, _ = run_requests(tts, label, n, kernels, dev, ref_path, ref_text,
                                               gen_text)
                totals = {k: totals[k] + launches[k] for k in totals}
            with attn_pack(False):
                profile_request(tts, ref_path, ref_text, gen_text)
            del tts
            torch.cuda.empty_cache()
    return totals


def _frontend_units(frontend, text: str) -> list:
    """The units ``TTS.prepare_units`` gives ``text`` with ``frontend``
    (checked against it once the model is built)."""
    if frontend.dtype == "phone":
        return frontend.text2phn(text + ". ").replace("(cmn)", "(zh)").split("|")
    lang, norm = frontend.text2norm(text + ". ")
    return [f"({lang.replace('cmn', 'zh')})"] + list(norm)


def _edit_inputs(d: Path) -> tuple:
    """A synthetic 10 s utterance at 24 kHz (937 frames: bucket 1024, RMS above
    the sampler's target, so the sampler keeps its scale and the kept frames
    are the reference mel as it is) and its alignment JSON: 20 words of 0.5 s,
    words 8-9 replaced. Returns (wav path, align dir, target text)."""
    from lemas_tts_tpu_torch.utils.audio_io import write_wav

    words = ("the old lighthouse keeper walked along the rocky shore every "
             "morning before the fishing boats came home with their catch").split()
    wav_dir, align_dir = d / "edit_wavs", d / "edit_align"
    wav_dir.mkdir()
    align_dir.mkdir()
    wav_path = wav_dir / "utt.wav"
    write_wav(str(wav_path), 2.0 * _reference_wave(24000, 10.0, seed=1), 24000)
    orig, new = " ".join(words[8:10]), "beside the quiet harbour"
    display = " ".join(words)
    (align_dir / "utt.json").write_text(json.dumps({
        "interval": [0.0, 10.0], "modified_index": [8, 10],
        "words": [{"word": w, "interval": [0.5 * i + 0.05, 0.5 * i + 0.45]}
                  for i, w in enumerate(words)],
        "modified_text": [orig, new], "display_text": display}))
    return wav_path, align_dir, display.replace(orig, new)


def _unit_vocab(d: Path, rtext: str, edit_text: str) -> tuple:
    """A vocab of " " and every unit of this run's texts (the reference, the
    generated text, the edit's target), in both frontends and in their
    separate_langs forms. Returns (vocab path, the frontends by name, the
    units by (frontend, text))."""
    import types

    from lemas_tts_tpu_torch.api import process_phone_list
    from lemas_tts_tpu_torch.scripts import speech_edit_multilingual as edit_cli
    from lemas_tts_tpu_torch.text import TextNorm

    frontends = {dt: TextNorm(dt) for dt in ("phone", "char")}
    units = {(dt, t): _frontend_units(fe, t) for dt, fe in frontends.items()
             for t in (rtext, GEN_TEXT)}
    edit_units = edit_cli.build_tokens_from_text(
        types.SimpleNamespace(frontend=frontends["phone"]), edit_text)
    seqs = list(units.values()) + [edit_units]
    vocab_units = sorted({u for q in seqs for u in q + process_phone_list(q)} - {" "})
    vocab = d / "phone_vocab.txt"
    vocab.write_text("\n".join([" "] + vocab_units) + "\n")
    return vocab, frontends, units


def phase_frontend(dev: dict, model: str = "multilingual") -> dict:
    """The text frontend on the flagship at full depth and width: ``TTS`` with
    its default ``frontend="phone"`` on a phone vocab made by the port's
    ``TextNorm`` from this run's texts (one warm-up and one timed request,
    bucket 1024, K1-K3 depth x 32 each), the host time of ``prepare_units``,
    then one request with ``frontend="char"`` on the same model; then speech
    editing through ``speech_edit_multilingual.main()`` (NFE 64, CFG 5, sway 3:
    K1-K3 depth x 64 each) with its kept frames held bit for bit against the
    reference mel. Returns the launch counts summed over these runs."""
    import importlib.util

    import numpy as np
    import torch

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.config import SamplerConfig
    from lemas_tts_tpu_torch.infer.pipeline import TEXT_BUCKETS, pick_bucket
    from lemas_tts_tpu_torch.infer.preprocess import preprocess_ref_audio_text
    from lemas_tts_tpu_torch.text import tokenizer
    from lemas_tts_tpu_torch.utils.audio_io import write_wav
    from lemas_tts_tpu_torch.utils.vocab import text_to_ids

    totals = dict.fromkeys(kernel_counters(), 0)
    tier = "espeak-ng" if tokenizer.available() else "builtin-ipa"
    backends = ", ".join(f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}"
                         for m in ("phonemizer", "jieba", "pypinyin", "langid"))
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        ref_path = str(d / "ref.wav")
        write_wav(ref_path, _reference_wave(16000, 3.0, seed=0), 16000)
        wav, sr, rtext = preprocess_ref_audio_text(ref_path, REF_TEXT, show_info=lambda *_: None)
        wav_path, align_dir, edit_text = _edit_inputs(d)
        vocab, frontends, units = _unit_vocab(d, rtext, edit_text)

        t0 = time.perf_counter()
        tts = TTS(model=model, vocab_file=str(vocab))  # default frontend: "phone"
        check(tts.device.type == "cuda" and tts.frontend is not None
              and tts.frontend.dtype == "phone", "TTS() is not the phone frontend on the card")
        for dt, fe in frontends.items():
            tts.frontend = fe
            for t in (rtext, GEN_TEXT):
                check(tts.prepare_units(t) == units[dt, t], f"prepare_units ({dt}) differs")
        tts.frontend = frontends["phone"]
        # host time of the request's frontend work (reference + one chunk)
        host = []
        for _ in range(21):
            t1 = time.perf_counter()
            ref_units, gen_units = tts.prepare_units(rtext), tts.prepare_units(GEN_TEXT)
            host.append((time.perf_counter() - t1) * 1e3)
        ids = text_to_ids(ref_units + gen_units, tts.vocab)
        check(bool((ids > 0).all()), "a phone unit is not in the vocab")
        bucket = tts.synth.estimate_bucket(wav, sr, ref_units, gen_units, SamplerConfig())
        a = tts.config.arch
        print(f"[frontend] TTS({model}) built on {tts.device} in {time.perf_counter() - t0:.1f} s "
              f"(frontend {tts.frontend.dtype}, phone vocab of {tts.vocab.size} units, depth "
              f"{a.depth}, dim {a.dim}); G2P tier {tier} ({backends}); request: "
              f"{len(ref_units)} + {len(gen_units)} phone units, duration bucket {bucket}, "
              f"text bucket {pick_bucket(len(ids), TEXT_BUCKETS)}; prepare_units host ms per "
              f"request: "
              f"first {host[0]:.3f}, median of 20 more {float(np.median(host[1:])):.3f}",
              flush=True)
        check(bucket == 1024, f"the phone request lands in bucket {bucket}, not 1024")
        launches, _ = run_requests(tts, "flagship phone frontend", 2, FLAGSHIP_KERNELS, dev,
                                   ref_path, REF_TEXT, GEN_TEXT)
        totals = {k: totals[k] + launches[k] for k in totals}
        profile_request(tts, ref_path, REF_TEXT, GEN_TEXT)
        # the same model and text as phone units and as the raw string, in
        # turns (phone, raw, raw, phone), so the host's drift over the run
        # falls on both sides: the frontend's effect on a request's wall time
        walls = {"phone": [], "raw": []}
        for kind in ("phone", "raw", "raw", "phone"):
            tts.frontend = frontends["phone"] if kind == "phone" else None
            launches, timed = run_requests(tts, f"flagship in turns, {kind}", 1,
                                           FLAGSHIP_KERNELS, dev, ref_path, REF_TEXT, GEN_TEXT)
            totals = {k: totals[k] + launches[k] for k in totals}
            walls[kind] += [round(w, 4) for _, w in timed]
        print(f"[frontend] the same model in turns (phone, raw, raw, phone): wall s per request "
              f"phone {walls['phone']}, raw {walls['raw']} on {dev['card']}", flush=True)

        tts.frontend = frontends["char"]  # the same model through the char frontend
        ref_c, gen_c = tts.prepare_units(rtext), tts.prepare_units(GEN_TEXT)
        bucket_c = tts.synth.estimate_bucket(wav, sr, ref_c, gen_c, SamplerConfig())
        print(f"[frontend] char frontend on the same model: {len(ref_c)} + {len(gen_c)} char "
              f"units, duration bucket {bucket_c}", flush=True)
        launches, _ = run_requests(tts, "flagship char frontend", 1, FLAGSHIP_KERNELS, dev,
                                   ref_path, REF_TEXT, GEN_TEXT, bucket=bucket_c)
        totals = {k: totals[k] + launches[k] for k in totals}
        del tts
        torch.cuda.empty_cache()

        launches = phase_edit(dev, model, vocab, wav_path, align_dir, d / "edited")
        totals = {k: totals[k] + launches[k] for k in totals}
    return totals


def phase_edit(dev: dict, model: str, vocab: Path, wav_path: Path, align_dir: Path,
               save_dir: Path, flags=(), tag: str = "edit", kernels=FLAGSHIP_KERNELS) -> dict:
    """Speech editing through the CLI's ``main()`` with its defaults (and
    ``flags``), the launch counts set to 0 just before and read just after.
    ``edit_speech`` is wrapped to keep what it was given and gave back; its
    kept frames must equal the reference mel of the utterance bit for bit
    (plus the ``prosody_to_mel`` offset of its embedding, when the edit is
    prosody-conditioned), every edited frame must differ from it, and the
    written WAV must be finite."""
    import numpy as np
    import torch

    from lemas_tts_tpu_torch.cfm.sampler import DURATION_BUCKETS, pick_bucket
    from lemas_tts_tpu_torch.config import load_model_config
    from lemas_tts_tpu_torch.infer import editing
    from lemas_tts_tpu_torch.scripts import speech_edit_multilingual as edit_cli
    from lemas_tts_tpu_torch.utils.audio_io import read_audio

    seen = {}
    edit_speech = editing.edit_speech

    def recorded(synth, wav, sr, tokens, parts, **kw):
        t0 = time.perf_counter()
        out = edit_speech(synth, wav, sr, tokens, parts, **kw)  # ends on the host
        seen.update(synth=synth, wav=np.asarray(wav, np.float32), sr=sr, parts=parts,
                    cfg=kw["cfg"], out=out, seconds=time.perf_counter() - t0,
                    tokens=list(tokens))
        return out

    editing.edit_speech = recorded
    try:
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = edit_cli.main(["--wav", str(wav_path), "--align_dir", str(align_dir),
                            "--save_dir", str(save_dir), "--model", model,
                            "--vocab_file", str(vocab), "--seed", "0", *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
    finally:
        editing.edit_speech = edit_speech
    check(rc == 0 and "out" in seen, f"speech_edit_multilingual.main() returned {rc}")
    synth, cfg = seen["synth"], seen["cfg"]
    depth = load_model_config(model).arch.depth
    wave, out_sr, mel = seen["out"]
    hop = synth.mel_cfg.hop_length
    ref = synth.ref_mel(seen["wav"])  # the cond mel edit_speech pasted from
    prosody = synth.uses_prosody(cfg)
    if prosody:  # the offset edit_speech added over the utterance's frames
        ref = ref + synth.prosody_embedding(seen["wav"])[1][None, :]
    frames = ref.shape[0]
    keep = editing.build_edit_mask(seen["parts"], len(seen["wav"]), seen["sr"], hop)[:frames]
    check(mel.shape[1] > frames, f"edit: {mel.shape[1]} mel frames for {frames} of the utterance")
    got = mel.T[:frames]
    rms = float(np.sqrt(np.mean(np.square(seen["wav"]))))
    bucket = pick_bucket(mel.shape[1], DURATION_BUCKETS)
    print(f"[{tag}] speech_edit_multilingual.main({' '.join(flags)}) on {synth.device}: "
          f"prosody-conditioned {prosody}; NFE {cfg.nfe_steps}, CFG "
          f"{cfg.cfg_strength}, sway {cfg.sway_sampling_coef}; "
          f"{seen['wav'].shape[0] / seen['sr']:.2f} s utterance ({frames} mel frames, RMS "
          f"{rms:.3f}), {len(seen['tokens'])} units, edit span {seen['parts']} s, "
          f"{int((~keep).sum())} frames regenerated; mel {mel.shape[1]} frames, bucket {bucket}; "
          f"edit_speech {seen['seconds']:.3f} s, main() {wall:.3f} s wall (model build "
          f"included) on {dev['card']}; launches {launches}", flush=True)
    check(synth.device.type == "cuda", "the edit did not run on the card")
    check(prosody == ("--use_prosody_encoder" in flags),
          f"edit: prosody-conditioned {prosody} with flags {list(flags)}")
    check((cfg.nfe_steps, cfg.cfg_strength, cfg.sway_sampling_coef) == (64, 5.0, 3.0),
          "the edit CLI's defaults are not NFE 64, CFG 5, sway 3")
    check(seen["sr"] == out_sr == 24000 and rms >= cfg.target_rms,
          "the utterance is rescaled or resampled: its mel is not the reference")
    check(bucket == 1024, f"the edit ({mel.shape[1]} frames) does not land in bucket 1024")
    check(all(t in synth.vocab.char_map for t in seen["tokens"]),
          "an edit unit is not in the vocab")
    want = expected_launches(kernels, depth * 64, 64)
    check(launches == want, f"edit: launches {launches}, expected {want}")
    kept_equal = np.array_equal(got[keep], ref[keep])
    edited_differ = bool((got[~keep] != ref[~keep]).any(axis=1).all())
    print(f"[{tag}] kept frames ({int(keep.sum())}) equal to the reference mel"
          f"{' + prosody offset' if prosody else ''} bit for bit: "
          f"{kept_equal}; every regenerated frame differs from it: {edited_differ}", flush=True)
    check(kept_equal, "edit: kept frames differ from the reference mel")
    check(edited_differ and (~keep).any(), "edit: regenerated frames equal the reference mel")
    written, wsr = read_audio(str(save_dir / "utt.wav"))
    check(wave.size > 0 and bool(np.isfinite(wave).all()) and wsr == 24000
          and written.shape[-1] == wave.size and bool(np.isfinite(written).all()),
          "edit: the edited wave is empty or not finite")
    return launches



def profiled(fn, label: str, top: int = 12) -> dict:
    """``fn()`` once under torch.profiler (``utils/profiling.py:profile_card``):
    the card's busy time (the union of its kernels' intervals: a graph's
    kernels may overlap), the kernels' summed time by kernel, and the idle
    share of the call's wall time (which ends in a sync). Fails if the busy
    time exceeds the wall time."""
    out = profile_card(fn)
    rows, summed = out.pop("rows"), out["summed_ms"] * 1e3
    print(f"[profile] {label} under torch.profiler: wall {out['wall_ms']:.1f} ms, card busy "
          f"{out['busy_ms']:.1f} ms (union of {out['intervals']} intervals; kernel times summed "
          f"{out['summed_ms']:.1f} ms) in {out['kernels']} kernels, idle share "
          f"{out['idle']:.3f}", flush=True)
    for us, count, key in rows[:top]:
        print(f"[profile] {us / 1e3:9.2f} ms {100 * us / max(summed, 1e-9):5.1f} % x{count:6d}  "
              f"{key[:90]}", flush=True)
    check(0 < out["busy_ms"] <= out["wall_ms"], f"{label}: card busy {out['busy_ms']:.3f} ms "
                                                f"against a wall of {out['wall_ms']:.3f} ms")
    return out


def profile_request(tts, ref_path: str, ref_text: str, gen_text: str) -> dict:
    """One more request (after the counted runs) under torch.profiler."""
    return profiled(lambda: tts.infer(ref_path, ref_text, gen_text, seed=3,
                                      show_info=lambda *_: None), "one request")


CHAR_VOCAB = [" "] + list("abcdefghijklmnopqrstuvwxyz0123456789") + list(",.!?'-")


def _timed(fn) -> tuple:
    """(fn()'s result, wall seconds), the call ending in a sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def graphed_request(tts, tag: str, kernels, ref_path: str) -> tuple:
    """One B = 1 request after its bucket's graph was captured (``warmup``),
    the counts set to 0 just before and read just after: it must replay the
    one graph (launches = its record = depth x 32 of each kernel of
    ``kernels``, no other), and its mel must equal a direct ``sample_mel`` on
    the same inputs (bit for bit, or rel-L2 <= 1e-6). Returns (launches,
    wave, mel, wall s, the recorded sampler call, the direct call)."""
    import torch

    from lemas_tts_tpu_torch.cfm.sampler import sample_mel, sway_time_grid

    seen, run = {}, tts.synth.run_sampler

    def recorded(settings, *args):
        out = run(settings, *args)
        seen.update(settings=settings, out=out.clone(),
                    args=[None if a is None else a.clone() for a in args])
        return out

    tts.synth.run_sampler = recorded
    try:
        reset_counters()
        (wave, _, spec), wall = _timed(lambda: tts.infer(ref_path, REF_TEXT, GEN_TEXT, seed=0,
                                                         show_info=lambda *_: None))
        got = read_counters()
    finally:
        del tts.synth.run_sampler
    want = expected_launches(kernels, tts.config.arch.depth * 32, 32)
    check(got == want, f"{tag} graphed request: launches {got}, expected {want}")
    graphs = list(tts.synth._graphs.values())
    check(len(graphs) == 1 and got == {k: graphs[0].launches_per_replay.get(k, 0)
                                       for k in got},
          f"{tag}: launches {got} are not 1 replay of the one graph's")
    s = seen["settings"]
    cond, cond_mask, text_ids, duration, y0, step_cond, prosody_text = seen["args"]
    grid = sway_time_grid(s.steps, s.sway_sampling_coef, s.t_start)

    def eager():
        return sample_mel(tts.dit, cond=cond, cond_mask=cond_mask, text_ids=text_ids,
                          duration=duration, y0=y0, time_grid=grid, settings=s,
                          step_cond=step_cond, prosody_text=prosody_text)

    ref_out = eager()
    same = torch.equal(ref_out, seen["out"])
    err = rel_l2(seen["out"], ref_out)
    print(f"[{tag}] graphed B 1 mel against a direct sample_mel on the same inputs: equal "
          f"bit for bit {same}, rel-L2 {err:.3e}, max-abs {max_abs(seen['out'], ref_out):.3e}",
          flush=True)
    check(same or err <= 1e-6, f"{tag}: graph replay differs from sample_mel: rel-L2 {err:.3e}")
    return got, wave, spec, wall, seen, eager


def serving_refresh_steps(settings, steps: int = 32) -> tuple:
    """(CFG steps, refresh steps in the CFG prefix, refresh steps in the
    cond-only tail) of a block-cached sampler, from the port's own
    ``cfg_active_steps`` and ``block_cache_flags``; the tail refreshes at its
    first step, where the batch width halves."""
    from lemas_tts_tpu_torch.cfm.sampler import block_cache_flags, sway_time_grid

    k = settings.cfg_active_steps(sway_time_grid(steps, settings.sway_sampling_coef))
    flags = block_cache_flags(settings, steps)
    tail = flags[k:].copy()
    if tail.size:
        tail[0] = True
    return k, int(flags[:k].sum()), int(tail.sum())


def serving_settings(synth):
    """The sampler settings ``serve_http`` runs at its defaults."""
    from lemas_tts_tpu_torch.config import (SERVING_BLOCK_CACHE, SERVING_CFG_CUTOFF,
                                            SamplerConfig)

    return synth._settings(SamplerConfig(nfe_steps=32, cfg_strength=3.0, sway_sampling_coef=1.0,
                                         cfg_cutoff=SERVING_CFG_CUTOFF,
                                         block_cache=SERVING_BLOCK_CACHE))


def phase_graph(dev: dict) -> tuple:
    """The flagship sampler as a CUDA graph, and the serving modes on it.
    Returns (launch counts summed over the counted requests, the eager and
    graphed B = 1 profiles)."""
    import numpy as np
    import torch

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.cfm.sampler import sample_mel, sway_time_grid
    from lemas_tts_tpu_torch.config import SERVING_BLOCK_CACHE, SERVING_CFG_CUTOFF, SamplerConfig
    from lemas_tts_tpu_torch.infer.pipeline import TEXT_BUCKETS, pick_bucket
    from lemas_tts_tpu_torch.infer.preprocess import preprocess_ref_audio_text
    from lemas_tts_tpu_torch.utils.audio_io import write_wav
    from lemas_tts_tpu_torch.utils.vocab import text_to_ids

    totals = dict.fromkeys(kernel_counters(), 0)
    quiet = dict(show_info=lambda *_: None)

    def count(label, fn, kernels, blocks, forwards):
        """fn() with the counts set to 0 just before and read just after;
        it must launch ``expected_launches(kernels, blocks, forwards)``."""
        reset_counters()
        out, wall = _timed(fn)
        got = read_counters()
        want = expected_launches(kernels, blocks, forwards)
        check(got == want, f"{label}: launches {got}, expected {want}")
        for k in totals:
            totals[k] += got[k]
        return out, wall, got

    def report(label, wave, wall, launches):
        audio = len(wave) / 24000
        check(wave.ndim == 1 and wave.size > 0 and bool(np.isfinite(wave).all()),
              f"{label}: wave empty or not finite")
        print(f"[graph] {label}: {audio:.3f} audio-s in {wall:.3f} s = {audio / wall:.2f} "
              f"audio-s/s on {dev['card']}; launches {launches}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        vocab = d / "vocab.txt"
        vocab.write_text("\n".join(CHAR_VOCAB) + "\n")
        ref_path = str(d / "ref.wav")
        write_wav(ref_path, _reference_wave(16000, 3.0, seed=0), 16000)
        wav, sr, rtext = preprocess_ref_audio_text(ref_path, REF_TEXT, **quiet)
        t0 = time.perf_counter()
        tts = TTS(model="multilingual", vocab_file=str(vocab), frontend=None)
        depth = tts.config.arch.depth
        nt = pick_bucket(len(text_to_ids(rtext + GEN_TEXT, tts.vocab)), TEXT_BUCKETS)
        plain = SamplerConfig(nfe_steps=32, cfg_strength=2.0, sway_sampling_coef=5)  # infer's
        t1 = time.perf_counter()
        n = tts.synth.warmup(plain, duration_buckets=(1024,), text_buckets=(nt,),
                             batch_buckets=(1,))
        print(f"[graph] TTS(multilingual) built in {t1 - t0:.1f} s; warmup captured {n} graph "
              f"(B 1, bucket 1024, text bucket {nt}) in {time.perf_counter() - t1:.1f} s",
              flush=True)
        check(n == 1, f"warmup captured {n} graphs, not 1")

        # graph parity: one request replays the graph; the same inputs through sample_mel
        run = tts.synth.run_sampler
        got, wave, spec, wall, seen, eager = graphed_request(tts, "graph", FLAGSHIP_KERNELS,
                                                             ref_path)
        for k in totals:
            totals[k] += got[k]
        report("B 1 request, graph replay (NFE 32, CFG 2)", wave, wall, got)
        graphs = list(tts.synth._graphs.values())
        s = seen["settings"]

        # two buckets' first calls at once, as a server's threads make them:
        # one thread's eager run may fall inside the other's capture, yet each
        # eager run counts once and each graph records only its own launches
        errors = []

        def first_call(N):
            try:
                tts.synth.warmup(plain, duration_buckets=(N,), text_buckets=(nt,),
                                 batch_buckets=(1,))
            except BaseException as e:  # handed to the main thread below
                errors.append(e)

        reset_counters()
        firsts = [threading.Thread(target=first_call, args=(N,)) for N in (512, 768)]
        t0 = time.perf_counter()
        for t in firsts:
            t.start()
        for t in firsts:
            t.join(600)
        torch.cuda.synchronize()
        if errors:
            raise errors[0]
        got = read_counters()
        for k in totals:
            totals[k] += got[k]
        new = [g for g in tts.synth._graphs.values() if g is not graphs[0]]
        one = expected_launches(FLAGSHIP_KERNELS, depth * 32, 32)
        print(f"[graph] two first calls at once (B 1, buckets 512 and 768) in "
              f"{time.perf_counter() - t0:.1f} s: launches {got}; the graphs record "
              f"{[g.launches_per_replay for g in new]}", flush=True)
        check(got == expected_launches(FLAGSHIP_KERNELS, 2 * depth * 32, 2 * 32)
              and len(new) == 2
              and all({k: g.launches_per_replay.get(k, 0) for k in one} == one for g in new),
              "concurrent first calls: the counts or the graphs' records are not their own")
        walls = {"eager": [], "graph": []}
        for kind in ("eager", "graph", "graph", "eager"):
            fn = eager if kind == "eager" else (lambda: run(s, *seen["args"]))
            walls[kind].append(_timed(fn)[1] * 1e3)
        print(f"[graph] sampler B 1 wall ms in turns (eager, graph, graph, eager): eager "
              f"{[round(w, 1) for w in walls['eager']]}, graph "
              f"{[round(w, 1) for w in walls['graph']]} on {dev['card']}", flush=True)
        profiles = {"eager": profiled(eager, "eager sample_mel, B 1, NFE 32, CFG 2", top=6),
                    "graph": profiled(lambda: run(s, *seen["args"]),
                                      "graph replay of the same sampler, B 1", top=6)}
        # whole requests with the sampler run eagerly (this script swaps
        # run_sampler for sample_mel; the port has no such switch), in turns
        # with graphed ones
        tts.synth.run_sampler = lambda st, *a: sample_mel(
            tts.dit, cond=a[0], cond_mask=a[1], text_ids=a[2], duration=a[3], y0=a[4],
            step_cond=a[5], prosody_text=a[6], settings=st,
            time_grid=sway_time_grid(st.steps, st.sway_sampling_coef, st.t_start))
        (wave, _, _), wall, got = count(
            "eager request", lambda: tts.infer(ref_path, REF_TEXT, GEN_TEXT, seed=0, **quiet),
            FLAGSHIP_KERNELS, depth * 32, 32)
        report("B 1 request, sampler eager", wave, wall, got)
        del tts.synth.run_sampler
        (wave, _, _), wall, got = count(
            "graphed request", lambda: tts.infer(ref_path, REF_TEXT, GEN_TEXT, seed=0, **quiet),
            FLAGSHIP_KERNELS, depth * 32, 32)
        report("B 1 request, graph replay", wave, wall, got)

        # serving modes on the bf16 model
        serving = dict(nfe_step=32, cfg_strength=3.0, sway_sampling_coef=1.0,
                       cfg_cutoff=SERVING_CFG_CUTOFF, seed=0, **quiet)
        k, prefix, tail = serving_refresh_steps(serving_settings(tts.synth))
        refresh = prefix + tail
        print(f"[graph] block cache {SERVING_BLOCK_CACHE} at NFE 32, CFG 3, sway 1, cutoff "
              f"{SERVING_CFG_CUTOFF}: {k} CFG steps, {32 - k} cond-only; {prefix} + {tail} "
              f"refresh steps, so {refresh} x {depth} launches a kernel", flush=True)
        (_, _, spec_exact), wall, got = count(
            "cutoff, no cache", lambda: tts.infer(ref_path, REF_TEXT, GEN_TEXT, **serving),
            FLAGSHIP_KERNELS, depth * 32, 32)
        for i in range(2):  # the capture, then a replay
            (wave, _, spec_cache), wall, got = count(
                "block cache", lambda: tts.infer(ref_path, REF_TEXT, GEN_TEXT,
                                                 block_cache=SERVING_BLOCK_CACHE, **serving),
                FLAGSHIP_KERNELS, depth * refresh, 32)
            report(f"block cache request {i} ({'capture' if i == 0 else 'replay'})", wave, wall,
                   got)
        print(f"[graph] block cache mel against the uncached mel (same noise, cutoff): rel-L2 "
              f"{rel_l2(torch.from_numpy(spec_cache), torch.from_numpy(spec_exact)):.3e}",
              flush=True)
        mid = SamplerConfig(nfe_steps=16, cfg_strength=2.0, sway_sampling_coef=5,
                            ode_method="midpoint")
        for i in range(2):
            (wave, _, _), wall, got = count(
                "midpoint", lambda: tts.synth.synthesize_chunks(wav, sr, rtext, [GEN_TEXT],
                                                                cfg=mid, seed=0),
                FLAGSHIP_KERNELS, depth * 2 * 16, 2 * 16)
            report(f"midpoint NFE 16 request {i}", wave, wall, got)
        del tts
        gc.collect()
        torch.cuda.empty_cache()

        for mode, kernels in (("int8", ("vmem_attention_nhd",)),
                              ("int8_ff", ("qkv_block", "vmem_attention_nhd"))):
            qtts = TTS(model="multilingual", vocab_file=str(vocab), frontend=None,
                       quantization=mode)
            for i in range(2):
                (wave, _, qspec), wall, got = count(
                    mode, lambda: qtts.infer(ref_path, REF_TEXT, GEN_TEXT, seed=0, **quiet),
                    kernels, depth * 32, 32)
                report(f"{mode} request {i}", wave, wall, got)
            err = rel_l2(torch.from_numpy(qspec), torch.from_numpy(spec))
            lo, hi = INT8_REL_L2
            print(f"[graph] {mode} mel against bf16 (same weights before quantization, same "
                  f"noise): rel-L2 {err:.3e} (bounds {lo:.0e} to {hi:.0e})", flush=True)
            check(qspec.shape == spec.shape and lo <= err <= hi,
                  f"{mode}: rel-L2 {err:.3e} against bf16 lies outside [{lo:.0e}, {hi:.0e}]")
            del qtts
            gc.collect()
            torch.cuda.empty_cache()

    int8_product_check()
    return totals, profiles


def int8_product_check() -> None:
    """``int8_dense``'s product on the card (``torch._int_mm``) equals the
    CPU's int32 integer math, at the flagship's q/k/v, FF-up and FF-down
    shapes (B 1 under CFG: rows 2048)."""
    import torch

    from lemas_tts_tpu_torch.ops import quant

    g = torch.Generator(device="cuda").manual_seed(7)
    for rows, k_in, n_out in ((2048, 1024, 1024), (2048, 1024, 2048), (2048, 2048, 1024)):
        x = torch.randn(rows, k_in, generator=g, device="cuda").to(torch.bfloat16)
        w = torch.randn(n_out, k_in, generator=g, device="cuda")
        x_q, _ = quant.quantize_activation(x)
        w_q, _ = quant.quantize_weight(w)
        got = quant.int8_matmul(x_q, w_q)
        ref = quant.int8_matmul(x_q.cpu(), w_q.cpu())
        same = torch.equal(got.cpu(), ref)
        print(f"[graph] int8_dense product [{rows}, {k_in}] x [{n_out}, {k_in}]^T: torch._int_mm "
              f"on the card equal to the CPU's int32 math: {same}", flush=True)
        check(same, "int8 product on the card differs from the CPU's")


def _http(port: int, method: str, path: str, body=None, timeout: float = 600.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def phase_serve(dev: dict, eager_b1: dict) -> dict:
    """``serve_http`` in-process at its defaults with ``--max_batch 8
    --warmup_batches 1,8``: two waves of 8 concurrent /tts requests (each one
    batch of 8, K3 only under int8, 18 x depth launches a batch), one
    /tts_stream of 3 chunks, /healthz, /config, one B = 8 batch profiled.
    Returns the launch counts of the two waves."""
    import http.client
    import io
    import wave as wave_mod

    import numpy as np
    import torch

    from lemas_tts_tpu_torch.config import SERVING_BLOCK_CACHE
    from lemas_tts_tpu_torch.scripts import serve_http
    from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav

    totals = dict.fromkeys(kernel_counters(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        vocab = d / "vocab.txt"
        vocab.write_text("\n".join(CHAR_VOCAB) + "\n")
        ref_path = str(d / "ref.wav")
        write_wav(ref_path, _reference_wave(16000, 3.0, seed=0), 16000)
        # the serving default's 15 ms batching window (the JAX server's) is
        # shorter than eight clients take to post here: wait up to 2 s for a
        # full batch
        args = serve_http.build_parser().parse_args(
            ["--port", "0", "--vocab_file", str(vocab), "--frontend", "none", "--max_batch", "8",
             "--warmup_batches", "1,8", "--max_wait_ms", "2000"])
        ready, box, failed = threading.Event(), [], []

        def run_server():
            try:
                serve_http.serve(args, ready_event=ready, server_box=box)
            except BaseException as e:  # handed to the main thread below
                failed.append(e)
                ready.set()

        t0 = time.perf_counter()
        server = threading.Thread(target=run_server, daemon=True)
        server.start()
        check(ready.wait(900), "serve_http did not start")
        if failed:
            raise failed[0]
        httpd, engine = box[0]
        port = httpd.server_address[1]

        def memory(when: str) -> None:
            print(f"[serve] card memory {when}: reserved {torch.cuda.memory_reserved() / 2**20:.0f}"
                  f" MiB, allocated {torch.cuda.memory_allocated() / 2**20:.0f} MiB, peak "
                  f"reserved {torch.cuda.max_memory_reserved() / 2**20:.0f} MiB; "
                  f"{len(engine.synth._graphs)} sampler graphs cached", flush=True)

        try:
            print(f"[serve] serve_http ready on 127.0.0.1:{port} in "
                  f"{time.perf_counter() - t0:.1f} s (model build, warmup and dispatch warmup "
                  f"of batches 1 and 8)", flush=True)
            memory("after warmup")
            status, _, body = _http(port, "GET", "/healthz")
            check(status == 200 and json.loads(body)["ok"], f"/healthz: {status} {body!r}")
            status, _, body = _http(port, "GET", "/config")
            conf = json.loads(body)
            print(f"[serve] /config: {conf}", flush=True)
            check(status == 200 and (conf["nfe_steps"], conf["cfg_strength"],
                                     conf["sway_sampling_coef"], conf["cfg_cutoff"],
                                     conf["block_cache"], conf["quant"], conf["max_batch"],
                                     conf["device"])
                  == (32, 3.0, 1.0, 0.5, SERVING_BLOCK_CACHE, "int8", 8, "cuda"),
                  "serve_http's defaults differ from the JAX server's")
            depth = len(engine.synth.dit_model.transformer_blocks)
            _, prefix, tail = serving_refresh_steps(serving_settings(engine.synth))
            per_batch = expected_launches(("vmem_attention_nhd",), (prefix + tail) * depth, 32)
            payload = dict(ref_path=ref_path, ref_text=REF_TEXT, text=GEN_TEXT)
            for wave_no in (1, 2):
                results = [None] * 8
                start = threading.Barrier(9)

                def client(i):
                    start.wait()
                    t1 = time.perf_counter()
                    out = _http(port, "POST", "/tts", dict(payload, seed=i))
                    results[i] = out + (time.perf_counter() - t1,)

                threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
                for t in threads:
                    t.start()
                reset_counters()
                start.wait()
                t1 = time.perf_counter()
                for t in threads:
                    t.join(timeout=900)
                wall = time.perf_counter() - t1
                got = read_counters()
                check(got == per_batch, f"wave {wave_no}: launches {got}, one batch of 8 "
                                        f"launches {per_batch}")
                for k in totals:
                    totals[k] += got[k]
                audio = []
                for i, res in enumerate(results):
                    check(res is not None and res[0] == 200, f"/tts {i}: {res and res[:2]}")
                    with wave_mod.open(io.BytesIO(res[2]), "rb") as w:
                        rate = w.getframerate()
                        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
                    check(rate == 24000 and pcm.size > 0 and np.abs(pcm).max() > 0,
                          f"/tts {i}: {rate} Hz, {pcm.size} samples")
                    audio.append(pcm.size / rate)
                    print(f"[serve] wave {wave_no} request {i}: {audio[-1]:.3f} audio-s, wall "
                          f"{res[3]:.3f} s, {audio[-1] / res[3]:.2f} audio-s/s", flush=True)
                run = "captures the B 8 graph" if wave_no == 1 else "replays it"
                print(f"[serve] wave {wave_no} ({run}): "
                      f"{sum(audio):.3f} audio-s in {wall:.3f} s = {sum(audio) / wall:.2f} "
                      f"audio-s/s on {dev['card']}; launches {got}", flush=True)
            status, _, body = _http(port, "GET", "/stats")
            sizes = json.loads(body)["batch_sizes"]
            print(f"[serve] /stats batch sizes: {sizes}", flush=True)
            check(sizes == [8, 8], f"the waves did not form batches of 8: {sizes}")

            lines = ["the old lighthouse keeper walked home.", "the fishing boats came in late.",
                     "and the harbour lights went out."]
            ref_wav, ref_sr = read_audio(ref_path)
            chunks = None
            for run in ("captures its graphs", "replays them"):
                t1 = time.perf_counter()
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
                conn.request("POST", "/tts_stream", body=json.dumps(
                    dict(payload, text="\n".join(lines), seed=5, chunk_batch=2)))
                resp = conn.getresponse()  # the 200 follows the first chunk
                ttfb = time.perf_counter() - t1
                streamed = np.frombuffer(resp.read(), "<i2")
                total = time.perf_counter() - t1
                conn.close()
                check(resp.status == 200 and resp.getheader("Content-Type").startswith(
                    "audio/L16; rate=24000"), f"/tts_stream: {resp.status}")
                if chunks is None:
                    chunks = list(engine.synth.synthesize_stream(
                        ref_wav.mean(axis=0), ref_sr, REF_TEXT, lines, cfg=engine.cfg, seed=5,
                        chunk_batch=2, first_chunk_batch=1))
                # the server's first run of a bucket is the eager one, a
                # replay may differ in the PCM's last step
                pcm = [(np.clip(w, -1.0, 1.0) * 32767.0).astype("<i2") for w, _ in chunks]
                whole = np.concatenate(pcm)
                in_order = (len(pcm) == 3 and streamed.shape == whole.shape and int(np.abs(
                    streamed.astype(np.int32) - whole.astype(np.int32)).max()) <= 1)
                print(f"[serve] /tts_stream of {len(lines)} chunks ({run}): first audio after "
                      f"{ttfb:.3f} s, all {streamed.size / 24000:.3f} audio-s after {total:.3f} "
                      f"s; equal (to 1 PCM step), in order, to synthesize_stream's chunks "
                      f"({[p.size for p in pcm]} samples): {in_order}", flush=True)
                check(in_order and all(np.abs(p).max() > 0 for p in pcm),
                      "the stream's chunks are not synthesize_stream's, in order")

            memory("after the /tts waves and streams")
            reqs = [dict(ref_wav=ref_wav.mean(axis=0), ref_sr=ref_sr, ref_units=REF_TEXT,
                         gen_units=GEN_TEXT, seed=i) for i in range(8)]
            b8 = profiled(lambda: engine.synth.synthesize_requests(reqs, cfg=engine.cfg),
                          "one served B 8 batch (synthesize_requests, graph replay)", top=8)
            print(f"[serve] card busy per request: B 8 served batch {b8['busy_ms'] / 8:.1f} ms "
                  f"(idle share {b8['idle']:.3f}), eager B 1 sampler {eager_b1['busy_ms']:.1f} ms "
                  f"(idle share {eager_b1['idle']:.3f}), on {dev['card']}", flush=True)
        finally:
            httpd.shutdown()
            server.join(timeout=120)
        check(not server.is_alive(), "serve_http did not stop")
    return totals


# The prosody request's mel against the same request with the conditioning
# off (same weights, noise and kernels): rel-L2 must reach this. Without the
# conditioning the two would be one computation, rel-L2 0. The bar is about a
# seventh of the CPU test's reading (tests/test_torch_prosody.py, tiny model,
# NFE 32: 7.7e-4) and a twentieth of this phase's own on an H100 (2.08e-3), so
# a path that kept the prosody_to_mel offset and lost the prosody text, or the
# other way round, falls well short of the full conditioning's distance.
PROSODY_MIN_REL_L2 = 1e-4


def encoder_check(dev: dict) -> tuple:
    """The fbank and the ECAPA encoder at their default widths on the card
    against the CPU, f32 (TF32 off), on a 3 s reference at 16 kHz; the card
    ms of each. Returns (fbank ms, encoder ms incl. fbank)."""
    import torch

    from lemas_tts_tpu_torch.models.prosody import ProsodyEncoder
    from lemas_tts_tpu_torch.ops.fbank import extract_fbank_16k

    wav = torch.from_numpy(_reference_wave(16000, 3.0, seed=0))
    feats = {d: extract_fbank_16k(wav.to(d)) for d in ("cpu", "cuda")}
    enc = {d: ProsodyEncoder.build(device=d) for d in ("cpu", "cuda")}  # same seeded weights
    emb = {d: enc[d].embed(wav.to(d)) for d in ("cpu", "cuda")}
    wav_c = wav.cuda()
    fb_ms = device_ms([lambda: extract_fbank_16k(wav_c)])
    enc_ms = device_ms([lambda: enc["cuda"].embed(wav_c)])
    for name, got, ref in (("kaldi fbank [298, 80]", feats["cuda"], feats["cpu"]),
                           ("ECAPA-TDNN embedding [512]", emb["cuda"], emb["cpu"])):
        rl2 = rel_l2(got.cpu(), ref)
        print(f"[prosody] {name}, 3 s at 16 kHz, f32: card vs CPU rel-L2 {rl2:.3e} max-abs "
              f"{max_abs(got.cpu(), ref):.3e} (tol {TOL_REL_L2['f32']:.0e})", flush=True)
        check(bool(torch.isfinite(got).all()) and rl2 <= TOL_REL_L2["f32"],
              f"{name}: card vs CPU rel-L2 {rl2:.3e}")
    profiled(lambda: enc["cuda"].embed(wav_c), "prosody fbank + encoder, 3 s reference, f32",
             top=6)
    c = enc["cuda"].cfg
    print(f"[prosody] encoder (channels {list(c.channels)}, embed {c.embed_dim}, "
          f"{sum(p.numel() for p in enc['cuda'].model.parameters()) / 1e6:.2f} M parameters) "
          f"card ms per 3 s reference: fbank {fb_ms:.3f}, fbank + encoder {enc_ms:.3f} on "
          f"{dev['card']}", flush=True)
    return fb_ms, enc_ms


def phase_prosody(dev: dict) -> dict:
    """The prosody-conditioned ``multilingual_prosody`` (the flagship DiT and
    the Pretssel encoder at their default widths, random weights): the fbank
    and the encoder card against CPU; ``TTS`` with its default phone frontend,
    a warmed B = 1 request replaying its prosody graph (K1-K3 depth x 32 each,
    the mel equal to a direct ``sample_mel`` with the same prosody text), the
    request with ``use_prosody_encoder=False`` (which must differ), one
    request profiled; then ``speech_edit_multilingual.main()`` with
    ``--use_prosody_encoder``. Returns the launch counts of the counted runs."""
    import numpy as np
    import torch

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.cfm.sampler import sample_mel, sway_time_grid
    from lemas_tts_tpu_torch.config import SamplerConfig
    from lemas_tts_tpu_torch.infer.pipeline import TEXT_BUCKETS, pick_bucket
    from lemas_tts_tpu_torch.infer.preprocess import preprocess_ref_audio_text
    from lemas_tts_tpu_torch.utils.audio_io import write_wav
    from lemas_tts_tpu_torch.utils.vocab import text_to_ids

    fb_ms, enc_ms = encoder_check(dev)
    totals = dict.fromkeys(kernel_counters(), 0)
    quiet = dict(show_info=lambda *_: None)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        ref_path = str(d / "ref.wav")
        write_wav(ref_path, _reference_wave(16000, 3.0, seed=0), 16000)
        wav, sr, rtext = preprocess_ref_audio_text(ref_path, REF_TEXT, **quiet)
        wav_path, align_dir, edit_text = _edit_inputs(d)
        vocab, _, units = _unit_vocab(d, rtext, edit_text)
        t0 = time.perf_counter()
        tts = TTS(model="multilingual_prosody", vocab_file=str(vocab))
        check(tts.device.type == "cuda" and tts.use_prosody_encoder
              and tts.prosody_encoder.device.type == "cuda"
              and tts.frontend is not None and tts.frontend.dtype == "phone",
              "TTS(multilingual_prosody) is not the prosody model on the card")
        depth = tts.config.arch.depth
        ids = text_to_ids(units["phone", rtext] + units["phone", GEN_TEXT], tts.vocab)
        nt = pick_bucket(len(ids), TEXT_BUCKETS)
        plain = SamplerConfig(nfe_steps=32, cfg_strength=2.0, sway_sampling_coef=5)  # infer's
        t1 = time.perf_counter()
        n = tts.synth.warmup(plain, duration_buckets=(1024,), text_buckets=(nt,),
                             batch_buckets=(1,))
        print(f"[prosody] TTS(multilingual_prosody) built in {t1 - t0:.1f} s (phone frontend, "
              f"depth {depth}); warmup captured {n} prosody graph (B 1, bucket 1024, text "
              f"bucket {nt}) in {time.perf_counter() - t1:.1f} s", flush=True)
        check(n == 1 and all(k[-1] for k in tts.synth._graphs),
              f"warmup captured {n} graphs, not 1 prosody graph")

        seen, run = {}, tts.synth.run_sampler

        def recorded(settings, *args):
            out = run(settings, *args)
            seen.update(settings=settings, out=out.clone(),
                        args=[None if a is None else a.clone() for a in args])
            return out

        tts.synth.run_sampler = recorded
        try:
            reset_counters()
            (wave, _, spec_on), wall = _timed(lambda: tts.infer(ref_path, REF_TEXT, GEN_TEXT,
                                                                seed=0, **quiet))
            got = read_counters()
        finally:
            del tts.synth.run_sampler
        for k in totals:
            totals[k] += got[k]
        audio = len(wave) / 24000
        print(f"[prosody] B 1 request, prosody graph replay (NFE 32, CFG 2): {audio:.3f} "
              f"audio-s in {wall:.3f} s = {audio / wall:.2f} audio-s/s on {dev['card']}; "
              f"launches {got}", flush=True)
        check(got == expected_launches(FLAGSHIP_KERNELS, depth * 32, 32) and len(tts.synth._graphs)
              == 1, f"prosody request: launches {got}, not one replay of the prosody graph")
        check(wave.size > 0 and bool(np.isfinite(wave).all()), "prosody wave empty or not finite")
        s = seen["settings"]
        cond, cond_mask, text_ids, duration, y0, step_cond, pt = seen["args"]
        check(pt is not None and tuple(pt.shape) == (1, nt, 512),
              f"the sampler got prosody text {None if pt is None else tuple(pt.shape)}")
        ref_out = sample_mel(tts.dit, cond=cond, cond_mask=cond_mask, text_ids=text_ids,
                             duration=duration, y0=y0, step_cond=step_cond, prosody_text=pt,
                             settings=s, time_grid=sway_time_grid(s.steps, s.sway_sampling_coef,
                                                                  s.t_start))
        same = torch.equal(ref_out, seen["out"])
        err = rel_l2(seen["out"], ref_out)
        print(f"[prosody] graphed mel against a direct sample_mel with the same prosody text: "
              f"equal bit for bit {same}, rel-L2 {err:.3e}", flush=True)
        check(same or err <= 1e-6, f"prosody graph replay differs from sample_mel: {err:.3e}")

        reset_counters()
        (_, _, spec_off), wall_off = _timed(lambda: tts.infer(
            ref_path, REF_TEXT, GEN_TEXT, seed=0, use_prosody_encoder=False, **quiet))
        got = read_counters()
        for k in totals:
            totals[k] += got[k]
        check(got == expected_launches(FLAGSHIP_KERNELS, depth * 32, 32),
              f"unconditioned request: launches {got}")
        diff = rel_l2(torch.from_numpy(spec_on), torch.from_numpy(spec_off)) \
            if spec_on.shape == spec_off.shape else float("inf")
        print(f"[prosody] the same request with use_prosody_encoder=False (a plain graph, "
              f"{wall_off:.3f} s with its capture): mel rel-L2 against the prosody request "
              f"{diff:.3e} (must reach {PROSODY_MIN_REL_L2:.0e}: unconditioned, the two "
              f"would be one computation)", flush=True)
        check(diff >= PROSODY_MIN_REL_L2, f"prosody request equals the unconditioned one: {diff}")
        # both graphs captured: the request with and without the conditioning
        # in turns, and the reference prep (host wall: it ends on the host)
        # with and without the embedding
        walls, preps = {True: [], False: []}, {True: [], False: []}
        for on in (True, False, False, True):
            walls[on].append(_timed(lambda: tts.infer(ref_path, REF_TEXT, GEN_TEXT, seed=1,
                                                      use_prosody_encoder=on, **quiet))[1])
            cfg = SamplerConfig(use_prosody_encoder=on)
            preps[on].append(_timed(lambda: tts.synth._prepare_ref(wav, sr, cfg))[1] * 1e3)
        print(f"[prosody] replayed requests in turns (on, off, off, on): wall s with prosody "
              f"{[round(w, 4) for w in walls[True]]}, without {[round(w, 4) for w in walls[False]]}"
              f"; reference prep ms with the embedding {[round(w, 2) for w in preps[True]]}, "
              f"without {[round(w, 2) for w in preps[False]]}; the encoder and its fbank "
              f"{enc_ms:.3f} ms (device_ms) on {dev['card']}", flush=True)
        profile_request(tts, ref_path, REF_TEXT, GEN_TEXT)
        del tts
        gc.collect()
        torch.cuda.empty_cache()
        launches = phase_edit(dev, "multilingual_prosody", vocab, wav_path, align_dir,
                              d / "edited", flags=("--use_prosody_encoder",), tag="prosody")
        totals = {k: totals[k] + launches[k] for k in totals}
    return totals


BIGVGAN_FRAMES = 64  # a short mel: the CPU runs the f32 generator too


def phase_bigvgan(dev: dict) -> dict:
    """The BigVGAN-vocoded F5-TTS ``f5tts_base_bigvgan``: the full-width
    generator (bigvgan_v2_24khz_100band_256x widths, random weights) on the
    card against the CPU in f32 on a 64-frame mel of the reference, its bf16
    form against f32, ``bigvgan_mel_spectrogram`` card against CPU, the
    vocoder's card ms for a 1024-frame mel (profiled), then ``TTS.infer``
    (one warm-up, one timed request, K5 and K2 depth x 32 each, wave length
    = frames x 256) and a profiled request. Returns the launch counts."""
    import numpy as np
    import torch

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from lemas_tts_tpu_torch.models.dit import cast_matrices
    from lemas_tts_tpu_torch.ops.mel import bigvgan_mel_spectrogram
    from lemas_tts_tpu_torch.utils.audio_io import write_wav

    wav = torch.from_numpy(_reference_wave(24000, 3.0, seed=0))[None]
    mels = {d: bigvgan_mel_spectrogram(wav.to(d)) for d in ("cpu", "cuda")}
    got, ref = mels["cuda"].cpu(), mels["cpu"]
    rl2 = rel_l2(got, ref)
    print(f"[bigvgan] bigvgan_mel_spectrogram {tuple(ref.shape)} of 3 s at 24 kHz, f32: card "
          f"vs CPU rel-L2 {rl2:.3e} max-abs {max_abs(got, ref):.3e} (tol "
          f"{TOL_REL_L2['f32']:.0e})", flush=True)
    check(rl2 <= TOL_REL_L2["f32"], f"bigvgan mel: card vs CPU rel-L2 {rl2:.3e}")
    check(mels["cpu"].shape[-1] == wav.shape[-1] // 256, "the bigvgan mel is not T // hop frames")

    cfg = BigVGANConfig.for_hop(256, 100)
    torch.manual_seed(1)
    gen = BigVGAN(cfg).eval()
    mel = mels["cpu"][:, :, :BIGVGAN_FRAMES]
    with torch.no_grad():
        ref = gen.decode(mel)
        gen_c = gen.to("cuda")
        out32 = gen_c.decode(mel.cuda())
        gen16 = cast_matrices(BigVGAN(cfg, compute_dtype=torch.bfloat16), torch.bfloat16)
        gen16.load_state_dict(gen.state_dict())
        gen16 = gen16.to("cuda").eval()
        out16 = gen16.decode(mel.cuda())
    rl2 = rel_l2(out32.cpu(), ref)
    rl2_16 = rel_l2(out16, out32)
    print(f"[bigvgan] generator {sum(p.numel() for p in gen.parameters()) / 1e6:.2f} M "
          f"parameters, rates {cfg.upsample_rates}, mel [1, 100, {BIGVGAN_FRAMES}] -> wave "
          f"{tuple(ref.shape)} (peak {float(ref.abs().max()):.3f}): f32 card vs CPU rel-L2 "
          f"{rl2:.3e} max-abs {max_abs(out32.cpu(), ref):.3e} (tol {TOL_REL_L2['f32']:.0e}); bf16 "
          f"card vs f32 card rel-L2 {rl2_16:.3e} (tol {TOL_REL_L2['bf16']:.0e})", flush=True)
    check(tuple(ref.shape) == (1, BIGVGAN_FRAMES * 256) and rl2 <= TOL_REL_L2["f32"],
          f"bigvgan f32 card vs CPU rel-L2 {rl2:.3e}")
    check(bool(torch.isfinite(out16).all()) and rl2_16 <= TOL_REL_L2["bf16"],
          f"bf16 bigvgan vs f32 card rel-L2 {rl2_16:.3e}")
    del gen, gen_c, out32
    gc.collect()
    torch.cuda.empty_cache()

    totals = dict.fromkeys(kernel_counters(), 0)
    with tempfile.TemporaryDirectory() as d:
        vocab = Path(d) / "vocab.txt"
        vocab.write_text("\n".join(CHAR_VOCAB) + "\n")
        ref_path = str(Path(d) / "ref.wav")
        write_wav(ref_path, _reference_wave(16000, 3.0, seed=0), 16000)
        tts = TTS(model="f5tts_base_bigvgan", vocab_file=str(vocab), frontend=None)
        check(isinstance(tts.vocoder, BigVGAN) and tts.vocoder.compute_dtype == torch.bfloat16
              and tts.device.type == "cuda", "TTS(f5tts_base_bigvgan) has no bf16 BigVGAN on "
                                             "the card")
        mel1024 = torch.randn(1, 100, 1024, generator=torch.Generator().manual_seed(2)).cuda() - 5
        mask = torch.ones(1, 1024, dtype=torch.bool, device="cuda")
        with torch.no_grad():
            voc_ms = device_ms([lambda: tts.vocoder.decode(mel1024, mask)], iters=5)
            print(f"[bigvgan] vocoder decode of a 1024-frame mel (B 1, bf16, 262144 samples): "
                  f"card ms {voc_ms:.3f} on {dev['card']}", flush=True)
            profiled(lambda: tts.vocoder.decode(mel1024, mask),
                     "BigVGAN decode, 1024 frames, bf16", top=10)
        launches, timed = run_requests(tts, "f5tts_base_bigvgan (v0 + BigVGAN)", 2, V0_KERNELS,
                                       dev, ref_path, REF_TEXT, GEN_TEXT)
        totals = {k: totals[k] + launches[k] for k in totals}
        wave, _, spec = tts.infer(ref_path, REF_TEXT, GEN_TEXT, seed=0,
                                  show_info=lambda *_: None)
        print(f"[bigvgan] request wave {len(wave)} samples for {spec.shape[1]} mel frames "
              f"(frames x 256 = {spec.shape[1] * 256})", flush=True)
        check(len(wave) == spec.shape[1] * 256 and bool(np.isfinite(wave).all()),
              "the BigVGAN wave is not frames x 256 samples")
        profile_request(tts, ref_path, REF_TEXT, GEN_TEXT)
        del tts
        gc.collect()
        torch.cuda.empty_cache()
    return totals


def phase_unett(dev: dict) -> dict:
    """The E2-TTS ``e2tts_base`` (UNetT, dim 1024, depth 24, 16 x 64 heads,
    rope on the first head): a depth-2 full-width forward card against CPU
    (K5 once a block at N 1025: the time token), then ``TTS.infer`` at full
    depth (one warm-up, one timed request: K5 24 x 32 = 768 times) and a
    profiled request. Returns the launch counts."""
    import torch

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.config import load_model_config
    from lemas_tts_tpu_torch.models.unett import UNetT
    from lemas_tts_tpu_torch.utils.audio_io import write_wav

    depth2_forward("unett", "UNetT e2tts_base, N 1024 + the time token", UNetT,
                   load_model_config("e2tts_base"), False, MMDIT_KERNELS)
    totals = dict.fromkeys(kernel_counters(), 0)
    with tempfile.TemporaryDirectory() as d:
        vocab = Path(d) / "vocab.txt"
        vocab.write_text("\n".join(CHAR_VOCAB) + "\n")
        ref_path = str(Path(d) / "ref.wav")
        write_wav(ref_path, _reference_wave(16000, 3.0, seed=0), 16000)
        t0 = time.perf_counter()
        tts = TTS(model="e2tts_base", vocab_file=str(vocab), frontend=None)
        n = sum(p.numel() for p in tts.dit.parameters())
        print(f"[unett] TTS(e2tts_base) built in {time.perf_counter() - t0:.1f} s: UNetT, "
              f"{n / 1e6:.1f} M parameters (char vocab), depth {len(tts.dit.layers)}",
              flush=True)
        check(isinstance(tts.dit, UNetT) and len(tts.dit.layers) == 24, "not the 24-layer UNetT")
        launches, _ = run_requests(tts, "e2tts_base UNetT", 2, MMDIT_KERNELS, dev, ref_path,
                                   REF_TEXT, GEN_TEXT)
        totals = {k: totals[k] + launches[k] for k in totals}
        profile_request(tts, ref_path, REF_TEXT, GEN_TEXT)
        del tts
        gc.collect()
        torch.cuda.empty_cache()
    return totals


UVR5_SECONDS = 10.0  # the synthetic reference UVR5 denoises, at 24 kHz


def _uvr5_nets(dev: dict) -> None:
    """The STFT pair at MDX's n_fft 7680 / hop 1024 with its symmetric window
    (cuFFT at a size that is not a power of two) and ``ConvTDFNet`` at
    ``MDXConfig()`` on 2 chunk rows, card against CPU in f32."""
    import numpy as np
    import torch

    from lemas_tts_tpu_torch.ops.stft import istft, stft
    from lemas_tts_tpu_torch.uvr5.inference import hann_symmetric
    from lemas_tts_tpu_torch.uvr5.mdxnet import ConvTDFNet, MDXConfig, seeded_init_

    cfg = MDXConfig()
    chunk = cfg.hop * (cfg.dim_t - 1)
    x = torch.from_numpy(np.tile(_reference_wave(44100, 6.0, seed=3)[:chunk], (4, 1)))
    out = {}
    for d in ("cpu", "cuda"):
        win = hann_symmetric(cfg.n_fft, d)
        spec = stft(x.to(d), cfg.n_fft, cfg.hop, window=win)
        out[d] = (spec, istft(spec, cfg.n_fft, cfg.hop, window=win))
    spec_rl2 = rel_l2(torch.view_as_real(out["cuda"][0]).cpu(), torch.view_as_real(out["cpu"][0]))
    wave_rl2 = rel_l2(out["cuda"][1].cpu(), out["cpu"][1])
    inner = slice(cfg.n_fft, -cfg.n_fft)  # the symmetric window is 0 at both ends
    trip = rel_l2(out["cuda"][1][:, inner].cpu(), x[:, inner])
    print(f"[uvr5] STFT -> iSTFT, n_fft {cfg.n_fft} hop {cfg.hop}, symmetric Hann, 4 x {chunk} "
          f"samples, f32: card vs CPU rel-L2 spectrogram {spec_rl2:.3e}, wave {wave_rl2:.3e} "
          f"(tol {TOL_REL_L2['f32']:.0e}); card round trip vs input rel-L2 {trip:.3e}", flush=True)
    check(max(spec_rl2, wave_rl2, trip) <= TOL_REL_L2["f32"],
          f"MDX STFT pair: card vs CPU {spec_rl2:.3e} / {wave_rl2:.3e}, round trip {trip:.3e}")

    model = seeded_init_(ConvTDFNet(cfg), torch.Generator().manual_seed(0)).eval()
    n = sum(p.numel() for p in model.parameters())
    spek = torch.randn(2, cfg.dim_c, cfg.dim_t, cfg.dim_f,
                       generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = model(spek)
        cpu_s = time.perf_counter() - t0
        got = model.cuda()(spek.cuda()).cpu()
    rl2 = rel_l2(got, ref)
    print(f"[uvr5] ConvTDFNet at MDXConfig() (dim_f {cfg.dim_f}, dim_t {cfg.dim_t}, "
          f"{cfg.num_blocks} blocks, l {cfg.l}, g {cfg.g}, bn {cfg.bn}, GroupNorm): "
          f"{n / 1e6:.3f} M parameters; 2 chunk rows [2, 4, {cfg.dim_t}, {cfg.dim_f}], f32: card "
          f"vs CPU rel-L2 {rl2:.3e} max-abs {max_abs(got, ref):.3e} (tol {TOL_REL_L2['f32']:.0e}; "
          f"the CPU took {cpu_s:.1f} s)", flush=True)
    check(bool(torch.isfinite(got).all()) and rl2 <= TOL_REL_L2["f32"],
          f"ConvTDFNet card vs CPU rel-L2 {rl2:.3e}")


def _mdx_flops(cfg) -> float:
    """Multiply-adds x 2 of one ``ConvTDFNet`` forward on one chunk row:
    the TFC convs, the TDF Linears and the strided/transposed convs."""
    total, f, t, ch = 0.0, cfg.dim_f, cfg.dim_t, cfg.g
    total += 2 * cfg.dim_c * ch * f * t * 2  # first and final 1x1 convs

    def tfc_tdf(ch, f, t):
        tdf = 2 * f * f * ch * t if cfg.bn == 0 else 2 * 2 * f * (f // cfg.bn) * ch * t
        return cfg.l * 2 * cfg.k * cfg.k * ch * ch * f * t + tdf

    for _ in range(cfg.n):
        total += 2 * tfc_tdf(ch, f, t)  # encoder and decoder blocks of this level
        total += 2 * 2 * 4 * ch * (ch + cfg.g) * (f // 2) * (t // 2)  # ds and us 2x2 convs
        f, t, ch = f // 2, t // 2, ch + cfg.g
    return total + tfc_tdf(ch, f, t)


def phase_uvr5(dev: dict) -> dict:
    """UVR5 denoising at full width, random weights from a seed: the MDX
    STFT pair and ``ConvTDFNet`` card against CPU; ``UVR5.denoise`` of a 10 s
    24 kHz reference (length at 44.1 kHz, finite, the match-mix pass returns
    its input; wall, the network's card ms, a profiled call); the flagship
    ``tts_multilingual.main --denoise --uvr5_model`` (exit 0, the 44.1 kHz
    ``_vocal.wav``, depth x 32 launches of K1-K3, counts set to 0 just before
    and read just after); ``scripts/denoise.main`` over 3 WAVs with
    ``-b`` (3 vocal and 3 background stems, then a run with nothing to do);
    ``CascadedNet`` and ``CascadedASPPNet(123821)`` on one 512-frame window
    card against CPU, and ``VRSeparator.separate_full`` single-band and
    2-band (``2band_48000``) on the reference. Returns the launch counts."""
    import numpy as np
    import torch

    from lemas_tts_tpu_torch.ops.resample import resample
    from lemas_tts_tpu_torch.uvr5 import UVR5
    from lemas_tts_tpu_torch.uvr5.mdxnet import ConvTDFNet, MDXConfig, seeded_init_

    gc.collect()
    torch.cuda.empty_cache()
    _uvr5_nets(dev)
    totals = dict.fromkeys(kernel_counters(), 0)
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        pt = d / "mdx_seed0.pt"
        torch.save(seeded_init_(ConvTDFNet(MDXConfig()), torch.Generator().manual_seed(0))
                   .state_dict(), pt)
        uvr = UVR5(model_path=str(pt))
        sep = uvr.sep
        check(sep.device.type == "cuda" and sep.cfg == MDXConfig() and sep.batch_size == 8,
              "UVR5() did not build the MDXConfig() denoiser on the card at batch 8")
        wav = _reference_wave(24000, UVR5_SECONDS, seed=4)
        uvr.denoise(wav, 24000)  # warm-up
        (den, sr), wall = _timed(lambda: uvr.denoise(wav, 24000))
        want = int(np.ceil(len(wav) * 44100 / 24000))
        n_chunks = sep.initialize_mix(np.zeros((2, want), np.float32))[0].shape[0]
        print(f"[uvr5] UVR5.denoise of {UVR5_SECONDS:.0f} s at 24 kHz: {len(den)} samples at {sr} "
              f"Hz (want {want}); {n_chunks} chunks of {sep.chunk_size} padded to batch "
              f"{sep.batch_size}, x 2 for the sign flip; wall {wall:.3f} s = "
              f"{UVR5_SECONDS / wall:.1f} x real time on {dev['card']}", flush=True)
        check(sr == 44100 and den.shape == (want,) and bool(np.isfinite(den).all()),
              "UVR5.denoise: wrong length, rate or not finite")
        x44 = resample(torch.from_numpy(np.stack([wav, wav])).cuda(), 24000, 44100).cpu().numpy()
        mm = sep.demix({0: x44}, is_match_mix=True)
        inner = slice(sep.trim, -sep.trim)
        mm_err = float(np.abs(mm[:, inner] - x44[:, inner]).max())
        mm_rl2 = float(np.linalg.norm(mm - x44) / np.linalg.norm(x44))
        print(f"[uvr5] match-mix demix returns its input: max-abs {mm_err:.3e} inside the "
              f"edges (bound 5e-2), rel-L2 {mm_rl2:.3e} (the 3 lowest bins are zeroed)",
              flush=True)
        check(mm.shape == x44.shape and mm_err < 5e-2, f"match-mix demix: max-abs {mm_err:.3e}")
        spek = torch.randn(sep.batch_size, 4, sep.cfg.dim_t, sep.cfg.dim_f, device="cuda")
        net_ms = device_ms([lambda: sep.spec_to_spec(spek)], iters=3)
        flops = 2 * sep.batch_size * _mdx_flops(sep.cfg)
        print(f"[uvr5] network of one demix batch (B {sep.batch_size} x 2 sign-flip rows, f32, "
              f"TF32 off): card ms {net_ms:.2f} (device_ms) for {flops / 1e12:.2f} TFLOP = "
              f"{flops / net_ms / 1e9:.1f} TFLOP/s against the {H100_F32_FLOPS / 1e12:.0f} "
              f"TFLOP/s f32 peak, on {dev['card']}", flush=True)
        profiled(lambda: uvr.denoise(wav, 24000), f"UVR5.denoise, {UVR5_SECONDS:.0f} s at 24 kHz",
                 top=8)
        del uvr, sep, spek
        gc.collect()
        torch.cuda.empty_cache()

        totals = _uvr5_clis(dev, d, pt)
        _uvr5_vr(dev, d, wav)
    return totals


def _uvr5_clis(dev: dict, d: Path, pt: Path) -> dict:
    """``tts_multilingual.main --denoise`` on the flagship (char vocab, NFE
    32) and ``scripts/denoise.main -b`` over 3 WAVs, with the seeded MDX
    weights file ``pt``. Returns the launch counts of the TTS request."""
    import numpy as np
    import torch

    from lemas_tts_tpu_torch.config import load_model_config
    from lemas_tts_tpu_torch.scripts import denoise as denoise_cli
    from lemas_tts_tpu_torch.scripts import tts_multilingual
    from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav

    vocab = d / "vocab.txt"
    vocab.write_text("\n".join(CHAR_VOCAB) + "\n")
    ref = d / "ref.wav"
    write_wav(str(ref), _reference_wave(24000, 3.0, seed=0), 24000)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = tts_multilingual.main(["--ref_audio", str(ref), "--ref_text", REF_TEXT, "--text",
                                GEN_TEXT, "--model", "multilingual", "--vocab_file", str(vocab),
                                "--frontend", "none", "--nfe_step", "32", "--seed", "0",
                                "--output_wave", str(d / "out.wav"), "--denoise",
                                "--uvr5_model", str(pt)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    want = expected_launches(FLAGSHIP_KERNELS, load_model_config("multilingual").arch.depth * 32,
                             32)
    check(rc == 0 and (d / "ref_vocal.wav").is_file(),
          f"tts_multilingual --denoise returned {rc} or wrote no ref_vocal.wav")
    vocal, vsr = read_audio(str(d / "ref_vocal.wav"))
    wave, osr = read_audio(str(d / "out.wav"))
    print(f"[uvr5] tts_multilingual.main(--denoise --uvr5_model, NFE 32) on the flagship: rc "
          f"{rc}, ref_vocal.wav {vocal.shape[-1]} samples at {vsr} Hz, output {wave.shape[-1]} "
          f"samples at {osr} Hz, {wall:.2f} s wall (model builds included) on {dev['card']}; "
          f"launches {launches}", flush=True)
    check(vsr == 44100 and vocal.shape[-1] == 3 * 44100 and bool(np.isfinite(vocal).all()),
          "the denoised reference is not 3 s at 44.1 kHz")
    check(osr == 24000 and wave.size > 0 and bool(np.isfinite(wave).all()), "the TTS wave is bad")
    check(launches == want, f"tts --denoise: launches {launches}, expected {want}")

    src, out = d / "batch_in", d / "batch_out"
    src.mkdir()
    for i in range(3):
        write_wav(str(src / f"clip{i}.wav"), _reference_wave(24000, 2.0, seed=10 + i), 24000)
    argv = ["-a", str(src), "-r", str(out), "-m", str(pt), "-b"]
    written, wall = _timed(lambda: denoise_cli.main(argv))
    stems = sorted(p.name for p in out.iterdir())
    again = denoise_cli.main(argv)
    print(f"[uvr5] scripts/denoise.main -b over 3 x 2 s WAVs: {len(written)} written, stems "
          f"{stems}, {wall:.2f} s wall (model load included); a second run processed "
          f"{len(again)} files", flush=True)
    names = sorted(f"clip{i}_{k}.wav" for i in range(3) for k in ("vocal", "background"))
    check(len(written) == 3 and stems == names and again == [],
          f"denoise CLI: wrote {stems}, second run {again}")
    for name in names:
        w, sr = read_audio(str(out / name))
        check(sr == 44100 and w.shape == (2, 2 * 44100) and bool(np.isfinite(w).all()),
              f"{name}: {w.shape} at {sr} Hz")
    return launches


def _uvr5_vr(dev: dict, d: Path, wav) -> None:
    """The VR nets at their default widths on one 512-frame window, card
    against CPU in f32 (the sigmoid masks and the logits before them), with
    their card ms; ``VRSeparator.separate_full`` single-band (``CascadedNet``,
    n_fft 2048, hop 1024) and 2-band (``CascadedASPPNet(123821)`` through
    ``from_file``: with no band param it takes the default 2-band param, and
    with ``2band_48000`` it separates) on the reference."""
    import warnings

    import numpy as np
    import torch

    from lemas_tts_tpu_torch.uvr5 import vr_legacy, vr_network
    from lemas_tts_tpu_torch.uvr5.band_params import load_band_params

    g = torch.Generator().manual_seed(0)
    nets = [("CascadedNet (n_fft 2048, nout 32, LSTM 128)", vr_network.CascadedNet(2048), 1025),
            ("CascadedASPPNet 123821 (hp, n_fft 1536)", vr_legacy.CascadedASPPNet(1536, 123821),
             769)]
    for name, net, bins in nets:
        net = vr_network.random_vr_init_(net, g).eval()
        x = torch.rand(1, 2, bins, 512, generator=g)
        logits = []
        net.out.register_forward_hook(lambda m, i, o: logits.append(o.detach().cpu()))
        with torch.no_grad():
            ref = net(x)
            got = net.cuda()(x.cuda()).cpu()
            xc = x.cuda()
            ms = device_ms([lambda: net(xc)], iters=3)
        rl2, lrl2 = rel_l2(got, ref), rel_l2(logits[1], logits[0])
        print(f"[uvr5] {name}, {sum(p.numel() for p in net.parameters()) / 1e6:.2f} M "
              f"parameters, one window [1, 2, {bins}, 512], f32: card vs CPU rel-L2 mask "
              f"{rl2:.3e}, logits {lrl2:.3e} (std {float(logits[0].std()):.3f}; tol "
              f"{TOL_REL_L2['f32']:.0e}); card ms {ms:.2f} (device_ms) on {dev['card']}",
              flush=True)
        check(max(rl2, lrl2) <= TOL_REL_L2["f32"], f"{name}: card vs CPU {rl2:.3e} / {lrl2:.3e}")
        if isinstance(net, vr_legacy.CascadedASPPNet):
            torch.save(net.state_dict(), d / "vr_123821.pth")
        del net
    x = np.stack([wav, wav])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random init, on purpose
        single = vr_network.VRSeparator()
    default = vr_network.VRSeparator.from_file(str(d / "vr_123821.pth"))
    check(single.device.type == default.device.type == "cuda"
          and isinstance(default.model, vr_legacy.CascadedASPPNet)
          and default.model.nn_architecture == 123821 and default.n_fft == 1536
          and default.mp == load_band_params(None),
          "the VR separators are not the defaults on the card")
    # the default 2-band param (reference model_param_init.py) has no lpf_stop /
    # hpf_stop, which the band synthesis reads, so it cannot synthesize (nor can
    # the JAX package or the reference with it): the 48 kHz 2-band config at the
    # same 768 bins (n_fft 1536) does
    two_band = vr_network.VRSeparator.from_file(str(d / "vr_123821.pth"),
                                                band_params="2band_48000")
    check(two_band.n_fft == 1536, "2band_48000 is not at n_fft 1536")
    for label, sep, want_sr in (("single-band", single, 24000), ("2-band", two_band, 48000)):
        sep.separate_full(x, 24000)  # warm-up: cuDNN picks its algorithms per shape
        (p, s, sr), wall = _timed(lambda: sep.separate_full(x, 24000))
        want = int(round(x.shape[-1] * want_sr / 24000))
        print(f"[uvr5] VRSeparator.separate_full {label} of {UVR5_SECONDS:.0f} s at 24 kHz: "
              f"stems {p.shape} and {s.shape} at {sr} Hz (want ~{want}), {wall:.3f} s wall",
              flush=True)
        check(sr == want_sr and p.shape == s.shape and p.shape[0] == 2
              and abs(p.shape[1] - want) <= sep.n_fft and bool(np.isfinite(p).all())
              and bool(np.isfinite(s).all()), f"separate_full {label}: {p.shape} at {sr} Hz")
        profiled(lambda: sep.separate_full(x, 24000), f"VRSeparator.separate_full {label}",
                 top=6)


# ------------------------------------------------------------- [train] phase
TRAIN_TOL = {"loss": 1e-4, "grad": 1e-3}  # card vs CPU, f32, TF32 off
TRAIN_SYNTHETIC = 200  # --synthetic samples: 40-299 frames each, batches of 64 at the budget


def _train_step_flop(arch, B: int, N: int) -> float:
    """FLOP of one training step with activation checkpointing: 4 x the
    block stack's forward (forward, the recompute, and a backward of twice
    the forward); per block the dense products 2 x (4 d² + 2 d f) per frame
    and the attention's 4 x B x N² x inner. The embeddings, the heads and the
    loss are left out."""
    d, f, inner = arch.dim, arch.dim * arch.ff_mult, arch.heads * arch.dim_head
    return 4.0 * arch.depth * (2 * (4 * d * d + 2 * d * f) * B * N + 4 * B * N * N * inner)


def _train_flops(log_path: Path, arch) -> list:
    """(batch [B, T], step seconds, FLOP) of each logged training step after
    the first (the log's timestamps, each after a sync on the loss)."""
    events = [json.loads(line) for line in log_path.read_text().splitlines()]
    steps = [e for e in events if e["event"] == "train_step"]
    return [(e["batch"], e["ts"] - prev["ts"], _train_step_flop(arch, *e["batch"]))
            for prev, e in zip(steps, steps[1:])]


def _train_vs_cpu(dev: dict) -> None:
    """One ``cfm_training_loss`` (accent and CTC heads) and one ``Distiller``
    loss at the flagship's width and depth 2, f32, dropout 0 (the card's and
    the CPU's dropout generators draw different masks), on the card and on
    the CPU with the same weights, batch and draws; the losses and the worst
    per-parameter gradient rel-L2."""
    import dataclasses

    import torch

    from lemas_tts_tpu_torch.cfm.distill import Distiller
    from lemas_tts_tpu_torch.cfm.loss import AccentClassifier, CTCHead, cfm_training_loss
    from lemas_tts_tpu_torch.config import load_model_config
    from lemas_tts_tpu_torch.models.dit import DiT

    cfg = load_model_config("multilingual")
    arch = dataclasses.replace(cfg.arch, depth=2, dropout=0.0)
    mel, vocab, B, T, nt = cfg.mel_spec.n_mel_channels, 64, 4, 512, 128
    g = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    models = {"dit": DiT(arch, mel_dim=mel, text_num_embeds=vocab),
              "accent": AccentClassifier(mel, arch.dim), "ctc": CTCHead(mel, arch.dim, vocab)}
    text = torch.randint(0, vocab, (B, nt), generator=g)
    text[:, 100:] = -1
    batch = {"mel": torch.randn(B, T, mel, generator=g), "mel_lengths": torch.tensor(
        [512, 480, 450, 400]), "text": text, "langs": torch.tensor([0, 3, 7, 11])}
    draws = {"frac": 0.7 + 0.3 * torch.rand(B, generator=g), "span": torch.rand(B, generator=g),
             "x0": torch.randn(B, T, mel, generator=g), "time": torch.tensor([0.6, 0.7, 0.8, 0.3]),
             "seg": torch.tensor([0, 5, 9, 15])}

    def run(device, which):
        mods = {k: v.to(device) for k, v in models.items()}
        b = {k: v.to(device) for k, v in batch.items()}
        dr = {k: v.to(device) for k, v in draws.items()}
        for m in mods.values():
            m.zero_grad(set_to_none=True)
        if which == "loss":
            total, _ = cfm_training_loss(mods["dit"], {"accent": mods["accent"], "ctc": mods["ctc"]},
                                         b, draws=dr, vocab_size=vocab)
            named = {f"{n}.{k}": p for n, m in mods.items() for k, p in m.named_parameters()}
        else:
            dist = Distiller(mods["dit"], 16, sway_sampling_coef=1.0)
            st = dist.init_state(mods["dit"].state_dict())
            total, _ = dist.loss(st.params, st.teacher_params, b, draws=dr)
            named = dict(st.params.named_parameters())
        total.backward()
        return float(total.detach()), {k: p.grad.detach().cpu() for k, p in named.items()}

    for which in ("loss", "distill"):
        (l_cpu, g_cpu), (l_gpu, g_gpu) = run("cpu", which), run("cuda", which)
        dl = abs(l_gpu - l_cpu) / max(abs(l_cpu), 1e-30)
        worst = max((rel_l2(g_gpu[k], g_cpu[k]), k) for k in g_cpu
                    if float(g_cpu[k].norm()) > 0)
        label = "cfm_training_loss (accent + CTC)" if which == "loss" else "Distiller loss (NFE 16)"
        print(f"[train] {label}, flagship width, depth 2, B {B} x N {T}, f32, TF32 off: card "
              f"{l_gpu:.7f} vs CPU {l_cpu:.7f} (rel {dl:.2e}, tol {TRAIN_TOL['loss']:.0e}); worst "
              f"gradient rel-L2 {worst[0]:.2e} ({worst[1]}; tol {TRAIN_TOL['grad']:.0e}) over "
              f"{len(g_cpu)} tensors", flush=True)
        check(dl <= TRAIN_TOL["loss"], f"{label}: card vs CPU loss rel {dl:.2e}")
        check(worst[0] <= TRAIN_TOL["grad"], f"{label}: gradient rel-L2 {worst}")
    for m in models.values():
        m.to("cpu")


def _overfit(dev: dict) -> None:
    """``Trainer`` at full width and depth on one repeated batch (B 8 x N 256)
    with the same draws every step, lr 1e-4 after a 1-step warmup: the loss
    must fall."""
    import numpy as np
    import torch

    from lemas_tts_tpu_torch.api import seeded_init
    from lemas_tts_tpu_torch.cfm.train import Trainer
    from lemas_tts_tpu_torch.config import TrainConfig, load_model_config
    from lemas_tts_tpu_torch.models.dit import DiT

    cfg = load_model_config("multilingual")
    mel, vocab, B, T = cfg.mel_spec.n_mel_channels, len(CHAR_VOCAB), 8, 256
    dit = seeded_init(lambda: DiT(cfg.arch, mel_dim=mel, text_num_embeds=vocab), 0).cuda()
    tcfg = TrainConfig(learning_rate=1e-4, num_warmup_updates=1, audio_drop_prob=0.0,
                       text_drop_prob=0.0)
    tr = Trainer(dit, vocab_size=vocab, mel_dim=mel, cfg=tcfg)
    state = tr.init_state(0)
    g = torch.Generator().manual_seed(1)
    batch = {"mel": torch.randn(B, T, mel, generator=g).cuda(),
             "mel_lengths": torch.full((B,), T).cuda(),
             "text": torch.randint(0, vocab, (B, 40), generator=g).cuda(),
             "langs": torch.randint(0, 12, (B,), generator=g).cuda()}
    losses = []
    for _ in range(12):
        state, m = tr.train_step(state, batch, torch.Generator("cuda").manual_seed(5), None,
                                 {"dropout": torch.Generator().manual_seed(5)})
        losses.append(float(m["flow_loss"]))
    print(f"[train] one repeated batch (B {B} x N {T}), full width and depth, lr 1e-4: flow loss "
          f"{' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < 0.95 * losses[1],
          f"the loss did not fall on a repeated batch: {losses}")
    del tr, state, dit, batch


def _step_at_budget(dev: dict) -> None:
    """``Trainer.train_step`` at full width and depth on a batch that fills
    the reference's 40,000-frame budget (39 utterances of 1024 frames, ~10.9
    s each), with ``checkpoint_activations``: one warm-up step, then two
    timed steps (host clock, ending in a sync); frames/s, TFLOP/s by
    ``_train_step_flop``, peak memory."""
    import dataclasses

    import torch

    from lemas_tts_tpu_torch.api import seeded_init
    from lemas_tts_tpu_torch.cfm.train import Trainer
    from lemas_tts_tpu_torch.config import TrainConfig, load_model_config
    from lemas_tts_tpu_torch.models.dit import DiT

    cfg = load_model_config("multilingual")
    arch = dataclasses.replace(cfg.arch, checkpoint_activations=True)
    mel, vocab, B, T = cfg.mel_spec.n_mel_channels, len(CHAR_VOCAB), 39, 1024
    check(B * T <= TrainConfig().batch_size_per_gpu, "over the frame budget")
    dit = seeded_init(lambda: DiT(arch, mel_dim=mel, text_num_embeds=vocab), 0).cuda()
    tr = Trainer(dit, vocab_size=vocab, mel_dim=mel)
    state = tr.init_state(0)
    g = torch.Generator().manual_seed(2)
    batch = {"mel": torch.randn(B, T, mel, generator=g).cuda(),
             "mel_lengths": torch.randint(700, T + 1, (B,), generator=g).cuda(),
             "text": torch.randint(0, vocab, (B, 256), generator=g).cuda(),
             "langs": torch.randint(0, 12, (B,), generator=g).cuda()}
    tr.train_step(state, batch, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(2):
        t0 = time.perf_counter()
        _, m = tr.train_step(state, batch, torch.Generator("cuda").manual_seed(1 + i))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    flop = _train_step_flop(arch, B, T)
    sec = min(walls)
    print(f"[train] Trainer.train_step at the 40,000-frame budget: batch {B} x {T} = {B * T} "
          f"frames, 22 x 1024 f32, checkpoint_activations, TF32 off: {walls[0]:.3f} / "
          f"{walls[1]:.3f} s a step, {B * T / sec:.0f} frames/s, {flop / sec / 1e12:.1f} TFLOP/s "
          f"({flop / 1e12:.1f} TFLOP counted a step; f32 peak {H100_F32_FLOPS / 1e12:.0f}); peak "
          f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB;"
          f" loss {float(m['loss']):.4f}, on {dev['card']}", flush=True)
    check(bool(torch.isfinite(m["loss"])), "loss at the budget not finite")
    del tr, state, dit, batch


def phase_train(dev: dict) -> dict:
    """Training and distillation on the card, ending in distilled students
    served on K1-K3. Returns the launch counts of the student requests."""
    import numpy as np
    import torch

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.cfm.checkpoint import CheckpointManager
    from lemas_tts_tpu_torch.cfm.train import Trainer
    from lemas_tts_tpu_torch.config import TrainConfig, load_model_config
    from lemas_tts_tpu_torch.models.dit import DiT
    from lemas_tts_tpu_torch.models.speaker import SpeakerEncoder
    from lemas_tts_tpu_torch.ops import ffn
    from lemas_tts_tpu_torch.scripts import distill, evaluate, train
    from lemas_tts_tpu_torch.utils.audio_io import write_wav

    gc.collect()
    torch.cuda.empty_cache()
    # 1. the grad guard: K1 on CUDA inputs that require grad raises
    args = [torch.randn(1, 64, 1024, device="cuda", requires_grad=True),
            *(torch.zeros(1, 1024, device="cuda") for _ in range(2)),
            *(t for _ in range(3) for t in (torch.randn(1024, 1024, device="cuda") * 0.02,
                                            torch.zeros(1024, device="cuda")))]
    raised = None
    try:
        ffn.qkv_block(*args)
    except RuntimeError as e:
        raised = str(e)
    print(f"[train] qkv_block (K1) on CUDA inputs that require grad: raised {raised!r}",
          flush=True)
    check(raised is not None and "no backward" in raised, "K1 ran under grad")
    with torch.no_grad():
        check(ffn.qkv_block(*args)[0].grad_fn is None, "K1 under no_grad")

    # 2. card against CPU: the training loss and the distill loss with their gradients
    _train_vs_cpu(dev)
    _overfit(dev)
    gc.collect()
    torch.cuda.empty_cache()
    _step_at_budget(dev)
    gc.collect()
    torch.cuda.empty_cache()

    cfg = load_model_config("multilingual")
    depth = cfg.arch.depth
    totals = dict.fromkeys(kernel_counters(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        vocab = d / "vocab.txt"
        vocab.write_text("\n".join(CHAR_VOCAB) + "\n")
        ck, log = d / "ck", d / "train.jsonl"
        common = ["--config", "multilingual", "--vocab_file", str(vocab), "--synthetic",
                  str(TRAIN_SYNTHETIC), "--ckpt_dir", str(ck), "--log_every", "1",
                  "--log_file", str(log), "--checkpoint_activations"]

        # 3. scripts/train at full width, the reference frame budget, remat on; then --resume
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        check(train.main([*common, "--steps", "3"]) == 0, "train.main failed")
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gc.collect()
        torch.cuda.empty_cache()
        events = [json.loads(line) for line in log.read_text().splitlines()]
        losses = [e["loss"] for e in events if e["event"] == "train_step"]
        check(len(losses) == 3 and all(np.isfinite(losses)), f"train losses {losses}")
        for (b, sec, flop) in _train_flops(log, cfg.arch):
            print(f"[train] step, batch {b[0]} x {b[1]} = {b[0] * b[1]} padded frames (budget "
                  f"{TrainConfig().batch_size_per_gpu}): {sec:.3f} s, "
                  f"{b[0] * b[1] / sec:.0f} frames/s, {flop / sec / 1e12:.1f} TFLOP/s "
                  f"({flop / 1e12:.1f} TFLOP counted) on {dev['card']}", flush=True)
        print(f"[train] scripts/train.main: 22 x 1024 flagship, f32, checkpoint_activations, "
              f"3 steps in {wall:.1f} s wall (build, data and the model_last write included); "
              f"losses {losses}; peak torch.cuda.max_memory_allocated {peak:.2f} GiB on "
              f"{dev['card']}", flush=True)

        # the resume point restores bit for bit, and the step count carries on
        mgr = CheckpointManager(str(ck), TrainConfig())
        saved = mgr.restore()
        dit = DiT(cfg.arch, mel_dim=100, text_num_embeds=len(CHAR_VOCAB)).cuda()
        tr = Trainer(dit, vocab_size=len(CHAR_VOCAB), mel_dim=100)
        state = tr.restore_state(tr.init_state(0), saved)
        same = all(torch.equal(v.cpu(), saved["model_state_dict"][f"transformer.{k}"])
                   for k, v in state.params["dit"].state_dict().items())
        same &= all(torch.equal(v.cpu(), saved["ema_model_state_dict"]
                                [f"ema_model.transformer.{k}"])
                    for k, v in state.ema_params.state_dict().items())
        check(same and state.step == saved["step"] == 3, "restored state differs from the saved")
        del saved, dit, tr, state
        gc.collect()
        torch.cuda.empty_cache()
        check(train.main([*common, "--steps", "5", "--resume"]) == 0, "train.main --resume failed")
        events = [json.loads(line) for line in log.read_text().splitlines()]
        steps = [e["step"] for e in events if e["event"] == "train_step"]
        check(any(e["event"] == "resumed" and e["step"] == 3 for e in events)
              and steps == [1, 2, 3, 4, 5], f"resume did not carry on: {steps}")
        print(f"[train] --resume: restored step 3 bit for bit (params and EMA), ran steps 4-5, "
              f"losses {[e['loss'] for e in events if e['event'] == 'train_step'][3:]}",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()

        # 4. scripts/distill from that checkpoint: stages 16, 8; a wide-head stage 8
        dlog = d / "distill.jsonl"
        dcommon = ["--config", "multilingual", "--vocab_file", str(vocab), "--synthetic",
                   str(TRAIN_SYNTHETIC), "--teacher", str(ck), "--steps_per_stage", "2",
                   "--log_every", "1", "--log_file", str(dlog)]
        t0 = time.perf_counter()
        check(distill.main([*dcommon, "--stages", "16,8", "--ckpt_dir", str(d / "dd")]) == 0,
              "distill.main failed")
        gc.collect()
        torch.cuda.empty_cache()
        check(distill.main([*dcommon, "--stages", "8", "--ckpt_dir", str(d / "dw"),
                            "--student_heads", "8", "--student_dim_head", "128"]) == 0,
              "distill.main (wide head) failed")
        events = [json.loads(line) for line in dlog.read_text().splitlines()]
        dl = [(e["stage"], e["batch"], round(e["loss"], 5)) for e in events
              if e["event"] == "distill_step"]
        print(f"[train] scripts/distill.main: stages 16, 8 and a wide-head (8 x 128) stage 8, "
              f"2 steps each, in {time.perf_counter() - t0:.1f} s wall; (stage, batch, loss) "
              f"{dl}", flush=True)
        check(all(np.isfinite(x[2]) for x in dl) and len(dl) == 6, f"distill losses {dl}")
        gc.collect()
        torch.cuda.empty_cache()

        # 5. TTS on each student directory: pinned settings, exact launches, graph = eager
        ref_path = str(d / "ref.wav")
        write_wav(ref_path, _reference_wave(24000, 3.0, seed=0), 24000)
        rows = []
        for stage, heads, k in ((d / "dd" / "stage_16", 16, 16), (d / "dd" / "stage_8", 16, 8),
                                (d / "dw" / "stage_8", 8, 8)):
            meta = json.loads((stage / "student.json").read_text())
            tts = TTS(model="multilingual", ckpt_file=str(stage), vocab_file=str(vocab),
                      frontend=None)
            a = tts.dit.transformer_blocks[0].attn
            check((a.heads, a.dim_head) == (heads, 1024 // heads) and meta["student_steps"] == k,
                  f"{stage.name}: heads {a.heads} x {a.dim_head}")
            seen, real = [], tts.synth.synthesize_chunks

            def spy(*args, cfg, **kw):
                seen.append(cfg)
                return real(*args, cfg=cfg, **kw)

            tts.synth.synthesize_chunks = spy
            want = expected_launches(FLAGSHIP_KERNELS, depth * k, k)
            outs = []
            for i, route in enumerate(("eager (first of its bucket)", "graph replay")):
                reset_counters()
                (wave, sr, spec), wall = _timed(lambda: tts.infer(
                    ref_path, REF_TEXT, GEN_TEXT, seed=7, nfe_step=32, cfg_strength=2.0,
                    show_info=lambda *_: None))
                got = read_counters()
                for kk in totals:
                    totals[kk] += got[kk]
                audio = len(wave) / sr
                print(f"[train] student {stage.parent.name}/{stage.name} ({heads} x "
                      f"{1024 // heads} heads) request {i}, {route}: pinned to steps "
                      f"{seen[-1].nfe_steps}, cfg {seen[-1].cfg_strength}; {audio:.3f} audio-s "
                      f"in {wall:.3f} s = {audio / wall:.2f} audio-s/s on {dev['card']}; "
                      f"launches {got}", flush=True)
                check((seen[-1].nfe_steps, seen[-1].cfg_strength, seen[-1].cfg_cutoff)
                      == (k, 0.0, None), f"student settings not pinned: {seen[-1]}")
                check(got == want, f"{stage.name}: launches {got}, expected {want}")
                check(bool(np.isfinite(wave).all()) and wave.size > 0, "student wave not finite")
                outs.append(spec)
            same = bool(np.array_equal(outs[0], outs[1]))
            err = float(np.linalg.norm(outs[1] - outs[0]) / max(np.linalg.norm(outs[0]), 1e-30))
            print(f"[train] student {stage.name}: graphed mel against the eager one: equal bit "
                  f"for bit {same}, rel-L2 {err:.3e}", flush=True)
            check(same or err <= 1e-6, f"student graph replay differs from eager: {err:.3e}")
            hyp = d / f"{stage.parent.name}_{stage.name}.wav"
            write_wav(str(hyp), wave, sr)
            rows.append({"ref": ref_path, "hyp": str(hyp)})
            del tts
            gc.collect()
            torch.cuda.empty_cache()

        # 6. scripts/evaluate over the students' output with a random-init speaker encoder
        spk = d / "speaker.pt"
        torch.manual_seed(0)
        torch.save(SpeakerEncoder().state_dict(), spk)
        manifest = d / "eval.jsonl"
        manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
        out = d / "summary.json"
        check(evaluate.main(["--manifest", str(manifest), "--out", str(out), "--dtw",
                             "--speaker_ckpt", str(spk)]) == 0, "evaluate.main failed")
        summary = json.loads(out.read_text())
        print(f"[train] scripts/evaluate.main over the 3 students' output (random weights): "
              f"{summary}", flush=True)
        check(summary["n_utterances"] == 3 and all(
            np.isfinite(summary[k]) for k in ("mel_mse", "mel_mae", "mcd_db", "speaker_cos")),
            f"evaluate: {summary}")
    return totals


def _flagship_as_mmdit(d: Path) -> Path:
    """The flagship config with the MMDiT backbone (no public MMDiT config)."""
    from lemas_tts_tpu_torch.config import CONFIG_DIR

    cfg = json.loads((CONFIG_DIR / "multilingual.json").read_text())
    cfg["model"]["backbone"] = "MMDiT"
    path = d / "multilingual_mmdit.json"
    path.write_text(json.dumps(cfg))
    return path


def phase_splash(dev: dict) -> dict:
    """``attn_backend="splash"`` at full depth: the flagship (a warmed graph,
    one warm-up and two timed B = 1 requests with K6 depth x 32 each and no
    other kernel, a request equal to a direct ``sample_mel``, a profiled
    request; K6 then held to its plain version at the request's own valid
    length), the MMDiT built from the flagship config (K6 at N 1280),
    ``e2tts_base`` (K5 at N 1025: JAX hands that N to its ``sdpa``), the
    two CLIs with ``--attn_backend splash`` (the TTS CLI at NFE 16: K6
    depth x 16; the edit at its defaults: K6 depth x 64, kept frames equal to
    the reference mel), and ``attn_backend="xla"``: a request that launches
    no kernel, its mel against the ``vmem`` route's on the same noise
    (printed, not gated: bf16 rounds at other points). Returns the launch
    counts."""
    import numpy as np
    import torch

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.config import SamplerConfig
    from lemas_tts_tpu_torch.infer.pipeline import DURATION_BUCKETS, TEXT_BUCKETS, pick_bucket
    from lemas_tts_tpu_torch.infer.preprocess import preprocess_ref_audio_text
    from lemas_tts_tpu_torch.scripts import tts_multilingual
    from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav
    from lemas_tts_tpu_torch.utils.vocab import text_to_ids

    totals = dict.fromkeys(kernel_counters(), 0)
    quiet = dict(show_info=lambda *_: None)

    def add(launches):
        for k in totals:
            totals[k] += launches[k]

    def counted(label, fn, kernels, blocks, forwards):
        """fn() with the counts set to 0 just before and read just after."""
        reset_counters()
        out, wall = _timed(fn)
        got = read_counters()
        want = expected_launches(kernels, blocks, forwards)
        print(f"[splash] {label}: {wall:.3f} s wall on {dev['card']}; launches {got}",
              flush=True)
        check(got == want, f"{label}: launches {got}, expected {want}")
        add(got)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        vocab = d / "vocab.txt"
        vocab.write_text("\n".join(CHAR_VOCAB) + "\n")
        ref_path = str(d / "ref.wav")
        write_wav(ref_path, _reference_wave(16000, 3.0, seed=0), 16000)
        _, _, rtext = preprocess_ref_audio_text(ref_path, REF_TEXT, **quiet)
        mels = {}
        for backend in ("splash", "xla", "vmem"):
            t0 = time.perf_counter()
            tts = TTS(model="multilingual", vocab_file=str(vocab), frontend=None,
                      attn_backend=backend)
            depth = tts.config.arch.depth
            print(f"[splash] TTS(multilingual, attn_backend={backend!r}) built in "
                  f"{time.perf_counter() - t0:.1f} s on {tts.device}", flush=True)
            if backend == "splash":
                nt = pick_bucket(len(text_to_ids(rtext + GEN_TEXT, tts.vocab)), TEXT_BUCKETS)
                t1 = time.perf_counter()
                n = tts.synth.warmup(SamplerConfig(nfe_steps=32, cfg_strength=2.0,
                                                   sway_sampling_coef=5),
                                     duration_buckets=(1024,), text_buckets=(nt,),
                                     batch_buckets=(1,))
                print(f"[splash] warmup captured {n} graph (B 1, bucket 1024, text bucket "
                      f"{nt}) in {time.perf_counter() - t1:.1f} s", flush=True)
                check(n == 1, f"warmup captured {n} graphs, not 1")
                launches, _ = run_requests(tts, "flagship attn_backend=splash", 3,
                                           SPLASH_KERNELS, dev, ref_path, REF_TEXT, GEN_TEXT,
                                           tag="splash")
                add(launches)
                add(graphed_request(tts, "splash", SPLASH_KERNELS, ref_path)[0])
                reset_counters()
                profile_request(tts, ref_path, REF_TEXT, GEN_TEXT)
                add(read_counters())
            kernels = {"splash": SPLASH_KERNELS, "xla": (), "vmem": FLAGSHIP_KERNELS}[backend]
            dispatch = tts.synth._dispatch_chunks
            durations = []

            def recorded(*args, **kw):  # the request's durations (frames), as K6 sees them
                pending = dispatch(*args, **kw)
                durations.append(list(pending["durations"]))
                return pending

            tts.synth._dispatch_chunks = recorded
            for seed in (7, 8) if backend != "splash" else (7,):  # 8: a replay of 7's graph
                mel = counted(f"flagship attn_backend={backend} request (seed {seed})",
                              lambda: tts.infer(ref_path, REF_TEXT, GEN_TEXT, seed=seed,
                                                **quiet)[2], kernels, depth * 32, 32)
                mels.setdefault(backend, mel)
            tts.synth._dispatch_chunks = dispatch
            check(bool(np.isfinite(mels[backend]).all()), f"{backend}: mel not finite")
            if backend == "splash":
                flagship = (pick_bucket(max(durations[0]), DURATION_BUCKETS), durations[0][0],
                            tts.config.arch.heads, tts.config.arch.dim_head)
            del tts
            gc.collect()
            torch.cuda.empty_cache()
        n, dur, heads, dh = flagship
        print(f"[splash] the flagship request under splash: duration {dur} of bucket {n} "
              f"frames, so K6 sees valid lengths [{dur}, {dur}] (the CFG pair); K6 there:",
              flush=True)
        splash_case("bf16", 2, n, heads, dh, "flagship", [dur, dur])
        for backend in ("xla", "splash"):
            err = rel_l2(torch.from_numpy(mels[backend]), torch.from_numpy(mels["vmem"]))
            print(f"[splash] flagship mel, attn_backend={backend} against vmem on the same "
                  f"noise (bf16, random weights): rel-L2 {err:.3e} (printed, not gated)",
                  flush=True)

        for model, label, kernels, n in ((str(_flagship_as_mmdit(d)), "MMDiT", SPLASH_KERNELS,
                                          2),
                                         ("e2tts_base", "e2tts_base UNetT", MMDIT_KERNELS, 2)):
            tts = TTS(model=model, vocab_file=str(vocab), frontend=None, attn_backend="splash")
            launches, _ = run_requests(tts, f"{label} attn_backend=splash", n, kernels, dev,
                                       ref_path, REF_TEXT, GEN_TEXT, tag="splash")
            add(launches)
            del tts
            gc.collect()
            torch.cuda.empty_cache()

        out_wav = d / "cli.wav"
        rc = counted("tts_multilingual.main --attn_backend splash --nfe_step 16",
                     lambda: tts_multilingual.main([
                         "--attn_backend", "splash", "--frontend", "none",
                         "--vocab_file", str(vocab), "--ref_audio", ref_path, "--ref_text",
                         REF_TEXT, "--text", GEN_TEXT, "--output_wave", str(out_wav),
                         "--nfe_step", "16", "--seed", "0"]), SPLASH_KERNELS, depth * 16, 16)
        w, wsr = read_audio(str(out_wav))
        check(rc == 0 and wsr == 24000 and w.size > 0 and bool(np.isfinite(w).all()),
              f"tts_multilingual --attn_backend splash: rc {rc}, wav {w.shape} at {wsr} Hz")
        wav_path, align_dir, edit_text = _edit_inputs(d)
        evocab, _, _ = _unit_vocab(d, rtext, edit_text)
        add(phase_edit(dev, "multilingual", evocab, wav_path, align_dir, d / "edited",
                       flags=("--attn_backend", "splash"), tag="splash",
                       kernels=SPLASH_KERNELS))
    return totals


def tiny_whisper_pipeline(device):
    """A transformers ASR pipeline of a random-init tiny Whisper (seed 0),
    its feature extractor and a stub tokenizer that writes "heard" and the
    generated ids, on ``device``: what the ASR checks inject as
    ``infer/asr.py``'s pipeline where no Whisper weights exist."""
    import numpy as np
    import torch
    from transformers import (WhisperConfig, WhisperFeatureExtractor,
                              WhisperForConditionalGeneration, pipeline)

    # every id but the end of text suppressed: generation stops at its first
    # step, whatever length the installed transformers asks of it
    cfg = WhisperConfig(vocab_size=64, num_mel_bins=80, d_model=32, encoder_layers=1,
                        encoder_attention_heads=2, decoder_layers=1, decoder_attention_heads=2,
                        encoder_ffn_dim=64, decoder_ffn_dim=64, max_source_positions=1500,
                        max_target_positions=448, decoder_start_token_id=1, eos_token_id=2,
                        pad_token_id=0, bos_token_id=1,
                        suppress_tokens=[i for i in range(64) if i != 2],
                        begin_suppress_tokens=[], forced_decoder_ids=None)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = WhisperForConditionalGeneration(cfg).eval()
    gen = model.generation_config
    gen.is_multilingual, gen.no_timestamps_token_id = True, 6
    gen.task_to_id = {"transcribe": 3, "translate": 4}
    gen.lang_to_id = {"<|en|>": 5, "<|zh|>": 7}

    class SpellIds:
        pad_token_id, bos_token_id, eos_token_id, padding_side = 0, 1, 2, "right"

        def _decode_asr(self, model_outputs, **_):
            ids = [int(t) for out in model_outputs for t in np.asarray(out["tokens"]).ravel()]
            return " heard " + " ".join(f"t{i}" for i in ids) + " ", {}

    return pipeline("automatic-speech-recognition", model=model, tokenizer=SpellIds(),
                    feature_extractor=WhisperFeatureExtractor(feature_size=80),
                    torch_dtype=torch.float32, device=device)


def phase_asr(dev: dict) -> dict:
    """An empty reference text on the flagship. With ``transformers``
    installed (``importlib.util.find_spec``), a random-init tiny Whisper on
    the card (``tiny_whisper_pipeline``) transcribes the reference through
    ``TTS.transcribe`` and through ``TTS.infer`` (K1-K3 depth x 32 each).
    With it hidden (absent, or ``sys.modules["transformers"] = None``),
    ``TTS.infer`` raises an ``ImportError`` naming it and runs nothing.
    Then two requests on one new reference with an injected
    ``transcribe_fn``: called once (the md5 cache), K1-K3 depth x 32 each a
    request. Returns the launch counts."""
    import importlib.util

    import numpy as np
    import torch

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.infer import asr
    from lemas_tts_tpu_torch.utils.audio_io import write_wav

    totals = dict.fromkeys(kernel_counters(), 0)
    quiet = dict(show_info=lambda *_: None)
    want = None

    def request(label, ref_path, **kw):
        reset_counters()
        (wave, _, _), wall = _timed(lambda: tts.infer(ref_path, "", GEN_TEXT, seed=0, **quiet,
                                                      **kw))
        launches = read_counters()
        print(f"[asr] {label}: {wall:.3f} s wall on {dev['card']}; launches {launches}",
              flush=True)
        check(launches == want, f"asr {label}: launches {launches}, expected {want}")
        check(wave.size > 0 and bool(np.isfinite(wave).all()), f"asr {label}: bad wave")
        for k in totals:
            totals[k] += launches[k]

    with tempfile.TemporaryDirectory() as tmp:
        vocab = Path(tmp) / "vocab.txt"
        vocab.write_text("\n".join(CHAR_VOCAB) + "\n")
        refs = [str(Path(tmp) / f"ref{i}.wav") for i in range(3)]
        for i, path in enumerate(refs):
            write_wav(path, _reference_wave(16000, 3.0, seed=5 + i), 16000)
        tts = TTS(model="multilingual", vocab_file=str(vocab), frontend=None)
        want = expected_launches(FLAGSHIP_KERNELS, tts.config.arch.depth * 32, 32)
        installed = importlib.util.find_spec("transformers") is not None
        if installed:
            import transformers

            asr._asr_pipe = tiny_whisper_pipeline(tts.device)
            text = tts.transcribe(refs[0])
            print(f"[asr] transformers {transformers.__version__}: a random-init tiny Whisper "
                  f"on {asr._asr_pipe.device} transcribes the reference as {text!r}",
                  flush=True)
            check(asr._asr_pipe.device.type == "cuda" and text.startswith("heard"),
                  f"tiny Whisper transcription {text!r} on {asr._asr_pipe.device}")
            request("TTS.infer with an empty ref_text, the tiny Whisper transcribing",
                    refs[0])
            asr._asr_pipe = None
        hidden = sys.modules.get("transformers", False)
        sys.modules["transformers"] = None  # absent, as import sees it
        try:
            reset_counters()
            raised = None
            try:
                tts.infer(refs[1], "", GEN_TEXT, seed=0, **quiet)
            except ImportError as e:
                raised = e
            launches = read_counters()
        finally:
            if hidden is False:
                del sys.modules["transformers"]
            else:
                sys.modules["transformers"] = hidden
        print(f"[asr] transformers {'hidden' if installed else 'not installed'}: TTS.infer "
              f"with an empty ref_text raised {type(raised).__name__}: {raised}; launches "
              f"{launches}", flush=True)
        check(raised is not None and "transformers" in str(raised)
              and not any(launches.values()),
              "an empty ref_text without transformers did not raise an ImportError naming "
              "it, or ran the sampler")
        calls = []

        def transcribe_fn(wav, sr):
            calls.append(sr)
            return "a transcript of the reference."

        for i in range(2):
            request(f"request {i} with an injected transcribe_fn ({len(calls)} calls before)",
                    refs[2], transcribe_fn=transcribe_fn)
        check(len(calls) == 1, f"transcribe_fn called {len(calls)} times for one reference")
        del tts
        gc.collect()
        torch.cuda.empty_cache()
    return totals


MESH_REL_L2 = {"bf16": 2e-2, "f32": 1e-4}  # seq mesh against the unmeshed mel (ring vs K3)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mesh_requests(tts, label: str, kernels, dev: dict, ref_path: str) -> tuple:
    """A warm-up and two timed B = 1 requests (seeds 0-2), each launching
    every kernel of ``kernels`` depth x 32 times and no other; returns the
    launch counts, the mels, the timed walls and the last request's sampler
    call ``(settings, inputs, mel)``."""
    import numpy as np
    import torch

    want = expected_launches(kernels, tts.config.arch.depth * 32, 32)
    synth, sampler_call = tts.synth, []
    run_sampler = synth.run_sampler

    def spy(settings, *inputs):
        out = run_sampler(settings, *inputs)
        sampler_call[:] = [settings, inputs, out]
        return out

    synth.run_sampler = spy
    reset_counters()
    mels, walls = [], []
    for i in range(3):
        before = read_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave, _, spec = tts.infer(ref_path, REF_TEXT, GEN_TEXT, seed=i,
                                  show_info=lambda *_: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in read_counters().items()}
        check(wave.size > 0 and bool(np.isfinite(wave).all()) and spec.shape[0] == 100,
              f"{label}: wave or mel bad")
        check(grew == want, f"{label}: launches per request {grew}, expected {want}")
        mels.append(spec)
        if i:
            walls.append(wall)
        print(f"[mesh] {label} B 1 request {i} ({'warm-up, captures' if i == 0 else 'timed'}): "
              f"{wave.size / 24000:.3f} audio-s in {wall:.3f} s on {dev['card']}; launches "
              f"{grew}", flush=True)
    del synth.run_sampler
    return read_counters(), mels, walls, sampler_call


def phase_mesh(dev: dict) -> dict:
    """Multi-GPU serving on one card: an NCCL job of one process, set up as
    ``torchrun --nproc_per_node 1`` would (``parallel.distributed.initialize``
    from ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``), the
    flagship at full width (random weights, character vocab, bucket 1024)
    unmeshed and on a ``("data", "model")`` mesh (``TTS(mesh=make_mesh())``):
    B = 1 requests (K1-K3 depth x 32 each, the data mesh's mel equal to the
    unmeshed one bit for bit) and a B = 8 ``synthesize_requests`` batch
    (bit-equal). ``SequenceParallelSampler`` on a ``("data", "seq")`` mesh
    (``make_seq_mesh(seq_parallel=1)``; a ``Synthesizer`` takes it only
    where ``seq`` > 1, as JAX does) on the unmeshed request's sampler
    inputs: K2 only, its mel within ``MESH_REL_L2`` bf16 of the unmeshed
    sampler's (not profiled: torch.profiler takes ~50 s over the eager
    call's ~70k kernels); the same sampler at depth 2 in f32 against
    the unmeshed ``sample_mel``. ``serve_http --multihost`` in-process (its
    warm-ups, a wave of 8 ``/tts``, a ``/tts_stream``, ``/stats``' multihost
    block); ``denoise --data_parallel`` against the plain run (a tiny MDX
    net). Returns the launch counts of the counted runs."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.api import seeded_init
    from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings, sample_mel, sway_time_grid
    from lemas_tts_tpu_torch.config import SamplerConfig, load_model_config
    from lemas_tts_tpu_torch.models.dit import DiT
    from lemas_tts_tpu_torch.parallel.distributed import initialize
    from lemas_tts_tpu_torch.parallel.mesh import make_mesh
    from lemas_tts_tpu_torch.parallel.sequence import SequenceParallelSampler, make_seq_mesh
    from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    check(initialize(), "initialize() did not join the job")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"the job runs {dist.get_backend()} over {dist.get_world_size()} processes")
    totals = dict.fromkeys(kernel_counters(), 0)
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as job:
        job.callback(dist.destroy_process_group)
        d = Path(tmp)
        vocab = d / "vocab.txt"
        vocab.write_text("\n".join(CHAR_VOCAB) + "\n")
        ref_path = str(d / "ref.wav")
        write_wav(ref_path, _reference_wave(16000, 3.0, seed=0), 16000)
        kw = dict(model="multilingual", vocab_file=str(vocab), frontend=None)
        t0 = time.perf_counter()
        ttss = {"unmeshed": TTS(**kw), "data mesh": TTS(**kw, mesh=make_mesh())}
        print(f"[mesh] NCCL job of 1 process up, two flagship TTS built in "
              f"{time.perf_counter() - t0:.1f} s; mesh {ttss['data mesh'].synth.mesh}",
              flush=True)
        runs = {}
        for label in ("unmeshed", "data mesh"):
            launches, *runs[label] = _mesh_requests(ttss[label], label, FLAGSHIP_KERNELS, dev,
                                                    ref_path)
            if label != "unmeshed":
                totals = {k: totals[k] + launches[k] for k in totals}
        base, base_walls, (settings, inputs, base_out) = runs["unmeshed"]
        same = all(np.array_equal(a, b) for a, b in zip(runs["data mesh"][0], base))
        print(f"[mesh] B 1 timed requests: data mesh {np.mean(runs['data mesh'][1]):.4f} s "
              f"against unmeshed {np.mean(base_walls):.4f} s (mean of 2, NFE 32, CFG 2, bucket "
              f"1024) on {dev['card']}; mels bit-equal to the unmeshed ones: {same}", flush=True)
        check(same, "the data mesh's mel is not the unmeshed one")

        # the sequence-parallel sampler on the unmeshed request's sampler
        # inputs (the same noise), against the unmeshed sampler's mel
        synth = ttss["unmeshed"].synth
        seq = SequenceParallelSampler(synth.dit_model, settings, make_seq_mesh(seq_parallel=1))
        want = expected_launches(("ffn_block",), ttss["unmeshed"].config.arch.depth * 32, 32)
        reset_counters()
        walls = {"seq": [], "unmeshed": []}
        for i in range(3):
            before = read_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = seq(*inputs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            grew = {k: v - before[k] for k, v in read_counters().items()}
            err = rel_l2(got, base_out)
            print(f"[mesh] seq mesh sampler call {i} (eager, bf16, B 1, bucket 1024, NFE 32, "
                  f"CFG 2): {wall:.3f} s on {dev['card']}; rel-L2 {err:.3e} against the "
                  f"unmeshed sampler (ring attention vs K3); launches {grew}", flush=True)
            check(grew == want, f"seq mesh sampler: launches {grew}, expected {want}")
            check(bool(torch.isfinite(got).all()) and err <= MESH_REL_L2["bf16"],
                  f"seq mesh sampler rel-L2 {err}")
            if i:
                walls["seq"].append(wall)
        totals = {k: totals[k] + v for k, v in read_counters().items()}
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            synth.run_sampler(settings, *inputs)
            torch.cuda.synchronize()
            walls["unmeshed"].append(time.perf_counter() - t0)
        print(f"[mesh] sampler calls: seq mesh {np.mean(walls['seq']):.4f} s (eager) against "
              f"unmeshed {np.mean(walls['unmeshed']):.4f} s (graph replay; mean of 2 each) on "
              f"{dev['card']}", flush=True)

        wav, sr = read_audio(ref_path)
        reqs = [dict(ref_wav=wav.mean(axis=0), ref_sr=sr, ref_units=REF_TEXT,
                     gen_units=GEN_TEXT, seed=i) for i in range(8)]
        cfg = SamplerConfig(nfe_steps=32, cfg_strength=2.0)
        b8 = {}
        for label in ("unmeshed", "data mesh"):
            synth = ttss[label].synth
            synth.synthesize_requests(reqs, cfg=cfg)  # eager run and capture of the B 8 graph
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = synth.synthesize_requests(reqs, cfg=cfg)
            torch.cuda.synchronize()
            b8[label] = (out, time.perf_counter() - t0, read_counters())
            if label != "unmeshed":
                totals = {k: totals[k] + v for k, v in b8[label][2].items()}
            print(f"[mesh] {label} B 8 synthesize_requests (graph replay): "
                  f"{sum(w.size for w, _, _ in out) / 24000:.3f} audio-s in {b8[label][1]:.3f} s "
                  f"on {dev['card']}; launches {b8[label][2]}", flush=True)
        want8 = expected_launches(FLAGSHIP_KERNELS, ttss["unmeshed"].config.arch.depth * 32, 32)
        check(b8["data mesh"][2] == want8, f"data mesh B 8: launches {b8['data mesh'][2]}")
        check(all(np.array_equal(a[2], b[2]) and np.array_equal(a[0], b[0])
                  for a, b in zip(b8["data mesh"][0], b8["unmeshed"][0])),
              "the data mesh's B 8 batch is not the unmeshed one")
        print("[mesh] data mesh B 8 mels and waves bit-equal to the unmeshed ones: True",
              flush=True)
        del ttss
        gc.collect()
        torch.cuda.empty_cache()

        # the seq sampler at depth 2 in f32 (TF32 off) against the unmeshed
        # sample_mel, cond-only steps (no velocity clamp)
        mcfg = load_model_config("multilingual")
        dit = seeded_init(lambda: DiT(dataclasses.replace(mcfg.arch, depth=2), mel_dim=100,
                                      text_num_embeds=len(CHAR_VOCAB)), 0).cuda().eval()
        st = SamplerSettings(steps=8, cfg_strength=0.0, sway_sampling_coef=1.0)
        g = torch.Generator().manual_seed(5)
        B, N = 1, 1024
        x = dict(cond=torch.randn(B, N, 100, generator=g), cond_mask=torch.arange(N)[None] < 300,
                 text_ids=torch.randint(0, len(CHAR_VOCAB), (B, 120), generator=g),
                 duration=torch.tensor([900]), y0=torch.randn(B, N, 100, generator=g))
        x = {k: v.cuda() for k, v in x.items()}
        want = sample_mel(dit, **x, settings=st, time_grid=sway_time_grid(8, 1.0))
        got = SequenceParallelSampler(dit, st, make_seq_mesh(seq_parallel=1))(**x)
        err = rel_l2(got, want)
        start = torch.where(x["cond_mask"][..., None], x["cond"], torch.where(
            (torch.arange(N, device="cuda") < x["duration"][:, None])[..., None], x["y0"], 0.0))
        moved = rel_l2(want, start)
        print(f"[mesh] seq sampler at depth 2, f32, NFE 8, no CFG: rel-L2 {err:.3e} against "
              f"the unmeshed sample_mel (bar {MESH_REL_L2['f32']}; the ODE moved the state "
              f"{moved:.3f} rel-L2 from its start)", flush=True)
        check(err <= MESH_REL_L2["f32"] and moved > 1e-2,
              f"seq sampler f32 rel-L2 {err} (the state moved {moved})")
        del dit

        print(f"[mesh] {time.perf_counter() - t_phase:.1f} s into the phase", flush=True)
        totals = {k: totals[k] + v for k, v in _mesh_serve(dev, vocab, ref_path).items()}
        _mesh_denoise(dev, d)
        print(f"[mesh] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        totals = {k: totals[k] + v for k, v in phase_train_mesh(dev, d, vocab, ref_path).items()}
    return totals


# full-width meshed steps against the unmeshed step: the bars of the JAX
# package's tests/test_parallel.py:348 (FSDP) and tests/test_pipeline_parallel.py:80
TRAIN_MESH_BAR = {"fsdp": dict(rtol=2e-4, atol=2e-5), "pipe_loss": 1e-5,
                  "pipe": dict(rtol=5e-5, atol=5e-6), "pipe_grad_rel_l2": 1e-4}


def _flagship_trainer(cls, mesh=None, pipe_test: bool = False, **kw):
    """The flagship at full width with remat, lr 1e-4; ``pipe_test``: the
    JAX pipeline test's setting, dropout 0 (a pipeline folds its dropout
    seeds per microbatch) and 2 warm-up updates (the first at lr 0)."""
    import dataclasses

    from lemas_tts_tpu_torch.api import seeded_init
    from lemas_tts_tpu_torch.config import TrainConfig, load_model_config
    from lemas_tts_tpu_torch.models.dit import DiT

    cfg = load_model_config("multilingual")
    arch = dataclasses.replace(cfg.arch, checkpoint_activations=True,
                               dropout=0.0 if pipe_test else cfg.arch.dropout)
    dit = seeded_init(lambda: DiT(arch, mel_dim=100, text_num_embeds=len(CHAR_VOCAB)), 0).cuda()
    tcfg = TrainConfig(learning_rate=1e-4, num_warmup_updates=2 if pipe_test else 0)
    return cls(dit, vocab_size=len(CHAR_VOCAB), mel_dim=100, cfg=tcfg, mesh=mesh, **kw)


def _budget_batch(B: int, T: int, seed: int = 2) -> dict:
    import torch

    g = torch.Generator().manual_seed(seed)
    return {"mel": torch.randn(B, T, 100, generator=g).cuda(),
            "mel_lengths": torch.randint(700, T + 1, (B,), generator=g).cuda(),
            "text": torch.randint(0, len(CHAR_VOCAB), (B, 256), generator=g).cuda(),
            "langs": torch.randint(0, 12, (B,), generator=g).cuda()}


def _meshed_steps(tr, batch, timed: int) -> tuple:
    """One step (seed 0, dropout live) and ``timed`` more: the loss and the
    payload after the first, the walls and the peak memory of the timed."""
    import random

    import torch

    state = tr.init_state(0)

    def step(i):
        return tr.train_step(state, batch, torch.Generator("cuda").manual_seed(i),
                             random.Random(i), {"dropout": torch.Generator().manual_seed(i)})[1]

    m = step(0)
    loss = float(m["loss"])
    payload = tr.checkpoint_payload(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = [_timed(lambda: step(1 + i))[1] for i in range(timed)]
    return loss, payload, walls, torch.cuda.max_memory_allocated() / 2 ** 30


def _payload_diff(got: dict, want: dict, part: str = "model_state_dict", **tol) -> tuple:
    """(largest |difference|, all within ``tol``) over ``part``."""
    import torch

    worst, ok = 0.0, True
    for k, w in want[part].items():
        g = got[part][k]
        worst = max(worst, float((g - w).abs().max()))
        ok &= bool(torch.allclose(g, w, **tol))
    return worst, ok


def phase_train_mesh(dev: dict, d: Path, vocab: Path, ref_path: str) -> dict:
    """Multi-GPU training on the job of one (``phase_mesh``'s): the FSDP and
    the pipelined steps at full width against the unmeshed step, the train
    and distill CLIs under the job, the student on K1-K3. Returns the
    student requests' launch counts."""
    import numpy as np
    import torch

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.cfm.checkpoint import CheckpointManager
    from lemas_tts_tpu_torch.cfm.train import Trainer
    from lemas_tts_tpu_torch.config import TrainConfig, load_model_config
    from lemas_tts_tpu_torch.models.dit import DiT
    from lemas_tts_tpu_torch.parallel.mesh import make_mesh
    from lemas_tts_tpu_torch.parallel.pipeline import PipelinedTrainer, make_pipe_mesh
    from lemas_tts_tpu_torch.scripts import distill, train

    t_phase = time.perf_counter()
    # 1. FSDP on a data mesh against the unmeshed step, at the 39 x 1024 budget batch
    batch = _budget_batch(39, 1024)
    runs = {}
    for label, kw in (("unmeshed", {}), ("fsdp", dict(mesh=make_mesh(), fsdp=True))):
        tr = _flagship_trainer(Trainer, **kw)
        runs[label] = _meshed_steps(tr, batch, timed=2)
        if label == "fsdp":
            n_split = len(tr.placement.fsdp)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    worst, ok = _payload_diff(runs["fsdp"][1], runs["unmeshed"][1], **TRAIN_MESH_BAR["fsdp"])
    for label, (loss, _, walls, peak) in runs.items():
        print(f"[train_mesh] {label} Trainer step at 39 x 1024 = 39936 frames, 22 x 1024 f32, "
              f"checkpoint_activations, TF32 off: {walls[0]:.3f} / {walls[1]:.3f} s a step, "
              f"peak torch.cuda.max_memory_allocated {peak:.2f} GiB (PERF.md's unmeshed step: "
              f"2.452 s, 17.95 GiB); first loss {loss:.6f} on {dev['card']}", flush=True)
    print(f"[train_mesh] Trainer(mesh=make_mesh(), fsdp=True), {n_split} leaves split over data, "
          f"one step against the unmeshed step from the same state and draws: largest parameter "
          f"difference {worst:.3e} (bar rtol {TRAIN_MESH_BAR['fsdp']['rtol']}, atol "
          f"{TRAIN_MESH_BAR['fsdp']['atol']}): {ok}", flush=True)
    check(ok and abs(runs["fsdp"][0] - runs["unmeshed"][0]) <= 1e-5 * abs(runs["unmeshed"][0]),
          f"FSDP step differs from the unmeshed one: {worst}")
    del runs, batch
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the pipelined step (pipe 1, 4 microbatches) against the plain step
    batch = _budget_batch(40, 1000, seed=3)
    runs = {}
    for label, cls, kw in (("plain", Trainer, {}),
                           ("pipelined", PipelinedTrainer,
                            dict(mesh=make_pipe_mesh(pipe_parallel=1), num_microbatches=4))):
        tr = _flagship_trainer(cls, pipe_test=True, **kw)
        runs[label] = _meshed_steps(tr, batch, timed=0)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    (lp, pp, *_), (lq, pq, *_) = runs["plain"], runs["pipelined"]
    worst, ok = _payload_diff(pq, pp, **TRAIN_MESH_BAR["pipe"])
    grad = max(rel_l2(pq["optimizer_state_dict"]["state"][i]["exp_avg"].cpu(),
                      st["exp_avg"].cpu())
               for i, st in pp["optimizer_state_dict"]["state"].items()
               if float(st["exp_avg"].norm()) > 0)
    dl = abs(lq - lp) / abs(lp)
    print(f"[train_mesh] PipelinedTrainer (pipe 1, 4 microbatches) at 40 x 1000 = 40000 frames "
          f"against the plain step: loss {lq:.7f} vs {lp:.7f} (rel {dl:.2e}, bar "
          f"{TRAIN_MESH_BAR['pipe_loss']}); largest parameter difference {worst:.3e} (bar rtol "
          f"{TRAIN_MESH_BAR['pipe']['rtol']}, atol {TRAIN_MESH_BAR['pipe']['atol']}): {ok}; "
          f"worst gradient (AdamW first moment) rel-L2 {grad:.2e}", flush=True)
    check(ok and dl <= TRAIN_MESH_BAR["pipe_loss"] and grad <= TRAIN_MESH_BAR["pipe_grad_rel_l2"],
          f"pipelined step differs: loss {dl}, params {worst}, grad {grad}")
    del runs, batch, pp, pq
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the train CLI with --fsdp under the job, restored bit for bit, --resume
    ck, log = d / "ck_mesh", d / "train_mesh.jsonl"
    common = ["--config", "multilingual", "--vocab_file", str(vocab), "--synthetic",
              str(TRAIN_SYNTHETIC), "--ckpt_dir", str(ck), "--log_every", "1", "--log_file",
              str(log), "--checkpoint_activations", "--fsdp"]
    (rc, wall) = _timed(lambda: train.main([*common, "--steps", "2"]))
    check(rc == 0, "train.main --fsdp failed")
    gc.collect()
    torch.cuda.empty_cache()
    saved = CheckpointManager(str(ck), TrainConfig()).restore()
    cfg = load_model_config("multilingual")
    tr = Trainer(DiT(cfg.arch, mel_dim=100, text_num_embeds=len(CHAR_VOCAB)).cuda(),
                 vocab_size=len(CHAR_VOCAB), mel_dim=100)
    again = tr.checkpoint_payload(tr.restore_state(tr.init_state(0), saved))
    same = all(torch.equal(again[p][k], v) for p in ("model_state_dict", "ema_model_state_dict")
               for k, v in saved[p].items()) and again["step"] == saved["step"] == 2
    del tr, again, saved
    gc.collect()
    torch.cuda.empty_cache()
    check(same, "the saved state did not restore bit for bit")
    check(train.main([*common, "--steps", "3", "--resume"]) == 0, "train.main --resume failed")
    events = [json.loads(line) for line in log.read_text().splitlines()]
    steps = [e["step"] for e in events if e["event"] == "train_step"]
    check(steps == [1, 2, 3] and any(e["event"] == "resumed" and e["step"] == 2 for e in events),
          f"resume did not carry on: {steps}")
    print(f"[train_mesh] scripts/train.main --fsdp under the NCCL job of 1 (no mesh at one "
          f"process, as in JAX): 2 steps in {wall:.1f} s wall, restored bit for bit {same}, "
          f"--resume ran step 3; losses "
          f"{[round(e['loss'], 5) for e in events if e['event'] == 'train_step']}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the distill CLI under the job (one NFE-8 stage), the student on K1-K3
    dlog = d / "distill_mesh.jsonl"
    (rc, wall) = _timed(lambda: distill.main([
        "--config", "multilingual", "--vocab_file", str(vocab), "--synthetic",
        str(TRAIN_SYNTHETIC), "--teacher", str(ck), "--steps_per_stage", "2", "--stages", "8",
        "--ckpt_dir", str(d / "dd_mesh"), "--model_parallel", "1", "--log_every", "1",
        "--log_file", str(dlog)]))
    check(rc == 0, "distill.main --model_parallel 1 failed")
    dl = [round(json.loads(line)["loss"], 5) for line in dlog.read_text().splitlines()
          if json.loads(line)["event"] == "distill_step"]
    print(f"[train_mesh] scripts/distill.main --model_parallel 1 under the job: stage 8, 2 steps "
          f"in {wall:.1f} s wall; losses {dl}", flush=True)
    check(len(dl) == 2 and all(np.isfinite(dl)), f"distill losses {dl}")
    gc.collect()
    torch.cuda.empty_cache()
    tts = TTS(model="multilingual", ckpt_file=str(d / "dd_mesh" / "stage_8"),
              vocab_file=str(vocab), frontend=None)
    want = expected_launches(FLAGSHIP_KERNELS, cfg.arch.depth * 8, 8)
    totals = dict.fromkeys(kernel_counters(), 0)
    for i, route in enumerate(("eager (first of its bucket)", "graph replay")):
        reset_counters()
        (wave, sr, _), wall = _timed(lambda: tts.infer(
            ref_path, REF_TEXT, GEN_TEXT, seed=7, show_info=lambda *_: None))
        got = read_counters()
        totals = {k: totals[k] + got[k] for k in totals}
        print(f"[train_mesh] student stage_8 request {i}, {route}: {len(wave) / sr:.3f} audio-s "
              f"in {wall:.3f} s on {dev['card']}; launches {got}", flush=True)
        check(got == want, f"student launches {got}, expected {want}")
        check(wave.size > 0 and bool(np.isfinite(wave).all()), "student wave not finite")
    del tts
    print(f"[train_mesh] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return totals


def _mesh_serve(dev: dict, vocab: Path, ref_path: str) -> dict:
    """``serve_http --multihost`` in-process on the job of one: its warm-up
    and a dispatch-path warm-up batch of 8 through the broadcast, a wave of
    8 ``/tts`` (one batch of 8), a ``/tts_stream`` of 3 chunks, ``/stats``
    with the multihost block. Returns the wave's launch counts."""
    import io
    import wave as wave_mod

    import numpy as np

    from lemas_tts_tpu_torch.scripts import serve_http

    args = serve_http.build_parser().parse_args(
        ["--port", "0", "--vocab_file", str(vocab), "--frontend", "none", "--max_batch", "8",
         "--warmup_batches", "8", "--warmup_durations", "1024", "--multihost",
         "--max_wait_ms", "2000"])  # one batch of 8 (see phase_serve)
    ready, box, failed = threading.Event(), [], []

    def run_server():
        try:
            serve_http.serve(args, ready_event=ready, server_box=box)
        except BaseException as e:  # handed to the main thread below
            failed.append(e)
            ready.set()

    t0 = time.perf_counter()
    server = threading.Thread(target=run_server, daemon=True)
    server.start()
    check(ready.wait(600), "serve_http --multihost did not start")
    if failed:
        raise failed[0]
    httpd, engine = box[0]
    port = httpd.server_address[1]
    try:
        print(f"[mesh] serve_http --multihost ready (warm-ups included) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        depth = len(engine.synth.synth.dit_model.transformer_blocks)
        _, prefix, tail = serving_refresh_steps(serving_settings(engine.synth.synth))
        per_batch = expected_launches(("vmem_attention_nhd",), (prefix + tail) * depth, 32)
        results = [None] * 8
        start = threading.Barrier(9)

        def client(i):
            start.wait()
            results[i] = _http(port, "POST", "/tts", dict(ref_path=ref_path, ref_text=REF_TEXT,
                                                          text=GEN_TEXT, seed=i))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        reset_counters()
        start.wait()
        t1 = time.perf_counter()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t1
        got = read_counters()
        audio = 0.0
        for i, res in enumerate(results):
            check(res is not None and res[0] == 200, f"/tts {i}: {res and res[:2]}")
            with wave_mod.open(io.BytesIO(res[2]), "rb") as w:
                pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
            check(pcm.size > 0 and np.abs(pcm).max() > 0, f"/tts {i}: silent")
            audio += pcm.size / 24000
        print(f"[mesh] multihost wave of 8 /tts: {audio:.3f} audio-s "
              f"in {wall:.3f} s on {dev['card']}; launches {got}", flush=True)
        check(got == per_batch, f"multihost wave: launches {got}, one batch of 8 {per_batch}")
        t1 = time.perf_counter()
        status, ctype, body = _http(port, "POST", "/tts_stream", dict(
            ref_path=ref_path, ref_text=REF_TEXT, seed=5, chunk_batch=2,
            text="the old lighthouse keeper walked home.\nthe fishing boats came in late.\n"
                 "and the harbour lights went out."))
        streamed = np.frombuffer(body, "<i2")
        print(f"[mesh] multihost /tts_stream of 3 chunks: {status}, {streamed.size / 24000:.3f} "
              f"audio-s in {time.perf_counter() - t1:.3f} s", flush=True)
        check(status == 200 and streamed.size > 0 and np.abs(streamed).max() > 0,
              f"/tts_stream: {status}")
        status, _, body = _http(port, "GET", "/stats")
        stats = json.loads(body)
        mh = stats.get("multihost") or {}
        print(f"[mesh] /stats batch sizes {stats['batch_sizes']}, multihost {mh}", flush=True)
        # dispatches: the warm-up batch, the wave and the stream's mini-batches
        check(status == 200 and mh.get("processes") == 1 and mh.get("in_lockstep") is True
              and mh["per_process"][0]["dispatches"] >= 4
              and mh["per_process"][0]["warmups"] == 1 and stats["batch_sizes"] == [8],
              "/stats has no multihost block in lockstep with the warm-ups, or the wave was "
              "not one batch")
        status, _, body = _http(port, "GET", "/config")
        check(status == 200 and json.loads(body)["multihost"] is True, "/config: multihost")
    finally:
        httpd.shutdown()
        server.join(timeout=120)
    check(not server.is_alive(), "serve_http --multihost did not stop")
    return got


def _mesh_denoise(dev: dict, d: Path) -> None:
    """``scripts/denoise.main --data_parallel`` on the job of one against
    the plain run: the same stems, bit for bit (a tiny MDX net at the full
    7680-point STFT)."""
    import numpy as np
    import torch

    from lemas_tts_tpu_torch.scripts import denoise as denoise_cli
    from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav
    from lemas_tts_tpu_torch.uvr5.mdxnet import ConvTDFNet, MDXConfig, seeded_init_

    pt = d / "mdx_tiny.pt"
    torch.save(seeded_init_(ConvTDFNet(MDXConfig(dim_f=24, num_blocks=5, l=2, g=4, bn=2)),
                            torch.Generator().manual_seed(0)).state_dict(), pt)
    src = d / "dn_in"
    src.mkdir()
    write_wav(str(src / "clip.wav"), _reference_wave(24000, 5.0, seed=3), 24000)
    outs = {}
    for label, flag in (("plain", []), ("data_parallel", ["--data_parallel"])):
        (written,), wall = _timed(lambda: denoise_cli.main(
            ["-a", str(src), "-r", str(d / f"dn_{label}"), "-m", str(pt)] + flag))
        outs[label] = read_audio(written)[0]
        print(f"[mesh] denoise {label}: {outs[label].shape} in {wall:.2f} s on {dev['card']}",
              flush=True)
    same = np.array_equal(outs["plain"], outs["data_parallel"])
    print(f"[mesh] denoise --data_parallel equal to the plain run: {same}", flush=True)
    check(same, "denoise --data_parallel differs from the plain run")


def sampler_forwards(settings) -> int:
    """Model forwards one sampler call runs: one a step, two a midpoint
    step. The block cache skips blocks, not the input embedding, so its
    cached steps are forwards too."""
    return settings.steps * (2 if settings.method == "midpoint" else 1)


def sampler_blocks(settings, depth: int) -> int:
    """Blocks one sampler call runs (each block launches K1, K3 and K2 once
    on the flagship path), from the settings' schedule: depth a forward,
    less the cached range on the block cache's cached steps."""
    steps = settings.steps
    if settings.block_cache_range is None:
        return depth * sampler_forwards(settings)
    _, pre, tail = serving_refresh_steps(settings, steps)
    lo, hi = settings.block_cache_range
    return depth * (pre + tail) + (depth - (hi - lo)) * (steps - pre - tail)


PROBE_MFU_MAX = 1.05  # model FLOP utilisation above this is a wrong count


def phase_probes(dev: dict) -> dict:
    """The measurement tools (``scripts/``) at flagship width on the card,
    each printing its own JSON lines: ``kernel_check`` (vmem against xla,
    N 1024, B 1 and 8); ``profile_sampler`` (the graphed B 1 sampler at NFE
    32, CFG 2: card busy, idle share, mfu in (0, ``PROBE_MFU_MAX``]);
    ``latency_probe`` at the serving defaults, a closed loop of 4 requests
    and ``--loaded_ttfb`` for 10 s (no request shed); ``cutoff_probe``,
    ``blockcache_probe`` and ``quant_probe`` at two specs (modes) each, their
    launch counts equal to the blocks their settings run; ``attn_pack_probe``
    (K4 bit-equal to K3); ``widehead_probe --no_e2e``; ``distill_probe
    --stages 8 --steps 2``; ``student_stack_probe`` with one spec. Returns
    the launch counts of the sampler tools (the kernel-only checks and
    timings are not counted)."""
    import torch

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.config import resolve_quant
    from lemas_tts_tpu_torch.scripts import (attn_pack_probe, blockcache_probe, cutoff_probe,
                                             distill_probe, kernel_check, latency_probe,
                                             profile_sampler, quant_probe, student_stack_probe,
                                             widehead_probe)

    t_phase = time.perf_counter()
    totals = dict.fromkeys(kernel_counters(), 0)
    depth = 22

    def run(label, fn, want=None):
        """fn() with the counts set to 0 just before and read just after
        (``want``: the counts it must give); None counts nothing."""
        reset_counters()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got = read_counters()
        print(f"[probes] {label}: {time.perf_counter() - t0:.1f} s, launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if want is not None:
            want = {k: want.get(k, 0) for k in got}
            check(got == want, f"[probes] {label}: launches {got}, expected {want}")
            for k in totals:
                totals[k] += got[k]
        gc.collect()
        torch.cuda.empty_cache()
        return out

    recs = run("kernel_check N 1024, B 1 and 8",
               lambda: kernel_check.check_kernels([1024], [1, 8], device="cuda", verbose=False))
    print(json.dumps({"kernel_check": "ok", "device": dev["kind"], "records": recs}), flush=True)

    prof = run("profile_sampler B 1 (capture, a timed replay, a profiled replay)",
               lambda: profile_sampler.profile(profile_sampler.build_parser().parse_args(
                   ["--batch", "1", "--nfe", "32", "--top", "8"])),
               expected_launches(FLAGSHIP_KERNELS, 3 * depth * 32, 3 * 32))
    for ms, n, name in prof.pop("top"):
        print(f"[probes] profile_sampler {ms:9.3f} ms x{n:6d}  {name[:90]}")
    print(json.dumps(prof), flush=True)
    check(prof["mfu"] is not None and 0 < prof["mfu"] <= PROBE_MFU_MAX,
          f"profile_sampler mfu {prof['mfu']} outside (0, {PROBE_MFU_MAX}]")

    def latency():
        tts = TTS(model="multilingual", quantization=resolve_quant("default"))
        parse = latency_probe.build_parser().parse_args
        closed = latency_probe.run(parse(["--requests", "4"]), tts)["latency_probe"]
        loaded = latency_probe.run(parse(["--loaded_ttfb", "--qps", "1", "--secs", "10",
                                          "--max_batch", "2"]), tts)["latency_probe"]
        return closed, loaded

    closed, loaded = run("latency_probe closed loop and --loaded_ttfb", latency)
    lat_launches = read_counters()
    check(closed["shed"] == 0 and closed["latency"]["count"] == 4,
          f"latency_probe closed loop: {closed}")
    check(loaded["shed"] == 0 and loaded["stream_ttfb"] and loaded["batched"]
          and loaded["batched"]["count"] == loaded["fired"],
          f"latency_probe --loaded_ttfb shed requests or finished none: {loaded}")
    check(lat_launches["vmem_attention_nhd"] > 0, "latency_probe launched no K3")
    for k in totals:  # int8 serving: K3 only; every launch is a request's
        totals[k] += lat_launches[k]

    cut = cutoff_probe.build_argparser().parse_args(["--cutoffs", "0.25,1.0"])
    run("cutoff_probe (full CFG, 2 cutoffs; eager)", lambda: cutoff_probe.run_probe(cut),
        expected_launches(FLAGSHIP_KERNELS, 3 * depth * cut.nfe, 3 * cut.nfe))

    bc = blockcache_probe.build_argparser().parse_args(
        ["--specs", "0-22:2+t2,4-20:3", "--batch", "2", "--reps", "2"])
    bc_settings = [blockcache_probe.cache_settings(bc, spec)
                   for spec in (None, "0-22:2+t2", "4-20:3")]
    bc_blocks = sum(sampler_blocks(st, depth) for st in bc_settings)
    run("blockcache_probe (none + 2 specs; graphs: eager run, capture, 2 replays)",
        lambda: blockcache_probe.run_probe(bc),
        expected_launches(FLAGSHIP_KERNELS, 3 * bc_blocks,
                          3 * sum(sampler_forwards(st) for st in bc_settings)))

    qa = quant_probe.build_argparser().parse_args(
        ["--geometries", "16x64", "--speed", "--reps", "2"])
    q_settings = quant_probe.mode_settings(qa).values()
    q_blocks = sum(sampler_blocks(s, depth) for s in q_settings)
    q_forwards = sum(sampler_forwards(s) for s in q_settings)
    # bf16 (K1-K3) and int8 (K3 only) samplers, each run 3 times
    recs = run("quant_probe int8 against bf16, exact and serving (graphs)",
               lambda: quant_probe.run(qa),
               {**expected_launches(FLAGSHIP_KERNELS, 3 * q_blocks, 6 * q_forwards),
                "vmem_attention_nhd": 6 * q_blocks})
    for r in recs:
        lo, hi = INT8_REL_L2
        print(f"[probes] quant_probe {r['mode']}: int8 rel-L2 {r['rel_l2']:.3e} "
              f"(INT8_REL_L2 band {lo:g}-{hi:g}: {lo <= r['rel_l2'] <= hi}), int8 "
              f"{r['int8_wall_s']:.4f} s against bf16 {r['bf16_wall_s']:.4f} s", flush=True)
        check(0 < r["rel_l2"] < kernel_check.REL_TOL,
              f"quant_probe {r['mode']}: int8 against bf16 rel-L2 {r['rel_l2']}")

    run("attn_pack_probe", lambda: attn_pack_probe.run(attn_pack_probe.build_argparser()
                                                       .parse_args(["--shapes", "1x1024",
                                                                    "8x1024", "--reps", "50"])))
    run("widehead_probe --no_e2e", lambda: widehead_probe.main(
        ["--no_e2e", "--shapes", "1x1024", "8x1024", "--reps", "50"]))

    da = distill_probe.build_argparser().parse_args(
        ["--stages", "8", "--steps", "2", "--synthetic", "16", "--reps", "2"])
    # the teacher's graph (3 runs of NFE 32), the student eager twice, its graph 3 runs
    run("distill_probe --stages 8 --steps 2", lambda: distill_probe.run(da),
        expected_launches(FLAGSHIP_KERNELS, 3 * depth * 32 + 5 * depth * 8, 3 * 32 + 5 * 8))

    sa = student_stack_probe.build_argparser().parse_args(
        ["--steps", "8", "--specs", "0-22:2+t2", "--batch", "2", "--reps", "2"])
    sub = blockcache_probe.build_argparser().parse_args(
        ["--nfe", "8", "--cfg", "0", "--depth", str(sa.depth)])
    s_settings = [blockcache_probe.cache_settings(sub, spec) for spec in (None, "0-22:2+t2")]
    s_blocks = sum(sampler_blocks(st, depth) for st in s_settings)
    run("student_stack_probe 8 x 128, NFE 8, one spec", lambda: student_stack_probe.run(sa),
        expected_launches(FLAGSHIP_KERNELS, 3 * s_blocks,
                          3 * sum(sampler_forwards(st) for st in s_settings)))
    print(f"[probes] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return totals


SMOKE_TEXT = "Hello from the runbook."  # validate_assets' smoke request


def _runbook(argv: list) -> tuple:
    """``validate_assets.main(argv)`` with its stdout shown and kept: (exit
    code, step records by name, the summary line)."""
    import io

    from lemas_tts_tpu_torch.scripts import validate_assets

    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, text):
            buf.write(text)
            sys.__stdout__.write(text)
            return len(text)

    with contextlib.redirect_stdout(Tee()):
        rc = validate_assets.main(argv)
    lines = buf.getvalue().splitlines()
    recs = {r["step"]: r for r in (json.loads(ln[len("[step] "):]) for ln in lines
                                   if ln.startswith("[step] "))}
    return rc, recs, json.loads(lines[-1])


def _reprobe_launches(steps: dict, depth: int) -> dict:
    """The launches each reprobe step of the runbook must make, from the
    settings its argv gives its probe: ``cutoff_probe`` full CFG and each
    cutoff (eager), ``blockcache_probe`` the uncached and each spec's graph
    (the eager first call and ``--reps`` replays), ``quant_probe`` each
    geometry's and mode's bf16 (K1-K3) and int8 (K3 only) sampler once
    (eager)."""
    from lemas_tts_tpu_torch.scripts import blockcache_probe, cutoff_probe, quant_probe

    cut = cutoff_probe.build_argparser().parse_args(steps["reprobe_cutoff"].argv)
    n_cut = 1 + len([c for c in cut.cutoffs.split(",") if c])
    bc = blockcache_probe.build_argparser().parse_args(steps["reprobe_blockcache"].argv)
    bc_settings = [blockcache_probe.cache_settings(bc, spec)
                   for spec in [None] + [s for s in bc.specs.split(",") if s]]
    bc_blocks = sum(sampler_blocks(st, depth) for st in bc_settings)
    bc_forwards = sum(sampler_forwards(st) for st in bc_settings)
    qa = quant_probe.build_argparser().parse_args(steps["reprobe_quant"].argv)
    q_settings = quant_probe.mode_settings(qa).values()
    n_geo = len(quant_probe.geometries(qa))
    q_blocks = n_geo * sum(sampler_blocks(st, depth) for st in q_settings)
    q_forwards = n_geo * sum(sampler_forwards(st) for st in q_settings)
    return {"reprobe_cutoff": expected_launches(FLAGSHIP_KERNELS, n_cut * depth * cut.nfe,
                                                n_cut * cut.nfe),
            "reprobe_blockcache": expected_launches(FLAGSHIP_KERNELS, (1 + bc.reps) * bc_blocks,
                                                    (1 + bc.reps) * bc_forwards),
            "reprobe_quant": {**expected_launches(FLAGSHIP_KERNELS, q_blocks, 2 * q_forwards),
                              "vmem_attention_nhd": 2 * q_blocks}}


def phase_assets(dev: dict) -> dict:
    """The JAX package's remaining runtime on the card, on the flagship
    ``multilingual`` model (1024 x 22, 16 x 64 heads) with the seeded random
    weights of a port ``TTS``, written as a reference-layout checkpoint
    (``ema_model.`` keys) and a Vocos ``pytorch_model.bin``:
    ``validate_assets`` on them (parity and the goldens skipped: no reference
    repository, no espeak), its smoke at NFE 32 launching K1-K3 22 x 32
    times each and writing the seeded model's wave bit for bit, the loaded
    model's mel equal to the seeded one's, the three reprobes with the
    launches their settings give, the ``convert_*`` steps run where
    ``tensorstore`` imports and skipped with the reason where not; the
    Gradio ``infer_fn`` plain (K1-K3 22 x 32) and in fast mode (the block
    cache's count); ``serve_http`` on the native scheduler, one wave of 8
    ``/tts`` with ``ref_b64`` forming one batch of 8; ``export_wav(
    remove_silence=True)``; ``read_audio`` of a non-WAV file where ``ffmpeg``
    is. Returns the launch counts of these runs."""
    import base64
    import importlib.util
    import shutil

    import numpy as np
    import torch

    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.api import process_phone_list
    from lemas_tts_tpu_torch.config import SERVING_BLOCK_CACHE, SamplerConfig
    from lemas_tts_tpu_torch.scripts import inference_gradio, serve_http, validate_assets
    from lemas_tts_tpu_torch.text import TextNorm
    from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav

    t_phase = time.perf_counter()
    totals = dict.fromkeys(kernel_counters(), 0)
    quiet = lambda *_: None  # noqa: E731

    def add(got):
        for k in totals:
            totals[k] += got.get(k, 0)

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        ref_path = str(d / "ref.wav")
        write_wav(ref_path, _reference_wave(16000, 3.0, seed=0), 16000)
        phone = TextNorm("phone")
        seqs = [_frontend_units(phone, t) for t in (REF_TEXT, GEN_TEXT, SMOKE_TEXT)]
        units = sorted({u for q in seqs for u in q + process_phone_list(q)} - {" "})
        vocab = d / "vocab.txt"
        vocab.write_text("\n".join([" "] + units) + "\n")

        # ---- the assets: a seeded TTS's random weights, in the reference layouts
        t0 = time.perf_counter()
        seeded = TTS(model="multilingual", vocab_file=str(vocab))
        ckpt, voc = d / "model_last.pt", d / "vocos"
        torch.save({"ema_model_state_dict": {f"ema_model.transformer.{k}": v.float().cpu()
                                             for k, v in seeded.dit.state_dict().items()}}, ckpt)
        voc.mkdir()
        torch.save({k: v.float().cpu() for k, v in seeded.vocoder.state_dict().items()},
                   voc / "pytorch_model.bin")
        a = seeded.config.arch
        print(f"[assets] seeded flagship TTS ({a.dim} x {a.depth}, {a.heads} x {a.dim_head} "
              f"heads) written as {ckpt.name} ({ckpt.stat().st_size / 2**20:.0f} MiB, "
              f"ema_model. keys) and vocos/pytorch_model.bin in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # ---- validate_assets on them
        have_ts = validate_assets.have_tensorstore()
        out = d / "validated"
        argv = ["--ckpt", str(ckpt), "--use_ema", "--vocab_file", str(vocab), "--vocos", str(voc),
                "--model", "multilingual", "--ref_audio", ref_path, "--ref_text", REF_TEXT,
                "--smoke_nfe", "32", "--probe_args", f"--batch 2 --vocab {seeded.vocab.size}",
                "--skip", "parity_capture,parity_compare,phone_goldens", "--out", str(out)]
        steps = {st.name: st for st in validate_assets.build_steps(
            validate_assets.build_parser().parse_args(argv))}
        want = {"smoke_infer": expected_launches(FLAGSHIP_KERNELS, a.depth * 32, 32),
                **_reprobe_launches(steps, a.depth)}
        reset_counters()
        t0 = time.perf_counter()
        rc, recs, summary = _runbook(argv)
        print(f"[assets] validate_assets: exit {rc} in {time.perf_counter() - t0:.1f} s; "
              f"{summary}", flush=True)
        check(rc == 0 and summary["failed"] == [], f"validate_assets failed: {summary}")
        for name, launches in want.items():
            launches = {k: v for k, v in launches.items() if v}
            got = {k: v for k, v in recs[name].get("launches", {}).items() if v}
            print(f"[assets] {name}: {recs[name]['status']}, {recs[name]['time_s']} s, launches "
                  f"{got} (expected {launches})", flush=True)
            check(recs[name]["status"] == "pass" and got == launches,
                  f"{name}: {recs[name]}, expected launches {launches}")
            add(got)
        converts = ("convert_cfm", "convert_vocoder", "convert_uvr5")
        if have_ts:
            check(recs["convert_cfm"]["status"] == recs["convert_vocoder"]["status"] == "pass"
                  and (out / "native_model" / "_METADATA").is_file(), "convert_* did not run")
            check(recs["smoke_infer"]["loaded"] == str(out / "native_model"),
                  "smoke_infer did not load the orbax directory")
        else:
            check(all(recs[s]["status"] == "skip" and "tensorstore" in recs[s]["reason"]
                      for s in converts[:2]), "convert_* not skipped for tensorstore")
            check(recs["smoke_infer"]["loaded"] == str(ckpt), "smoke_infer loaded another file")
        print(f"[assets] tensorstore {'imports: convert_* ran' if have_ts else 'absent: convert_*'}"
              f" {'' if have_ts else 'skipped with the reason'}: "
              + ", ".join(f"{s} {recs[s]['status']}" for s in converts)
              + f"; smoke_infer loaded {Path(recs['smoke_infer']['loaded']).name}", flush=True)

        # ---- the loaded model against the seeded one: same wave, same mel
        seeded_wave, sr, seeded_mel = seeded.infer(ref_path, REF_TEXT, SMOKE_TEXT, nfe_step=32,
                                                   seed=0, show_info=quiet)
        write_wav(str(d / "seeded.wav"), seeded_wave.astype(np.float32), sr)
        same_file = (d / "seeded.wav").read_bytes() == (out / "smoke.wav").read_bytes()
        loaded = TTS(model="multilingual", ckpt_file=recs["smoke_infer"]["loaded"],
                     vocab_file=str(vocab), vocoder_local_path=str(voc))
        reset_counters()
        wave, _, mel = loaded.infer(ref_path, REF_TEXT, SMOKE_TEXT, nfe_step=32, seed=0,
                                    show_info=quiet)
        got = read_counters()
        add(got)
        print(f"[assets] smoke.wav equal to the seeded TTS's wave, byte for byte: {same_file}; "
              f"a TTS on {Path(recs['smoke_infer']['loaded']).name}: mel {tuple(mel.shape)} "
              f"bit-equal to the seeded TTS's: {np.array_equal(mel, seeded_mel)}, wave equal: "
              f"{np.array_equal(wave, seeded_wave)}; launches {got}", flush=True)
        check(same_file and np.array_equal(mel, seeded_mel) and np.array_equal(wave, seeded_wave),
              "the loaded checkpoint does not reproduce the seeded model")
        check(got == want["smoke_infer"], f"loaded TTS launches {got}")

        # ---- export_wav(remove_silence=True)
        gap = np.concatenate([wave, np.zeros(2 * sr, np.float32), wave])
        seeded.export_wav(gap, str(d / "full.wav"))
        seeded.export_wav(gap, str(d / "cut.wav"), remove_silence=True)
        full, _ = read_audio(str(d / "full.wav"))
        cut, _ = read_audio(str(d / "cut.wav"))
        print(f"[assets] export_wav(remove_silence=True): {cut.shape[1]} samples of "
              f"{full.shape[1]} (a 2 s gap cut)", flush=True)
        check(cut.shape[1] < full.shape[1] and bool(np.isfinite(cut).all()),
              "remove_silence did not shorten the file")
        del seeded, loaded
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the Gradio infer_fn on the card, plain and in fast mode
        gargs = inference_gradio.build_parser().parse_args(
            ["--ckpt_file", str(ckpt), "--vocab_file", str(vocab)])
        infer_fn, _ = inference_gradio.make_handlers(gargs, RuntimeError)
        rwav, rsr = read_audio(ref_path)
        pcm = (rwav[0] * 32767).astype(np.int16)
        for fast in (False, True):
            reset_counters()
            t0 = time.perf_counter()
            (out_sr, audio), seed = infer_fn((rsr, pcm), REF_TEXT, GEN_TEXT, 32, 2.0, 1.0, 1.0,
                                             1.0, True, False, fast, "3")
            torch.cuda.synchronize()
            got = read_counters()
            tts = inference_gradio.get_tts("multilingual", str(ckpt), str(vocab))
            settings = tts.synth._settings(SamplerConfig(
                nfe_steps=32, cfg_strength=2.0, sway_sampling_coef=1.0,
                cfg_cutoff=1.0 if fast else None, block_cache=SERVING_BLOCK_CACHE if fast else None))
            blocks = sampler_blocks(settings, a.depth)
            print(f"[assets] gradio infer_fn ({'fast mode' if fast else 'plain'}) on "
                  f"{tts.device}: {audio.size / out_sr:.3f} audio-s int16 at {out_sr} Hz, seed "
                  f"{seed}, in {time.perf_counter() - t0:.1f} s; launches {got} (expected "
                  f"{blocks} each)", flush=True)
            check(tts.device.type == "cuda" and out_sr == 24000 and audio.dtype == np.int16
                  and np.abs(audio).max() > 0 and seed == "3", "infer_fn output")
            check(got == expected_launches(FLAGSHIP_KERNELS, blocks, sampler_forwards(settings)),
                  f"infer_fn launches {got}")
            add(got)
        inference_gradio._model_cache.clear()
        del tts
        gc.collect()
        torch.cuda.empty_cache()

        # ---- serve_http on the native scheduler: one wave of 8 /tts with ref_b64
        args = serve_http.build_parser().parse_args(
            ["--port", "0", "--ckpt_file", str(ckpt), "--vocab_file", str(vocab),
             "--max_batch", "8", "--warmup_batches", "8",
             "--max_wait_ms", "2000"])  # one batch of 8 (see phase_serve)
        ready, box, failed = threading.Event(), [], []

        def run_server():
            try:
                serve_http.serve(args, ready_event=ready, server_box=box)
            except BaseException as e:  # handed to the main thread below
                failed.append(e)
                ready.set()

        t0 = time.perf_counter()
        server = threading.Thread(target=run_server, daemon=True)
        server.start()
        check(ready.wait(600), "serve_http did not start")
        if failed:
            raise failed[0]
        httpd, engine = box[0]
        port = httpd.server_address[1]
        try:
            check(engine.batcher.is_native, "serve_http's engine is not on the native scheduler")
            print(f"[assets] serve_http ready in {time.perf_counter() - t0:.1f} s on the "
                  "native scheduler", flush=True)
            depth = len(engine.synth.dit_model.transformer_blocks)
            _, prefix, tail = serving_refresh_steps(serving_settings(engine.synth))
            per_batch = expected_launches(("vmem_attention_nhd",), (prefix + tail) * depth, 32)
            ref_b64 = base64.b64encode(Path(ref_path).read_bytes()).decode()
            results = [None] * 8
            start = threading.Barrier(9)

            def client(i):
                start.wait()
                results[i] = _http(port, "POST", "/tts", dict(ref_b64=ref_b64, ref_text=REF_TEXT,
                                                              text=GEN_TEXT, seed=i))

            threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            reset_counters()
            start.wait()
            t1 = time.perf_counter()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t1
            got = read_counters()
            add(got)
            check(all(r is not None and r[0] == 200 for r in results),
                  f"/tts: {[r and r[:2] for r in results]}")
            stats = json.loads(_http(port, "GET", "/stats")[2])
            print(f"[assets] a wave of 8 /tts with ref_b64 in {wall:.3f} s; /stats scheduler "
                  f"{stats['scheduler']!r}, batch sizes {stats['batch_sizes']}; launches {got} "
                  f"(one batch of 8: {per_batch})", flush=True)
            check(stats["scheduler"] == "native" and stats["batch_sizes"] == [8],
                  f"the wave did not form one batch of 8 on the native scheduler: {stats}")
            check(got == per_batch, f"the wave's launches {got}, expected {per_batch}")
        finally:
            httpd.shutdown()
            server.join(timeout=120)
        check(not server.is_alive(), "serve_http did not stop")
        del engine, httpd
        gc.collect()
        torch.cuda.empty_cache()

        # ---- read_audio of a container other than WAV
        if shutil.which("ffmpeg"):
            flac = d / "ref.flac"
            subprocess.run(["ffmpeg", "-v", "quiet", "-y", "-i", ref_path, str(flac)], check=True,
                           timeout=120)
            w, r = read_audio(str(flac))
            how = "soundfile" if importlib.util.find_spec("soundfile") else "ffmpeg"
            print(f"[assets] read_audio of a FLAC through {how}: {w.shape} at {r} Hz", flush=True)
            check(w.shape[-1] == 48000 and r == 16000 and bool(np.isfinite(w).all()),
                  "read_audio of the FLAC")
        else:
            print("[assets] ffmpeg absent on this machine: read_audio of a non-WAV container "
                  "not run", flush=True)
    print(f"[assets] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return totals


def main() -> int:
    t_start = time.perf_counter()
    if not (REPO / "lemas_tts_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py must run from a checkout of the repository "
              "(lemas_tts_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = phase_card()
    phase_build()
    records = {**phase_kernels(), **phase_split_attention(), **phase_splash_attention(),
               **phase_conv()}
    phase_dit()
    launches = phase_slice(dev)
    graphed, profiles = phase_graph(dev)
    for more in (phase_frontend(dev), graphed, phase_serve(dev, profiles["eager"]),
                 phase_prosody(dev), phase_bigvgan(dev), phase_unett(dev), phase_uvr5(dev),
                 phase_train(dev), phase_splash(dev), phase_asr(dev), phase_mesh(dev),
                 phase_probes(dev), phase_assets(dev)):
        launches = {k: launches[k] + more[k] for k in launches}
    kernels = [records[k] for k in ("qkv_block", "vmem_attention_nhd", "ffn_block",
                                     "vmem_attention_nhd_pack", "vmem_attention",
                                     "splash_attention", CONV)]
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
        check(rec["launches"] > 0, f"{rec['name']} was not launched on the slice's paths")
    print(f"[smoke] every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(dev["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
