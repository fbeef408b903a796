"""Synthesis engine: text chunking, batched sampling, vocoding, stitching
(counterpart of ``lemas_tts_tpu/infer/pipeline.py``).

Text chunks of one request are packed into one batch: one sampler call and
one masked vocoder decode. Shapes are bucketed (duration, text length,
batch); every chunk starts from the same seeded noise prefix, so results do
not depend on how chunks are batched.

On CUDA the sampler runs as one captured CUDA graph per (settings, batch
bucket, duration bucket, text bucket) (``cfm/graph.py``), the counterpart of
the JAX package's compiled program per bucket, on every attention route of
the model (``attn_backend`` ``"vmem"``, ``"splash"`` or ``"xla"``, fixed when
the model is built); ``warmup`` captures them
ahead, ``dispatch_warmup`` through the real request path. CPU tensors run
``sample_mel`` eagerly. ``synthesize_requests`` serves many requests, each
with its own reference, as one sampler call; ``synthesize_stream`` yields
chunk by chunk, the next mini-batch queued on the card before the previous
one's results are read on the host. Inputs go up and results come down
through pinned memory (``to_device``, ``to_host``), so queueing waits for
nothing on the card and a read waits for its own batch only.

Each call runs in stage spans (``utils/profiling.py:StageTimers.stage``,
counted in ``TIMERS``; ``record_function`` ranges while a profiler records):
``synth.request`` per device batch, inside it ``synth.prep`` (reference,
text, host arrays, uploads), ``synth.sample``, ``synth.vocode``,
``synth.fetch`` (copies to the host and the wait on them) and
``synth.finish`` (trim, RMS restore, cross-fade, clip); a stream's
mini-batches run the inner five.

With a prosody encoder (the prosody-conditioned model) and
``cfg.use_prosody_encoder``, ``_prepare_ref`` embeds the reference's 16 kHz
resample once a request; the sampler then sees ``prosody_to_mel`` of the
embedding added over the reference frames of the cond mel and the embedding
broadcast to ``[B, nt, 512]`` as the DiT's prosody text, each request of
``synthesize_requests`` with its own.

The vocoder gives ``vocoder_model.wave_length(frames)`` samples for a
decoded mel: ``(frames - 1) * hop`` from Vocos' iSTFT head, ``frames * hop``
from BigVGAN's conv stack; a BigVGAN mel has ``T // hop`` frames, a Vocos one
``T // hop + 1``.

With a ``mesh`` (``parallel/``; every process of the job makes the same
calls with the same inputs) the sampler runs data-parallel on a
``("data", "model")`` mesh (each process its rows, on the card its own
graph per bucket at the local batch, the mel ``all_gather``ed outside the
graph; ``_pick_batch`` pads the batch to a multiple of ``data``) or
sequence-parallel on a ``("data", "seq")`` mesh whose ``seq`` axis has more
than one process (``parallel/sequence.py``; eager on the card:
point-to-point sends inside a captured graph are not used); a ``seq`` axis
of one is data-parallel, as in JAX. Every process then decodes the batch's real rows (as
the unmeshed ``Synthesizer`` does), so the waves are the unmeshed ones.

Intentional difference from the JAX package: the seeded initial noise comes
from ``torch.Generator(device).manual_seed(seed)``, not ``jax.random``, so
the same seed gives different noise in the two packages. Parity checks pin
the noise with ``noise_override``. ``synthesize_requests`` conditions on
prosody, which the JAX package's leaves out.
"""

from __future__ import annotations

import itertools
import logging
import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lemas_tts_tpu_torch.cfm.graph import GraphedSampler, GraphPool
from lemas_tts_tpu_torch.cfm.sampler import (
    DURATION_BUCKETS,
    SamplerSettings,
    block_cache_fields,
    parse_block_cache,
    pick_bucket,
    sample_mel,
    sway_time_grid,
)
from lemas_tts_tpu_torch.config import MelSpecConfig, SamplerConfig
from lemas_tts_tpu_torch.models.dit import PROSODY_DIM
from lemas_tts_tpu_torch.ops.mel import MelFrontend
from lemas_tts_tpu_torch.ops.resample import resample
from lemas_tts_tpu_torch.parallel.mesh import axis_size, data_parallel
from lemas_tts_tpu_torch.parallel.sequence import SequenceParallelSampler
from lemas_tts_tpu_torch.utils.profiling import TIMERS
from lemas_tts_tpu_torch.utils.vocab import Vocab, pad_text_batch, text_to_ids

logger = logging.getLogger(__name__)

TEXT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)
_CALL_IDS = itertools.count(1)  # names each synth.request span


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To CUDA it goes through pinned memory
    without waiting: a copy from pageable memory would wait for the card to
    finish what is queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_host(*tensors: torch.Tensor):
    """Start copying device tensors to the host: ``(host tensors, event)``.
    From CUDA they go into pinned memory behind an event, so a reader waits
    for these results only, not for work queued on the card after them (the
    next mini-batch of a stream); on the CPU the event is None."""
    if tensors[0].device.type != "cuda":
        return list(tensors), None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()
    return host, copied


def dispatch_warmup(synth, cfg: SamplerConfig = SamplerConfig(),
                    duration_buckets: Sequence[int] = (1024,),
                    batch_buckets: Sequence[int] = (1,),
                    max_text_chars: int = 20000) -> int:
    """Warm the serving path through ``synth.synthesize_requests`` itself:
    synthetic requests whose estimated duration lands in each target bucket,
    ``B`` of them for each batch bucket, so the graphs real traffic replays
    are the ones captured (JAX ``dispatch_warmup``). Returns the number of
    dispatches; buckets the synthetic reference cannot reach are skipped, and
    non-bucket durations are taken to their bucket. Each duration bucket is
    warmed at the one text bucket its synthetic text lands in."""
    sr = synth.mel_cfg.target_sample_rate
    t = np.arange(2 * sr) / sr
    ref = (0.1 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    ref_units = "warm up reference audio."
    filler = "all warmup and no playback makes the first request slow ".split()
    n = 0
    for N in sorted({pick_bucket(int(N), DURATION_BUCKETS) for N in duration_buckets}):
        gen, w = "warm. ", 0
        # one word at a time: coarse growth can jump over a narrow bucket
        while (synth.estimate_bucket(ref, sr, ref_units, gen, cfg) < N
               and len(gen) < max_text_chars):
            gen += filler[w % len(filler)] + " "
            w += 1
        if synth.estimate_bucket(ref, sr, ref_units, gen, cfg) != N:
            continue
        for B in batch_buckets:
            synth.synthesize_requests(
                [dict(ref_wav=ref, ref_sr=sr, ref_units=ref_units, gen_units=gen, seed=i)
                 for i in range(int(B))], cfg=cfg)
            n += 1
    return n


def _slice_for_vocoder(mel: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                       n_out: int):
    """Per-row ``[start, start+len)`` windows of ``mel [B, N, D]`` as one
    vocoder batch ``[B, D, n_out]`` plus its frame mask ``[B, n_out]``."""
    B = mel.shape[0]
    melp = F.pad(mel, (0, 0, 0, n_out))
    pos = torch.arange(n_out, device=mel.device)
    sl = melp[torch.arange(B, device=mel.device)[:, None], starts[:, None] + pos[None, :]]
    mask = pos[None, :] < lens[:, None]
    sl = torch.where(mask[..., None], sl, 0.0)
    return sl.transpose(1, 2), mask


def chunk_text(text: str, max_chars: int = 135) -> List[str]:
    """Sentence-boundary chunking with a UTF-8 byte budget (reference
    ``chunk_text``, ``utils_infer.py:89-116``)."""
    chunks: List[str] = []
    current = ""
    sentences = re.split(r"(?<=[;:,.!?])\s+|(?<=[；：，。！？])", text)
    for sentence in sentences:
        piece = (sentence + " " if sentence and len(sentence[-1].encode("utf-8")) == 1
                 else sentence)
        if len(current.encode("utf-8")) + len(sentence.encode("utf-8")) <= max_chars:
            current += piece
        else:
            if current:
                chunks.append(current.strip())
            current = piece
    if current:
        chunks.append(current.strip())
    return chunks


def estimate_duration_frames(ref_frames: int, n_ref_units: int, n_gen_units: int,
                             speed: float) -> int:
    """Reference duration heuristic (``utils_infer.py:520-527``): extrapolate
    the reference's frames-per-unit rate to the new text, scaled by 1/speed."""
    return ref_frames + int(ref_frames / max(1, n_ref_units) * n_gen_units / max(speed, 1e-6))


def cross_fade_concat(waves: Sequence[np.ndarray], sample_rate: int,
                      cross_fade_duration: float) -> np.ndarray:
    """Linear cross-fade stitching (reference ``utils_infer.py:586-617``)."""
    if not waves:
        return np.zeros(0, dtype=np.float32)
    if cross_fade_duration <= 0:
        return np.concatenate(list(waves))
    final = waves[0]
    for nxt in waves[1:]:
        n = min(int(cross_fade_duration * sample_rate), len(final), len(nxt))
        if n <= 0:
            final = np.concatenate([final, nxt])
            continue
        overlap = final[-n:] * np.linspace(1.0, 0.0, n) + nxt[:n] * np.linspace(0.0, 1.0, n)
        final = np.concatenate([final[:-n], overlap, nxt[n:]])
    return final


def clip_and_shuffle(mel: np.ndarray, ratio: Optional[float], frames_per_second: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Accent-GRL conditioning shuffle (reference ``cfm.py:39-83``): crop a
    segment, shuffle ~1 s chunks, repeat to the original length. mel [T, D]."""
    total = mel.shape[0]
    if total <= 1:
        return mel
    seg_len = (int(total * ratio) if ratio else
               int(rng.integers(int(0.25 * total),
                                max(int(0.25 * total) + 1, int(0.75 * total) + 1))))
    seg_len = max(1, seg_len)
    start = int(rng.integers(0, max(1, total - seg_len + 1)))
    seg = mel[start: start + seg_len]
    n_chunks = -(-seg.shape[0] // frames_per_second)
    chunks = [seg[i * frames_per_second: (i + 1) * frames_per_second] for i in range(n_chunks)]
    order = rng.permutation(len(chunks))
    shuffled = np.concatenate([chunks[i] for i in order], axis=0) if chunks else seg
    while shuffled.shape[0] < total:
        shuffled = np.concatenate([shuffled, chunks[int(rng.integers(len(chunks)))]], axis=0)
    return shuffled[:total]


def initial_noise(N: int, D: int, device, seed: Optional[int], rng: np.random.Generator,
                  noise_override: Optional[np.ndarray] = None) -> torch.Tensor:
    """The sampler's initial noise [N, D] f32: ``noise_override`` zero-padded
    or truncated to N rows, else ``torch.randn`` from a generator seeded by
    ``seed`` (or by a draw from ``rng`` when ``seed`` is None)."""
    if noise_override is not None:
        pad = np.zeros((N, D), np.float32)
        t = min(len(noise_override), N)
        pad[:t] = np.asarray(noise_override[:t], np.float32)
        return to_device(pad, torch.device(device))
    noise_seed = seed if seed is not None else int(rng.integers(2 ** 31 - 1))
    gen = torch.Generator(device=device).manual_seed(int(noise_seed))
    return torch.randn((N, D), generator=gen, device=device, dtype=torch.float32)


class Synthesizer:
    """Owns the DiT, the vocoder and the vocab on one device, and, on CUDA,
    a locked cache of sampler graphs keyed as the JAX package's program
    cache is: the ``SamplerSettings`` and the (batch, duration, text)
    bucket. ``mesh``: a ``DeviceMesh`` of the device's type, sequence-parallel
    where its ``seq`` axis has more than one process, else data-parallel
    over ``data``."""

    def __init__(self, dit_model, vocoder_model, vocab: Vocab,
                 mel_cfg: MelSpecConfig = MelSpecConfig(), device="cpu",
                 prosody_encoder=None, prosody_to_mel=None, mesh=None):
        self.dit_model = dit_model
        self.vocoder_model = vocoder_model
        self.prosody_encoder = prosody_encoder  # models/prosody.py:ProsodyEncoder
        self.prosody_to_mel = prosody_to_mel  # f32 Linear(512 -> n_mels)
        self.vocab = vocab
        self.mel_cfg = mel_cfg
        self.device = torch.device(device)
        self.mel_frontend = MelFrontend(
            n_fft=mel_cfg.n_fft, hop_length=mel_cfg.hop_length, win_length=mel_cfg.win_length,
            n_mel_channels=mel_cfg.n_mel_channels, target_sample_rate=mel_cfg.target_sample_rate,
            mel_spec_type=mel_cfg.mel_spec_type)
        self._graphs: Dict[tuple, GraphedSampler] = {}
        self._graph_pool = GraphPool()  # one memory pool for all of them
        self._graph_lock = threading.Lock()
        self._warned_cache_drop = False
        self.mesh = mesh
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a Synthesizer on {self.device}")
        self._seq_parallel = mesh is not None and axis_size(mesh, "seq") > 1
        self._batch_multiple = axis_size(mesh, "data") if mesh is not None else 1
        self._samplers: Dict[SamplerSettings, Callable] = {}
        self._sampler_lock = threading.Lock()

    # ---------------------------------------------------------------- sampler
    def _block_cache_kwargs(self, cfg: SamplerConfig) -> dict:
        """Block-cache ``SamplerSettings`` fields for this model: clamped to
        its depth, off under midpoint, and DiT-only; a spec that is dropped
        warns once (JAX ``_block_cache_kwargs``)."""
        dit = hasattr(self.dit_model, "run_blocks")
        depth = len(self.dit_model.transformer_blocks) if dit else None
        fields = block_cache_fields(cfg.block_cache, depth, cfg.ode_method) if dit else {}
        if (cfg.block_cache and parse_block_cache(cfg.block_cache) and not fields
                and not self._warned_cache_drop):
            self._warned_cache_drop = True
            logger.warning("block_cache=%r disabled: %s — sampling on the exact path",
                           cfg.block_cache, "DiT-only feature" if not dit else
                           f"ode_method={cfg.ode_method!r} or range empty at depth {depth}")
        return fields

    def _settings(self, cfg: SamplerConfig, t_start: float = 0.0) -> SamplerSettings:
        return SamplerSettings(steps=int(cfg.nfe_steps * (1.0 - t_start)) or 1,
                               cfg_strength=cfg.cfg_strength,
                               sway_sampling_coef=cfg.sway_sampling_coef, method=cfg.ode_method,
                               cfg_cutoff=cfg.cfg_cutoff, t_start=t_start,
                               **self._block_cache_kwargs(cfg))

    def _pick_batch(self, b: int) -> int:
        """The batch bucket, rounded up to a multiple of the mesh's ``data``
        axis (JAX ``_batch_multiple``); the padded rows are dropped."""
        m = self._batch_multiple
        return -(-pick_bucket(b, BATCH_BUCKETS) // m) * m

    def _graph(self, settings: SamplerSettings, B: int, N: int, nt: int,
               prosody: bool = False) -> GraphedSampler:
        # a graph keeps the kernels its capture chose: the head-pair switch
        # (LEMAS_ATTN_PACK, read by the blocks) is part of the key, and so is
        # whether the graph takes prosody text
        key = (settings, B, N, nt, os.environ.get("LEMAS_ATTN_PACK", "") == "1", prosody)
        with self._graph_lock:
            g = self._graphs.get(key)
            if g is None:
                grid = sway_time_grid(settings.steps, settings.sway_sampling_coef,
                                      settings.t_start)
                g = self._graphs[key] = GraphedSampler(
                    self.dit_model, settings, grid, B, N, self.mel_cfg.n_mel_channels, nt,
                    self.device, self._graph_pool, PROSODY_DIM if prosody else None)
        return g

    def _local(self, settings: SamplerSettings):
        """This process's sampler: on CUDA the bucket's graph (captured at
        its first use), on the CPU ``sample_mel``."""
        grid = sway_time_grid(settings.steps, settings.sway_sampling_coef, settings.t_start)

        def run(cond, cond_mask, text_ids, duration, y0, step_cond=None, prosody_text=None):
            if self.device.type == "cuda":
                B, N, _ = cond.shape
                return self._graph(settings, B, N, text_ids.shape[1], prosody_text is not None)(
                    cond, cond_mask, text_ids, duration, y0, step_cond, prosody_text)
            return sample_mel(self.dit_model, cond=cond, cond_mask=cond_mask, text_ids=text_ids,
                              duration=duration, y0=y0, time_grid=grid, settings=settings,
                              step_cond=step_cond, prosody_text=prosody_text)

        return run

    def _sampler(self, settings: SamplerSettings) -> Callable:
        """``fn(cond, cond_mask, text_ids, duration, y0, step_cond,
        prosody_text)`` for ``settings``: the whole mel on this process (JAX
        ``_sampler``: the mesh's data- or sequence-parallel form)."""
        fn = self._samplers.get(settings)
        if fn is None:
            with self._sampler_lock:
                fn = self._samplers.get(settings)
                if fn is None:
                    if self._seq_parallel:
                        fn = SequenceParallelSampler(self.dit_model, settings, self.mesh)
                    elif self.mesh is not None:
                        fn = data_parallel(self._local(settings), self.mesh)
                    else:
                        fn = self._local(settings)
                    self._samplers[settings] = fn
        return fn

    def run_sampler(self, settings: SamplerSettings, cond, cond_mask, text_ids, duration, y0,
                    step_cond=None, prosody_text=None) -> torch.Tensor:
        """The sampler on device tensors, the whole batch in, the whole mel
        out (on every process of a mesh)."""
        return self._sampler(settings)(cond, cond_mask, text_ids, duration, y0, step_cond,
                                       prosody_text)

    def uses_prosody(self, cfg: SamplerConfig) -> bool:
        """Whether requests at ``cfg`` are prosody-conditioned."""
        return (cfg.use_prosody_encoder and self.prosody_encoder is not None
                and self.prosody_to_mel is not None)

    @torch.no_grad()
    def warmup(self, cfg: SamplerConfig = SamplerConfig(),
               duration_buckets: Sequence[int] = (1024,), text_buckets: Sequence[int] = (256,),
               batch_buckets: Sequence[int] = (1,)) -> int:
        """Capture the sampler graphs of these buckets ahead of the first
        request (JAX ``warmup``, which compiles them), the prosody graphs
        when requests at ``cfg`` are prosody-conditioned. Returns the number of
        graphs captured; the CPU and a sequence-parallel mesh run the sampler
        eagerly and capture none."""
        if self.device.type != "cuda" or self._seq_parallel:
            return 0
        settings = self._settings(cfg)
        prosody = self.uses_prosody(cfg)
        d = self._batch_multiple  # a data mesh's graph takes this process's rows
        n = 0
        for B in batch_buckets:
            for N in duration_buckets:
                for nt in text_buckets:
                    n += self._graph(settings, self._pick_batch(B) // d, N, nt, prosody).capture()
        return n

    def estimate_bucket(self, ref_wav, ref_sr: int, ref_units, gen_units,
                        cfg: SamplerConfig) -> int:
        """Duration bucket a request lands in; shares
        :func:`estimate_duration_frames` with the synthesis path."""
        sr = self.mel_cfg.target_sample_rate
        hop = self.mel_cfg.hop_length
        n_samples = int(np.asarray(ref_wav).shape[-1])
        ref_sr = max(1, int(ref_sr))
        # ceil-divide: the resampler's output length is ceil(new/orig · T)
        ref_len = (-(-n_samples * sr // ref_sr)) // hop if ref_sr != sr else n_samples // hop
        dur = estimate_duration_frames(ref_len, len(ref_units), len(gen_units), cfg.speed)
        if isinstance(ref_units, str) and self.vocab.char_map is None:
            n_units = len((ref_units + gen_units).encode("utf-8"))
        else:
            n_units = len(ref_units) + len(gen_units)
        # the vocos mel (center=True STFT) has T//hop + 1 frames, the bigvgan one T//hop
        cond_frames = ref_len + 1 if self.mel_cfg.mel_spec_type == "vocos" else ref_len
        dur = max(max(n_units, cond_frames) + 1, dur)
        dur = min(dur, cfg.max_duration, DURATION_BUCKETS[-1])
        return pick_bucket(dur, DURATION_BUCKETS)

    @torch.no_grad()
    def _on_device(self, wav) -> torch.Tensor:
        """A host array or a tensor as an f32 tensor on the model's device."""
        if not torch.is_tensor(wav):
            wav = torch.from_numpy(np.ascontiguousarray(wav, np.float32))
        return wav.to(self.device, torch.float32)

    def ref_mel(self, wav) -> np.ndarray:
        """[T] float wave at the model rate (host array or tensor) ->
        [frames, n_mels] log-mel."""
        return self.mel_frontend(self._on_device(wav)[None, :])[0].T.cpu().numpy()

    # ------------------------------------------------------------ main entry
    def synthesize_chunks(self, ref_wav: np.ndarray, ref_sr: int,
                          ref_text_units: Sequence[str] | str,
                          gen_chunks: Sequence[Sequence[str] | str],
                          cfg: SamplerConfig = SamplerConfig(), seed: Optional[int] = None,
                          return_parts: bool = False,
                          noise_override: Optional[np.ndarray] = None,
                          duration_override: Optional[Sequence[int]] = None,
                          ) -> Tuple[np.ndarray, int, np.ndarray]:
        """Zero-shot TTS over pre-tokenized chunks: RMS normalisation,
        resampling, per-chunk duration estimate, sampling, vocoding, RMS
        restore, cross-fade. Returns (wave, sample_rate, mel [n_mels, T]).
        ``noise_override`` ([T, n_mels], zero-padded/truncated to the bucket)
        replaces the seeded noise; ``duration_override`` replaces the
        per-chunk duration estimate."""
        max_b = BATCH_BUCKETS[-1]
        if len(gen_chunks) > max_b:
            waves: List[np.ndarray] = []
            slices: List[np.ndarray] = []
            for i in range(0, len(gen_chunks), max_b):
                w, sr_out, s = self.synthesize_chunks(
                    ref_wav, ref_sr, ref_text_units, list(gen_chunks[i: i + max_b]), cfg, seed,
                    return_parts=True, noise_override=noise_override,
                    duration_override=None if duration_override is None
                    else list(duration_override[i: i + max_b]))
                waves += w
                slices += s
            if return_parts:
                return waves, sr_out, slices
            final = np.clip(cross_fade_concat(waves, sr_out, cfg.cross_fade_duration),
                            -0.999, 0.999)
            return final, sr_out, np.concatenate([g.T for g in slices], axis=1)

        if not gen_chunks:
            sr = self.mel_cfg.target_sample_rate
            if return_parts:
                return [], sr, []
            return (np.zeros(0, np.float32), sr,
                    np.zeros((self.mel_cfg.n_mel_channels, 0), np.float32))

        with TIMERS.stage("synth.request", f"call {next(_CALL_IDS)}"):
            pending = self._dispatch_chunks(ref_wav, ref_sr, ref_text_units, gen_chunks,
                                            cfg=cfg, seed=seed, noise_override=noise_override,
                                            duration_override=duration_override)
            return self._finalize_chunks(pending, cfg, return_parts=return_parts)

    def _prepare_ref(self, ref_wav: np.ndarray, ref_sr: int, cfg: SamplerConfig) -> dict:
        """RMS normalise, resample to the model rate, reference mel, and under
        prosody the embedding of the 16 kHz resample with its
        ``prosody_to_mel`` offset (host arrays)."""
        sr = self.mel_cfg.target_sample_rate
        hop = self.mel_cfg.hop_length
        audio = np.asarray(ref_wav, dtype=np.float32)
        if audio.ndim == 2:
            audio = audio.mean(axis=0)
        rms = float(np.sqrt(np.mean(np.square(audio)))) if audio.size else 0.0
        if 0 < rms < cfg.target_rms:
            audio = audio * (cfg.target_rms / rms)
        x = resample(self._on_device(audio), ref_sr, sr)  # the mel and the encoder share it
        prep = dict(rms=rms, ref_audio_len=x.shape[-1] // hop, cond_mel=self.ref_mel(x),
                    prosody_emb=None, prosody_offset=None)
        if self.uses_prosody(cfg):
            prep["prosody_emb"], prep["prosody_offset"] = self.prosody_embedding(x)
        return prep

    @torch.no_grad()
    def prosody_embedding(self, audio) -> Tuple[np.ndarray, np.ndarray]:
        """The prosody embedding ``[512]`` of ``audio`` (at the model rate,
        host array or tensor; resampled to 16 kHz) and its ``prosody_to_mel``
        offset ``[n_mels]``, as host arrays fetched in one copy."""
        x = resample(self._on_device(audio), self.mel_cfg.target_sample_rate, 16000)
        emb = self.prosody_encoder.embed(x)
        both = torch.cat([emb, self.prosody_to_mel(emb)]).cpu().numpy()
        return both[:emb.shape[0]], both[emb.shape[0]:]

    @torch.no_grad()
    def _dispatch_chunks(self, ref_wav, ref_sr, ref_text_units, gen_chunks,
                         cfg: SamplerConfig = SamplerConfig(), seed: Optional[int] = None,
                         noise_override: Optional[np.ndarray] = None,
                         duration_override: Optional[Sequence[int]] = None,
                         ref_prep: Optional[dict] = None) -> dict:
        """Host prep, the sampler call and the vocoder decode of <= one batch
        bucket of chunks, queued on the device without a host sync; returns
        the pending results for _finalize_chunks. ``ref_prep`` (from
        ``_prepare_ref``) is the reference prep made once for a stream."""
        with TIMERS.stage("synth.prep"):
            pending, settings, inputs = self._prep_chunks(
                ref_wav, ref_sr, ref_text_units, gen_chunks, cfg, seed, noise_override,
                duration_override, ref_prep)
        with TIMERS.stage("synth.sample"):
            out = self.run_sampler(settings, *inputs)
        if cfg.no_ref_audio:
            pending.update(kind="no_ref", results=(out,))
            return pending
        B, durations = pending["B"], pending["durations"]
        # keep >= 1 generated frame when the reference fills the duration
        starts_l = [min(pending["ref_audio_len"], durations[i] - 1) for i in range(B)]
        lens_l = [durations[i] - starts_l[i] for i in range(B)]
        n_out = pick_bucket(max(lens_l), DURATION_BUCKETS)
        with TIMERS.stage("synth.vocode"):
            # the vocoder decodes the real rows only, whatever the padded batch
            starts = to_device(np.asarray(starts_l, np.int64), self.device)
            lens = to_device(np.asarray(lens_l, np.int64), self.device)
            sliced, vmask = _slice_for_vocoder(out[:B], starts, lens, n_out)
            wave = self.vocoder_model.decode(sliced, vmask)
        pending.update(kind="decode", lens_l=lens_l, results=(wave, sliced))
        return pending

    def _prep_chunks(self, ref_wav, ref_sr, ref_text_units, gen_chunks, cfg: SamplerConfig,
                     seed: Optional[int], noise_override: Optional[np.ndarray],
                     duration_override: Optional[Sequence[int]], ref_prep: Optional[dict]):
        """The host side of ``_dispatch_chunks`` up to the sampler call:
        ``(pending, settings, the sampler's inputs on the device)``."""
        sr = self.mel_cfg.target_sample_rate
        hop = self.mel_cfg.hop_length
        D = self.mel_cfg.n_mel_channels
        dev = self.device
        if ref_prep is None:
            ref_prep = self._prepare_ref(ref_wav, ref_sr, cfg)
        rms, ref_audio_len = ref_prep["rms"], ref_prep["ref_audio_len"]
        cond_mel = ref_prep["cond_mel"]
        ref_frames = cond_mel.shape[0]

        if duration_override is not None and len(duration_override) != len(gen_chunks):
            raise ValueError(f"duration_override has {len(duration_override)} entries for "
                             f"{len(gen_chunks)} chunks")
        texts: List[np.ndarray] = []
        durations: List[int] = []
        for chunk_idx, gen in enumerate(gen_chunks):
            if isinstance(ref_text_units, str) != isinstance(gen, str):
                raise TypeError(
                    "ref_text_units and gen chunks must both be strings or both token "
                    f"lists (got {type(ref_text_units).__name__} / {type(gen).__name__})")
            local_speed = cfg.speed
            if isinstance(gen, str) and len(gen.encode("utf-8")) < 10:
                local_speed = 0.3
            if duration_override is not None:
                duration = int(duration_override[chunk_idx])
            elif cfg.fix_duration is not None:
                duration = int(cfg.fix_duration * sr / hop)
            else:
                duration = estimate_duration_frames(ref_audio_len, len(ref_text_units),
                                                    len(gen), local_speed)
            full = ref_text_units + gen if isinstance(gen, str) \
                else list(ref_text_units) + list(gen)
            ids = text_to_ids(full, self.vocab)
            # duration >= max(text_len, ref_frames) + 1, <= max cap (cfm.py:300-304)
            duration = max(max(len(ids), ref_frames) + 1, duration)
            duration = min(duration, cfg.max_duration, DURATION_BUCKETS[-1])
            texts.append(ids)
            durations.append(duration)

        B = len(texts)
        Bp = self._pick_batch(B)
        N = pick_bucket(max(durations), DURATION_BUCKETS)
        max_ids = max(len(t) for t in texts)
        if max_ids > TEXT_BUCKETS[-1]:
            raise ValueError(f"text length {max_ids} exceeds the largest text bucket "
                             f"({TEXT_BUCKETS[-1]}); split the text into more chunks")
        nt = pick_bucket(max_ids, TEXT_BUCKETS)
        text_ids = pad_text_batch(texts, pad_to=nt)
        if Bp > B:  # pad the batch with dummy rows (discarded)
            text_ids = np.concatenate([text_ids, np.full((Bp - B, nt), -1, np.int32)], axis=0)
        dur_arr = np.asarray(durations + [ref_frames + 1] * (Bp - B), dtype=np.int64)

        ref_frames = min(ref_frames, N)
        cond_mel = cond_mel[:ref_frames]
        cond = np.zeros((Bp, N, D), dtype=np.float32)
        cond[:, :ref_frames] = cond_mel[None]
        cond_mask = np.zeros((Bp, N), dtype=bool)
        cond_mask[:, :ref_frames] = True
        cond_mean = cond_mel.mean(axis=0, keepdims=True)
        rng = np.random.default_rng(seed if seed is not None else None)

        # prosody (JAX cfm.py:245-265, 451-455): the offset over the reference
        # frames before masking, the embedding as every chunk's prosody text
        prosody_text = None
        if ref_prep["prosody_emb"] is not None:
            cond[:, :ref_frames] += ref_prep["prosody_offset"][None, None, :]
            prosody_text = np.broadcast_to(ref_prep["prosody_emb"][None, None, :],
                                           (Bp, nt, PROSODY_DIM)).astype(np.float32)

        step_cond = None
        if cfg.use_acc_grl and cfg.ref_ratio is not None and cfg.ref_ratio < 1:
            shuffled = clip_and_shuffle(cond_mel, cfg.ref_ratio, int(sr / hop), rng)
            step_cond = cond.copy()
            step_cond[:, :ref_frames] = shuffled[None]
        if cfg.no_ref_audio:  # cfm.py:320-324
            random_cond = rng.standard_normal(cond.shape).astype(np.float32) * 0.1 + cond_mean
            cond = random_cond / random_cond.mean(axis=1, keepdims=True) * cond_mean

        # shared seeded noise prefix (cfm.py:430-435 semantics)
        y0 = initial_noise(N, D, dev, seed, rng, noise_override)[None].expand(Bp, N, D)

        t_start = 0.0
        if cfg.duplicate_test:  # cfm.py:307-309,439-443
            t_start = cfg.t_inter
            test_cond = np.zeros_like(cond)
            dup_end = min(2 * ref_frames, N)
            test_cond[:, ref_frames:dup_end] = cond_mel[None, : dup_end - ref_frames]
            y0 = (1.0 - t_start) * y0 + t_start * to_device(test_cond, dev)

        inputs = (to_device(cond, dev), to_device(cond_mask, dev), to_device(text_ids, dev),
                  to_device(dur_arr, dev), y0,
                  None if step_cond is None else to_device(step_cond, dev),
                  None if prosody_text is None else to_device(prosody_text, dev))
        pending = dict(B=B, sr=sr, rms=rms, durations=durations, ref_frames=ref_frames,
                       ref_audio_len=ref_audio_len, cond_mean=cond_mean)
        return pending, self._settings(cfg, t_start), inputs

    @staticmethod
    def _start_fetch(pending: dict) -> None:
        """Queue the copies of a dispatched batch's results to the host (a
        stream does so before it dispatches the next mini-batch, which the
        copies then do not wait for; else ``_finalize_chunks`` does)."""
        pending["host"] = to_host(*pending.pop("results"))

    def _finalize_chunks(self, pending: dict, cfg: SamplerConfig, return_parts: bool = False):
        """Fetch the results, trim, restore the RMS, clip and stitch."""
        with TIMERS.stage("synth.fetch"):
            if "host" not in pending:
                self._start_fetch(pending)
            host, copied = pending["host"]
            if copied is not None:
                copied.synchronize()  # this batch's copies only, not work queued after them
        with TIMERS.stage("synth.finish"):
            return self._finish_chunks(pending, host, cfg, return_parts)

    def _finish_chunks(self, pending: dict, host: list, cfg: SamplerConfig, return_parts: bool):
        """Trim the fetched results, restore the RMS, clip and stitch."""
        B, sr, rms = pending["B"], pending["sr"], pending["rms"]
        durations = pending["durations"]
        if pending["kind"] == "no_ref":
            # mean re-alignment of the generated region (cfm.py:464-467)
            ref_frames, ref_audio_len = pending["ref_frames"], pending["ref_audio_len"]
            out_np = host[0].numpy().astype(np.float32)
            gen_region = out_np[:, ref_frames:, :]
            out_np[:, ref_frames:, :] = gen_region - (
                gen_region.mean(axis=1, keepdims=True) - pending["cond_mean"][None])
            gen_slices = [out_np[i, min(ref_audio_len, durations[i] - 1): durations[i], :]
                          for i in range(B)]
            with TIMERS.stage("synth.vocode"):
                waves = self.vocode_batch(gen_slices)
        else:
            lens_l = pending["lens_l"]
            waves_np, mels_np = (h.numpy() for h in host)
            gen_slices = [mels_np[i, :, : lens_l[i]].T for i in range(B)]
            waves = [waves_np[i, : self.vocoder_model.wave_length(lens_l[i])] for i in range(B)]
        if 0 < rms < cfg.target_rms:
            waves = [w * (rms / cfg.target_rms) for w in waves]
        if return_parts:
            return [np.clip(w, -0.999, 0.999) for w in waves], sr, gen_slices
        final = np.clip(cross_fade_concat(waves, sr, cfg.cross_fade_duration), -0.999, 0.999)
        return final, sr, np.concatenate([g.T for g in gen_slices], axis=1)

    # --------------------------------------------------------------- streaming
    def _stream_plan(self, n_chunks: int, cfg: SamplerConfig, chunk_batch: int,
                     first_chunk_batch: Optional[int], first_chunk_cfg: Optional[SamplerConfig]):
        """Mini-batches ``[(start, size, cfg)]`` of a stream: the first may be
        smaller and run other settings than the rest."""
        chunk_batch = max(1, chunk_batch)
        fb = chunk_batch if first_chunk_batch is None else max(1, int(first_chunk_batch))
        plan = [(0, min(fb, n_chunks), first_chunk_cfg or cfg)]
        i = plan[0][1]
        while i < n_chunks:
            size = min(chunk_batch, n_chunks - i)
            plan.append((i, size, cfg))
            i += size
        return plan

    def synthesize_stream(self, ref_wav: np.ndarray, ref_sr: int,
                          ref_text_units: Sequence[str] | str,
                          gen_chunks: Sequence[Sequence[str] | str],
                          cfg: SamplerConfig = SamplerConfig(), seed: Optional[int] = None,
                          chunk_batch: int = 2, first_chunk_batch: Optional[int] = None,
                          first_chunk_cfg: Optional[SamplerConfig] = None):
        """Yield ``(wave, sample_rate)`` per text chunk, in order, as soon as
        its mini-batch is done (no cross-fade). Mini-batch i+1 is queued on
        the device before batch i's results are copied to the host.
        ``first_chunk_batch`` sizes only the first mini-batch and
        ``first_chunk_cfg`` gives it other sampler settings."""
        if not gen_chunks:
            return
        ref_prep = self._prepare_ref(ref_wav, ref_sr, cfg)
        pending = None
        for start, size, bcfg in self._stream_plan(len(gen_chunks), cfg, chunk_batch,
                                                    first_chunk_batch, first_chunk_cfg):
            nxt = (self._dispatch_chunks(ref_wav, ref_sr, ref_text_units,
                                         list(gen_chunks[start: start + size]), cfg=bcfg,
                                         seed=seed, ref_prep=ref_prep), bcfg)
            self._start_fetch(nxt[0])  # its copies queue before the next mini-batch
            if pending is not None:
                yield from self._stream_waves(*pending)
            pending = nxt
        yield from self._stream_waves(*pending)

    def _stream_waves(self, pending: dict, cfg: SamplerConfig):
        waves, sr, _ = self._finalize_chunks(pending, cfg, return_parts=True)
        for w in waves:
            yield w, sr

    # -------------------------------------------------- cross-request batching
    @torch.no_grad()
    def synthesize_requests(self, requests: Sequence[Dict[str, Any]],
                            cfg: SamplerConfig = SamplerConfig(),
                            ) -> List[Tuple[np.ndarray, int, np.ndarray]]:
        """Many independent requests as one sampler call, each batch row with
        its own reference. A request is ``{"ref_wav": [T], "ref_sr": int,
        "ref_units": tokens | str, "gen_units": tokens | str, "seed": int |
        None}``, and optionally ``"rid"`` (the engine's request id, named in
        the call's ``synth.request`` span); settings are shared by the batch.
        Returns ``[(wave, sr, mel [D, T])]`` in request order; a row's noise is
        ``initial_noise`` of its own seed, so its result does not depend on its
        batch."""
        max_b = BATCH_BUCKETS[-1]
        if len(requests) > max_b:
            out: List[Tuple[np.ndarray, int, np.ndarray]] = []
            for i in range(0, len(requests), max_b):
                out += self.synthesize_requests(requests[i: i + max_b], cfg)
            return out
        rids = [str(r["rid"]) for r in requests if "rid" in r]
        with TIMERS.stage("synth.request",
                          f"rids {','.join(rids)}" if rids else f"call {next(_CALL_IDS)}"):
            with TIMERS.stage("synth.prep"):
                rows, inputs = self._prep_requests(requests, cfg)
            with TIMERS.stage("synth.sample"):
                mel = self.run_sampler(self._settings(cfg), *inputs)
            B = len(rows)
            lens_l = [r["duration"] - r["ref_audio_len"] for r in rows]
            n_out = pick_bucket(max(lens_l), DURATION_BUCKETS)
            with TIMERS.stage("synth.vocode"):
                starts = to_device(np.asarray([r["ref_audio_len"] for r in rows], np.int64),
                                  self.device)
                lens = to_device(np.asarray(lens_l, np.int64), self.device)
                sliced, vmask = _slice_for_vocoder(mel[:B], starts, lens, n_out)
                waves = self.vocoder_model.decode(sliced, vmask)
            with TIMERS.stage("synth.fetch"):
                waves = waves.cpu().numpy()
                mels_np = sliced.cpu().numpy()
            with TIMERS.stage("synth.finish"):
                results = []
                for i, r in enumerate(rows):
                    w = waves[i, : self.vocoder_model.wave_length(lens_l[i])]
                    if 0 < r["rms"] < cfg.target_rms:
                        w = w * (r["rms"] / cfg.target_rms)
                    results.append((np.clip(w, -0.999, 0.999), self.mel_cfg.target_sample_rate,
                                    mels_np[i, :, : lens_l[i]]))
        return results

    def _prep_requests(self, requests: Sequence[Dict[str, Any]], cfg: SamplerConfig):
        """The host side of ``synthesize_requests`` up to the sampler call:
        ``(rows, the sampler's inputs on the device)``."""
        D = self.mel_cfg.n_mel_channels
        dev = self.device

        rows = []
        for r in requests:
            prep = self._prepare_ref(r["ref_wav"], r["ref_sr"], cfg)
            cond_mel = prep["cond_mel"]
            ref_units, gen = r["ref_units"], r["gen_units"]
            if isinstance(ref_units, str) != isinstance(gen, str):
                raise TypeError("ref_units and gen_units must both be strings or both token "
                                f"lists (got {type(ref_units).__name__} / "
                                f"{type(gen).__name__})")
            full = ref_units + gen if isinstance(gen, str) else list(ref_units) + list(gen)
            ids = text_to_ids(full, self.vocab)
            duration = estimate_duration_frames(prep["ref_audio_len"], len(ref_units), len(gen),
                                                cfg.speed)
            duration = max(max(len(ids), cond_mel.shape[0]) + 1, duration)
            duration = min(duration, cfg.max_duration, DURATION_BUCKETS[-1])
            # a reference longer than the duration cap keeps >= 1 generated frame
            rows.append(dict(ids=ids, duration=duration, cond_mel=cond_mel, rms=prep["rms"],
                             ref_audio_len=min(prep["ref_audio_len"], duration - 1),
                             seed=r.get("seed"), prosody_emb=prep["prosody_emb"],
                             prosody_offset=prep["prosody_offset"]))

        B = len(rows)
        Bp = self._pick_batch(B)
        N = pick_bucket(max(r["duration"] for r in rows), DURATION_BUCKETS)
        max_ids = max(len(r["ids"]) for r in rows)
        if max_ids > TEXT_BUCKETS[-1]:
            raise ValueError(f"text length {max_ids} exceeds the largest text bucket "
                             f"({TEXT_BUCKETS[-1]}); split the request into chunks")
        nt = pick_bucket(max_ids, TEXT_BUCKETS)
        text_ids = pad_text_batch([r["ids"] for r in rows], pad_to=nt)
        if Bp > B:
            text_ids = np.concatenate([text_ids, np.full((Bp - B, nt), -1, np.int32)], axis=0)
        dur_arr = np.asarray([r["duration"] for r in rows] + [2] * (Bp - B), dtype=np.int64)
        cond = np.zeros((Bp, N, D), dtype=np.float32)
        cond_mask = np.zeros((Bp, N), dtype=bool)
        prosody = self.uses_prosody(cfg)
        prosody_text = np.zeros((Bp, nt, PROSODY_DIM), np.float32) if prosody else None
        entropy = np.random.default_rng()  # an unseeded row draws its own seed
        seeds = []
        for i, r in enumerate(rows):
            f = min(r["cond_mel"].shape[0], N)
            cond[i, :f] = r["cond_mel"][:f]
            cond_mask[i, :f] = True
            if prosody:  # each request its own embedding
                cond[i, :f] += r["prosody_offset"][None, :]
                prosody_text[i] = r["prosody_emb"][None, :]
            seeds.append(r["seed"] if r["seed"] is not None
                         else int(entropy.integers(2 ** 31 - 1)))
        seeds += [0] * (Bp - B)
        y0 = torch.stack([initial_noise(N, D, dev, s, entropy) for s in seeds])

        return rows, (to_device(cond, dev), to_device(cond_mask, dev), to_device(text_ids, dev),
                      to_device(dur_arr, dev), y0, None,
                      None if prosody_text is None else to_device(prosody_text, dev))

    @torch.no_grad()
    def vocode_batch(self, mels: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Decode variable-length [T_i, D] mels as one masked batch call."""
        max_b = BATCH_BUCKETS[-1]
        if len(mels) > max_b:
            out: List[np.ndarray] = []
            for i in range(0, len(mels), max_b):
                out += self.vocode_batch(mels[i: i + max_b])
            return out
        lens = [m.shape[0] for m in mels]
        N = pick_bucket(max(lens), DURATION_BUCKETS)
        B = pick_bucket(len(mels), BATCH_BUCKETS)
        batch = np.zeros((B, self.mel_cfg.n_mel_channels, N), dtype=np.float32)
        mask = np.zeros((B, N), dtype=bool)
        for i, m in enumerate(mels):
            batch[i, :, : m.shape[0]] = m.T
            mask[i, : m.shape[0]] = True
        waves = self.vocoder_model.decode(torch.from_numpy(batch).to(self.device),
                                          torch.from_numpy(mask).to(self.device)).cpu().numpy()
        return [waves[i, : self.vocoder_model.wave_length(lens[i])] for i in range(len(mels))]
