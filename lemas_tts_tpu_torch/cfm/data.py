"""Training data pipeline: frame-budget batching and a prefetching loader
(counterpart of ``lemas_tts_tpu/cfm/data.py``; the same batches from the
same seed):

 - **frame-budget batching**: samples accumulate until the padded batch would
   exceed the frame budget (the reference's ``batch_size_per_gpu: 40000``
   frames) or ``max_samples``;
 - **length bucketing**: batches draw from similar-length samples, padded to
   the sampler's duration buckets, so padding waste and the set of shapes
   stay small;
 - **host prefetch**: a background thread keeps ``prefetch`` batches (on the
   device, through ``to_device``) ahead of the training loop; a producer
   error is raised in the loop, and a loop that stops early stops the thread.

Samples are dicts: ``{"mel": [T, D] float32, "text": [nt] int32 ids,
"lang": int}``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from lemas_tts_tpu_torch.cfm.sampler import DURATION_BUCKETS, pick_bucket
from lemas_tts_tpu_torch.config import TrainConfig

TEXT_PAD = -1


def frame_budget_batches(
    lengths: Sequence[int],
    frame_budget: int,
    max_samples: int = 64,
    shuffle_seed: Optional[int] = None,
    bucket_size: int = 256,
) -> List[List[int]]:
    """Group sample indices into batches under a padded-frame budget.

    Sorts within shuffled windows (≈ bucketing by length without a fixed
    epoch order), then packs greedily: a batch closes when
    ``(n+1) * padded_len`` would exceed ``frame_budget`` or ``max_samples``.
    """
    idx = np.arange(len(lengths))
    if shuffle_seed is not None:
        rng = np.random.default_rng(shuffle_seed)
        rng.shuffle(idx)
    # window-sort: shuffle globally, sort locally by length
    windows = [idx[i : i + bucket_size * 4] for i in range(0, len(idx), bucket_size * 4)]
    ordered: List[int] = []
    for w in windows:
        ordered.extend(sorted(w, key=lambda i: lengths[i]))

    batches: List[List[int]] = []
    cur: List[int] = []
    cur_max = 0
    for i in ordered:
        new_max = max(cur_max, lengths[i])
        # budget against the PADDED length (collate rounds the batch up to
        # the next duration bucket) so real device batches honor the frame
        # budget instead of overshooting it by up to a bucket step
        padded = pick_bucket(new_max, DURATION_BUCKETS)
        if cur and ((len(cur) + 1) * padded > frame_budget or len(cur) >= max_samples):
            batches.append(cur)
            cur, cur_max = [], 0
            new_max = lengths[i]
        cur.append(int(i))
        cur_max = new_max
    if cur:
        batches.append(cur)
    if shuffle_seed is not None:
        rng.shuffle(batches)
    return batches


def collate(samples: Sequence[Dict[str, Any]],
            duration_buckets=DURATION_BUCKETS) -> Dict[str, np.ndarray]:
    """Pad a list of samples into one batch with bucketed shapes."""
    B = len(samples)
    T = pick_bucket(max(s["mel"].shape[0] for s in samples), duration_buckets)
    D = samples[0]["mel"].shape[1]
    nt = max(len(s["text"]) for s in samples)
    nt = 1 << (nt - 1).bit_length() if nt > 1 else 1  # pow2 text bucket

    mel = np.zeros((B, T, D), np.float32)
    mel_lengths = np.zeros((B,), np.int32)
    text = np.full((B, nt), TEXT_PAD, np.int32)
    langs = np.zeros((B,), np.int32)
    for i, s in enumerate(samples):
        # samples longer than the largest bucket are truncated, not crashed
        # on (pick_bucket clamps T to buckets[-1])
        t = min(s["mel"].shape[0], T)
        mel[i, :t] = s["mel"][:t]
        mel_lengths[i] = t
        text[i, : len(s["text"])] = s["text"]
        langs[i] = s.get("lang", 0)
    return {"mel": mel, "mel_lengths": mel_lengths, "text": text, "langs": langs}


def compute_prosody_conds(
    samples: Sequence[Dict[str, Any]],
    prosody_encoder: Any,  # lemas_tts_tpu_torch.models.prosody.ProsodyEncoder
    T_mel: int,
    T_text: int,
) -> Dict[str, np.ndarray]:
    """Per-segment prosody embeddings scattered into dense conditioning maps
    (reference ``cfm.py:544-594``): each sample may carry ``audio_16k`` [Tw]
    and ``prosody_idx`` — a list of
    ``(text_start, text_end, mel_start, mel_end, audio_start, audio_end)``
    segments. The frozen encoder embeds each audio segment; the embedding is
    written over its mel-frame and text-token spans, at data-prep time."""
    B = len(samples)
    mel_cond = np.zeros((B, T_mel, 512), np.float32)
    text_cond = np.zeros((B, T_text, 512), np.float32)
    for b, s in enumerate(samples):
        audio = s.get("audio_16k")
        segs = s.get("prosody_idx")
        if audio is None or not segs:
            continue
        audio = np.asarray(audio, np.float32)
        for ts, te, ms, me, a0, a1 in segs:
            a0 = max(0, min(int(a0), audio.shape[0] - 1))
            a1 = max(a0 + 1, min(int(a1), audio.shape[0]))
            emb = _to_numpy(prosody_encoder.embed(audio[a0:a1]))  # [512], frozen
            mel_cond[b, ms:me] = emb
            text_cond[b, ts:te] = emb
    return {"prosody_mel_cond": mel_cond, "prosody_text_cond": text_cond}


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, perhaps on the card
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class DataLoader:
    """Epoch iterator: frame-budget batches + background prefetch.
    ``to_device`` maps a collated numpy batch (default: unchanged)."""

    def __init__(
        self,
        dataset: Sequence[Dict[str, Any]],
        cfg: TrainConfig = TrainConfig(),
        seed: int = 0,
        prefetch: int = 2,
        to_device: Optional[Callable[[Dict[str, np.ndarray]], Any]] = None,
        batch_multiple: int = 1,
    ):
        self.dataset = dataset
        self.cfg = cfg
        self.seed = seed
        self.prefetch = prefetch
        # data-parallel sharding needs batch % mesh('data') == 0; short batches
        # are padded by cyclically repeating real samples
        self.batch_multiple = max(1, batch_multiple)
        self.to_device = to_device if to_device is not None else (lambda b: b)
        self._lengths = [s["mel"].shape[0] for s in dataset]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self.epoch(self.seed)

    def _epoch_batches(self, seed: int) -> List[List[int]]:
        """The single source of truth for batch composition (epoch() and
        __len__ must agree — train loops size max_steps from len())."""
        budget = (
            self.cfg.batch_size_per_gpu
            if self.cfg.batch_size_type == "frame"
            else 10**9
        )
        max_samples = (
            self.cfg.max_samples
            if self.cfg.batch_size_type == "frame"
            else self.cfg.batch_size_per_gpu
        )
        return frame_budget_batches(
            self._lengths, budget, max_samples, shuffle_seed=seed
        )

    def epoch(self, seed: int) -> Iterator[Dict[str, Any]]:
        batches = self._epoch_batches(seed)

        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = object()
        cancel = threading.Event()  # consumer broke out early
        errors: List[BaseException] = []

        def _put(item) -> bool:
            # bounded put that gives up when the consumer is gone — never
            # leaves the producer blocked holding device-resident batches
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                m = self.batch_multiple
                for b in batches:
                    if cancel.is_set():
                        return
                    if len(b) % m:
                        b = list(b) + [b[i % len(b)] for i in range(m - len(b) % m)]
                    if not _put(self.to_device(collate([self.dataset[i] for i in b]))):
                        return
            except BaseException as e:  # surfaced to the consumer below
                errors.append(e)
            finally:
                # the stop sentinel is enqueued on EVERY exit path — a
                # collate/to_device error must not deadlock the train loop
                _put(stop)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            cancel.set()
        if errors:
            raise errors[0]

    def __len__(self) -> int:
        return len(self._epoch_batches(self.seed))
