"""The one traffic generator: a pool of requests drawn from ``--seed`` and a
traffic file's parameters, and the order in which each client sends them.

Rewritten from ``lemas_tts_tpu_torch/scripts/latency_probe.py`` (commit
a2fd43e), whose four fixed texts and one sine reference gave one bucket and
no length distribution. The sizes of the pool are a design that is the same
for every seed: the kinds (chunk count x duration bucket) in their joint
shares, and inside each kind stratified grids of the position in the bucket,
the reference seconds, the text length and the second chunk's share, with
the sample rates and loudness ranges shared equally, paired by a generator
of their own that ``--seed`` does not touch. The seed gives each request of
the pool its sizes, orders the clients' walks and draws the words, the
voices, the loudness inside its range and the noise seeds: two seeds ask
for the same work in another order.

A traffic file gives:
- ``pool``: distinct requests; ``clients``: closed-loop clients, each
  walking the pool in an order of its own;
- ``ref_seconds`` [lo, hi], ``ref_rates`` (shared equally), ``ref_rms``
  (ranges shared equally; the normaliser's target lies between them);
- ``duration_buckets`` {bucket: share} of a request's longest chunk, and
  ``bucket_margin`` frames kept from each edge of a bucket;
- ``text_ids`` [lo, hi]: the byte length of reference plus chunk; the
  longest row of a request reaches ``lo`` and no row passes ``hi``, so every
  batch lands in one text bucket;
- ``chunks`` {count: share} (the single-stream entry), ``second_chunk``
  [lo, hi]: the generated frames of a second chunk as a share of the first's,
  ``max_chunk_bytes``: the chunker's budget (``chunk_text``'s 135).

Durations are worked out as the program's entry points estimate them: the
reference's frames per text byte, extrapolated to the chunk.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

HOP, RATE = 256, 24000
DURATION_BUCKETS = (256, 512, 768, 1024, 1536, 2048, 3072, 4096)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)
LETTERS = "etaoinshrdlucmfwypvbgkjqxz"
WEIGHTS = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8, 2.4, 2.4,
                    2.0, 2.0, 1.9, 1.0, 1.5, 2.0, 0.8, 0.2, 0.2, 0.1, 0.1])


def mix(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for ``tag`` under ``seed``."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()[:8], "big") >> 1


@dataclass
class Request:
    index: int
    ref_wav: np.ndarray
    ref_sr: int
    ref_text: str
    chunks: List[str]
    seed: int
    durations: List[int] = field(default_factory=list)  # frames of each chunk's row

    @property
    def bucket(self) -> int:
        return pick(max(self.durations))


def pick(n: int) -> int:
    return next((b for b in DURATION_BUCKETS if n <= b), DURATION_BUCKETS[-1])


def pick_batch(b: int) -> int:
    """The batch bucket a batch of ``b`` rows is padded to."""
    return next((x for x in BATCH_BUCKETS if b <= x), BATCH_BUCKETS[-1])


def ref_frames(n_samples: int, sr: int) -> int:
    """Frames of the reference at the model rate (the resampler gives
    ``ceil(24000 / sr * n)`` samples)."""
    n = n_samples if sr == RATE else -(-n_samples * RATE // sr)
    return n // HOP


def estimate(ref_len: int, ref_text: str, gen: str) -> int:
    est = ref_len + int(ref_len / max(1, len(ref_text)) * len(gen) / 1.0)
    n_ids = len((ref_text + gen).encode("utf-8"))
    return min(max(max(n_ids, ref_len + 1) + 1, est), DURATION_BUCKETS[-1])


def _counts(n: int, shares: Dict) -> List[int]:
    """``n`` split by ``shares`` (largest remainders, ties to the first)."""
    w = np.array([float(v) for v in shares.values()])
    exact = n * w / w.sum()
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def kinds(spec: dict) -> List[tuple]:
    """``[(chunk count, duration bucket, requests)]``: the pool split over
    the joint kinds, each share the product of the two files' shares."""
    chunks = spec.get("chunks") or {"1": 1}
    joint = {(int(c), int(b)): float(cw) * float(bw)
             for c, cw in chunks.items() for b, bw in spec["duration_buckets"].items()}
    return [(c, b, k) for (c, b), k in zip(joint, _counts(int(spec["pool"]), joint)) if k]


def sizes(spec: dict) -> List[dict]:
    """The pool's sizes, the same for every seed (see the module's head)."""
    fixed = np.random.default_rng(mix(0, "sizes"))
    out = []
    for c, b, k in kinds(spec):
        def grid():
            return fixed.permutation((np.arange(k) + 0.5) / k)

        def shared(values):  # taken in turn over the whole pool
            at = len(out) + np.arange(k)
            return fixed.permutation(np.asarray(values)[at % len(values)])

        pos = (np.arange(k) + 0.5) / k
        secs, length, second, level = grid(), grid(), grid(), grid()
        rates, ranges = shared(spec["ref_rates"]), shared(np.arange(len(spec["ref_rms"])))
        out += [{"chunks": c, "bucket": b, "pos": pos[j], "secs": secs[j], "len": length[j],
                 "second": second[j], "level": level[j], "rate": int(rates[j]),
                 "rms_range": int(ranges[j])} for j in range(k)]
    return out


def words(n: int, rng: np.random.Generator) -> str:
    """Lower-case words and spaces, exactly ``n`` characters, ending in '.'."""
    out = []
    while len(" ".join(out)) < n - 1:
        k = int(rng.integers(2, 9))
        out.append("".join(rng.choice(list(LETTERS), k, p=WEIGHTS / WEIGHTS.sum())))
    s = " ".join(out)[: n - 1].rstrip()
    while len(s) < n - 1:
        s += LETTERS[int(rng.integers(0, 8))]
    return s + "."


def voice(n: int, sr: int, target_rms: float, rng: np.random.Generator) -> np.ndarray:
    """A voiced signal: a gliding f0 with vibrato, eight harmonics, a
    syllable-rate envelope and breath noise, scaled to ``target_rms``."""
    t = np.arange(n) / sr
    f0 = rng.uniform(90.0, 240.0) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t)
                                     + 0.02 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(h * phase + rng.uniform(0, 2 * np.pi)) / h for h in range(1, 9))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t + rng.uniform(0, 6.3))
    x = x * env + 0.05 * rng.standard_normal(n)
    return (x * (target_rms / np.sqrt(np.mean(x * x)))).astype(np.float32)


def pool(spec: dict, seed: int) -> List[Request]:
    """The traffic file's request pool for ``seed``."""
    rng = np.random.default_rng(mix(seed, "traffic"))
    design = sizes(spec)
    P = len(design)
    lo_s, hi_s = spec["ref_seconds"]
    order = rng.permutation(P)
    margin = int(spec.get("bucket_margin", 16))
    lo_t, hi_t = spec["text_ids"]
    out = []
    for i in range(P):
        z = design[int(order[i])]
        sr = z["rate"]
        n = int(round((lo_s + (hi_s - lo_s) * z["secs"]) * sr))
        ref_len = ref_frames(n, sr)
        top = z["bucket"]
        below = max([b for b in DURATION_BUCKETS if b < top], default=0)
        d_first = below + margin + int(z["pos"] * (top - below - 2 * margin))
        targets = [d_first]
        if z["chunks"] == 2:
            a, b = spec["second_chunk"]
            share = a + (b - a) * z["second"]
            targets.append(ref_len + int(share * (d_first - ref_len)))
        # reference text: a row's ids (ref + chunk ~ n_ref * d / ref_len) inside
        # the text range for the longest row, and each chunk inside the budget
        r_lo = max(math.ceil(lo_t * ref_len / d_first), 8)
        r_hi = math.floor(hi_t * ref_len / d_first)
        if spec.get("max_chunk_bytes"):
            r_hi = min(r_hi, math.floor(spec["max_chunk_bytes"] * ref_len / (d_first - ref_len)))
        if r_hi < r_lo:
            raise ValueError(f"traffic {spec.get('name')}: no reference text length fits "
                             f"request {i} (ref {ref_len} frames, rows {targets})")
        n_ref = r_lo + int(z["len"] * (r_hi - r_lo))
        ref_text = words(n_ref, rng)
        chunks, durs = [], []
        for d in targets:
            L = max(1, round((d - ref_len) * n_ref / ref_len))
            chunk = words(L, rng)
            # nudge into the bucket and the text range, a byte at a time
            while pick(estimate(ref_len, ref_text, chunk)) > pick(d) and len(chunk) > 10:
                chunk = chunk[:-2] + "."
            while pick(estimate(ref_len, ref_text, chunk)) < pick(d):
                chunk = chunk[:-1] + "a."
            ids = len(ref_text) + len(chunk)
            if ids > hi_t or (not chunks and ids < lo_t) or len(chunk) < 10 or \
                    len(chunk) > spec.get("max_chunk_bytes", len(chunk)):
                raise ValueError(f"request {i}: a chunk of {len(chunk)} bytes, {ids} text ids "
                                 f"(range {spec['text_ids']})")
            chunks.append(chunk)
            durs.append(estimate(ref_len, ref_text, chunk))
        r_rng = spec["ref_rms"][z["rms_range"]]
        level = r_rng[0] + (r_rng[1] - r_rng[0]) * z["level"]
        out.append(Request(i, voice(n, sr, level, rng), sr, ref_text, chunks,
                           int(rng.integers(0, 2 ** 31 - 1)), durs))
    return out


def client_orders(spec: dict, seed: int, requests: List[Request],
                  passes: int = 8) -> List[np.ndarray]:
    """Each client's walk through the pool, ``passes`` times over. A pass is
    stratified: the requests of each kind (chunk count, duration bucket) are
    spread evenly along it, in an order from the seed, so that any stretch
    of a walk (the part a window reaches) holds every kind in its share and
    a seed changes the order, not the work."""
    rng = np.random.default_rng(mix(seed, "clients"))
    kinds: Dict[tuple, List[int]] = {}
    for r in requests:
        kinds.setdefault((len(r.chunks), r.bucket), []).append(r.index)
    out = []
    for _ in range(int(spec["clients"])):
        walk = []
        for _ in range(passes):
            keys, idx = [], []
            for members in kinds.values():
                members = rng.permutation(members)
                keys += list((np.arange(len(members)) + rng.random(len(members))) / len(members))
                idx += list(members)
            walk += [idx[i] for i in np.argsort(keys, kind="stable")]
        out.append(np.asarray(walk))
    return out
