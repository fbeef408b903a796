"""The traffic generator: deterministic per seed, the same sizes for every
seed, and requests that land where the mix says, as the port estimates."""

import collections
import json

import numpy as np
import pytest

from portbench import traffic as gen
from portbench.tests.tiny import REPO

MIXES = ["serve-c8-bf16", "single", "single-1chunk"]


def _spec(name):
    return json.loads((REPO / f"portbench/traffic/{name}.json").read_text())


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_pool(mix):
    a, b = gen.pool(_spec(mix), 2 ** 31 + 17), gen.pool(_spec(mix), 2 ** 31 + 17)
    for x, y in zip(a, b):
        assert (x.ref_text, x.chunks, x.seed, x.ref_sr) == (y.ref_text, y.chunks, y.seed, y.ref_sr)
        np.testing.assert_array_equal(x.ref_wav, y.ref_wav)
    assert [o.tolist() for o in gen.client_orders(_spec(mix), 5, a)] == \
        [o.tolist() for o in gen.client_orders(_spec(mix), 5, b)]


@pytest.mark.parametrize("mix", MIXES)
def test_every_stretch_of_a_walk_holds_each_kind_in_its_share(mix):
    spec = _spec(mix)
    p = gen.pool(spec, 11)
    kind = {r.index: (len(r.chunks), r.bucket) for r in p}
    share = collections.Counter(kind.values())
    for walk in gen.client_orders(spec, 11, p):
        for n in (20, 37, len(p) + 13):
            got = collections.Counter(kind[int(i)] for i in walk[:n])
            for k, c in share.items():
                assert abs(got[k] - n * c / len(p)) <= 2


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_share_sizes_not_content(mix):
    spec = _spec(mix)
    a, b = gen.pool(spec, 1), gen.pool(spec, 2 ** 40 + 3)

    def sizes(p):  # every request's work: rate, reference samples, rows and their frames
        return sorted((r.ref_sr, len(r.ref_wav), tuple(r.durations)) for r in p)

    assert sizes(a) == sizes(b)
    assert [r.ref_text for r in a] != [r.ref_text for r in b]


@pytest.mark.parametrize("mix", MIXES)
def test_buckets_and_shares(mix):
    spec = _spec(mix)
    p = gen.pool(spec, 99)
    counts = collections.Counter(r.bucket for r in p)
    total = sum(float(v) for v in spec["duration_buckets"].values())
    for b, share in spec["duration_buckets"].items():
        assert abs(counts[int(b)] - len(p) * float(share) / total) <= 1
    rates = collections.Counter(r.ref_sr for r in p)
    assert set(rates) == set(spec["ref_rates"]) and max(rates.values()) - min(rates.values()) <= 1
    lo, hi = spec["ref_seconds"]
    assert all(lo <= len(r.ref_wav) / r.ref_sr <= hi for r in p)
    lo_t, hi_t = spec["text_ids"]
    for r in p:
        ids = [len(r.ref_text) + len(c) for c in r.chunks]
        assert max(ids) >= lo_t and max(ids) <= hi_t  # one text bucket a batch
        assert all(len(c) <= spec.get("max_chunk_bytes", 10 ** 9) for c in r.chunks)
    if spec.get("chunks"):
        n = collections.Counter(len(r.chunks) for r in p)
        tot = sum(float(v) for v in spec["chunks"].values())
        for k, share in spec["chunks"].items():
            assert abs(n[int(k)] - len(p) * float(share) / tot) <= 1


@pytest.mark.parametrize("mix", MIXES)
def test_port_puts_requests_in_the_designed_bucket(mix):
    """The port's own estimate (``Synthesizer.estimate_bucket``, the
    engine's batching key) agrees with the generator's durations."""
    from lemas_tts_tpu_torch.config import MelSpecConfig, SamplerConfig
    from lemas_tts_tpu_torch.infer.pipeline import Synthesizer
    from lemas_tts_tpu_torch.utils.vocab import get_tokenizer

    synth = Synthesizer(None, None, get_tokenizer("", "byte"), MelSpecConfig(), device="cpu")
    for r in gen.pool(_spec(mix), 7):
        for c, d in zip(r.chunks, r.durations):
            assert synth.estimate_bucket(r.ref_wav, r.ref_sr, r.ref_text, c,
                                         SamplerConfig()) == gen.pick(d)
