"""A whole run of a tiny cell on the CPU (the harness's look for a card
skipped), judged by the committed limits of ``multilingual.single-1chunk``,
first sound, then with the timed path broken underneath: each fault a
serving cell can have must turn ``correct`` false. (The exchange between
chips has no counterpart: every cell runs on one chip.)"""

import json

import numpy as np
import pytest
import torch

from portbench.run import run_cell
from portbench.tests import tiny


def _run(root, seed=2 ** 31 + 9):
    torch.set_num_threads(4)
    return run_cell(root, tiny.CELL, seed, 3.0, False, device="cpu")


def fault_answer_altered(monkeypatch):
    """The vocoder's wave altered where it is produced: its level 10 % off,
    its length and its mel as they should be."""
    from lemas_tts_tpu_torch.models.vocos import Vocos

    decode = Vocos.decode
    monkeypatch.setattr(Vocos, "decode", lambda self, mel, mask=None: decode(self, mel, mask) * 1.1)


def fault_step_unchanged(monkeypatch):
    """The sampler's last Euler step returns its state unchanged."""
    from lemas_tts_tpu_torch.infer import pipeline

    sample = pipeline.sample_mel

    def broken(model, *, time_grid, **kw):
        g = np.array(time_grid, copy=True)
        g[-2] = g[-1]
        return sample(model, time_grid=g, **kw)

    monkeypatch.setattr(pipeline, "sample_mel", broken)


def fault_half_batch(monkeypatch):
    """Half of each batch left out: its rows answered with the first row's."""
    from lemas_tts_tpu_torch.infer.pipeline import Synthesizer

    real = Synthesizer.synthesize_requests

    def broken(self, requests, cfg):
        keep = max(1, len(requests) // 2)
        out = real(self, requests[:keep], cfg)
        return out + [out[0]] * (len(requests) - keep)

    monkeypatch.setattr(Synthesizer, "synthesize_requests", broken)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    limits = json.loads((tiny.REPO / "portbench/limits/multilingual.single-1chunk.json").read_text())
    return tiny.make_root(tmp_path_factory.mktemp("faults"), limits=limits)


def test_sound_run_is_correct(root):
    r = _run(root)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", [fault_answer_altered, fault_step_unchanged, fault_half_batch])
def test_fault_is_caught(root, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(root)
    assert not r["correct"], r["checks"]
