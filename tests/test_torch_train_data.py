"""The port's training data pipeline and checkpoints on the CPU:
``frame_budget_batches``, ``collate``, ``compute_prosody_conds`` and the
``DataLoader`` give exactly the JAX package's batches from the same seed
and samples; the loader surfaces a producer error and stops its thread when
the loop stops early. ``CheckpointManager`` keeps the reference save policy
(snapshots, pruning, ``model_last``, ``latest_step``, restore, a missing
checkpoint raising), and a ``Trainer`` saved in the middle of an
accumulation window resumes to the same parameters, bit for bit, as one that
never stopped.
"""

import random

import numpy as np
import pytest

import torch

from lemas_tts_tpu.cfm import data as jdata
from lemas_tts_tpu.config import TrainConfig as JTrainConfig
from lemas_tts_tpu_torch.cfm import data
from lemas_tts_tpu_torch.cfm.checkpoint import CheckpointManager, ema_update
from lemas_tts_tpu_torch.cfm.train import Trainer
from lemas_tts_tpu_torch.config import DiTArch, TrainConfig
from lemas_tts_tpu_torch.models.dit import DiT


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def samples(n, seed=0, d=4):
    rng = np.random.default_rng(seed)
    return [{"mel": rng.standard_normal((int(rng.integers(5, 700)), d)).astype(np.float32),
             "text": rng.integers(0, 30, int(rng.integers(1, 40))).astype(np.int32),
             "lang": int(rng.integers(0, 12))} for _ in range(n)]


@pytest.mark.parametrize("seed,budget,max_samples", [(None, 4000, 64), (0, 4000, 64),
                                                     (3, 40000, 8), (7, 1000, 64)])
def test_frame_budget_batches_match_jax(seed, budget, max_samples):
    lengths = [len(s["mel"]) for s in samples(300, 1)]
    got = data.frame_budget_batches(lengths, budget, max_samples, shuffle_seed=seed,
                                    bucket_size=16)
    want = jdata.frame_budget_batches(lengths, budget, max_samples, shuffle_seed=seed,
                                      bucket_size=16)
    assert got == want


def test_collate_matches_jax():
    ss = samples(5, 2) + [dict(mel=np.ones((5000, 4), np.float32), text=[1, 2], lang=3)]
    for buckets in ((16, 32), data.DURATION_BUCKETS):
        got, want = data.collate(ss, buckets), jdata.collate(ss, buckets)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


class _Encoder:
    """A stand-in prosody encoder: a fixed function of the audio segment
    (the port's returns a torch tensor, the JAX one an array)."""

    def __init__(self, as_tensor):
        self.as_tensor = as_tensor

    def embed(self, audio):
        e = np.full(512, float(np.sum(audio)), np.float32) + np.arange(512, dtype=np.float32)
        return torch.from_numpy(e) if self.as_tensor else e


def test_compute_prosody_conds_matches_jax():
    rng = np.random.default_rng(0)
    ss = [{"audio_16k": rng.standard_normal(1600).astype(np.float32),
           "prosody_idx": [(0, 3, 0, 12, 0, 800), (3, 6, 12, 24, 800, 2000)]},
          {"audio_16k": None, "prosody_idx": None}]
    got = data.compute_prosody_conds(ss, _Encoder(True), T_mel=32, T_text=8)
    want = jdata.compute_prosody_conds(ss, _Encoder(False), T_mel=32, T_text=8)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert np.abs(got["prosody_mel_cond"][0, :24]).max() > 0


@pytest.mark.parametrize("batch_type", ["frame", "sample"])
def test_dataloader_batches_match_jax(batch_type):
    ss = samples(60, 3)
    kw = dict(batch_size_per_gpu=3000 if batch_type == "frame" else 7, batch_size_type=batch_type)
    got_dl = data.DataLoader(ss, TrainConfig(**kw), seed=4)
    want_dl = jdata.DataLoader(ss, JTrainConfig(**kw), seed=4, to_device=lambda b: b)
    assert len(got_dl) == len(want_dl)
    got, want = list(got_dl.epoch(5)), list(want_dl.epoch(5))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for k in w:
            assert np.array_equal(g[k], w[k]), k


def test_dataloader_surfaces_producer_errors():
    good = dict(mel=np.zeros((8, 4), np.float32), text=[1, 2], lang=0)
    bad = dict(mel=np.zeros((8,), np.float32), text=[1], lang=0)  # wrong rank
    dl = data.DataLoader([good, bad], TrainConfig(batch_size_per_gpu=8))
    with pytest.raises(Exception):
        for _ in dl:
            pass


def test_dataloader_early_exit_stops_the_producer():
    import threading

    ds = [dict(mel=np.zeros((8, 4), np.float32), text=[1], lang=0) for _ in range(32)]
    dl = data.DataLoader(ds, TrainConfig(batch_size_per_gpu=8), prefetch=1)
    before = threading.active_count()
    it = dl.epoch(0)
    next(it)
    it.close()  # the loop walks away after one batch
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before


def test_ema_update_math():
    ema, p = [torch.ones(3)], [torch.zeros(3)]
    ema_update(ema, p, decay=0.9)
    np.testing.assert_allclose(ema[0].numpy(), 0.9)


ARCH = DiTArch(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, text_dim=16, conv_layers=1,
               dropout=0.0)


def _batch():
    rng = np.random.default_rng(0)
    return {"mel": torch.from_numpy(rng.standard_normal((2, 32, 8)).astype(np.float32)),
            "mel_lengths": torch.tensor([32, 27]),
            "text": torch.from_numpy(rng.integers(0, 20, (2, 6)).astype(np.int32)),
            "langs": torch.tensor([1, 4])}


def _trainer(**cfg):
    torch.manual_seed(0)
    dit = DiT(ARCH, mel_dim=8, text_num_embeds=20)
    tr = Trainer(dit, vocab_size=20, mel_dim=8, cfg=TrainConfig(**cfg))
    return tr, tr.init_state(0)


def _step(tr, state, i):
    g = torch.Generator().manual_seed(100 + i)
    return tr.train_step(state, _batch(), g, random.Random(i))


def test_checkpoint_policy_and_resume(tmp_path):
    tr, state = _trainer(save_per_updates=2, keep_last_n_checkpoints=2, last_per_updates=1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), tr.cfg)
    for i in range(6):
        state, _ = _step(tr, state, i)
        assert mgr.due(state.step)
        mgr.maybe_save(state.step, tr.checkpoint_payload(state))
    assert sorted(mgr.snapshots()) == [4, 6]  # 2, 4, 6 pruned to the last 2
    assert mgr.last_path.is_file() and mgr.latest_step() == 6
    restored = mgr.restore()
    assert restored["step"] == 6
    for k, v in state.params["dit"].state_dict().items():
        assert torch.equal(restored["model_state_dict"][f"transformer.{k}"], v)
    for k, v in state.ema_params.state_dict().items():
        assert torch.equal(restored["ema_model_state_dict"][f"ema_model.transformer.{k}"], v)
    assert mgr.restore(step=4)["step"] == 4
    with pytest.raises(FileNotFoundError):
        mgr.restore(step=2)
    # the file is a reference checkpoint: weights.load_reference_checkpoint reads it
    from lemas_tts_tpu_torch.weights import load_reference_checkpoint

    sd, _ = load_reference_checkpoint(str(mgr.last_path), use_ema=True)
    assert sd.keys() == state.ema_params.state_dict().keys()


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"), TrainConfig())
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    assert mgr.latest_step() is None


def test_keep_zero_writes_no_snapshot(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "k0"), TrainConfig(save_per_updates=1,
                                                              keep_last_n_checkpoints=0,
                                                              last_per_updates=0))
    assert not mgr.due(1)
    assert mgr.maybe_save(1, {"step": 1}) is None and mgr.snapshots() == {}


def test_accumulation_resumes_bit_for_bit(tmp_path):
    """Saved in the middle of an accumulation window (its gradients go with
    the file) and restored into a fresh ``init_state``, a trainer finishes
    the window to the same parameters, optimizer moments and EMA as one
    that never stopped; mid-window, nothing moved."""
    cfg = dict(grad_accumulation_steps=2, learning_rate=1e-3, num_warmup_updates=0)
    tr, state = _trainer(**cfg)
    p0 = {k: v.clone() for k, v in state.params.state_dict().items()}
    state, _ = _step(tr, state, 0)
    assert all(torch.equal(v, p0[k]) for k, v in state.params.state_dict().items())
    mgr = CheckpointManager(str(tmp_path / "ck"), tr.cfg)
    mgr.write(mgr.last_path, tr.checkpoint_payload(state))
    state, _ = _step(tr, state, 1)

    tr2, fresh = _trainer(**cfg)
    torch.manual_seed(9)  # a fresh state made from other weights
    for p in fresh.params.parameters():
        torch.nn.init.normal_(p)
    resumed = tr2.restore_state(fresh, mgr.restore())
    assert resumed.step == 1 and resumed.mini_step == 1
    resumed, _ = _step(tr2, resumed, 1)
    assert resumed.step == 2 and resumed.updates == 1
    for a, b in ((state.params, resumed.params), (state.ema_params, resumed.ema_params)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k
    assert not all(torch.equal(v, p0[k]) for k, v in state.params.state_dict().items())
    for sa, sb in zip(state.optimizer.state.values(), resumed.optimizer.state.values()):
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
