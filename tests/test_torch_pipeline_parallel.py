"""Pipeline parallelism of the port (``parallel/pipeline.py``) and the
multi-GPU flags of ``scripts/train.py`` on CPU process groups, against the
unmeshed port and the JAX package's ``pipeline_dit_forward``.

The jobs (gloo, torchrun's environment, one torch thread a process, no JAX)
run this file as a script, as ``tests/test_torch_parallel.py`` sets out:

- world 4, ``pipe`` 4 x ``data`` 1: ``pipeline_forward`` (2 and 8
  microbatches) against the unsharded forward; one ``PipelinedTrainer``
  step (4 microbatches) against the plain ``Trainer`` step;
- world 8, ``data`` 4 x ``pipe`` 2: two steps with ``fsdp`` against two
  without (2 microbatches); a step whose global batch has 4 samples at
  t > 0.5 but each data shard at most 1, so the CTC term fires only if its
  ``n_sel > 2`` gate is global (``tests/test_pipeline_parallel.py:211``);
- world 2: ``scripts/train.main --fsdp`` (``data`` 2) and
  ``--pipe_parallel 2`` for 2 steps, the saved state restored into a
  meshed trainer and gathered again bit for bit, then ``--resume`` to
  step 3.

The test process runs the JAX ``pipeline_dit_forward`` on conftest's CPU
devices (``pipe`` 4) with the same weights (``weights.py``). The DiT is
that of ``tests/test_pipeline_parallel.py:27`` (width 32, 2 x 16 heads,
depth 4, dropout 0), f32, lr 1e-3 with the JAX test's 2 warm-up updates
(the first has lr 0, the second 5e-4). Tolerances are the JAX test's: the
forward within 2e-5; the loss rtol 1e-5 and parameters and EMA rtol 5e-5 /
atol 5e-6 against the plain steps. AdamW's first moments, which after two
steps are ``0.09 g1 + 0.1 g2``, hold the gradients to rtol 1e-4 and 1e-5 of
each tensor's peak.
"""

import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import finish_jobs, start_jobs

ARCH = dict(dim=32, depth=4, heads=2, dim_head=16, ff_mult=2, text_dim=16, conv_layers=1,
            dropout=0.0)
D, V, B, T = 12, 30, 8, 32
WORLDS = (2, 4, 8)
STEP_BAR = dict(rtol=5e-5, atol=5e-6)
GATE_TIMES = [0.9, 0.1, 0.8, 0.2, 0.7, 0.3, 0.6, 0.4]  # one t > 0.5 in each shard of 2


class FixedDrops:
    def random(self):
        return 0.99


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"mel": rng.standard_normal((B, T, D)).astype(np.float32),
            "mel_lengths": rng.integers(T // 2, T + 1, B).astype(np.int32),
            "text": rng.integers(0, V, (B, 6)).astype(np.int32),
            "langs": rng.integers(0, 12, B).astype(np.int32)}


def forward_inputs(seed=1):
    rng = np.random.default_rng(seed)
    n = 16
    return {"x": rng.standard_normal((B, n, 8)).astype(np.float32),
            "cond": rng.standard_normal((B, n, 8)).astype(np.float32),
            "text": rng.integers(0, 20, (B, 5)).astype(np.int32),
            "time": rng.uniform(0, 1, B).astype(np.float32),
            "mask": np.arange(n)[None] < rng.integers(5, n + 1, B)[:, None]}


def port_dit(d: Path, mel=D, vocab=V):
    from lemas_tts_tpu_torch.config import DiTArch
    from lemas_tts_tpu_torch.models.dit import DiT

    dit = DiT(DiTArch(**ARCH), mel_dim=mel, text_num_embeds=vocab)
    if mel == 8:
        dit.load_state_dict(torch.load(d / "fwd_dit.pt"))
    else:
        dit.load_state_dict(torch.load(d / "step_dit.pt"))
    return dit


def trainer(d: Path, mesh=None, **kw):
    from lemas_tts_tpu_torch.cfm.train import Trainer
    from lemas_tts_tpu_torch.config import TrainConfig
    from lemas_tts_tpu_torch.parallel.pipeline import PipelinedTrainer

    cfg = TrainConfig(learning_rate=1e-3, num_warmup_updates=2, audio_drop_prob=0.0,
                      text_drop_prob=0.0)
    cls = Trainer if mesh is None else PipelinedTrainer
    return cls(port_dit(d), vocab_size=V, mel_dim=D, cfg=cfg, use_ctc=True, mesh=mesh, **kw)


def steps(d: Path, n: int, mesh=None, times=None, **kw) -> dict:
    """``n`` steps from the saved weights (seed-0 heads) with draws from
    seeded generators (``times``: the time draws pinned): the losses and
    the gathered payload as npz arrays."""
    tr = trainer(d, mesh, **kw)
    state = tr.init_state(0)
    b = {k: torch.from_numpy(v) for k, v in np.load(d / "batch.npz").items()}
    out = {}
    for i in range(n):
        draws = None if times is None else {"time": torch.tensor(times)}
        state, m = tr.train_step(state, b, torch.Generator().manual_seed(20 + i), FixedDrops(),
                                 draws)
        for k in ("loss", "flow_loss", "ctc_loss"):
            out[f"{k}/{i}"] = np.float64(m[k])
    p = tr.checkpoint_payload(state)
    for part in ("model_state_dict", "ema_model_state_dict"):
        for k, v in p[part].items():
            out[f"{part}/{k}"] = v.numpy()
    for i, st in p["optimizer_state_dict"]["state"].items():
        out[f"exp_avg/{i}"] = st["exp_avg"].numpy()
    if mesh is not None and kw.get("fsdp"):
        pl = tr.placement
        out["split_both"] = np.int64(sum(n in pl.stages and n in pl.fsdp for n in pl.names))
    return out


def cli_case(d: Path, tag: str, flags: list) -> dict:
    """``scripts/train.main`` with ``flags`` for 2 steps in the job, the
    saved state restored into a meshed trainer built as the CLI builds it
    and gathered again (equal bit for bit), then ``--resume`` to step 3."""
    import torch.distributed as dist

    from lemas_tts_tpu_torch.api import seeded_init
    from lemas_tts_tpu_torch.cfm.checkpoint import CheckpointManager
    from lemas_tts_tpu_torch.cfm.train import Trainer
    from lemas_tts_tpu_torch.config import TrainConfig, load_model_config
    from lemas_tts_tpu_torch.models.dit import DiT
    from lemas_tts_tpu_torch.parallel.pipeline import PipelinedTrainer
    from lemas_tts_tpu_torch.scripts import train

    ck, log = d / f"ck_{tag}", d / f"log_{tag}.jsonl"
    common = ["--synthetic", "12", "--tiny", "--device", "cpu", "--ckpt_dir", str(ck),
              "--log_every", "1", "--log_file", str(log), *flags]
    assert train.main([*common, "--steps", "2"]) == 0
    args = train.build_parser().parse_args(common)
    cfg = load_model_config(args.config)
    arch, mel = train.resolve_arch(args, cfg)
    mesh = train.job_mesh(args, torch.device("cpu"))
    vocab = train.resolve_vocab("")
    dit = seeded_init(lambda: DiT(arch, mel_dim=mel, text_num_embeds=vocab.size), 1)
    kw = dict(vocab_size=vocab.size, mel_dim=mel, cfg=TrainConfig(), use_ctc=cfg.use_ctc_loss,
              mesh=mesh, fsdp=args.fsdp)
    tr = PipelinedTrainer(dit, **kw) if args.pipe_parallel > 1 else Trainer(dit, **kw)
    saved = CheckpointManager(str(ck)).restore()
    again = tr.checkpoint_payload(tr.restore_state(tr.init_state(0), saved))
    same = all(torch.equal(again[part][k], v) for part in ("model_state_dict",
                                                             "ema_model_state_dict")
               for k, v in saved[part].items())
    same &= all(torch.equal(again["optimizer_state_dict"]["state"][i][k], v)
                for i, st in saved["optimizer_state_dict"]["state"].items()
                for k, v in st.items())
    same &= again["step"] == saved["step"] == 2
    dist.barrier()
    assert train.main([*common, "--steps", "3", "--resume"]) == 0
    return {f"{tag}/restored_bit_for_bit": np.bool_(same)}


# ------------------------------------------------------------ one rank
def rank_main(d: Path) -> None:
    import torch.distributed as dist

    from lemas_tts_tpu_torch.parallel.distributed import initialize
    from lemas_tts_tpu_torch.parallel.pipeline import make_pipe_mesh, pipeline_forward

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    assert initialize(device_type="cpu")
    world = dist.get_world_size()
    out = {}
    if world == 4:
        mesh = make_pipe_mesh(pipe_parallel=4, device_type="cpu")
        dit = port_dit(d, mel=8, vocab=20).eval()
        x = {k: torch.from_numpy(v) for k, v in np.load(d / "fwd.npz").items()}
        for m in (2, 8):
            out[f"fwd/{m}"] = pipeline_forward(dit, mesh, m)(
                x["x"], x["cond"], x["text"], x["time"], x["mask"]).numpy()
        out.update({f"pipe4/{k}": v for k, v in
                    steps(d, 2, mesh, num_microbatches=4).items()})
    elif world == 8:
        mesh = make_pipe_mesh(pipe_parallel=2, device_type="cpu")
        for tag, kw in (("plain", {}), ("fsdp", dict(fsdp=True, fsdp_min_size=128))):
            out.update({f"d4p2_{tag}/{k}": v for k, v in
                        steps(d, 2, mesh, num_microbatches=2, **kw).items()})
        out.update({f"gate/{k}": v for k, v in
                    steps(d, 1, mesh, GATE_TIMES, num_microbatches=2).items()})
    else:
        out.update(cli_case(d, "fsdp", ["--fsdp"]))
        out.update(cli_case(d, "pipe", ["--pipe_parallel", "2"]))
    np.savez(d / f"out_{dist.get_rank()}.npz", **out)
    dist.destroy_process_group()


# ------------------------------------------------------------ the test process
@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Weights (from JAX params), the jobs' results by world size, the
    unmeshed port's steps and forwards, and the JAX pipelined forward."""
    import jax
    import jax.numpy as jnp

    from lemas_tts_tpu.config import DiTArch as JArch
    from lemas_tts_tpu.models.dit import DiT as JDiT
    from lemas_tts_tpu.parallel.pipeline import make_pipe_mesh, pipeline_dit_forward
    from lemas_tts_tpu_torch import weights

    d = tmp_path_factory.mktemp("pipe")
    np.savez(d / "batch.npz", **make_batch())
    fwd = forward_inputs()
    np.savez(d / "fwd.npz", **fwd)
    jfwd = JDiT(arch=JArch(**ARCH), mel_dim=8, text_num_embeds=20)
    args = [jnp.asarray(fwd[k]) for k in ("x", "cond", "text", "time", "mask")]
    fparams = jax.jit(jfwd.init)(jax.random.key(0), *args)
    torch.save(weights.dit_state_from_jax(fparams), d / "fwd_dit.pt")
    jstep = JDiT(arch=JArch(**ARCH), mel_dim=D, text_num_embeds=V)
    z = jnp.zeros((1, 16, D))
    sparams = jax.jit(jstep.init)(jax.random.key(1), z, z, jnp.zeros((1, 4), jnp.int32),
                                  jnp.zeros((1,)))
    torch.save(weights.dit_state_from_jax(sparams), d / "step_dit.pt")
    jobs = start_jobs(__file__, WORLDS, d)

    with torch.no_grad():
        x = {k: torch.from_numpy(v) for k, v in fwd.items()}
        single = {"fwd": port_dit(d, mel=8, vocab=20).eval()(x["x"], x["cond"], x["text"],
                                                              x["time"], x["mask"]).numpy()}
    single["steps"] = steps(d, 2)
    single["gate"] = steps(d, 1, times=GATE_TIMES)
    jax_fwd = np.asarray(pipeline_dit_forward(
        jfwd, make_pipe_mesh(4, pipe_parallel=4, devices=jax.devices()[:4]))(fparams, *args))
    return d, finish_jobs(*jobs), single, jax_fwd


def part(got: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in got.items() if k.startswith(prefix)}


def test_pipeline_forward_matches_unsharded_and_jax(job):
    """``pipeline_forward`` on ``pipe`` 4 (2 microbatches, and 8: more
    than the stages) equals the unsharded forward and the JAX
    ``pipeline_dit_forward`` on its ``pipe`` 4 mesh."""
    _, ranks, single, jax_fwd = job
    for m in (2, 8):
        got = ranks[4][f"fwd/{m}"]
        np.testing.assert_allclose(got, single["fwd"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, jax_fwd, rtol=2e-5, atol=2e-5)


def assert_steps(got: dict, want: dict) -> None:
    """Two steps' losses, parameters, EMA and first moments."""
    for k in ("loss/0", "loss/1", "flow_loss/0", "flow_loss/1"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in want.items():
        if k.startswith(("model_state_dict/", "ema_model_state_dict/")):
            np.testing.assert_allclose(got[k], v, err_msg=k, **STEP_BAR)
        elif k.startswith("exp_avg/"):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5 * np.abs(v).max(),
                                       err_msg=k)


def test_pipelined_step_matches_plain_step(job):
    """Two ``PipelinedTrainer`` steps on ``pipe`` 4 x ``data`` 1 (4
    microbatches) equal the plain ``Trainer``'s: the loss, the gradients of
    every stage's blocks and of the replicated embeddings, heads and head,
    the parameters and the EMA."""
    _, ranks, single, _ = job
    assert_steps(part(ranks[4], "pipe4/"), single["steps"])


def test_pipelined_fsdp_matches_pipelined(job):
    """On ``data`` 4 x ``pipe`` 2, two ``fsdp`` steps equal two without it
    (the JAX test's bars), block leaves are split over both axes, and both
    equal the plain trainer's two steps."""
    _, ranks, single, _ = job
    got = ranks[8]
    plain, fsdp = part(got, "d4p2_plain/"), part(got, "d4p2_fsdp/")
    assert fsdp.pop("split_both") > 0
    assert set(plain) == set(fsdp)
    for k, v in plain.items():
        np.testing.assert_allclose(fsdp[k], v, err_msg=k, **STEP_BAR)
    assert_steps(plain, single["steps"])


def test_ctc_gate_is_global_across_data_shards(job):
    """At ``data`` 4 each shard holds 2 samples and here at most one with
    t > 0.5; the global batch has 4, so the reference's ``n_sel > 2`` gate
    fires only because it is evaluated over the global batch: the CTC term
    is on, and equals the unmeshed step's."""
    _, ranks, single, _ = job
    got, want = ranks[8]["gate/ctc_loss/0"], single["gate"]["ctc_loss/0"]
    assert want > 0 and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(ranks[8]["gate/loss/0"], single["gate"]["loss/0"], rtol=1e-5)


@pytest.mark.parametrize("tag", ["fsdp", "pipe"])
def test_train_cli_in_a_job_resumes_bit_for_bit(job, tag):
    """``scripts/train.main --fsdp`` (``data`` 2) and ``--pipe_parallel
    2`` in a job of 2: process 0 logs and writes; the saved state, restored
    into a meshed trainer and gathered again, is the file bit for bit;
    ``--resume`` carries on from step 2 to 3."""
    d, ranks, _, _ = job
    assert bool(ranks[2][f"{tag}/restored_bit_for_bit"])
    events = [json.loads(line) for line in (d / "world2" / f"log_{tag}.jsonl").read_text()
              .splitlines()]
    steps_logged = [e["step"] for e in events if e["event"] == "train_step"]
    assert steps_logged == [1, 2, 3], steps_logged
    assert any(e["event"] == "resumed" and e["step"] == 2 for e in events)
    assert all(np.isfinite(e["loss"]) for e in events if e["event"] == "train_step")


def test_pipe_stages_match_jax_and_refusals():
    """``pipe_param_stages`` is ``pipe_param_pspecs`` (the stacked depth
    axis over ``pipe``: block i on stage ``i // (depth / pipe)``, the rest
    on every stage); a depth the stages do not divide, a ``model`` axis and
    gradient accumulation are refused, as in JAX."""
    import jax
    import jax.numpy as jnp
    import torch.distributed as dist
    from jax.sharding import PartitionSpec as P

    from lemas_tts_tpu.config import DiTArch as JArch
    from lemas_tts_tpu.models.dit import DiT as JDiT
    from lemas_tts_tpu.parallel.pipeline import pipe_param_pspecs
    from lemas_tts_tpu_torch.config import DiTArch, TrainConfig
    from lemas_tts_tpu_torch.models.dit import DiT
    from lemas_tts_tpu_torch.parallel.mesh import make_mesh
    from lemas_tts_tpu_torch.parallel.pipeline import (PipelinedTrainer, pipe_param_stages,
                                                       stage_blocks)

    z = jnp.zeros((1, 16, D))
    params = jax.eval_shape(lambda: JDiT(arch=JArch(**ARCH), mel_dim=D, text_num_embeds=V).init(
        jax.random.key(0), z, z, jnp.zeros((1, 4), jnp.int32), jnp.zeros((1,))))
    specs = pipe_param_pspecs(params)
    n_pipe = sum("pipe" in tuple(s) for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, P)))
    dit = DiT(DiTArch(**ARCH), mel_dim=D, text_num_embeds=V)
    stages = pipe_param_stages(dit, 2)
    per_block = len(list(dit.transformer_blocks[0].parameters()))
    assert n_pipe == per_block and len(stages) == per_block * ARCH["depth"]
    assert all(s == int(n.split(".")[1]) // 2 for n, s in stages.items())
    with pytest.raises(ValueError, match="does not split"):
        stage_blocks(22, 4, 0)
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="not with a 'model' axis"):
            PipelinedTrainer(dit, vocab_size=V, mel_dim=D, mesh=mesh)
        with pytest.raises(ValueError, match="accumulation"):
            PipelinedTrainer(dit, vocab_size=V, mel_dim=D, mesh=mesh,
                             cfg=TrainConfig(grad_accumulation_steps=2))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(Path(sys.argv[1]))
