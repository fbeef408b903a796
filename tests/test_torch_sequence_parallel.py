"""Sequence-parallel sampling of the port (``parallel/sequence.py``,
``ops/ring_attention.py``) on CPU process groups, against the
single-process port and the JAX package's ``sequence_parallel_sampler``.

The jobs (world 2, 4 and 8, gloo, torchrun's environment, one torch thread a
process, no JAX) run this file as a script, as ``tests/test_torch_parallel.py``
sets out; the test process runs the JAX sampler on conftest's 8-device CPU
mesh (2 data x 4 seq). Tiny DiT (width 64, 4 x 16 heads, depth 2, mel 12),
f32. Cases, on a ``(1, world)`` mesh unless named:

- ring attention against the port's plain ``sdpa`` (``[2, 4, 256, 8]``,
  partly masked keys), and with a batch row whose keys are all masked
  (finite, the mean of v as in ``sdpa``);
- the conv position embedding's halo chain against the global convs;
- the sampler at B 2, N 256 with and without the CFG cutoff, with the
  block cache (cutoff 0.8, blocks [1, 2) every 2, warm tail 1), with
  prosody text and ``step_cond`` on a prosody DiT, and on a ``(2, world /
  2)`` data x seq mesh (B 4, N 128);
- a bucket whose shards would be shorter than the conv halo raises.

Tolerance: 2e-5 atol against the single-process port, 2e-4 rtol (atol 2e-4
of the peak) against JAX; ring attention and the halo 2e-5 against the
plain functions.
"""

import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import close, finish_jobs, start_jobs

ARCH = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_dim=32, conv_layers=1)
MEL, VOCAB = 12, 30
WORLDS = (2, 4, 8)
CASES = ("cutoff_none", "cutoff_0.8", "block_cache", "prosody_step_cond", "data_seq")


def case_settings(case: str) -> dict:
    kw = dict(steps=4, cfg_strength=2.0, sway_sampling_coef=1.0)
    if case == "cutoff_0.8":
        kw["cfg_cutoff"] = 0.8
    elif case == "block_cache":
        kw.update(steps=6, cfg_cutoff=0.8, block_cache_range=(1, 2), block_cache_every=2,
                  block_cache_warm_tail=1)
    elif case == "data_seq":
        kw.update(steps=2, cfg_strength=1.0)
    return kw


def case_inputs(case: str) -> dict:
    """Seeded sampler inputs (``step_cond``/``prosody_text`` None unless the
    case has them)."""
    B, N = (4, 128) if case == "data_seq" else (2, 256)
    rng = np.random.default_rng(3)
    out = dict(cond=rng.standard_normal((B, N, MEL)).astype(np.float32),
               cond_mask=np.repeat(np.arange(N)[None] < N // 4, B, axis=0),
               text_ids=rng.integers(0, VOCAB, (B, 6)).astype(np.int32),
               duration=np.asarray([N, N - 80, N, N - 8][:B], np.int64),
               y0=rng.standard_normal((B, N, MEL)).astype(np.float32),
               step_cond=None, prosody_text=None)
    if case == "prosody_step_cond":
        out["step_cond"] = rng.standard_normal((B, N, MEL)).astype(np.float32)
        out["prosody_text"] = (0.1 * rng.standard_normal((B, 6, 512))).astype(np.float32)
    return out


def attn_inputs(all_masked_row: bool):
    rng = np.random.default_rng(1 if all_masked_row else 0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, 256, 8)).astype(np.float32))
               for _ in range(3))
    mask = rng.random((2, 256)) > 0.2
    if all_masked_row:
        mask[1] = False
    return q, k, v, torch.from_numpy(mask)


def conv_module():
    from lemas_tts_tpu_torch.models.modules import ConvPositionEmbedding

    torch.manual_seed(0)
    return ConvPositionEmbedding(32)


def conv_input():
    return torch.from_numpy(np.random.default_rng(2).standard_normal((2, 256, 32))
                            .astype(np.float32))


def port_dit(d: Path, prosody: bool):
    from lemas_tts_tpu_torch.config import DiTArch
    from lemas_tts_tpu_torch.models.dit import DiT

    dit = DiT(DiTArch(**ARCH), mel_dim=MEL, text_num_embeds=VOCAB, use_prosody_encoder=prosody)
    dit.load_state_dict(torch.load(d / f"dit{'_prosody' if prosody else ''}.pt"))
    return dit.eval()


def single(d: Path, case: str) -> np.ndarray:
    """The single-process port sampler on the case."""
    from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings, sample_mel, sway_time_grid

    st = SamplerSettings(**case_settings(case))
    x = {k: None if v is None else torch.from_numpy(v) for k, v in case_inputs(case).items()}
    return sample_mel(port_dit(d, case == "prosody_step_cond"), **x, settings=st,
                      time_grid=sway_time_grid(st.steps, st.sway_sampling_coef)).numpy()


# ------------------------------------------------------------ one rank
def rank_main(d: Path) -> None:
    import torch.distributed as dist

    from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings
    from lemas_tts_tpu_torch.ops.ring_attention import ring_attention
    from lemas_tts_tpu_torch.parallel.distributed import initialize
    from lemas_tts_tpu_torch.parallel.mesh import all_gather
    from lemas_tts_tpu_torch.parallel.sequence import SequenceParallelSampler, make_seq_mesh

    torch.set_num_threads(1)
    assert initialize(device_type="cpu")
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_seq_mesh(seq_parallel=world, device_type="cpu")
    group = mesh.get_group("seq")
    out = {}
    for masked in (False, True):
        q, k, v, mask = attn_inputs(masked)
        nl = q.shape[2] // world
        cols = slice(rank * nl, (rank + 1) * nl)
        got = ring_attention(q[:, :, cols], k[:, :, cols], v[:, :, cols], mask[:, cols], group)
        out[f"ring_{masked}"] = all_gather(got, group, 2).numpy()
    x = conv_input()
    nl = x.shape[1] // world
    local = conv_module()(x[:, rank * nl:(rank + 1) * nl], group)
    out["halo"] = all_gather(local, group, 1).detach().numpy()

    combo = make_seq_mesh(seq_parallel=world // 2, device_type="cpu")
    for case in CASES:
        sp = SequenceParallelSampler(port_dit(d, case == "prosody_step_cond"),
                                     SamplerSettings(**case_settings(case)),
                                     combo if case == "data_seq" else mesh)
        x = {k: None if v is None else torch.from_numpy(v) for k, v in case_inputs(case).items()}
        out[case] = sp(**x).numpy()
    # a bucket whose shards are shorter than the halo raises, on every process
    short = case_inputs("data_seq")
    sp = SequenceParallelSampler(port_dit(d, False), SamplerSettings(steps=1), mesh)
    try:
        sp(**{k: torch.from_numpy(v[:, :16 * world] if v.ndim > 1 and k != "text_ids" else v)
              for k, v in short.items() if v is not None})
        out["short_raised"] = np.asarray(False)
    except ValueError as e:
        out["short_raised"] = np.asarray("conv halo" in str(e))
    np.savez(d / f"out_{rank}.npz", **out)
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
    """Weights (from JAX params), the jobs' results by world size and the
    JAX sequence-parallel results by case."""
    import jax
    import jax.numpy as jnp

    from lemas_tts_tpu.cfm.sampler import SamplerSettings as JSettings
    from lemas_tts_tpu.config import DiTArch as JArch
    from lemas_tts_tpu.models.dit import DiT as JDiT
    from lemas_tts_tpu.parallel.sequence import make_seq_mesh, sequence_parallel_sampler
    from lemas_tts_tpu_torch import weights

    d = tmp_path_factory.mktemp("sp")
    jmodels = {}
    for prosody in (False, True):
        kw = dict(arch=JArch(**ARCH), mel_dim=MEL, text_num_embeds=VOCAB,
                  use_prosody_encoder=prosody)
        args = [jnp.zeros((1, 8, MEL)), jnp.zeros((1, 8, MEL)), jnp.zeros((1, 4), jnp.int32),
                jnp.zeros((1,))]
        extra = dict(prosody_text=jnp.zeros((1, 4, 512))) if prosody else {}
        params = jax.jit(lambda *a: JDiT(**kw).init(jax.random.key(0), *a, **extra))(*args)
        jmodels[prosody] = (JDiT(**kw, seq_axis="seq"), params)
        torch.save(weights.dit_state_from_jax(params), d / f"dit{'_prosody' if prosody else ''}.pt")
    jobs = start_jobs(__file__, WORLDS, d)

    jax_out = {}
    mesh = make_seq_mesh(8, seq_parallel=4)
    for case in CASES:
        model, params = jmodels[case == "prosody_step_cond"]
        x = case_inputs(case)
        fn = sequence_parallel_sampler(model, JSettings(**case_settings(case)), mesh)
        jax_out[case] = np.asarray(fn(
            params, *(jnp.asarray(x[k].astype(np.int32) if k == "duration" else x[k])
                      for k in ("cond", "cond_mask", "text_ids", "duration", "y0")),
            step_cond=None if x["step_cond"] is None else jnp.asarray(x["step_cond"]),
            prosody_text=None if x["prosody_text"] is None else jnp.asarray(x["prosody_text"])))
    return d, finish_jobs(*jobs), jax_out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("all_masked_row", [False, True])
def test_ring_attention_matches_sdpa(job, world, all_masked_row):
    from lemas_tts_tpu_torch.ops.attention import sdpa

    got = job[1][world][f"ring_{all_masked_row}"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, sdpa(*attn_inputs(all_masked_row)).numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_halo_conv_matches_global(job, world):
    with torch.no_grad():
        want = conv_module()(conv_input()).numpy()
    np.testing.assert_allclose(job[1][world]["halo"], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sequence_parallel_sampler_matches_single_and_jax(job, world, case):
    d, results, jax_out = job
    got = results[world][case]
    np.testing.assert_allclose(got, single(d, case), rtol=0, atol=2e-5)
    close(got, jax_out[case])
    x = case_inputs(case)
    keep = x["cond_mask"][..., None]  # kept frames pasted exactly
    np.testing.assert_array_equal(np.where(keep, got, 0), np.where(keep, x["cond"], 0))


def test_conditioning_and_cache_change_the_result(job):
    """The block cache, prosody and ``step_cond`` really act: each case
    differs from the plain sampler on the same inputs."""
    d, results, _ = job
    plain = {case: single(d, case) for case in ("cutoff_0.8", "cutoff_none")}
    assert np.abs(results[4]["block_cache"] - plain["cutoff_0.8"]).max() > 0
    assert np.abs(results[4]["prosody_step_cond"] - plain["cutoff_none"]).max() > 1e-3


@pytest.mark.parametrize("world", WORLDS)
def test_short_shards_raise(job, world):
    assert bool(job[1][world]["short_raised"])


def test_halo_and_bucket_checks_in_one_process():
    """Without a group: the halo pads zeros, a shard shorter than the halo
    raises, and a bucket below 30 frames a shard raises before sampling."""
    import torch.distributed as dist

    from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings
    from lemas_tts_tpu_torch.ops.ring_attention import halo_exchange
    from lemas_tts_tpu_torch.parallel.sequence import SequenceParallelSampler, make_seq_mesh

    x = torch.randn(1, 40, 3)
    h = halo_exchange(x, 30)
    assert h.shape == (1, 100, 3) and torch.equal(h[:, 30:70], x) and not h[:, :30].any()
    with pytest.raises(ValueError, match="shorter than conv halo"):
        halo_exchange(x[:, :20], 30)
    assert not dist.is_initialized()
    try:
        from lemas_tts_tpu_torch.config import DiTArch
        from lemas_tts_tpu_torch.models.dit import DiT

        sp = SequenceParallelSampler(DiT(DiTArch(**ARCH), mel_dim=MEL, text_num_embeds=VOCAB),
                                     SamplerSettings(steps=1),
                                     make_seq_mesh(seq_parallel=1, device_type="cpu"))
        with pytest.raises(ValueError, match="conv halo"):
            sp.check(1, 16)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            sp.check(1, 32)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(Path(sys.argv[1]))
