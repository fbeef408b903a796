"""Data-parallel serving of the port (``parallel/mesh.py``, ``TTS(mesh=)``,
UVR5's ``mesh``) on CPU process groups, against the single-process port and
the JAX package's mesh results.

Each multi-rank case runs this file as a script in ``world`` processes of
one gloo job, with torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``
on a free port, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), one torch thread
each and no JAX. The test process makes the inputs and weights (carried
over from JAX params), writes them to a temporary directory and runs the
JAX package's mesh functions on conftest's 8-device CPU mesh; every rank
writes its whole result to ``out_<rank>.npz``, and every rank's result must
be the same. Tolerance, f32: 2e-5 atol against the single-process port
(the same products on other batch splits), 2e-4 rtol (and atol 2e-4 of the
peak) against JAX.

- the data-parallel sampler on the fused route's plain versions (K1-K3:
  width 128, 2 x 64 heads), world 2 and 4, B 8;
- ``TTS(mesh=make_mesh())``: ``infer`` against the unmeshed ``TTS``,
  ``synthesize_chunks`` on pinned noise against JAX ``TTS(mesh=)``,
  ``synthesize_requests`` of 3 requests (padded to the mesh) and
  ``TTS(mesh=make_seq_mesh())``'s ``infer``;
- UVR5: ``MDXSeparator(mesh=)`` demix against the plain demix and JAX
  ``MDXSeparator(mesh=)``, ``VRSeparator(mesh=)`` against the plain
  separator (the JAX separator takes no mesh);
- ``initialize()`` without a job returns False.
"""

import os
import socket
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "tests" / "data" / "tiny.yaml")
ARCH_FUSED = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1)
MEL, VOCAB = 12, 30
MDX_SIZES = dict(dim_c=4, dim_f=24, dim_t=16, n_fft=64, hop=16, num_blocks=5, l=2, g=4, k=3,
                 bn=2, bias=False)
VR_KW = dict(n_fft=64, hop=16, nout=8, nout_lstm=8, window_size=128, offset=16, batch_size=2)
WORLDS = (2, 4)
REF_TEXT, GEN_TEXT = "hello there. ", "general kenobi. you are a bold one."


# ------------------------------------------------------------ the launcher
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(world: int, rank: int, port: int) -> dict:
    """torchrun's environment for one process of a local job."""
    return dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank),
                LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")


def start_ranks(script, world: int, *args) -> list:
    """``world`` processes of ``script`` (``python script *args``) in one job."""
    port = free_port()
    return [subprocess.Popen([sys.executable, str(script), *map(str, args)],
                             env=rank_env(world, r, port), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for r in range(world)]


def wait_ranks(procs: list, timeout: float = 240.0) -> list:
    """Each process's (stdout, stderr); all are killed and the test fails if
    one fails or the job outlives ``timeout``."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
        if any(p.poll() not in (None, 0) for p in procs):
            break  # one rank failed: the others may wait on it for ever
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
    outs = [p.communicate() for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}\n{err[-4000:]}"
    return outs


def start_jobs(script, worlds, d: Path) -> tuple:
    """One job of ``script`` per world size, all at once, each as ``python
    script <d>/world<N>`` (a directory that sees ``d``'s files)."""
    dirs, procs = {}, []
    for world in worlds:
        dirs[world] = wd = d / f"world{world}"
        wd.mkdir()
        for f in d.iterdir():
            if f.is_file():
                (wd / f.name).symlink_to(f)
        procs += start_ranks(script, world, wd)
    return dirs, procs


def finish_jobs(dirs: dict, procs: list, timeout: float = 240.0) -> dict:
    """Every job's ``out_<rank>.npz`` by world size, each rank's result
    held equal to rank 0's."""
    wait_ranks(procs, timeout)
    results = {}
    for world, wd in dirs.items():
        outs = [dict(np.load(wd / f"out_{r}.npz")) for r in range(world)]
        for r, o in enumerate(outs[1:], 1):
            for k, v in outs[0].items():
                np.testing.assert_array_equal(o[k], v, err_msg=f"world {world}: rank {r} "
                                                               f"differs from rank 0: {k}")
        results[world] = outs[0]
    return results


def close(got, want, rtol=2e-4, atol=2e-4):
    """Within ``rtol`` and ``atol`` of ``want``'s peak."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1e-30, np.abs(want).max()))


# ------------------------------------------------------------ shared inputs
def sampler_inputs(B=8, N=128, seed=7):
    rng = np.random.default_rng(seed)
    cond = np.zeros((B, N, MEL), np.float32)
    cond[:, :16] = rng.standard_normal((B, 16, MEL))
    cond_mask = np.zeros((B, N), bool)
    cond_mask[:, :16] = True
    text = rng.integers(0, VOCAB, (B, 6)).astype(np.int32)
    duration = rng.integers(N // 2, N + 1, B).astype(np.int64)
    y0 = rng.standard_normal((B, N, MEL)).astype(np.float32)
    return dict(cond=cond, cond_mask=cond_mask, text_ids=text, duration=duration, y0=y0)


def ref_wave(n=12000, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    return (0.2 * np.sin(2 * np.pi * 180 * np.arange(n) / sr)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def stereo(n, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000
    return (np.stack([0.3 * np.sin(2 * np.pi * 440 * t), 0.3 * np.sin(2 * np.pi * 660 * t)])
            + 0.05 * rng.standard_normal((2, n))).astype(np.float32)


def settings():
    from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings

    return SamplerSettings(steps=2, cfg_strength=1.0, sway_sampling_coef=1.0)


def tts_cfg():
    from lemas_tts_tpu_torch.config import SamplerConfig

    return SamplerConfig(nfe_steps=4, cfg_strength=2.0, sway_sampling_coef=1.0, cfg_cutoff=0.5,
                         max_duration=512)


def fused_dit(d: Path):
    from lemas_tts_tpu_torch.config import DiTArch
    from lemas_tts_tpu_torch.models.dit import DiT

    dit = DiT(DiTArch(**ARCH_FUSED), mel_dim=MEL, text_num_embeds=VOCAB)
    dit.load_state_dict(torch.load(d / "fused_dit.pt"))
    return dit.eval()


def port_tts(d: Path, mesh=None):
    from lemas_tts_tpu_torch import TTS

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = TTS(model=TINY, vocab_file=str(d / "vocab.txt"), frontend=None, device="cpu",
                  mesh=mesh)
    tts.dit.load_state_dict(torch.load(d / "tts_dit.pt"))
    tts.vocoder.load_state_dict(torch.load(d / "tts_vocos.pt"))
    return tts


def mdx(d: Path, mesh=None):
    from lemas_tts_tpu_torch.uvr5 import inference, mdxnet

    return inference.MDXSeparator(mdxnet.MDXConfig(**MDX_SIZES), torch.load(d / "mdx.pt"),
                                  batch_size=4, device="cpu", mesh=mesh)


def vr(mesh=None):
    from lemas_tts_tpu_torch.uvr5.vr_network import VRSeparator

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return VRSeparator(**VR_KW, device="cpu", generator=torch.Generator().manual_seed(1),
                           mesh=mesh)


def requests():
    return [dict(ref_wav=ref_wave(n, seed=i), ref_sr=16000, ref_units=REF_TEXT,
                 gen_units=GEN_TEXT[: 12 + 9 * i], seed=11 + i)
            for i, n in enumerate((9000, 12000, 15000))]


# ------------------------------------------------------------ one rank
def rank_main(d: Path) -> None:
    """One process of the job: every case on the job's meshes, the whole
    results to ``out_<rank>.npz``."""
    import torch.distributed as dist

    from lemas_tts_tpu_torch.cfm.sampler import sample_mel, sway_time_grid
    from lemas_tts_tpu_torch.parallel.distributed import initialize
    from lemas_tts_tpu_torch.parallel.mesh import data_parallel, make_mesh
    from lemas_tts_tpu_torch.parallel.sequence import make_seq_mesh

    torch.set_num_threads(1)
    assert initialize(device_type="cpu")
    world = dist.get_world_size()
    mesh = make_mesh(device_type="cpu")
    out = {}

    dit, st = fused_dit(d), settings()
    grid = sway_time_grid(st.steps, st.sway_sampling_coef)
    dp = data_parallel(lambda c, cm, t, du, y, *rest: sample_mel(
        dit, cond=c, cond_mask=cm, text_ids=t, duration=du, y0=y, time_grid=grid, settings=st),
        mesh)
    x = {k: torch.from_numpy(v) for k, v in sampler_inputs().items()}
    out["dp"] = dp(x["cond"], x["cond_mask"], x["text_ids"], x["duration"], x["y0"]).numpy()

    tts = port_tts(d, mesh)
    assert tts.synth._pick_batch(3) % world == 0
    wave, sr, mel = tts.infer((ref_wave(), 16000), REF_TEXT, GEN_TEXT, show_info=lambda *_: None,
                              nfe_step=4, seed=5)
    out["infer_wave"], out["infer_mel"] = wave, mel
    noise = np.load(d / "noise.npy")
    w, _, m = tts.synth.synthesize_chunks(ref_wave(), 16000, REF_TEXT, [GEN_TEXT], cfg=tts_cfg(),
                                          seed=3, noise_override=noise)
    out["chunks_wave"], out["chunks_mel"] = w, m
    for i, (w, _, m) in enumerate(tts.synth.synthesize_requests(requests(), cfg=tts_cfg())):
        out[f"req{i}_wave"], out[f"req{i}_mel"] = w, m
    seq_tts = port_tts(d, make_seq_mesh(seq_parallel=2, device_type="cpu"))
    wave, _, mel = seq_tts.infer((ref_wave(), 16000), REF_TEXT, GEN_TEXT,
                                 show_info=lambda *_: None, nfe_step=4, seed=5)
    out["seq_infer_wave"], out["seq_infer_mel"] = wave, mel

    out["mdx"] = mdx(d, mesh).demix({0: stereo(4000)})
    out["vr"] = vr(mesh).separate_full(stereo(4000), 8000)[0]
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
    """Inputs, weights (from JAX params), the JAX mesh results and the
    jobs' results by world size."""
    import jax
    import jax.numpy as jnp

    from lemas_tts_tpu.cfm.sampler import SamplerSettings as JSettings
    from lemas_tts_tpu.cfm.sampler import make_sampler
    from lemas_tts_tpu.config import DiTArch as JArch
    from lemas_tts_tpu.config import SamplerConfig as JSamplerConfig
    from lemas_tts_tpu.config import load_model_config
    from lemas_tts_tpu.infer.pipeline import Synthesizer as JSynthesizer
    from lemas_tts_tpu.models.dit import DiT as JDiT
    from lemas_tts_tpu.models.vocos import Vocos as JVocos
    from lemas_tts_tpu.parallel.mesh import data_parallel_sampler, make_mesh
    from lemas_tts_tpu.utils.vocab import get_tokenizer
    from lemas_tts_tpu.uvr5 import inference as jinf
    from lemas_tts_tpu.uvr5 import mdxnet as jmdx
    from lemas_tts_tpu_torch import weights

    def init(module, *shapes, dtypes=None):  # jitted: ~4x faster than eager flax init
        args = [jnp.zeros(s, t) for s, t in zip(shapes, dtypes or [jnp.float32] * len(shapes))]
        return jax.jit(module.init)(jax.random.key(2), *args)

    d = tmp_path_factory.mktemp("dp")
    # weights first (the jobs read them), the jobs started, then the JAX side
    jdit = JDiT(arch=JArch(**ARCH_FUSED), mel_dim=MEL, text_num_embeds=VOCAB, attn_backend="xla")
    params = init(jdit, (1, 128, MEL), (1, 128, MEL), (1, 6), (1,),
                  dtypes=[jnp.float32, jnp.float32, jnp.int32, jnp.float32])
    torch.save(weights.dit_state_from_jax(params), d / "fused_dit.pt")
    (d / "vocab.txt").write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz")
                                           + [",", ".", "!"]) + "\n")
    mcfg = load_model_config(TINY)  # the tiny TTS's models, as the JAX TTS builds them
    mel_cfg, vocab = mcfg.mel_spec, get_tokenizer(str(d / "vocab.txt"), "custom")
    tdit = JDiT(arch=mcfg.arch, mel_dim=mel_cfg.n_mel_channels, text_num_embeds=vocab.size)
    tparams = init(tdit, (1, 32, 20), (1, 32, 20), (1, 8), (1,),
                   dtypes=[jnp.float32, jnp.float32, jnp.int32, jnp.float32])
    voc = JVocos(input_channels=mel_cfg.n_mel_channels, n_fft=mel_cfg.n_fft,
                 hop_length=mel_cfg.hop_length)
    vparams = init(voc, (1, mel_cfg.n_mel_channels, 16))
    torch.save(weights.dit_state_from_jax(tparams), d / "tts_dit.pt")
    torch.save(weights.vocos_state_from_jax(vparams), d / "tts_vocos.pt")
    noise = np.random.default_rng(1).standard_normal((512, 20)).astype(np.float32)
    np.save(d / "noise.npy", noise)
    jcfg = jmdx.MDXConfig(**MDX_SIZES)
    mparams = init(jmdx.ConvTDFNet(cfg=jcfg), (1, jcfg.dim_t, jcfg.dim_f, jcfg.dim_c))
    torch.save(weights.mdx_state_from_jax(mparams), d / "mdx.pt")
    jobs = start_jobs(__file__, WORLDS, d)

    jax_out = {}
    x = sampler_inputs()
    run = make_sampler(jdit, JSettings(steps=2, cfg_strength=1.0, sway_sampling_coef=1.0))
    jax_out["dp"] = np.asarray(data_parallel_sampler(run, make_mesh(8))(
        params, *(jnp.asarray(x[k].astype(np.int32) if k == "duration" else x[k])
                  for k in ("cond", "cond_mask", "text_ids", "duration", "y0"))))
    c = tts_cfg()
    jsynth = JSynthesizer(tdit, tparams, voc, vparams, vocab, mel_cfg, mesh=make_mesh(4))
    w, _, m = jsynth.synthesize_chunks(
        ref_wave(), 16000, REF_TEXT, [GEN_TEXT], seed=3, noise_override=noise,
        cfg=JSamplerConfig(nfe_steps=c.nfe_steps, cfg_strength=c.cfg_strength,
                           sway_sampling_coef=c.sway_sampling_coef, cfg_cutoff=c.cfg_cutoff,
                           max_duration=c.max_duration))
    jax_out["chunks_wave"], jax_out["chunks_mel"] = w, m
    jax_out["mdx"] = jinf.MDXSeparator(jcfg, mparams, batch_size=4,
                                       mesh=make_mesh(8)).demix({0: stereo(4000)})
    return d, jax_out, finish_jobs(*jobs)


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_sampler_matches_single_and_jax(job, world):
    from lemas_tts_tpu_torch.cfm.sampler import sample_mel, sway_time_grid

    d, jax_out, ranks = job
    st = settings()
    with torch.no_grad():
        single = sample_mel(fused_dit(d), **{k: torch.from_numpy(v)
                                             for k, v in sampler_inputs().items()},
                            time_grid=sway_time_grid(st.steps, st.sway_sampling_coef),
                            settings=st).numpy()
    got = ranks[world]["dp"]
    np.testing.assert_allclose(got, single, rtol=0, atol=2e-5)
    close(got, jax_out["dp"])


@pytest.mark.parametrize("world", WORLDS)
def test_tts_mesh_matches_unmeshed_and_jax(job, world):
    d, jax_out, ranks = job
    got = ranks[world]
    tts = port_tts(d)
    wave, _, mel = tts.infer((ref_wave(), 16000), REF_TEXT, GEN_TEXT, show_info=lambda *_: None,
                             nfe_step=4, seed=5)
    np.testing.assert_allclose(got["infer_mel"], mel, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["infer_wave"], wave, rtol=0, atol=2e-5)
    noise = np.load(d / "noise.npy")
    w, _, m = tts.synth.synthesize_chunks(ref_wave(), 16000, REF_TEXT, [GEN_TEXT], cfg=tts_cfg(),
                                          seed=3, noise_override=noise)
    np.testing.assert_allclose(got["chunks_mel"], m, rtol=0, atol=2e-5)
    close(got["chunks_mel"], jax_out["chunks_mel"])
    close(got["chunks_wave"], jax_out["chunks_wave"])
    for i, (w, _, m) in enumerate(tts.synth.synthesize_requests(requests(), cfg=tts_cfg())):
        np.testing.assert_allclose(got[f"req{i}_mel"], m, rtol=0, atol=2e-5)
        np.testing.assert_allclose(got[f"req{i}_wave"], w, rtol=0, atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_tts_seq_mesh_matches_unmeshed(job, world):
    d, _, ranks = job
    got = ranks[world]
    wave, _, mel = port_tts(d).infer((ref_wave(), 16000), REF_TEXT, GEN_TEXT,
                                     show_info=lambda *_: None, nfe_step=4, seed=5)
    np.testing.assert_allclose(got["seq_infer_mel"], mel, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["seq_infer_wave"], wave, rtol=0, atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_uvr5_mesh_matches_plain_and_jax(job, world):
    d, jax_out, ranks = job
    got = ranks[world]
    np.testing.assert_allclose(got["mdx"], mdx(d).demix({0: stereo(4000)}), rtol=0, atol=2e-5)
    close(got["mdx"], jax_out["mdx"], atol=2e-5)
    np.testing.assert_allclose(got["vr"], vr().separate_full(stereo(4000), 8000)[0], rtol=0,
                               atol=2e-5)


def test_initialize_without_a_job_is_single_process(monkeypatch):
    import torch.distributed as dist

    from lemas_tts_tpu_torch.parallel.distributed import initialize, is_primary

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize(device_type="cpu") is False
    assert not dist.is_initialized() and is_primary()


def test_a_mesh_of_the_wrong_size_or_device_raises(tmp_path):
    """A mesh in one process is a job of one (a gloo group over a hash
    store); other sizes, and a CUDA mesh for a CPU TTS, raise."""
    import torch.distributed as dist

    from lemas_tts_tpu_torch.infer.pipeline import Synthesizer
    from lemas_tts_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device_type="cpu")
        assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(ValueError, match="one process per device"):
            make_mesh(4, device_type="cpu")

        class CudaMesh:
            device_type = "cuda"

        with pytest.raises(ValueError, match="cuda mesh"):
            Synthesizer(None, None, None, device="cpu", mesh=CudaMesh())
    finally:
        dist.destroy_process_group()


def test_a_seq_axis_of_one_samples_data_parallel():
    """As in JAX, a ``("data", "seq")`` mesh whose ``seq`` axis has one
    process takes the data-parallel sampler (the fused route, K1-K3 on the
    card), not the ring: in a job of one its mel is ``sample_mel``'s."""
    import torch.distributed as dist

    from lemas_tts_tpu_torch.cfm.sampler import sample_mel, sway_time_grid
    from lemas_tts_tpu_torch.config import DiTArch
    from lemas_tts_tpu_torch.infer.pipeline import Synthesizer
    from lemas_tts_tpu_torch.models.dit import DiT
    from lemas_tts_tpu_torch.parallel.sequence import SequenceParallelSampler, make_seq_mesh

    assert not dist.is_initialized()
    try:
        torch.manual_seed(0)
        dit = DiT(DiTArch(**ARCH_FUSED), mel_dim=MEL, text_num_embeds=VOCAB).eval()
        synth = Synthesizer(dit, None, None, device="cpu",
                            mesh=make_seq_mesh(seq_parallel=1, device_type="cpu"))
        st = settings()
        assert not isinstance(synth._sampler(st), SequenceParallelSampler)
        x = {k: torch.from_numpy(v) for k, v in sampler_inputs(B=2).items()}
        with torch.no_grad():
            got = synth.run_sampler(st, x["cond"], x["cond_mask"], x["text_ids"],
                                    x["duration"], x["y0"])
            want = sample_mel(dit, **x, time_grid=sway_time_grid(st.steps, st.sway_sampling_coef),
                              settings=st)
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(Path(sys.argv[1]))
