"""The batch denoise CLI of the port (``scripts/denoise.py``) against the
JAX CLI on the CPU (``tests/test_denoise_cli.py``).

- ``collect_files``: the same (path, stem) pairs, resume skipping finished
  stems, stems mirroring subdirectories.
- ``process_files`` and ``main`` with MDX weights from a file (``-m``, a
  tiny ``.pt``, at the 7680-point STFT that ``infer_config_from_state_dict``
  assumes): the same stems as the JAX CLI writes, vocal and background
  (``-b``), to one 16-bit step plus ``atol=2e-5``; a second run processes
  nothing.
- ``-p "VR Arc"`` writes finite stems at the input rate.
- ``--data_parallel`` in one process (a mesh of one on gloo) writes the
  stems of the plain run, and without ``--device cpu`` the CLI raises where
  there is no CUDA (``tests/test_torch_parallel.py`` runs the separators on
  meshes of 2 and 4 processes).
"""

import warnings

import numpy as np
import pytest
import torch

from lemas_tts_tpu.scripts import denoise as jdenoise
from lemas_tts_tpu_torch.scripts import denoise
from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav
from lemas_tts_tpu_torch.uvr5 import mdxnet

TINY = mdxnet.MDXConfig(dim_f=24, dim_t=16, n_fft=64, hop=16, num_blocks=5, l=2, g=4, bn=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny CPU ops here run fastest on one thread, and the suite's
    parallel workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    """A tiny MDX model's state dict as a ``.pt``, random from a seed."""
    model = mdxnet.seeded_init_(mdxnet.ConvTDFNet(TINY), torch.Generator().manual_seed(3))
    path = tmp_path_factory.mktemp("mdx") / "tiny_mdx.pt"
    torch.save(model.state_dict(), path)
    return str(path)


def _write_inputs(d, n=3, sr=44100, dur_s=0.05, sub=""):
    rng = np.random.default_rng(7)
    (d / sub).mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        p = d / sub / f"clip{i}.wav"
        write_wav(str(p), rng.uniform(-0.3, 0.3, int(sr * dur_s)).astype(np.float32), sr)
        paths.append(str(p))
    return paths


def test_collect_files_resume_equals_jax(tmp_path):
    src, out = tmp_path / "in", tmp_path / "out"
    paths = _write_inputs(src)
    files = denoise.collect_files(str(src), str(out))
    assert files == jdenoise.collect_files(str(src), str(out))
    assert sorted(p for p, _ in files) == sorted(paths)
    out.mkdir()
    (out / "clip1_vocal.wav").write_bytes(b"")  # finished stems are skipped
    files = denoise.collect_files(str(src), str(out))
    assert files == jdenoise.collect_files(str(src), str(out))
    assert all("clip1" not in p for p, _ in files) and len(files) == 2
    assert denoise.collect_files(paths[0], str(out)) == [(paths[0], "clip0")]


def test_collect_files_mirrors_subdirs(tmp_path):
    src, out = tmp_path / "in", tmp_path / "out"
    for sub in ("a", "b"):
        _write_inputs(src, n=1, sub=sub)
    files = denoise.collect_files(str(src), str(out))
    assert files == jdenoise.collect_files(str(src), str(out))
    assert sorted(stem for _, stem in files) == ["a/clip0", "b/clip0"]


def _stems(out, names):
    return {n: read_audio(str(out / n)) for n in names}


@pytest.mark.parametrize("background", [False, True])
def test_main_writes_the_jax_clis_stems(tmp_path, weights_file, background):
    """Both CLIs over the same inputs and weights file; then a second run of
    the port's processes nothing."""
    src = tmp_path / "in"
    _write_inputs(src, n=2)
    flags = ["-m", weights_file] + (["-b"] if background else [])
    written = denoise.main(["-a", str(src), "-r", str(tmp_path / "port"), "--device", "cpu",
                            *flags])
    jwritten = jdenoise.main(["-a", str(src), "-r", str(tmp_path / "jax"), *flags])
    names = [f"clip{i}_{kind}.wav" for i in range(2)
             for kind in (("vocal", "background") if background else ("vocal",))]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(names)
    assert [w.replace("port", "jax") for w in written] == jwritten
    got, want = _stems(tmp_path / "port", names), _stems(tmp_path / "jax", names)
    for n in names:
        (wav, sr), (jwav, jsr) = got[n], want[n]
        assert sr == jsr == 44100 and wav.shape == jwav.shape == (2, int(0.05 * 44100))
        np.testing.assert_allclose(wav, jwav, atol=1 / 32767 + 2e-5)
    assert denoise.main(["-a", str(src), "-r", str(tmp_path / "port"), "--device", "cpu",
                         *flags]) == []


def test_vr_arc_path_writes_stems(tmp_path):
    src = tmp_path / "in"
    files = _write_inputs(src, n=1, sr=8000, dur_s=0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sep = denoise.build_separator(denoise.build_parser().parse_args(
            ["-a", str(src), "-r", str(tmp_path), "-p", "VR Arc", "--device", "cpu"]))
    from lemas_tts_tpu_torch.uvr5.vr_network import CascadedNet, random_vr_init_

    assert isinstance(sep.model, CascadedNet) and sep.n_fft == 2048 and sep.window_size == 512
    # narrow widths for the CPU
    sep.model = random_vr_init_(CascadedNet(256, 8, 16), torch.Generator().manual_seed(0)).eval()
    sep.n_fft, sep.hop = 256, 128
    written = denoise.process_files(sep, files, str(tmp_path / "out"), save_background=True,
                                    io_workers=1, aggressiveness=0.2)
    voc, sr = read_audio(written[0])
    bg, _ = read_audio(str(tmp_path / "out" / "clip0_background.wav"))
    assert sr == 8000 and voc.shape == bg.shape == (2, 4000) and np.isfinite(voc).all()


def test_data_parallel_and_device_are_refused(tmp_path, weights_file):
    import torch.distributed as dist

    src = tmp_path / "in"
    _write_inputs(src, n=1)
    args = ["-a", str(src), "-r", str(tmp_path / "out"), "-m", weights_file]
    assert not dist.is_initialized()
    try:
        dp = denoise.main(["-a", str(src), "-r", str(tmp_path / "dp"), "-m", weights_file,
                           "--data_parallel", "--device", "cpu"])
    finally:
        dist.destroy_process_group()
    plain = denoise.main(["-a", str(src), "-r", str(tmp_path / "plain"), "-m", weights_file,
                          "--device", "cpu"])
    assert len(dp) == len(plain) == 1
    np.testing.assert_array_equal(read_audio(dp[0])[0], read_audio(plain[0])[0])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would run on it")
    for argv in (args, args[:-2] + ["-p", "VR Arc"]):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(RuntimeError, match="CUDA"):
                denoise.main(argv)
