"""The model behind a lookup by name (``portbench/backbones/``,
``vocoders/``, ``kernels/``).

- The DiT and Vocos families give what the harness gave before they were
  families, exactly: the seeded weights, the reference's mel and wave (also
  under the W8A8 and fp8 hooks), the FLOP count and the kernels' bounds. The
  digests below were taken from the code before the move (commit 6a673f9),
  at one thread.
- A backbone and a vocoder that the harness has never seen (``toy/``) are
  taken by new files only: a tiny cell of them runs and checks correct.
- A name without its file stops the run at set-up, naming the file.
- The conv kernel's file gives PERF.md §6's bound.
"""

import hashlib
import json
import shutil

import numpy as np
import pytest
import torch

from portbench import roofline, system, weights
from portbench import traffic as gen
from portbench.reference import request as ref
from portbench.run import run_cell
from portbench.spec import Bench
from portbench.tests import tiny

PINNED = {
    "shapes_rules.multilingual": "47a4833d1a2c85f813599e1df5c928e3aa24803bcec49e6fc3c729ddb76034ff",
    "shapes_rules.f5tts_base": "47a4833d1a2c85f813599e1df5c928e3aa24803bcec49e6fc3c729ddb76034ff",
    "weights.tiny.backbone": "6fc3dff9b1254582a34aa416a71af660ded7471f20afc029f9512b9dc63165bf",
    "weights.tiny.vocoder": "aee8967e5f6f2dc3b79056e12a9c555c4fb1b53e54eaf9a1ce554840800792bb",
    "reference.single.mel": "1352c423da93fbcd30c3b5627afd95d2bb5068dbbee28c18b47fbdf2fb2a0bbc",
    "reference.single.wave": "afc547cdf906dc76beeea6ec638b1015573f6230412faa36a1af55b9ac5b6e87",
    "reference.serve.mel": "e04d4def89a9e34af00b8bf7c2a34a585139a86da6c6855e8f337c31382c22fa",
    "reference.serve.wave": "beef5489e60007df96c2ed26e9ef24b5eb01dc2ecba4a311a4d58e9e0c8cf1ea",
    "reference.serve.8.mel": "95f9de190e0593fcf30c91b4257843bbba3922ab2799aa500ab84a12f5f0f6e6",
    "reference.serve.8.wave": "e84b0cde5d0e0014abbd1e9e72bfa55fb12ff13e2de8b02af74976065e3e2fc1",
    "reference.serve.fp8.mel": "5515e805f92b1f47afdf62ce5cfa979a316d37757c08f1f4fc38693d7818b2af",
    "reference.serve.fp8.wave": "d47810c7669882e0bb8bcb06f291567ea103eaeebd5563bd9063923365cad03f",
    "grid": "4bdfd50f2e145e683e0ac06e77b0539b709e7c0053c98aec63063a0fa6f90518",
}
SEED = 2 ** 31 + 9


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _config(name: str) -> dict:
    return json.loads((tiny.REPO / f"portbench/configs/{name}.json").read_text())


@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    return Bench(tiny.make_root(tmp_path_factory.mktemp("families"))).cell(tiny.CELL)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["multilingual", "f5tts_base"])
def test_shapes_and_rules_are_the_parents(tiny_cell, name):
    c = _config(name)
    rows = []
    for part, tag in system.SEED_TAGS.items():
        fam = getattr(tiny_cell, part)
        for k, s in fam.param_shapes(c).items():
            rows.append([tag, k, list(s), list(weights.rule(k, s, fam.weight_rule))])
    assert _sha(json.dumps(rows).encode()) == PINNED[f"shapes_rules.{name}"]


def test_seeded_weights_are_the_parents(tiny_cell):
    for part, w in system.make_weights(tiny_cell, SEED, "cpu").items():
        h = hashlib.sha256()
        for k, t in w.items():
            h.update(k.encode())
            h.update(t.float().numpy().tobytes())
        assert h.hexdigest() == PINNED[f"weights.tiny.{part}"], part


@pytest.mark.parametrize("entry,quant", [("single", None), ("serve", None), ("serve", 8),
                                         ("serve", "fp8")])
def test_reference_mel_and_wave_are_the_parents(tiny_cell, one_thread, entry, quant):
    from portbench import check

    host = system.make_weights(tiny_cell, SEED, "cpu")
    model = check.reference_model(tiny_cell, host, "cpu", quant)
    t = tiny.tiny_traffic(entry)
    pool = gen.pool(t, SEED)
    r = max(pool, key=lambda r: (len(r.chunks), max(r.durations))) if entry == "single" \
        else pool[0]
    wave, _, mel = ref.synthesize(model, ref.Sampler(**t["sampler"]), r.ref_wav, r.ref_sr,
                                  r.ref_text, r.chunks, r.seed, "cpu", entry == "single")
    key = f"reference.{entry}" + (f".{quant}" if quant else "")
    assert _sha(np.ascontiguousarray(mel, np.float32).tobytes()) == PINNED[f"{key}.mel"]
    assert _sha(np.ascontiguousarray(wave, np.float64).tobytes()) == PINNED[f"{key}.wave"]


def test_flops_and_bounds_are_the_parents(tiny_cell):
    """``sampler_call_flops`` and ``batch_bounds`` over batch 1-8, every
    duration bucket, the sampler with and without CFG cutoff and block cache,
    bf16 and W8A8."""
    dit = tiny_cell.backbone
    base = {"nfe_steps": 32, "cfg_strength": 3.0, "sway_sampling_coef": 1.0}
    samplers = {"plain": dict(base, cfg_cutoff=None, block_cache=None),
                "cutoff": dict(base, cfg_cutoff=0.5, block_cache=None),
                "cache": dict(base, cfg_cutoff=None, block_cache="0-22:2+t2"),
                "both": dict(base, cfg_cutoff=0.5, block_cache="0-22:2+t2")}
    grid = []
    for name in ("multilingual", "f5tts_base"):
        c = _config(name)
        for sn, s in samplers.items():
            for quant in (None, "int8"):
                for b in range(1, 9):
                    for n in (512, 768, 1024, 1536, 2048, 3072, 4096):
                        durs = [max(1, n - 37 * i) for i in range(b)]
                        grid.append([name, sn, quant, b, n,
                                     dit.sampler_call_flops(c, s, b, n, quant),
                                     roofline.batch_bounds(dit, c, s, quant, n, durs)])
    assert _sha(json.dumps(grid, sort_keys=True).encode()) == PINNED["grid"]


def _toy_root(tmp_path):
    """A tiny checkout whose configuration names a backbone and a vocoder
    that only new files define."""
    root = tiny.make_root(tmp_path, entry="single")
    b = root / "portbench"
    toy = tiny.REPO / "portbench/tests/toy"
    shutil.copy(toy / "backbone.py", b / "backbones/toynet.py")
    shutil.copy(toy / "vocoder.py", b / "vocoders/toyvoc.py")
    cfg = tiny.tiny_config()
    cfg["model"]["backbone"] = "ToyNet"
    cfg["vocoder"] = {"name": "toyvoc"}
    (b / "configs/tiny.json").write_text(json.dumps(cfg))
    return root


def test_new_backbone_and_vocoder_by_new_files_only(tmp_path):
    torch.set_num_threads(4)
    root = _toy_root(tmp_path)
    cell = Bench(root).cell(tiny.CELL)
    assert cell.backbone.__name__.endswith("toynet") and cell.vocoder.__name__.endswith("toyvoc")
    r = run_cell(root, tiny.CELL, SEED, 2.0, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["mel_rel_l2"]["value"] < 1e-5
    for d in tiny.COPIED:  # nothing the harness had was edited
        for f in (tiny.REPO / "portbench" / d).glob("*.py"):
            assert (root / "portbench" / d / f.name).read_bytes() == f.read_bytes()


@pytest.mark.parametrize("what,file", [("backbone", "portbench/backbones/nonet.py"),
                                       ("vocoder", "portbench/vocoders/novoc.py"),
                                       ("kernel", "portbench/kernels/no_kernel.py")])
def test_unknown_name_stops_at_set_up(tmp_path, what, file):
    root = tiny.make_root(tmp_path)
    b = root / "portbench"
    cfg = json.loads((b / "configs/tiny.json").read_text())
    if what == "backbone":
        cfg["model"]["backbone"] = "NoNet"
    elif what == "vocoder":
        cfg["vocoder"]["name"] = "novoc"
    else:
        (b / "metrics/no_kernel_roofline.py").write_text(
            "from portbench.readings import roofline_share\n\nKERNELS = ('no_kernel',)\n\n\n"
            "def read(run):\n    return roofline_share(run, KERNELS)\n")
        doc = json.loads((root / "BENCHMARK.json").read_text())
        doc["per_layer"].append(dict(doc["per_layer"][0], name="no_kernel_roofline"))
        (root / "BENCHMARK.json").write_text(json.dumps(doc))
    (b / "configs/tiny.json").write_text(json.dumps(cfg))
    with pytest.raises(LookupError, match=file):
        run_cell(root, tiny.CELL, SEED, 2.0, False, device="cpu")


@pytest.mark.parametrize("n,ms", [(1024, 0.0084), (1536, 0.0126)])
def test_conv_kernel_bound(n, ms):
    """PERF.md §6's conv row: rows 2, dim 1024, bf16."""
    conv = Bench(tiny.REPO).kernel("conv_taps")
    assert round(roofline.bound_s(*conv.cost(_config("multilingual"), 2, n, 0.0)) * 1e3, 4) == ms
    assert conv.calls(_config("multilingual"), None) == 2 and conv.PER == "forward"
    assert conv.SYMBOL.search("void conv_taps_sm90_kernel(CUtensorMap, CUtensorMap, "
                              "ConvParams, int)")
    assert not conv.SYMBOL.search("void at::native::elementwise_kernel<128, 4>(copy)")
