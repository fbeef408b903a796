"""Multi-GPU training and distillation of the port (``parallel/mesh.py``
plans, ``parallel/tensor.py``, ``Trainer(mesh=, fsdp=)``,
``Distiller(mesh=)``) on CPU process groups, against the unmeshed port
and the JAX package's mesh results.

- The tensor-parallel plan and the FSDP dimensions (``tp_param_dims``,
  ``fsdp_param_dims``) against ``dit_param_pspecs``/``fsdp_param_pspecs``
  leaf for leaf: the JAX specs are carried into the port's layout by
  ``weights.dit_state_from_jax`` on marker arrays (each leaf numbered along
  its split dimension).
- The jobs (gloo, torchrun's environment, one torch thread a process, no
  JAX) run this file as a script, as ``tests/test_torch_parallel.py`` sets
  out, one job per world size with every mesh of that size in it:

  - world 4: one ``Trainer`` step on ``data`` 4, plain and ``fsdp``; an
    accumulation window of 2 with ``fsdp``, checkpointed after its first
    mini-step and finished by another trainer restored from it; a
    ``Distiller`` step on ``data`` 2 x ``model`` 2; the v0 arch
    (``pe_attn_head: 1``) on ``data`` 2 x ``model`` 2;
  - world 8: one ``Trainer`` step on ``data`` 4 x ``model`` 2, plain and
    ``fsdp``.

  Every rank gathers the whole state after the step (the checkpoint
  payload), and every rank's must be the same.

The test process starts the jobs, makes the unmeshed port's steps and runs
the JAX ``Trainer`` and ``Distiller`` on conftest's 8-device CPU mesh
(``data`` 4 x ``model`` 2, and ``data`` 2 x ``model`` 2 for the
distiller); the weights come from the JAX params (``weights.py``), the
draws from the JAX step's own ``jax.random`` splits, the global batch's
(each rank takes its rows). Tiny DiT of ``tests/test_parallel.py:23``
(width 64, 4 x 16 heads, depth 2, mel 12), dropout 0, f32, lr 1e-3 with no
warm-up, batch 8 x 32 frames.

Tolerances: the loss within rtol 1e-5 of the unmeshed port's and 5e-4 of
JAX's; parameters after the step at the JAX bar of
``tests/test_parallel.py:348`` (rtol 2e-4, atol 2e-5) against the unmeshed
port and against plain data parallelism on the same mesh (``fsdp``), and
within ``2·lr`` of JAX (Adam's first update is ``lr·sign(g)``: a near-zero
gradient may flip sign between the packages); the EMA within 1e-3 of that.
"""

import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import finish_jobs, start_jobs

ARCH = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_dim=32, conv_layers=1,
            dropout=0.0)
V0 = dict(ARCH, pe_attn_head=1)
D, V, B, T, NT = 12, 30, 8, 32, 6
LR = 1e-3
WORLDS = (4, 8)
BAR = dict(rtol=2e-4, atol=2e-5)


class FixedDrops:
    """Host RNG stub: no CFG drop (``random() >= 0.3``)."""

    def random(self):
        return 0.99


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, V, (B, NT)).astype(np.int32)
    text[1, 4:] = -1
    return {"mel": rng.standard_normal((B, T, D)).astype(np.float32),
            "mel_lengths": rng.integers(T // 2, T + 1, B).astype(np.int32),
            "text": text, "langs": rng.integers(0, 12, B).astype(np.int32)}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def train_cfg(accum: int = 1):
    from lemas_tts_tpu_torch.config import TrainConfig

    return TrainConfig(learning_rate=LR, num_warmup_updates=0, audio_drop_prob=0.0,
                       text_drop_prob=0.0, grad_accumulation_steps=accum)


def port_trainer(arch=ARCH, seed=0, accum=1, **kw):
    from lemas_tts_tpu_torch.api import seeded_init
    from lemas_tts_tpu_torch.cfm.train import Trainer
    from lemas_tts_tpu_torch.config import DiTArch
    from lemas_tts_tpu_torch.models.dit import DiT

    dit = seeded_init(lambda: DiT(DiTArch(**arch), mel_dim=D, text_num_embeds=V), seed)
    return Trainer(dit, vocab_size=V, mel_dim=D, cfg=train_cfg(accum), use_ctc=True, **kw)


def train_case(d: Path, arch=ARCH, **kw) -> dict:
    """One step from the saved initial state (or, for another arch, from a
    seeded one) with the saved draws: the loss and the gathered payload."""
    tr = port_trainer(arch, **kw)
    state = tr.init_state(0)
    if arch is ARCH:
        tr.restore_state(state, torch.load(d / "train_init.pt"))
    draws = torch.load(d / ("train_draws.pt" if arch is ARCH else "v0_draws.pt"))
    state, m = tr.train_step(state, tbatch(np.load(d / "batch.npz")), step_rng_host=FixedDrops(),
                             draws=draws)
    return {"loss": float(m["loss"]), "ctc": float(m["ctc_loss"]),
            "payload": tr.checkpoint_payload(state)}


def accum_case(d: Path, **kw) -> dict:
    """An accumulation window of 2 from the saved initial state: its first
    mini-step, the checkpoint then (the window's gradients in it), a fresh
    trainer restored from it taking the second mini-step (the update)."""
    b = tbatch(np.load(d / "batch.npz"))
    tr = port_trainer(accum=2, **kw)
    state = tr.restore_state(tr.init_state(0), torch.load(d / "train_init.pt"))
    state, _ = tr.train_step(state, b, step_rng_host=FixedDrops(),
                             draws=torch.load(d / "train_draws.pt"))
    mid = tr.checkpoint_payload(state)
    tr = port_trainer(accum=2, **kw)
    state = tr.restore_state(tr.init_state(0), mid)
    state, m = tr.train_step(state, b, step_rng_host=FixedDrops(),
                             draws=torch.load(d / "v0_draws.pt"))
    assert (state.step, state.updates, state.mini_step) == (2, 1, 0)
    return {"loss": float(m["loss"]), "payload": tr.checkpoint_payload(state)}


def distill_case(d: Path, mesh=None) -> dict:
    from lemas_tts_tpu_torch.cfm.distill import Distiller
    from lemas_tts_tpu_torch.config import DiTArch
    from lemas_tts_tpu_torch.models.dit import DiT

    dit = DiT(DiTArch(**ARCH), mel_dim=D, text_num_embeds=V)
    dist_ = Distiller(dit, 4, cfg=train_cfg(), mesh=mesh)
    state = dist_.init_state(torch.load(d / "teacher.pt"))
    b = tbatch(np.load(d / "batch.npz"))
    state, m = dist_.distill_step(state, {k: b[k] for k in ("mel", "mel_lengths", "text")},
                                  draws=torch.load(d / "distill_draws.pt"))
    return {"loss": float(m["loss"]), "t_mean": float(m["t_mean"]),
            "rms": float(m["target_v_rms"]),
            "student": dist_.full_state_dict(state.params),
            "ema": dist_.full_state_dict(state.ema_params)}


def flat(case: str, res: dict) -> dict:
    """``res`` as npz arrays under ``case/``."""
    out = {f"{case}/loss": np.float64(res["loss"])}
    for k in ("ctc", "t_mean", "rms"):
        if k in res:
            out[f"{case}/{k}"] = np.float64(res[k])
    if "payload" in res:
        p = res["payload"]
        for part in ("model_state_dict", "ema_model_state_dict"):
            for k, v in p[part].items():
                out[f"{case}/{part}/{k}"] = v.numpy()
        for i, st in p["optimizer_state_dict"]["state"].items():
            out[f"{case}/adam/{i}"] = st["exp_avg_sq"].numpy()
    for part in ("student", "ema"):
        for k, v in res.get(part, {}).items():
            out[f"{case}/{part}/{k}"] = v.numpy()
    return out


# ------------------------------------------------------------ one rank
def rank_main(d: Path) -> None:
    import torch.distributed as dist

    from lemas_tts_tpu_torch.parallel.distributed import initialize
    from lemas_tts_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    assert initialize(device_type="cpu")
    world = dist.get_world_size()
    out = {}
    if world == 4:
        data = make_mesh(device_type="cpu")
        tr = port_trainer(mesh=data, fsdp=True, fsdp_min_size=128)
        tr.init_state(0)
        out["fsdp_sharded"] = np.int64(len(tr.placement.fsdp))
        out.update(flat("data4", train_case(d, mesh=data)))
        out.update(flat("data4_fsdp", train_case(d, mesh=data, fsdp=True, fsdp_min_size=128)))
        out.update(flat("accum", accum_case(d, mesh=data, fsdp=True, fsdp_min_size=128)))
        dm = make_mesh(model_parallel=2, device_type="cpu")
        out.update(flat("distill", distill_case(d, dm)))
        out.update(flat("v0", train_case(d, V0, mesh=dm)))
    else:
        dm = make_mesh(model_parallel=2, device_type="cpu")
        out.update(flat("d4m2", train_case(d, mesh=dm)))
        out.update(flat("d4m2_fsdp", train_case(d, mesh=dm, fsdp=True, fsdp_min_size=128)))
    np.savez(d / f"out_{dist.get_rank()}.npz", **out)
    dist.destroy_process_group()


# ------------------------------------------------------------ the test process
@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_train_state(jt, key):
    """A JAX ``TrainState`` as ``Trainer.init_state`` builds it, with
    jit-initialised params (eager flax init is ~4x slower)."""
    import jax
    import jax.numpy as jnp

    from lemas_tts_tpu.cfm.train import TrainState

    z, ids = jnp.zeros((1, 16, D)), jnp.zeros((1, 4), jnp.int32)
    k1, k2, k3 = jax.random.split(key, 3)
    params = {"dit": jax.jit(jt.dit_model.init)(k1, z, z, ids, jnp.zeros((1,))),
              "accent": jax.jit(jt.aux_models["accent"].init)(k2, z),
              "ctc": jax.jit(jt.aux_models["ctc"].init)(k3, z)}
    ema = jax.tree_util.tree_map(lambda p: jnp.array(p, copy=True), params["dit"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=jt.optimizer.init(params), ema_params=ema)
    return jt.shard_state(state) if jt.mesh is not None else state


def jax_loss_draws(key) -> dict:
    """The draws of JAX ``cfm_training_loss`` for ``key``."""
    import jax

    r_frac, r_span, r_noise, r_time, _, _ = jax.random.split(key, 6)
    out = {"frac": jax.random.uniform(r_frac, (B,), minval=0.7, maxval=1.0),
           "span": jax.random.uniform(r_span, (B,)),
           "x0": jax.random.normal(r_noise, (B, T, D)),
           "time": jax.random.uniform(r_time, (B,))}
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Inputs and weights (from JAX params), the jobs' results by world
    size, the unmeshed port's results and the JAX mesh results."""
    import jax
    import jax.numpy as jnp

    from lemas_tts_tpu.cfm.distill import Distiller as JDistiller
    from lemas_tts_tpu.cfm.train import Trainer as JTrainer
    from lemas_tts_tpu.config import DiTArch as JArch
    from lemas_tts_tpu.config import TrainConfig as JTrainConfig
    from lemas_tts_tpu.models.dit import DiT as JDiT
    from lemas_tts_tpu.parallel.mesh import make_mesh
    from lemas_tts_tpu_torch import weights

    d = tmp_path_factory.mktemp("train_mesh")
    batch = make_batch()
    np.savez(d / "batch.npz", **batch)
    jcfg = JTrainConfig(learning_rate=LR, num_warmup_updates=0, audio_drop_prob=0.0,
                        text_drop_prob=0.0)
    jt = JTrainer(JDiT(arch=JArch(**ARCH), mel_dim=D, text_num_embeds=V), vocab_size=V,
                  mel_dim=D, cfg=jcfg, use_ctc=True, mesh=make_mesh(8, model_parallel=2))
    jstate = jax_train_state(jt, jax.random.key(0))
    jdit0 = jax.device_get(jstate.params["dit"])  # the step donates the state's buffers
    params0 = weights.train_params_from_jax(jax.device_get(jstate.params))
    # the unmeshed port's state at step 0 in the reference layout (the jobs restore it)
    tr = port_trainer()
    tr.dit_model.load_state_dict(params0["dit"])
    state = tr.init_state(0)
    for k in ("accent", "ctc"):
        state.params[k].load_state_dict(params0[k])
    torch.save(tr.checkpoint_payload(state), d / "train_init.pt")
    key = jax.random.key(7)
    torch.save(jax_loss_draws(key), d / "train_draws.pt")
    g = torch.Generator().manual_seed(3)
    torch.save({"frac": 0.7 + 0.3 * torch.rand(B, generator=g), "span": torch.rand(B, generator=g),
                "x0": torch.randn(B, T, D, generator=g),
                "time": torch.tensor([0.9, 0.2, 0.8, 0.6, 0.1, 0.7, 0.95, 0.3])},
               d / "v0_draws.pt")
    torch.save(params0["dit"], d / "teacher.pt")
    dkey = jax.random.key(11)
    r_noise, r_frac, r_span, r_seg = jax.random.split(dkey, 4)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in {
        "frac": jax.random.uniform(r_frac, (B,), minval=0.7, maxval=1.0),
        "span": jax.random.uniform(r_span, (B,)), "seg": jax.random.randint(r_seg, (B,), 0, 4),
        "x0": jax.random.normal(r_noise, (B, T, D))}.items()}, d / "distill_draws.pt")
    jobs = start_jobs(__file__, WORLDS, d)

    ports = {"train": train_case(d), "v0": train_case(d, V0), "distill": distill_case(d),
             "accum": accum_case(d)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, jm = jt.train_step(jstate, jb, key, FixedDrops())
    jax_out = {"loss": float(jm["loss"]), "ctc": float(jm["ctc_loss"]),
               "params": weights.train_params_from_jax(jax.device_get(jstate.params)),
               "ema": weights.dit_state_from_jax(jax.device_get(jstate.ema_params))}
    jd = JDistiller(jt.dit_model, 4, cfg=jcfg,
                    mesh=make_mesh(4, model_parallel=2, devices=jax.devices()[:4]))
    dstate = jd.init_state(jdit0)
    dstate, dm = jd.distill_step(dstate, {k: jb[k] for k in ("mel", "mel_lengths", "text")}, dkey)
    jax_out["distill"] = {"loss": float(dm["loss"]), "t_mean": float(dm["t_mean"]),
                          "rms": float(dm["target_v_rms"]),
                          "student": weights.dit_state_from_jax(jax.device_get(dstate.params)),
                          "ema": weights.dit_state_from_jax(jax.device_get(dstate.ema_params))}
    return d, finish_jobs(*jobs), ports, jax_out


FILE_NAMES = {"dit": "transformer", "accent": "accent_classifier", "ctc": "ctc"}


def params_of(got: dict, case: str, part: str = "model_state_dict") -> dict:
    pre = f"{case}/{part}/"
    return {k[len(pre):]: v for k, v in got.items() if k.startswith(pre)}


def assert_params(got: dict, want: dict, **tol) -> None:
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), err_msg=k, **tol)


def jax_params(jax_out) -> dict:
    return {f"{FILE_NAMES[m]}.{k}": v.numpy() for m, sd in jax_out["params"].items()
            for k, v in sd.items()}


def port_params(res: dict, part: str = "model_state_dict") -> dict:
    return {k: v.numpy() for k, v in res["payload"][part].items()}


# ------------------------------------------------------------ plans
PLAN_CASES = {
    "tests/test_parallel.py:320": (ARCH, {}, 4, 128),
    "every leaf over 4": (ARCH, {}, 4, 1),
    "v0 with prosody, long skip and qk norm over 8": (
        dict(V0, qk_norm="rms_norm", long_skip_connection=True), {"use_prosody_encoder": True},
        8, 1),
    "width 128, depth 4, default min_elems": (
        dict(dim=128, depth=4, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1),
        {}, 4, 1 << 16),
}


def marked_dims(params, specs, axis: str) -> dict:
    """``{port name: dimension}`` of a JAX pspec tree: every leaf numbered
    1.. along the dimension its spec splits over ``axis`` (0 elsewhere),
    carried into the port's names and layout by ``dit_state_from_jax``."""
    import jax
    from jax.sharding import PartitionSpec as P

    from lemas_tts_tpu_torch import weights

    def mark(leaf, spec):
        a = np.zeros(leaf.shape, np.float32)
        for i, entry in enumerate(tuple(spec)):
            names = entry if isinstance(entry, tuple) else (entry,)
            if axis in names:
                shape = [1] * leaf.ndim
                shape[i] = leaf.shape[i]
                a = a + np.arange(1, leaf.shape[i] + 1, dtype=np.float32).reshape(shape)
        return a

    marks = jax.tree_util.tree_map(mark, params, specs,
                                   is_leaf=lambda x: isinstance(x, P))
    out = {}
    for name, t in weights.dit_state_from_jax(marks).items():
        t = t.numpy()
        if not t.any():
            continue
        varies = [i for i in range(t.ndim) if t.shape[i] > 1
                  and not np.all(t == t.take([0], axis=i))]
        assert len(varies) == 1, (name, t.shape, varies)  # a split of the depth axis fails here
        out[name] = varies[0]
    return out


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_tp_and_fsdp_plans_match_jax(case):
    """``tp_param_dims`` is ``dit_param_pspecs`` and ``fsdp_param_dims`` is
    ``fsdp_param_pspecs`` (on the tensor-parallel base) leaf for leaf,
    under the port's names and layout."""
    import jax
    import jax.numpy as jnp

    from lemas_tts_tpu.config import DiTArch as JArch
    from lemas_tts_tpu.models.dit import DiT as JDiT
    from lemas_tts_tpu.parallel.mesh import dit_param_pspecs, fsdp_param_pspecs
    from lemas_tts_tpu_torch.config import DiTArch
    from lemas_tts_tpu_torch.models.dit import DiT
    from lemas_tts_tpu_torch.parallel.mesh import fsdp_param_dims, tp_param_dims

    arch, kw, axis, min_elems = PLAN_CASES[case]
    jdit = JDiT(arch=JArch(**arch), mel_dim=D, text_num_embeds=V, **kw)
    z = jnp.zeros((1, 16, D))
    pros = jnp.zeros((1, 4, 512)) if kw else None
    params = jax.eval_shape(lambda: jdit.init(jax.random.key(0), z, z, jnp.zeros((1, 4), jnp.int32),
                                              jnp.zeros((1,)), prosody_text=pros))
    base = dit_param_pspecs(params)
    fsdp = fsdp_param_pspecs(params, axis, base=base, min_elems=min_elems)
    port = DiT(DiTArch(**arch), mel_dim=D, text_num_embeds=V, **kw)
    tp = tp_param_dims(port)
    assert tp == marked_dims(params, base, "model")
    got = fsdp_param_dims(port, axis, tp, min_elems)
    assert got == marked_dims(params, fsdp, "data")
    assert got, "no leaf split over data"


# ------------------------------------------------------------ the jobs
@pytest.mark.parametrize("case,world", [("data4", 4), ("d4m2", 8)])
def test_train_step_on_a_mesh_matches_unmeshed_and_jax(job, case, world):
    """One ``Trainer`` step (accent and CTC heads) on ``data`` 4 and on
    ``data`` 4 x ``model`` 2 from the JAX weights with the JAX draws:
    loss, parameters, EMA and AdamW's second moments against the unmeshed
    port, and against the JAX ``Trainer`` on its ``data`` 4 x ``model`` 2
    mesh."""
    _, ranks, ports, jax_out = job
    got, port = ranks[world], ports["train"]
    np.testing.assert_allclose(got[f"{case}/loss"], port["loss"], rtol=1e-5)
    np.testing.assert_allclose(got[f"{case}/loss"], jax_out["loss"], rtol=5e-4)
    assert port["ctc"] > 0 and abs(got[f"{case}/ctc"] - port["ctc"]) <= 1e-5 * port["ctc"]
    assert_params(params_of(got, case), port_params(port), **BAR)
    assert_params(params_of(got, case), jax_params(jax_out), rtol=0, atol=2 * LR)
    ema = params_of(got, case, "ema_model_state_dict")
    assert_params(ema, port_params(port, "ema_model_state_dict"), **BAR)
    assert_params({k[len("ema_model.transformer."):]: v for k, v in ema.items()},
                  {k: v.numpy() for k, v in jax_out["ema"].items()}, rtol=0, atol=2 * LR * 1e-3)
    adam = {k: v for k, v in got.items() if k.startswith(f"{case}/adam/")}
    want = port["payload"]["optimizer_state_dict"]["state"]
    assert len(adam) == len(want)
    for i, st in want.items():
        w = st["exp_avg_sq"].numpy()
        np.testing.assert_allclose(adam[f"{case}/adam/{i}"], w, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(w).max()) + 1e-30)


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_matches_plain_data_parallel(job, world):
    """ZeRO-3 is a layout, not a numerics choice: the ``fsdp`` step equals
    plain data parallelism on the same mesh (``data`` 4, and ``data`` 4 x
    ``model`` 2 where FSDP splits the tensor-parallel parts once more) at
    the JAX bar, moments included, and some leaves are split."""
    _, ranks, _, _ = job
    got = ranks[world]
    case = "data4" if world == 4 else "d4m2"
    plain = {k[len(case) + 1:]: v for k, v in got.items() if k.startswith(f"{case}/")}
    fsdp = {k[len(case) + 6:]: v for k, v in got.items() if k.startswith(f"{case}_fsdp/")}
    assert set(plain) == set(fsdp) and len(plain) > 10
    for k, v in plain.items():
        np.testing.assert_allclose(fsdp[k], v, err_msg=k, **BAR)
    if world == 4:
        assert got["fsdp_sharded"] > 0


def test_v0_under_model_parallel(job):
    """The v0 arch (``pe_attn_head: 1``: the rope on global head 0 only,
    which one process of ``model`` 2 holds) on ``data`` 2 x ``model`` 2
    against the unmeshed port: one step with pinned draws."""
    _, ranks, ports, _ = job
    got, port = ranks[4], ports["v0"]
    np.testing.assert_allclose(got["v0/loss"], port["loss"], rtol=1e-5)
    assert_params(params_of(got, "v0"), port_params(port), **BAR)


def test_accumulation_window_on_an_fsdp_mesh(job):
    """Gradient accumulation (2 mini-steps an update) on ``data`` 4 with
    ``fsdp`` behaves as unmeshed, across a checkpoint taken inside the
    window (its gradients saved as their mean over ``data``) and restored
    into a fresh trainer: the loss, parameters and EMA after the update."""
    _, ranks, ports, _ = job
    got, port = ranks[4], ports["accum"]
    np.testing.assert_allclose(got["accum/loss"], port["loss"], rtol=1e-5)
    assert_params(params_of(got, "accum"), port_params(port), **BAR)
    assert_params(params_of(got, "accum", "ema_model_state_dict"),
                  port_params(port, "ema_model_state_dict"), **BAR)


def test_distiller_on_a_data_model_mesh(job):
    """One ``Distiller`` step (NFE 4, teacher CFG 2) on ``data`` 2 x
    ``model`` 2 against the unmeshed port and the JAX ``Distiller`` on its
    ``data`` 2 x ``model`` 2 mesh: the loss and metrics (global batch's),
    the student and its EMA."""
    _, ranks, ports, jax_out = job
    got, port, jx = ranks[4], ports["distill"], jax_out["distill"]
    for k in ("loss", "t_mean", "rms"):
        np.testing.assert_allclose(got[f"distill/{k}"], port[k], rtol=1e-5)
        np.testing.assert_allclose(got[f"distill/{k}"], jx[k], rtol=5e-4)
    for part in ("student", "ema"):
        mine = params_of(got, "distill", part)
        assert_params(mine, {k: v.numpy() for k, v in port[part].items()}, **BAR)
        atol = 2 * LR * (1 if part == "student" else 1e-3)
        assert_params(mine, {k: v.numpy() for k, v in jx[part].items()}, rtol=0, atol=atol)


if __name__ == "__main__":
    rank_main(Path(sys.argv[1]))
