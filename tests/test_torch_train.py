"""The port's training path against the JAX package on the CPU: the kernel
wrappers' grad guard, the gradient-reversal layer, ``cfm_training_loss``
(values and gradients), the DiT's training route (dropout, activation
checkpointing), InfoNCE, and the optimizer: three steps of clip + AdamW with
warmup, then gradient accumulation 2 with the EMA, through ``Trainer``.

Widths: two DiT blocks of width 64 (4 x 16 heads), 12 mel channels, f32,
``arch.dropout = 0`` where JAX is compared. The random draws come from the
JAX function's own ``jax.random`` splits (``draws=``). Tolerances: values
``rtol 2e-4``; gradients per tensor rel-L2 <= 2e-4; parameters after
optimizer steps within ``atol = 2·lr`` (Adam's early steps are nearly
``lr·sign(g)``, and a near-zero gradient may flip sign between the two
packages).
"""

import inspect
import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu.cfm import loss as jloss
from lemas_tts_tpu.cfm.train import Trainer as JTrainer
from lemas_tts_tpu.config import DiTArch as JArch
from lemas_tts_tpu.config import TrainConfig as JTrainConfig
from lemas_tts_tpu.models.dit import DiT as JDiT
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.cfm import loss
from lemas_tts_tpu_torch.cfm.train import Trainer, clip_by_global_norm, make_schedule
from lemas_tts_tpu_torch.config import DiTArch, TrainConfig
from lemas_tts_tpu_torch.models.dit import DiT
from lemas_tts_tpu_torch.ops import attention, ffn

ARCH = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_dim=32, conv_layers=1,
            dropout=0.0)
D, V, B, T, NT = 12, 30, 4, 48, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def make_batch(seed=0, prosody=False):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, V, (B, NT)).astype(np.int32)
    text[1, 5:] = -1
    b = {"mel": rng.standard_normal((B, T, D)).astype(np.float32),
         "mel_lengths": np.array([48, 40, 33, 44], np.int32),
         "text": text, "langs": rng.integers(0, 12, B).astype(np.int32)}
    if prosody:
        b["prosody_mel_cond"] = rng.standard_normal((B, T, 512)).astype(np.float32)
        b["prosody_text_cond"] = rng.standard_normal((B, NT, 512)).astype(np.float32)
    return b


def loss_draws(key, batch, lo=0.7, hi=1.0) -> dict:
    """The draws of JAX ``cfm_training_loss`` for ``key``, as torch tensors."""
    r_frac, r_span, r_noise, r_time, r_pdrop, _ = jax.random.split(key, 6)
    out = {"frac": jax.random.uniform(r_frac, (B,), minval=lo, maxval=hi),
           "span": jax.random.uniform(r_span, (B,)),
           "x0": jax.random.normal(r_noise, (B, T, D)),
           "time": jax.random.uniform(r_time, (B,))}
    if "prosody_mel_cond" in batch:
        kd, kt = jax.random.split(r_pdrop)
        out["prosody_mel_keep"] = jax.random.bernoulli(kd, 0.8, batch["prosody_mel_cond"].shape)
        out["prosody_text_keep"] = jax.random.bernoulli(kt, 0.8,
                                                        batch["prosody_text_cond"].shape)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jparams():
    """JAX DiT (with and without the prosody projection), accent and CTC params."""
    z = jnp.zeros((1, 16, D))
    out = {}
    for pros in (False, True):
        jd = JDiT(arch=JArch(**ARCH), mel_dim=D, text_num_embeds=V, use_prosody_encoder=pros)
        out[pros] = (jd, jax.jit(lambda k, jd=jd, pros=pros: jd.init(
            k, z, z, jnp.zeros((1, 4), jnp.int32), jnp.zeros((1,)),
            prosody_text=jnp.zeros((1, 4, 512)) if pros else None))(jax.random.key(0)))
    acc, ctc = jloss.AccentClassifier(hidden_dim=64), jloss.CTCHead(hidden_size=64, vocab_size=V)
    aux_p = {"accent": acc.init(jax.random.key(1), z), "ctc": ctc.init(jax.random.key(2), z)}
    pros_p = {"kernel": jax.random.normal(jax.random.key(3), (512, D)) * 0.02,
              "bias": jnp.zeros((D,))}
    return out, {"accent": acc, "ctc": ctc}, aux_p, pros_p


# --------------------------------------------------------------- grad guard
@pytest.mark.parametrize("wrapper", [ffn.qkv_block, ffn.ffn_block, attention.vmem_attention,
                                     attention.vmem_attention_nhd,
                                     attention.vmem_attention_nhd_pack,
                                     attention.splash_attention])
def test_kernel_wrappers_refuse_grad(wrapper):
    """Each CUDA kernel wrapper calls ``_cuda.refuse_grad`` on its inputs on
    the CUDA route, before it launches (its source says so; the card is
    checked by ``chip_smoke.py``), and the CPU route above it is unchanged.
    K5 and K6 launch through their shared ``_launch_bhnd``."""
    src = inspect.getsource(wrapper)
    cpu_at = src.index('device.type == "cpu"')
    guard_at = src.index("_cuda.refuse_grad(")
    launch_at = max(src.find(f) for f in ("_cuda.library(", "_launch_nhd(", "_launch_bhnd("))
    assert cpu_at < guard_at < launch_at, wrapper.__name__


def test_refuse_grad_raises_under_grad():
    from lemas_tts_tpu_torch.ops import _cuda

    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _cuda.refuse_grad("qkv_block (K1)", x)
    with torch.no_grad():
        _cuda.refuse_grad("qkv_block (K1)", x)
    _cuda.refuse_grad("qkv_block (K1)", x.detach(), None)


# ---------------------------------------------------------------------- GRL
def test_grad_reverse_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jloss.grad_reverse(a, 1.0) * w))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    y = loss.grad_reverse(t, 1.0)
    assert torch.equal(y, torch.from_numpy(x))
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    t.grad = None
    (loss.grad_reverse(t, 0.5) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), -0.5 * w)


def test_info_nce_matches_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((5, 16)).astype(np.float32) for _ in range(2))
    want = jloss.info_nce_speaker(jnp.asarray(a), jnp.asarray(b), temperature=0.2)
    got = loss.info_nce_speaker(torch.from_numpy(a), torch.from_numpy(b), temperature=0.2)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)


# --------------------------------------------------------------------- loss
CASES = {
    "ctc": dict(ctc=True),
    "no_ctc_prosody_drop_audio": dict(ctc=False, prosody=True, drop_audio_cond=True),
    "ctc_drop_text_infeasible_row": dict(ctc=True, drop_text=True, infeasible=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_training_loss_matches_jax(case, jparams):
    """``cfm_training_loss`` and its gradients against the JAX function on
    the same weights, batch and draws: the flow loss, the accent loss over
    the reversed cond, the CTC term (gated on n_sel > 2; a row with fewer
    frames than its labels need takes the 300 cap in both), the prosody
    conditioning with its dropout masks, and both CFG drops."""
    c = CASES[case]
    pros = c.get("prosody", False)
    jdits, jaux, aux_p, pros_p = jparams
    jd, dp = jdits[pros]
    batch = make_batch(1, prosody=pros)
    if c.get("infeasible"):
        batch["mel_lengths"][2] = 6  # 8 labels in 6 frames
    key = jax.random.key(7)
    # n_sel > 2 needs 3 samples with t > 0.5: pick a key that gives them
    while c["ctc"] and int((jax.random.uniform(jax.random.split(key, 6)[3], (B,)) > 0.5)
                           .sum()) < 3:
        key = jax.random.split(key)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jaux_m = {"accent": jaux["accent"], **({"ctc": jaux["ctc"]} if c["ctc"] else {})}
    kw = dict(drop_audio_cond=c.get("drop_audio_cond", False), drop_text=c.get("drop_text", False),
              vocab_size=V if c["ctc"] else None)

    def jf(params):
        return jloss.cfm_training_loss(jd, params["dit"], jaux_m, params["aux"], jb, key,
                                       prosody_params=params.get("pros"), **kw)

    jp = {"dit": dp, "aux": {k: aux_p[k] for k in jaux_m}, **({"pros": pros_p} if pros else {})}
    (_, jm), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jp)

    dit = DiT(DiTArch(**ARCH), mel_dim=D, text_num_embeds=V, use_prosody_encoder=pros)
    dit.load_state_dict(weights.dit_state_from_jax(dp))
    aux = {"accent": loss.AccentClassifier(D, 64)}
    aux["accent"].load_state_dict(weights.accent_state_from_jax(aux_p["accent"]))
    if c["ctc"]:
        aux["ctc"] = loss.CTCHead(D, 64, V)
        aux["ctc"].load_state_dict(weights.ctc_state_from_jax(aux_p["ctc"]))
    to_mel = None
    if pros:
        to_mel = torch.nn.Linear(512, D)
        to_mel.load_state_dict(weights.prosody_to_mel_from_jax(pros_p))
    total, m = loss.cfm_training_loss(dit, aux, tbatch(batch), draws=loss_draws(key, batch),
                                      prosody_to_mel=to_mel, **kw)
    for name in ("loss", "flow_loss", "accent_loss", "ctc_loss"):
        np.testing.assert_allclose(float(m[name].detach()), float(jm[name]), rtol=2e-4, atol=1e-6,
                                   err_msg=name)
    if c["ctc"]:
        assert float(m["ctc_loss"].detach()) > 0
    total.backward()
    want = {f"dit.{k}": v for k, v in weights.dit_state_from_jax(jg["dit"]).items()}
    want.update({f"accent.{k}": v for k, v in
                 weights.accent_state_from_jax(jg["aux"]["accent"]).items()})
    if c["ctc"]:
        want.update({f"ctc.{k}": v for k, v in
                     weights.ctc_state_from_jax(jg["aux"]["ctc"]).items()})
    if pros:
        want.update({f"pros.{k}": v for k, v in
                     weights.prosody_to_mel_from_jax(jg["pros"]).items()})
    mods = {"dit": dit, **aux, **({"pros": to_mel} if pros else {})}
    got = {f"{n}.{k}": p.grad for n, mod in mods.items() for k, p in mod.named_parameters()}
    assert set(got) == set(want)
    worst = max((rel_l2(got[k], want[k]), k) for k in want
                if float(np.linalg.norm(want[k])) > 0)
    assert worst[0] <= 2e-4, worst


def test_training_route_dropout_and_remat():
    """Under ``deterministic=False`` the dropouts of ``arch.dropout`` are
    live: the same dropout generator gives the same output, another gives
    another, and ``deterministic=True`` (``autograd=True``) gives the
    dropout-free training route, equal to the kernels' plain versions. With
    ``checkpoint_activations`` the recomputed blocks draw the same masks, so
    the gradients equal those without it."""
    torch.manual_seed(0)
    arch = DiTArch(**dict(ARCH, dropout=0.5))
    dit = DiT(arch, mel_dim=D, text_num_embeds=V)
    b = tbatch(make_batch(2))
    mask = torch.arange(T)[None] < b["mel_lengths"][:, None]
    args = (b["mel"], b["mel"] * 0.5, b["text"], torch.full((B,), 0.3), mask)

    def run(det, seed, d=dit):
        return d(*args, deterministic=det, autograd=True,
                 generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(False, 1), run(False, 1))
    assert not torch.allclose(run(False, 1), run(False, 2))
    assert torch.equal(run(True, 1), run(True, 2))
    with torch.no_grad():
        kernels = dit(*args)
    np.testing.assert_allclose(run(True, 1).detach().numpy(), kernels.numpy(), rtol=2e-4,
                               atol=2e-5)

    grads = []
    for remat in (False, True):
        d = DiT(DiTArch(**dict(ARCH, dropout=0.5, checkpoint_activations=remat)), mel_dim=D,
                text_num_embeds=V)
        d.load_state_dict(dit.state_dict())
        run(False, 3, d).square().sum().backward()
        grads.append({k: p.grad.clone() for k, p in d.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-5, atol=1e-7)


def test_clip_and_schedule_match_optax():
    import optax

    cfg = TrainConfig(learning_rate=1e-3, num_warmup_updates=4)
    js = __import__("lemas_tts_tpu.cfm.train", fromlist=["make_schedule"]).make_schedule(
        JTrainConfig(learning_rate=1e-3, num_warmup_updates=4))
    for i in range(7):
        np.testing.assert_allclose(make_schedule(cfg)(i), float(js(i)), rtol=1e-6)
    rng = np.random.default_rng(0)
    for scale in (0.1, 10.0):
        gs = [rng.standard_normal(s).astype(np.float32) * scale for s in ((3, 4), (5,))]
        want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in gs], None)
        got = [torch.from_numpy(g.copy()) for g in gs]
        clip_by_global_norm(got, 1.0)
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_steps_match_jax(accum):
    """``Trainer.train_step`` against the JAX ``Trainer`` from the same
    weights, batch, draws and host RNG: three optimizer steps of clip +
    AdamW with warmup (lr 0 at the first), and with accumulation 2 six
    mini-steps (three updates); parameters and the EMA after them. The CFG
    drops are off here (each drop pattern is a JAX program of its own to
    compile; the loss test holds them)."""
    lr = 1e-3
    common = dict(learning_rate=lr, num_warmup_updates=2, grad_accumulation_steps=accum,
                  audio_drop_prob=0.0, text_drop_prob=0.0)
    jcfg, cfg = JTrainConfig(**common), TrainConfig(**common)
    batch = make_batch(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jd = JDiT(arch=JArch(**ARCH), mel_dim=D, text_num_embeds=V)
    jt = JTrainer(jd, vocab_size=V, mel_dim=D, cfg=jcfg, use_ctc=True)
    jstate = jt.init_state(jax.random.key(0), jb)
    params0 = weights.train_params_from_jax(jstate.params)

    dit = DiT(DiTArch(**ARCH), mel_dim=D, text_num_embeds=V)
    dit.load_state_dict(params0["dit"])
    tr = Trainer(dit, vocab_size=V, mel_dim=D, cfg=cfg, use_ctc=True)
    state = tr.init_state(0)
    for k in ("accent", "ctc"):
        state.params[k].load_state_dict(params0[k])
    jr, r = random.Random(5), random.Random(5)
    tb = tbatch(batch)
    for i in range(3 * accum):
        key = jax.random.key(100 + i)
        jstate, jm = jt.train_step(jstate, jb, key, jr)
        state, m = tr.train_step(state, tb, step_rng_host=r, draws=loss_draws(key, batch))
        np.testing.assert_allclose(float(m["loss"].detach()), float(jm["loss"]), rtol=5e-4)
    assert state.step == int(jstate.step) == 3 * accum and state.updates == 3
    want = weights.train_params_from_jax(jstate.params)
    want_ema = weights.dit_state_from_jax(jstate.ema_params)
    for name, sd in want.items():
        got = state.params[name].state_dict()
        for k, w in sd.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=2 * lr,
                                       err_msg=f"{name}.{k}")
    moved = 0.0
    for k, w in want_ema.items():
        got = state.ema_params.state_dict()[k]
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=2 * lr * 1e-3 * 3,
                                   err_msg=f"ema.{k}")
        moved = max(moved, float((got - params0["dit"][k]).abs().max()))
    assert moved > 0  # the EMA moved with the updates


@pytest.mark.parametrize("kwargs", [dict(mesh="one process"), dict(fsdp=True)])
def test_trainer_multi_gpu_not_ported(kwargs):
    """Multi-GPU training is ported (``tests/test_torch_train_parallel.py``
    holds it at 2-8 processes). In one process: ``Trainer`` on a mesh of
    one (a process group over a hash store) takes the unmeshed step, and
    ``fsdp=True`` without a mesh is a no-op, as in JAX
    (``lemas_tts_tpu/cfm/train.py:80``). Two steps from the same weights
    and draws; parameters and EMA within 1e-6 of the unmeshed trainer's,
    AdamW moments within 1e-5 of their peak (the same products; the clip's
    norm is summed in another order)."""
    import torch.distributed as dist

    from lemas_tts_tpu_torch.parallel.mesh import make_mesh

    cfg = TrainConfig(learning_rate=1e-3, num_warmup_updates=0, audio_drop_prob=0.0,
                      text_drop_prob=0.0)
    tb = tbatch(make_batch(4))

    def run(**kw):
        torch.manual_seed(0)
        tr = Trainer(DiT(DiTArch(**ARCH), mel_dim=D, text_num_embeds=V), vocab_size=V,
                     mel_dim=D, cfg=cfg, **kw)
        state = tr.init_state(0)
        for i in range(2):
            state, m = tr.train_step(state, tb, torch.Generator().manual_seed(i),
                                     random.Random(0))
        return tr, tr.checkpoint_payload(state)

    plain, want = run()
    assert not dist.is_initialized()
    try:
        if kwargs.get("mesh"):
            tr, got = run(mesh=make_mesh(device_type="cpu"))
            assert tr.placement is not None and tr.placement.size["data"] == 1
        else:
            tr, got = run(**kwargs)
            assert tr.fsdp is False and tr.placement is None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for part in ("model_state_dict", "ema_model_state_dict"):
        for k, w in want[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), w.numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
    for i, w in want["optimizer_state_dict"]["state"].items():
        g = got["optimizer_state_dict"]["state"][i]
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=0,
                                       atol=1e-5 * float(w[k].abs().max()))
    assert got["step"] == want["step"] == 2


@pytest.mark.parametrize("flag", [["--model_parallel", "2"], ["--pipe_parallel", "2"],
                                  ["--fsdp"]])
def test_train_cli_multi_gpu_flags_raise(flag, tmp_path):
    """The multi-GPU flags run (``tests/test_torch_pipeline_parallel.py``
    runs them in a job of 2). Without a job there is no mesh, as in JAX:
    ``--model_parallel 2`` and ``--fsdp`` train unmeshed; ``--pipe_parallel
    2`` needs two processes and raises before any process group is made."""
    import torch.distributed as dist

    from lemas_tts_tpu_torch.scripts import train

    argv = ["--synthetic", "4", "--tiny", "--ckpt_dir", str(tmp_path), "--device", "cpu",
            "--steps", "1", *flag]
    if "--pipe_parallel" in flag:
        with pytest.raises(ValueError, match="one process per device"):
            train.main(argv)
    else:
        assert train.main(argv) == 0
        assert (tmp_path / "model_last.pt").is_file()
    assert not dist.is_initialized()
