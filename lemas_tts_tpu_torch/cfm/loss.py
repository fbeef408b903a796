"""CFM training objective: flow MSE + accent-GRL cross-entropy + optional
CTC (counterpart of ``lemas_tts_tpu/cfm/loss.py``).

The same math in the same order as the JAX function: φ = (1−t)x0 + t·x1,
a random 0.7–1.0 span mask, the prosody projection added to the cond mel
*before* the gradient reversal, the DiT on its training route
(``deterministic=False``), the prediction clamped to ±20 with non-finite
differences zeroed before the reduction, the 300 caps, the accent head over
the reversed cond, and the CTC term on the samples with t > 0.5, gated on
``n_sel > 2``.

Random draws: ``draws`` may carry any of them (``frac`` [B], ``span`` [B]
uniforms placing each span, ``x0`` [B, T, D], ``time`` [B],
``prosody_mel_keep`` / ``prosody_text_keep`` bool masks, ``dropout`` a CPU
``torch.Generator`` for the DiT's dropout seeds, else the global one); the
rest come from ``generator`` (``loss_draws``, in a fixed order). Torch
seeds cannot reproduce ``jax.random`` noise, so parity tests fill ``draws``
from the JAX function's own splits.

Data parallelism (``group``, the JAX ``loss_psum_axis``): the batch is this
process's rows of the global batch, and the flow loss's numerator and
denominator, the accent cross-entropy's sum and its B, and the CTC term's
sum and ``n_sel`` are summed over the group, so the local loss is the
global batch's and the ``n_sel > 2`` gate is global. The sums are one
autograd-aware all-reduce (``torch.distributed.nn.functional.all_reduce``,
whose backward sums the gradient over the group too): each process's
gradient is then its rows' part times the group's size, and the mean over
the group (``parallel/mesh.py:ParamPlacement.reduce_grads``) is the global
batch's gradient, as ``pmean`` after ``psum`` is in JAX.

CTC: ``optax.ctc_loss`` takes logits and paddings; ``F.ctc_loss`` takes
``(T, B, C)`` log-probs and lengths. An infeasible row (fewer frames than
the labels need) is +inf in torch and ~1e5 in optax (its log epsilon);
either way it is capped at 300 per frame-normalised sample, which the JAX
value exceeds whenever the row has fewer than 333 frames. The port computes
the torch loss with ``zero_infinity`` (finite gradients) and marks the
infeasible rows itself, so they take the cap.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from lemas_tts_tpu_torch.utils.masks import lens_to_mask, mask_from_frac_lengths

PROSODY_DROPOUT = 0.2  # on both prosody maps while training


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


def grad_reverse(x: torch.Tensor, lam: float = 1.0) -> torch.Tensor:
    """Identity forward, gradient times ``-lam`` backward."""
    return _GradReverse.apply(x, lam)


class AccentClassifier(nn.Module):
    """Linear -> ReLU -> Linear accent head over the reversed cond."""

    def __init__(self, in_dim: int, hidden_dim: int, num_accents: int = 12):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, num_accents)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class CTCHead(nn.Module):
    """proj -> ReLU -> vocab + 1 CTC logits (the blank last), under the
    reference's names (``proj.0``, ``ctc_proj``)."""

    def __init__(self, in_dim: int, hidden_size: int, vocab_size: int):
        super().__init__()
        self.proj = nn.Sequential(nn.Linear(in_dim, hidden_size), nn.ReLU())
        self.ctc_proj = nn.Linear(hidden_size, vocab_size + 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ctc_proj(self.proj(x))


def info_nce_speaker(e_gt: torch.Tensor, e_pred: torch.Tensor,
                     temperature: float = 0.1) -> torch.Tensor:
    """In-batch InfoNCE between ground-truth and predicted speaker
    embeddings: row i of ``e_pred`` is positive with row i of ``e_gt``."""
    e_gt = e_gt / torch.clamp(torch.linalg.norm(e_gt, dim=1, keepdim=True), min=1e-12)
    e_pred = e_pred / torch.clamp(torch.linalg.norm(e_pred, dim=1, keepdim=True), min=1e-12)
    logits = e_pred @ e_gt.t() / temperature
    return F.cross_entropy(logits, torch.arange(e_gt.shape[0], device=logits.device))


def ctc_feasible(labels: torch.Tensor, label_lens: torch.Tensor,
                 input_lens: torch.Tensor) -> torch.Tensor:
    """[B] whether a CTC alignment exists: the frames must cover the labels
    plus a blank between each pair of equal neighbours."""
    S = labels.shape[1]
    valid = torch.arange(S, device=labels.device)[None, :] < label_lens[:, None]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & valid[:, 1:]).sum(1) if S > 1 else 0
    return input_lens >= label_lens + repeats


def _draw(draws: Dict, key: str, make):
    v = draws.get(key)
    return make() if v is None else v


def loss_draws(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
               draws: Optional[Dict] = None, frac_lengths_mask=(0.7, 1.0),
               prosody_dropout: float = 0.0) -> Dict:
    """Every random draw of ``cfm_training_loss`` for ``batch``: those in
    ``draws`` as given, the others from ``generator`` in the loss's order
    (``frac``, ``span``, ``x0``, ``time``, then the prosody keep masks when
    ``prosody_dropout`` > 0 and the batch has the prosody maps). A meshed
    trainer draws them for the global batch and gives each process its
    rows."""
    draws = dict(draws or {})
    mel = batch["mel"]
    B, dev = mel.shape[0], mel.device
    lo, hi = frac_lengths_mask
    draws["frac"] = _draw(draws, "frac", lambda: lo + (hi - lo) * torch.rand(
        B, generator=generator, device=dev))
    draws["span"] = _draw(draws, "span", lambda: torch.rand(B, generator=generator, device=dev))
    draws["x0"] = _draw(draws, "x0", lambda: torch.randn(mel.shape, generator=generator,
                                                         device=dev, dtype=mel.dtype))
    draws["time"] = _draw(draws, "time", lambda: torch.rand(B, generator=generator, device=dev,
                                                            dtype=mel.dtype))
    pm, pt = batch.get("prosody_mel_cond"), batch.get("prosody_text_cond")
    if pm is not None and prosody_dropout > 0:
        keep = 1.0 - prosody_dropout

        def bern(shape):
            return torch.rand(shape, generator=generator, device=dev) < keep

        draws["prosody_mel_keep"] = _draw(draws, "prosody_mel_keep", lambda: bern(pm.shape))
        if pt is not None:
            draws["prosody_text_keep"] = _draw(draws, "prosody_text_keep",
                                               lambda: bern(pt.shape))
    return draws


def group_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group`` (None: ``x``), differentiably."""
    if group is None:
        return x
    from lemas_tts_tpu_torch.parallel.tensor import sum_over

    return sum_over(x, group)


def cfm_training_loss(dit, aux: Dict[str, nn.Module], batch: Dict[str, torch.Tensor], *,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Dict] = None,
                      frac_lengths_mask=(0.7, 1.0), drop_audio_cond: bool = False,
                      drop_text: bool = False, accent_weight: float = 0.1,
                      ctc_weight: float = 0.1, vocab_size: Optional[int] = None,
                      prosody_to_mel: Optional[nn.Module] = None,
                      prosody_dropout: float = PROSODY_DROPOUT, group=None):
    """The training loss of one batch: ``batch`` holds ``mel`` [B, T, D],
    ``mel_lengths`` [B] (each >= 1), ``text`` [B, nt] (-1 padded), ``langs``
    [B] and optionally ``prosody_mel_cond`` / ``prosody_text_cond``
    [B, *, 512]; ``aux`` holds ``accent`` and optionally ``ctc``. Returns
    ``(total, metrics)``; ``generator`` draws on the batch's device.
    ``group``: the batch is this process's rows, and the loss is the global
    batch's (module docstring)."""
    draws = loss_draws(batch, generator, draws, frac_lengths_mask,
                       prosody_dropout if prosody_to_mel is not None else 0.0)
    mel = batch["mel"]
    lens = batch["mel_lengths"]
    text = batch["text"]
    langs = batch["langs"]
    B, T, D = mel.shape
    dev = mel.device
    # sdpa_train gives NaN for a query row whose keys are all masked
    if lens.device.type == "cpu":
        assert bool((lens >= 1).all()), "every mel_lengths must be >= 1"
    else:
        torch._assert_async((lens >= 1).all(), "every mel_lengths must be >= 1")

    mask = lens_to_mask(lens, T)
    rand_span_mask = mask_from_frac_lengths(lens, draws["frac"], T, rand=draws["span"]) & mask

    x1 = mel
    x0, time = draws["x0"], draws["time"]
    t = time[:, None, None]
    phi = (1 - t) * x0 + t * x1
    flow = x1 - x0
    cond = torch.where(rand_span_mask[..., None], 0.0, x1)

    # prosody conditioning: dropout on both dense maps, the mel side
    # projected and added to cond before the gradient reversal
    pt_cond = batch.get("prosody_text_cond")
    pm_cond = batch.get("prosody_mel_cond")
    if pm_cond is not None and prosody_to_mel is not None:
        if prosody_dropout > 0:
            keep = 1.0 - prosody_dropout
            pm_cond = pm_cond * (draws["prosody_mel_keep"].to(pm_cond.dtype) / keep)
            if pt_cond is not None:
                pt_cond = pt_cond * (draws["prosody_text_keep"].to(pt_cond.dtype) / keep)
        cond = cond + prosody_to_mel(pm_cond[:, :T, :])
    if getattr(dit, "prosody_text_proj", None) is None:
        pt_cond = None  # the JAX DiT ignores prosody text without the encoder

    cond_grl = grad_reverse(cond, 1.0)
    pred = dit(phi, cond_grl, text, time, mask, drop_audio_cond=drop_audio_cond,
               drop_text=drop_text, prosody_text=pt_cond, deterministic=False,
               generator=draws.get("dropout"))

    # flow loss: clamped masked MSE, non-finite differences zeroed per element
    diff = torch.clamp(pred.float(), -20.0, 20.0) - flow.float()
    diff = torch.where(torch.isfinite(diff), diff, 0.0)
    mexp = rand_span_mask[..., None].float()
    # the accent loss over the gradient-reversed cond
    accent_mean = aux["accent"](cond_grl).mean(dim=1)
    parts = [(diff.square() * mexp).sum(), mexp.sum(),
             F.cross_entropy(accent_mean, langs.long(), reduction="sum"),
             torch.tensor(float(B), device=dev)]
    use_ctc_head = "ctc" in aux and vocab_size is not None
    if use_ctc_head:  # CTC on the high-t samples
        logits = aux["ctc"](pred)  # [B, T, V+1]
        log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
        labels = torch.clamp(text.long(), min=0)
        label_lens = (text != -1).sum(1)
        in_lens = lens.long()
        per_sample = F.ctc_loss(log_probs, labels, in_lens, label_lens, blank=vocab_size,
                                reduction="none", zero_infinity=True)
        per_sample = per_sample / torch.clamp(lens.float(), min=1.0)
        bad = (torch.isnan(per_sample) | (per_sample > 300.0)
               | ~ctc_feasible(labels, label_lens, in_lens))
        per_sample = torch.where(bad, 300.0, torch.where(bad, 0.0, per_sample))
        sel = (time > 0.5).float()
        parts += [(per_sample * sel).sum(), sel.sum()]
    sums = group_sum(torch.stack(parts), group)  # one all-reduce over the data shards

    loss = sums[0] / torch.clamp(sums[1] * D, min=1.0)
    loss = torch.where(torch.isnan(loss) | (loss > 300.0), 300.0, loss)
    accent_loss = sums[2] / sums[3]
    accent_loss = torch.where(torch.isfinite(accent_loss), accent_loss, 0.0)
    total = loss + accent_weight * accent_loss
    ctc_val = torch.zeros((), device=dev)
    if use_ctc_head:
        n_sel = sums[5]
        ctc_mean = sums[4] / torch.clamp(n_sel, min=1.0)
        use_ctc = (n_sel > 2) & torch.isfinite(ctc_mean) & (ctc_mean > 1e-6)
        ctc_val = torch.where(use_ctc, ctc_mean, 0.0)
        total = total + ctc_weight * ctc_val

    metrics = {"loss": total, "flow_loss": loss, "accent_loss": accent_loss,
               "ctc_loss": ctc_val}
    return total, metrics
