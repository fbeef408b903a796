"""Ring attention and the conv halo: sequence-parallel self-attention over a
process group (counterpart of ``lemas_tts_tpu/ops/ring_attention.py``).

Each process of the ``seq`` group holds ``Nl = N / s`` query rows and the
key/value chunk of the same rows. At each of the ``s`` steps it scores its
queries against the chunk it holds, folds the scores into an online softmax
and passes the chunk (keys, values, key mask) to the next process of the
ring, receiving the previous one's; the last step passes nothing. No process
ever holds the ``[N, N]`` scores or the whole key/value sequence.

Numerics are the JAX ones: q scaled by ``1/sqrt(D)`` in f32, f32 scores,
masked keys at ``-1e30`` (a row whose keys are all masked gets the mean of
v), p rounded to the compute dtype for the PV product accumulated in f32,
``/ l`` at the end. The reduction order differs from one-shot softmax, so
results agree to float tolerance. The JAX package leaves this to XLA, so it
is plain PyTorch here: no kernel. Every step's send and receive are posted
together in one ``batch_isend_irecv`` on the group's global ranks, before
the step's product, so the transfer runs beside it. With a group of one (or
None) both functions communicate nothing.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

NEG_INF = -1e30  # score of a masked key


def _ring(group) -> tuple:
    """(size, this process's index, global rank of the next, of the
    previous) of ``group``; size 1 without a group."""
    if group is None:
        return 1, 0, None, None
    s, i = dist.get_world_size(group), dist.get_rank(group)
    return s, i, dist.get_global_rank(group, (i + 1) % s), dist.get_global_rank(group, (i - 1) % s)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], group=None) -> torch.Tensor:
    """Exact attention over the sequence sharded on ``group``: q, k, v
    ``[B, H, Nl, D]`` (rope applied) are this process's rows, ``mask``
    ``[B, Nl]`` its keys (True = keep). Returns ``[B, H, Nl, D]`` in v's
    dtype."""
    B, H, Nl, D = q.shape
    s, _, nxt, prv = _ring(group)
    cdt = v.dtype
    qf = q.float() * (1.0 / math.sqrt(D))
    # the key mask travels as bytes beside k and v
    mc = (torch.ones(B, Nl, dtype=torch.uint8, device=q.device) if mask is None
          else mask.to(torch.uint8))
    kc, vc = k.contiguous(), v.contiguous()
    acc = torch.zeros(B, H, Nl, D, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Nl, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, H, Nl, 1, dtype=torch.float32, device=q.device)
    for i in range(s):
        reqs, nk = [], None
        if i + 1 < s:
            # sends and receives in one batch: a rank that posted only its
            # send would deadlock gloo at two processes
            nk = (torch.empty_like(kc), torch.empty_like(vc), torch.empty_like(mc))
            reqs = dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, t, nxt, group) for t in (kc, vc, mc)]
                + [dist.P2POp(dist.irecv, t, prv, group) for t in nk])
        logits = torch.matmul(qf, kc.float().transpose(-1, -2))  # [B, H, Nl, Nl] f32
        logits = logits.masked_fill(~mc.bool()[:, None, None, :], NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(cdt).float(), vc.float())
        m = m_new
        for r in reqs:
            r.wait()
        if nk is not None:
            kc, vc, mc = nk
    return (acc / l).to(cdt)


def halo_exchange(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """``[B, Nl, C]`` -> ``[B, Nl + 2 halo, C]``: the left neighbour's last
    ``halo`` frames before this shard and the right neighbour's first after
    it, zeros at the global edges (a SAME convolution's zero padding).
    Raises ``ValueError`` when the shard is shorter than the halo."""
    B, Nl, C = x.shape
    if Nl < halo:
        raise ValueError(f"sequence shard ({Nl}) shorter than conv halo ({halo}); "
                         f"use a longer bucket or fewer sequence shards")
    s, i, _, _ = _ring(group)
    left = torch.zeros(B, halo, C, dtype=x.dtype, device=x.device)
    right = torch.zeros_like(left)
    if s > 1:
        x = x.contiguous()
        # one batch: to the right neighbour our tail (its left halo), to the
        # left neighbour our head (its right halo); the edges skip the missing side
        ops = []
        if i + 1 < s:
            peer = dist.get_global_rank(group, i + 1)
            ops += [dist.P2POp(dist.isend, x[:, Nl - halo:].contiguous(), peer, group),
                    dist.P2POp(dist.irecv, right, peer, group)]
        if i > 0:
            peer = dist.get_global_rank(group, i - 1)
            ops += [dist.P2POp(dist.isend, x[:, :halo].contiguous(), peer, group),
                    dist.P2POp(dist.irecv, left, peer, group)]
        for r in dist.batch_isend_irecv(ops):
            r.wait()
    return torch.cat([left, x, right], dim=1)
