"""Sequence-parallel sampling: one utterance's sequence sharded over a mesh
axis (counterpart of ``lemas_tts_tpu/parallel/sequence.py``).

On a ``("data", "seq")`` mesh (``make_seq_mesh``) batch rows shard over
``data`` and each row's N frames over ``seq``; every process holds
``[B / data, N / seq]`` of the ODE state. Inside the shard:

- attention runs the ring (``ops/ring_attention.ring_attention``), the DiT
  block's unfused attention side (no K1, K3) with K2 kept on the FF side;
- the conv position embedding exchanges one halo of 30 frames a side, then
  runs its convs unpadded (equal to the global SAME chain);
- rope rows are the shard's global positions (``DiT.seq_sharded``).

What runs once per utterance runs outside the shard, on the whole sequence,
on every process: the cond and uncond text embeddings, the prosody
projection folded into both (it adds linearly to the text embedding and is
the same at every step), and the attention mask. The ODE itself is then
shard-local: ``cond``, ``y0`` and ``step_cond`` (the GRL shuffle) are
sliced like the state, and the block-range cache runs on each shard.
Outputs equal the single-process sampler to float tolerance (the online
softmax sums in another order). The shards are then joined along ``seq``
and ``data``, so every process gets the whole mel.

The ``Synthesizer`` takes this sampler only where the ``seq`` axis has more
than one process, as JAX does; a ``("data", "seq")`` mesh of ``seq`` 1 runs
the data-parallel sampler (``parallel/mesh.py``) with the fused kernels.
"""

from __future__ import annotations

from typing import Optional

from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings, sample_mel, sway_time_grid
from lemas_tts_tpu_torch.parallel.mesh import axis_rank, axis_size, device_mesh, gather_output
from lemas_tts_tpu_torch.utils.masks import lens_to_mask

CONV_HALO = 30  # 2 x (31 // 2): the shortest shard the conv position embedding takes


def make_seq_mesh(n_devices: Optional[int] = None, seq_parallel: int = 2,
                  device_type: Optional[str] = None):
    """``("data", "seq")`` mesh over the job's processes: ``seq_parallel``
    processes share each row's sequence; ``device_type=None`` means CUDA."""
    return device_mesh(n_devices, seq_parallel, ("data", "seq"), device_type)


class SequenceParallelSampler:
    """``fn(cond, cond_mask, text_ids, duration, y0, step_cond=None,
    prosody_text=None) -> mel [B, N, D]`` sequence-parallel over ``mesh``,
    for a DiT (``DiT.seq_sharded``); the JAX ``sequence_parallel_sampler``.
    N must split into ``seq`` shards of at least ``CONV_HALO`` frames and B
    over ``data``; otherwise it raises."""

    def __init__(self, model, settings: SamplerSettings, mesh, data_axis: str = "data",
                 seq_axis: str = "seq"):
        if not hasattr(model, "seq_sharded"):
            raise NotImplementedError(f"sequence parallelism supports the DiT backbone only, "
                                      f"not {type(model).__name__}")
        self.model, self.settings = model, settings
        self.sharded = model.seq_sharded(mesh.get_group(seq_axis))
        self.groups = (mesh.get_group(seq_axis), mesh.get_group(data_axis))
        self.s, self.d = axis_size(mesh, seq_axis), axis_size(mesh, data_axis)
        self.rs, self.rd = axis_rank(mesh, seq_axis), axis_rank(mesh, data_axis)
        self.time_grid = sway_time_grid(settings.steps, settings.sway_sampling_coef,
                                        settings.t_start)

    def check(self, B: int, N: int) -> None:
        if N % self.s or N // self.s < CONV_HALO:
            raise ValueError(f"bucket {N} must split into seq shards of >= {CONV_HALO} frames "
                             f"(the conv halo) over {self.s} processes")
        if B % self.d:
            raise ValueError(f"batch {B} does not split over the {self.d} processes of 'data'")

    def embed(self, text_ids, N: int, prosody_text=None) -> tuple:
        """The whole sequence's (cond, uncond) text embeddings (uncond None
        without CFG), the prosody projection folded into both."""
        m = self.model
        tes = [m.embed_text(text_ids, N, drop_text=False),
               m.embed_text(text_ids, N, drop_text=True) if self.settings.use_cfg else None]
        if prosody_text is not None:
            pt = m.embed_prosody(prosody_text, N)
            tes = [None if te is None else te + pt for te in tes]
        return tuple(tes)

    def __call__(self, cond, cond_mask, text_ids, duration, y0, step_cond=None,
                 prosody_text=None):
        """This process's ``[B / data, N / seq, D]`` share of the mel, then
        every process's: the whole ``[B, N, D]`` (and the trajectory under
        ``return_trajectory``), on every process."""
        B, N, _ = cond.shape
        self.check(B, N)
        tes = self.embed(text_ids, N, prosody_text)
        attn_mask = lens_to_mask(duration, N)
        bl, nl = B // self.d, N // self.s
        rows = slice(self.rd * bl, (self.rd + 1) * bl)
        cols = slice(self.rs * nl, (self.rs + 1) * nl)

        def shard(t):
            return None if t is None else t[rows, cols]

        out = sample_mel(self.sharded, cond=shard(cond), cond_mask=shard(cond_mask),
                         text_ids=None, duration=duration[rows], y0=shard(y0),
                         time_grid=self.time_grid, settings=self.settings,
                         step_cond=shard(step_cond), text_embed_pair=tuple(shard(t) for t in tes),
                         attn_mask_override=shard(attn_mask))
        seq_group, data_group = self.groups
        return gather_output(gather_output(out, seq_group, 1), data_group, 0)
