"""Training checkpoints with the reference save policy (counterpart of
``lemas_tts_tpu/cfm/checkpoint.py``):

 - ``model_<step>.pt`` every ``save_per_updates`` steps, pruned to
   ``keep_last_n_checkpoints`` (-1 keeps all, 0 writes none);
 - a rolling ``model_last.pt`` every ``last_per_updates`` steps (the resume
   point), with a ``model_last.step`` sidecar so ``latest_step`` reads the
   step without loading the file;
 - EMA weights saved beside the raw ones.

Files are torch files in the reference trainer's layout: ``model_state_dict``
(the CFM module's keys: ``transformer.*``, ``prosody_to_mel.*``,
``accent_classifier.*``, ``ctc.*``), ``ema_model_state_dict``
(``ema_model.transformer.*``), ``optimizer_state_dict`` and ``step``, so
``weights.load_reference_checkpoint`` (and so ``TTS``) reads them. The JAX
package writes orbax directories instead; native orbax files are not read
here.

Under a multi-process job (``torch.distributed``) every process calls the
manager with the same payload (a meshed trainer gathers it on every
process): process 0 writes and prunes, and every process waits at a
barrier after each write, so a file on disk is whole before any process
reads it or goes on.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist

from lemas_tts_tpu_torch.config import TrainConfig


def _primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


@torch.no_grad()
def ema_update(ema_params: Iterable[torch.Tensor], params: Iterable[torch.Tensor],
               decay: float = 0.999) -> None:
    """In place: ema <- decay * ema + (1 - decay) * params."""
    ema_params, params = list(ema_params), list(params)
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, [p.to(e.dtype) for e, p in zip(ema_params, params)],
                        alpha=1.0 - decay)


class CheckpointManager:
    """Reference save policy over torch files in ``directory``."""

    def __init__(self, directory: str, cfg: TrainConfig = TrainConfig()):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg

    def _snap_path(self, step: int) -> Path:
        return self.dir / f"model_{step}.pt"

    @property
    def last_path(self) -> Path:
        return self.dir / "model_last.pt"

    def snapshots(self) -> Dict[int, Path]:
        out = {}
        for p in self.dir.iterdir():
            m = re.fullmatch(r"model_(\d+)\.pt", p.name)
            if m:
                out[int(m.group(1))] = p
        return dict(sorted(out.items()))

    def write(self, path: Path, payload: Dict[str, Any]) -> None:
        """Write through a temporary file, so a crash leaves the old file
        (process 0 of a job; the others wait for it)."""
        if _primary():
            tmp = path.with_name(path.name + ".tmp")
            torch.save(payload, tmp)
            os.replace(tmp, path)
            if path == self.last_path:
                self.last_path.with_suffix(".step").write_text(str(int(payload["step"])))
        _barrier()

    def due(self, step: int) -> bool:
        """Whether ``maybe_save`` would write anything at ``step`` (the
        payload is then worth building)."""
        c = self.cfg
        return ((c.save_per_updates > 0 and step % c.save_per_updates == 0
                 and c.keep_last_n_checkpoints != 0)
                or (c.last_per_updates > 0 and step % c.last_per_updates == 0))

    def maybe_save(self, step: int, payload: Dict[str, Any]) -> Optional[Path]:
        """Apply the save policy at ``step`` to ``payload`` (the checkpoint
        dict). Returns the snapshot path when one was written."""
        written = None
        keep = self.cfg.keep_last_n_checkpoints
        if self.cfg.save_per_updates > 0 and step % self.cfg.save_per_updates == 0 and keep != 0:
            written = self._snap_path(step)
            self.write(written, payload)
            self._prune()
        if self.cfg.last_per_updates > 0 and step % self.cfg.last_per_updates == 0:
            self.write(self.last_path, payload)
        return written

    def _prune(self) -> None:
        keep = self.cfg.keep_last_n_checkpoints
        if keep is None or keep < 0:
            return
        if _primary():
            snaps = self.snapshots()
            for step in list(snaps)[: max(0, len(snaps) - keep)]:
                snaps[step].unlink()
        _barrier()

    def path_of(self, step: Optional[int] = None) -> Path:
        """The file ``restore`` reads: snapshot ``step``, else ``model_last``,
        else the newest snapshot; raises when there is none."""
        if step is not None:
            path = self._snap_path(step)
            if not path.is_file():
                raise FileNotFoundError(f"no checkpoint for step {step} under {self.dir}")
            return path
        if self.last_path.is_file():
            return self.last_path
        snaps = self.snapshots()
        if not snaps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return snaps[max(snaps)]

    def restore(self, step: Optional[int] = None, map_location="cpu") -> Dict[str, Any]:
        """The checkpoint dict (default: ``model_last``, else the newest)."""
        return torch.load(self.path_of(step), map_location=map_location, weights_only=True)

    def latest_step(self) -> Optional[int]:
        """Newest resumable step: numbered snapshots win, else the step of
        ``model_last``."""
        snaps = self.snapshots()
        if snaps:
            return max(snaps)
        side = self.last_path.with_suffix(".step")
        return int(side.read_text()) if side.is_file() else None
