"""Teacher + student checkpoints with torch.save (PyTorch port of
ubteacher_tpu.checkpoint.checkpointer).

Equivalent of DetectionTSCheckpointer over EnsembleTSModel (reference:
ubteacher/checkpoint/detection_checkpoint.py:10-89,
modeling/meta_arch/ts_ensemble.py:6-16): one checkpoint holds whatever the
trainer hands over (student, teacher, optimizer state, step, the strong
augmentation generator's state), one file per step under
OUTPUT_DIR/checkpoints/<step>, the newest `max_to_keep` kept. A file is
written under a temporary name and renamed into place, so a run cut while
saving leaves no partial checkpoint. Under data parallelism rank 0 writes
and every rank waits for it at a barrier, so a resume on any rank finds the
file; every rank then loads the same file. Pretrained weights load into the
student through checkpoint/torch_weights.py.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch

from ..parallel import barrier, is_main_process


class TSCheckpointer:
    def __init__(self, output_dir: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def save(self, step: int, state: Dict[str, Any]) -> str:
        """Rank 0 writes `state` as step `step` (the others' states are the
        same); every rank returns after the file is in place."""
        path = self._path(step)
        if is_main_process():
            tmp = os.path.join(self.directory, f".{step}.tmp")
            torch.save(state, tmp)
            os.replace(tmp, path)
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        barrier()
        return path

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def load(self, step: int) -> Dict[str, Any]:
        """The checkpoint of `step`, its tensors on the CPU (the trainer
        copies them into its modules). It is a pickle this program wrote."""
        return torch.load(self._path(step), map_location="cpu", weights_only=False)

    def resume_or_load(self, resume: bool) -> Optional[Dict[str, Any]]:
        """The newest checkpoint when `resume` and one exists, else None
        (the caller keeps its freshly built or pretrained state)."""
        if resume:
            step = self.latest_step()
            if step is not None:
                return self.load(step)
        return None

    def wait_until_finished(self) -> None:
        """Saves are synchronous; kept for the JAX checkpointer's interface."""
