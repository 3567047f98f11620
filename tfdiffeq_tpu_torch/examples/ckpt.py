"""Checkpoint and resume for the example trainers.

Counterpart of the repository's `examples/ckpt.py` (Orbax there): the
library stays stateless and the example trainers keep their own training
state. A checkpoint is one `torch.save` file a step, `ckpt_<step>.pt` in
`--train_dir`, holding what a trainer needs to resume exactly: its models'
and optimizer's state dicts, the step, and its generators' states. It is
written to a temporary name and renamed, so a run stopped while saving
leaves the previous checkpoint whole, and only the newest `max_to_keep`
(default 2) stay. Files are read back with `weights_only=True`: tensors,
numbers, strings and containers of them.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, List, Optional, Tuple

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


@dataclasses.dataclass(frozen=True)
class CheckpointManager:
    directory: str
    max_to_keep: int = 2

    def steps(self) -> List[int]:
        """The steps of the checkpoints on disk, oldest first."""
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.directory))
                      if m)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step)}.pt")


def make_manager(train_dir: str, max_to_keep: int = 2) -> CheckpointManager:
    """A manager rooted at `train_dir` (created if missing)."""
    path = os.path.abspath(train_dir)
    os.makedirs(path, exist_ok=True)
    return CheckpointManager(path, max_to_keep)


def save(mngr: CheckpointManager, step: int, state: Any) -> None:
    """Save the training state at `step`, then drop all but the newest
    `max_to_keep` checkpoints."""
    final = mngr.path(step)
    tmp = final + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, final)
    for old in mngr.steps()[:-mngr.max_to_keep]:
        os.remove(mngr.path(old))


def restore_latest(mngr: CheckpointManager,
                   state_template: Any = None) -> Tuple[Optional[int], Any]:
    """(step, state) of the newest checkpoint, its tensors on the CPU (the
    trainer's `load_state_dict` calls place them); (None, state_template)
    when there is none."""
    steps = mngr.steps()
    if not steps:
        return None, state_template
    state = torch.load(mngr.path(steps[-1]), map_location="cpu",
                       weights_only=True)
    return steps[-1], state


def finish(mngr: CheckpointManager) -> None:
    """Nothing to wait for: `save` writes synchronously (the reference
    waits for Orbax's asynchronous saves here)."""
