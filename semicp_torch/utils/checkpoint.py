"""Checkpoint / resume for SLAM state.

Port of `semicp/utils/checkpoint.py` with `torch.save` in place of orbax:
one file a step, `step_<n>.pt`, of CPU tensors nested in dicts, read back
with `torch.load(weights_only=True)`. The state is run_slam's
dict of numpy arrays (cli/run_slam.py `_capture_state`); it comes back as
numpy arrays. These files and the JAX package's orbax directories cannot
read each other.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np
import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _to_tensors(state):
    if isinstance(state, dict):
        return {k: _to_tensors(v) for k, v in state.items()}
    return torch.from_numpy(np.array(state))


def _to_numpy(state):
    if isinstance(state, dict):
        return {k: _to_numpy(v) for k, v in state.items()}
    return state.numpy()


def save_checkpoint(path: str | Path, state: dict, step: int) -> None:
    """Write `state` (nested dicts of arrays) as step `step` under `path`;
    the file appears whole or not at all (written aside, then renamed)."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f".step_{step}.pt.tmp"
    torch.save(_to_tensors(state), tmp)
    os.replace(tmp, path / f"step_{step}.pt")


def latest_checkpoint(path: str | Path):
    """Return (step, state) of the newest checkpoint, or (None, None)."""
    path = Path(path).absolute()
    if not path.exists():
        return None, None
    steps = [int(m.group(1)) for f in path.iterdir() if (m := _NAME.match(f.name))]
    if not steps:
        return None, None
    step = max(steps)
    state = torch.load(path / f"step_{step}.pt", map_location="cpu", weights_only=True)
    return step, _to_numpy(state)
