"""Checkpoints of the train state: parameters, optimizer state and step,
keeping the best few.

Counterpart of `rag_docvqa_tpu/training/checkpoint.py`, with torch state
dicts in files `step_<n>.pt` where the JAX package has Orbax. As its Orbax
manager, it keeps `max_to_keep` checkpoints ranked by accuracy + 1e-6 *
ANLS (ANLS breaks accuracy ties; a tie on both keeps the later step), and
`restore` reads the latest step unless told another.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from rag_docvqa_tpu_torch.training.train_step import TrainState


def _score(metrics: Dict[str, float]) -> float:
    return metrics.get("accuracy", 0.0) + 1e-6 * metrics.get("anls", 0.0)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._index_path = os.path.join(self.directory, "checkpoints.json")
        self._index: Dict[str, Dict[str, float]] = {}  # str(step) -> metrics
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state: TrainState, metrics: Optional[dict] = None) -> None:
        torch.save({"params": state.params.state_dict(), "opt_state": state.opt_state, "step": state.step},
                   self._path(step))
        self._index[str(step)] = {k: float(v) for k, v in (metrics or {}).items()}
        ranked = sorted(self._index, key=lambda s: (_score(self._index[s]), int(s)), reverse=True)
        for s in ranked[self.max_to_keep:]:
            os.remove(self._path(int(s)))
            del self._index[s]
        with open(self._index_path, "w") as f:
            json.dump(self._index, f)

    def _load(self, step: Optional[int], device) -> dict:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return torch.load(self._path(step), map_location=device, weights_only=True)

    def restore(self, state_like: TrainState, step: Optional[int] = None) -> TrainState:
        """Loads into `state_like`'s parameter module (in place) and returns
        the restored state; the latest step unless `step` is given."""
        blob = self._load(step, next(state_like.params.parameters()).device)
        state_like.params.load_state_dict(blob["params"])
        return TrainState(params=state_like.params, opt_state=blob["opt_state"], step=blob["step"])

    def restore_params(self, params_like, step: Optional[int] = None):
        """Only the parameters, into `params_like` (in place)."""
        params_like.load_state_dict(self._load(step, next(params_like.parameters()).device)["params"])
        return params_like

    def best_step(self) -> Optional[int]:
        if not self._index:
            return None
        return int(max(self._index, key=lambda s: (_score(self._index[s]), int(s))))

    def latest_step(self) -> Optional[int]:
        return max((int(s) for s in self._index), default=None)
