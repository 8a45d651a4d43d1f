"""Run logging: stdout always, wandb when available and enabled, a
metrics.jsonl in the log directory, timing-split summaries.

A copy of `rag_docvqa_tpu/training/logger.py`, which imports no jax itself
but cannot be imported without it: the JAX `training/__init__.py` imports
jax and optax."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class RunLogger:
    def __init__(
        self,
        project: str = "rag-docvqa-tpu",
        name: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        use_wandb: bool = False,
        log_dir: Optional[str] = None,
    ):
        self.start = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=name, config=config or {})
            except Exception as e:  # wandb not baked in; degrade to stdout
                print(f"wandb unavailable ({e}); logging to stdout only")
        self._file = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if config:
            print("Config:", json.dumps({k: str(v) for k, v in config.items()}, indent=2))

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        line = dict(metrics)
        line["wall_time"] = round(time.time() - self.start, 2)
        print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in line.items()))
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._file is not None:
            self._file.write(json.dumps(line, default=str) + "\n")
            self._file.flush()

    def log_timing_split(self, timing: Dict[str, float]) -> None:
        """Percent breakdown like eval.py:104-112."""
        total = sum(timing.values()) or 1.0
        pct = {f"{k}_pct": round(100 * v / total, 1) for k, v in timing.items()}
        self.log({**{k: round(v, 2) for k, v in timing.items()}, **pct})

    def log_media(
        self,
        timing: Optional[Dict[str, float]] = None,
        label_dist: Optional[Dict[str, float]] = None,
        media_dir: Optional[str] = None,
    ) -> None:
        """Time pie + layout-label spider charts (reference logger.py:136-179
        wandb media). Gated on matplotlib; PNGs land in media_dir (or the
        log dir) and are logged to wandb when active."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            import numpy as np
        except Exception:
            return
        out_dir = media_dir or (os.path.dirname(self._file.name) if self._file else None)
        if out_dir is None:
            return
        os.makedirs(out_dir, exist_ok=True)
        images = {}
        if timing:
            fig, ax = plt.subplots()
            keys = [k for k, v in timing.items() if v > 0]
            ax.pie([timing[k] for k in keys], labels=keys, autopct="%1.1f%%")
            ax.set_title("time distribution")
            path = os.path.join(out_dir, "time_pie.png")
            fig.savefig(path, bbox_inches="tight")
            plt.close(fig)
            images["time_pie"] = path
        if label_dist:
            keys = list(label_dist)
            vals = np.asarray([label_dist[k] for k in keys], float)
            angles = np.linspace(0, 2 * np.pi, len(keys), endpoint=False)
            fig, ax = plt.subplots(subplot_kw={"projection": "polar"})
            ax.plot(np.concatenate([angles, angles[:1]]), np.concatenate([vals, vals[:1]]))
            ax.fill(np.concatenate([angles, angles[:1]]), np.concatenate([vals, vals[:1]]), alpha=0.25)
            ax.set_xticks(angles)
            ax.set_xticklabels(keys)
            ax.set_title("top-k layout label distribution")
            path = os.path.join(out_dir, "layout_spider.png")
            fig.savefig(path, bbox_inches="tight")
            plt.close(fig)
            images["layout_spider"] = path
        if self._wandb is not None and images:
            import wandb

            self._wandb.log({k: wandb.Image(p) for k, p in images.items()})

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._file is not None:
            self._file.close()
