"""Experiment logging: a run-scoped JSONL logger with ``log_training`` /
``log_eval``, the wandb logger of the training commands (which falls back
to the JSONL one where wandb is missing or cannot start), a tqdm-safe
logging handler, and the CSV and heatmap side files of the evaluation and
tuning commands."""

from __future__ import annotations

import csv
import json
import logging
import os
import time
from typing import Any, Mapping


class JSONLLogger:
    """Append-only JSONL metric log + optional CSV mirror."""

    def __init__(self, log_dir: str, run_name: str = "run"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.jsonl")
        self.run_name = run_name

    def log(self, record: Mapping[str, Any]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"ts": time.time(), **record}) + "\n")

    def log_training(self, epoch: int, steps_per_epoch: int, step: int, lr: float, loss: float, loss_name: str = "loss") -> None:
        self.log(
            {"kind": "train", "epoch": epoch, "step": step, "lr": lr, loss_name: loss}
        )

    def log_eval(self, epoch: int, step: int, metric: str, value: float) -> None:
        self.log({"kind": "eval", "epoch": epoch, "step": step, "metric": metric, "value": value})


class WandbLogger:
    """A wandb run with ``log_training`` / ``log_eval``; where wandb is not
    installed or its run cannot start, the same calls go to a
    ``JSONLLogger`` under ``log_dir``."""

    def __init__(self, project_name: str, run_name: str, run_config=None, log_dir: str = "logs"):
        self.backend = None
        try:  # pragma: no cover - wandb is not installed here
            import wandb

            self.backend = wandb.init(project=project_name, name=run_name, config=run_config, dir=log_dir)
        except Exception:  # noqa: BLE001 - any failure to start a run falls back to the local log
            self.fallback = JSONLLogger(log_dir, run_name)

    def log_training(self, epoch, steps_per_epoch, step, lr, loss, loss_name="loss"):
        if self.backend is not None:  # pragma: no cover
            self.backend.log({"train/lr": lr, f"train/{loss_name}": loss}, step=step)
        else:
            self.fallback.log_training(epoch, steps_per_epoch, step, lr, loss, loss_name)

    def log_eval(self, epoch, step, metric, value):
        if self.backend is not None:  # pragma: no cover
            self.backend.log({metric: value}, step=step)
        else:
            self.fallback.log_eval(epoch, step, metric, value)

    def finish(self):
        if self.backend is not None:  # pragma: no cover
            self.backend.finish()


class LoggingHandler(logging.Handler):
    """tqdm-safe console handler."""

    def emit(self, record):
        try:
            from tqdm import tqdm

            tqdm.write(self.format(record))
        except Exception:
            print(self.format(record))


def write_metrics_csv(
    path: str, rows: list[Mapping[str, Any]], append: bool = False
) -> None:
    """CSV side-output of tuning and evaluation grids.  ``append=True`` adds
    rows to an existing file (the header written once)."""
    if not rows:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    keys = list(rows[0].keys())
    exists = append and os.path.isfile(path) and os.path.getsize(path) > 0
    with open(path, "a" if append else "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=keys)
        if not exists:
            writer.writeheader()
        writer.writerows(rows)


def write_tuning_heatmap(
    path: str,
    rows: list,
    metric: str = "recall@100",
    x: str = "b",
    y: str = "k1",
    vmin: float = 40.0,
    vmax: float = 60.0,
) -> None:
    """BM25 tuning heatmap PDF: recall@100 × 100 over the k1 × b grid, the
    color scale pinned to 40–60 (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    xs = sorted({r[x] for r in rows})
    ys = sorted({r[y] for r in rows})
    grid = np.full((len(ys), len(xs)), np.nan)
    for r in rows:
        grid[ys.index(r[y]), xs.index(r[x])] = r[metric] * 100.0
    fig, ax = plt.subplots(figsize=(max(6, len(xs) * 0.6), max(4, len(ys) * 0.35)))
    im = ax.imshow(grid, aspect="auto", cmap="viridis", vmin=vmin, vmax=vmax)
    ax.set_xticks(range(len(xs)), [f"{v:g}" for v in xs])
    ax.set_yticks(range(len(ys)), [f"{v:g}" for v in ys])
    ax.set_xlabel(x)
    ax.set_ylabel(y)
    ax.set_title(f"{metric} × 100")
    fig.colorbar(im, ax=ax)
    for i in range(len(ys)):
        for j in range(len(xs)):
            if np.isfinite(grid[i, j]):
                ax.text(j, i, f"{grid[i, j]:.0f}", ha="center", va="center",
                        fontsize=6, color="white")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, format="pdf", bbox_inches="tight")
    plt.close(fig)
