"""Reporting utilities (``JAX: eval/report.py``).

  * per-feature distribution plots, fake vs genuine users — the
    seaborn-KDE charts of the reference's version_1/plot_chart.py:136-160,
    here as matplotlib KDE curves with a headless backend (``train-cred
    --plots``);
  * :class:`MetricLogger`, the JSONL stream that ``fit`` writes to
    ``OUT/metrics.jsonl`` beside the human-format epoch lines.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..data.features import UserFeatures


def _gaussian_kde(x: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Minimal Scott's-rule Gaussian KDE (no scipy dependency)."""
    x = x[np.isfinite(x)]
    if x.size < 2 or x.std() == 0:
        return np.zeros_like(grid)
    h = x.std() * x.size ** (-1 / 5) + 1e-12
    z = (grid[:, None] - x[None, :]) / h
    return np.exp(-0.5 * z * z).sum(1) / (x.size * h * np.sqrt(2 * np.pi))


def plot_feature_distributions(features: UserFeatures, out_dir,
                               keys: Optional[Sequence[str]] = None) -> list:
    """One PNG per feature, fake vs genuine density (plot_chart.py:136-160).
    Returns the written paths.  Requires matplotlib, imported here; raises
    ImportError without it."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    y = features.labels.label
    keys = list(keys or features.keys)
    paths = []
    for k, key in enumerate(features.keys):
        if key not in keys:
            continue
        col = features.values[:, k]
        fake = col[y == 0]
        genuine = col[y == 1]
        lo = np.nanmin(col) if np.isfinite(col).any() else 0.0
        hi = np.nanmax(col) if np.isfinite(col).any() else 1.0
        grid = np.linspace(lo, hi if hi > lo else lo + 1.0, 200)
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(grid, _gaussian_kde(genuine, grid), label="genuine")
        ax.plot(grid, _gaussian_kde(fake, grid), label="fake")
        ax.set_title(f"{key} distribution")
        ax.set_xlabel(key)
        ax.set_ylabel("density")
        ax.legend()
        p = out / f"dist_{key}.png"
        fig.savefig(p, dpi=100, bbox_inches="tight")
        plt.close(fig)
        paths.append(str(p))
    return paths


class MetricLogger:
    """JSONL metric stream + reference-format stdout lines."""

    def __init__(self, path=None, echo: bool = True):
        self.path = Path(path) if path else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a")
        else:
            self._f = None

    def log(self, record: Dict, human: Optional[str] = None):
        if self._f:
            self._f.write(json.dumps(record, default=float) + "\n")
            self._f.flush()
        if self.echo and human:
            print(human)

    def close(self):
        if self._f:
            self._f.close()
