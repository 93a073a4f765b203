"""Reporting: the structured JSONL metric stream (``JAX: eval/report.py``).

Only :class:`MetricLogger` so far: the JSONL stream that ``fit`` writes to
``OUT/metrics.jsonl`` beside the human-format epoch lines.  The feature
distribution plots come with Stage A.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional


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
