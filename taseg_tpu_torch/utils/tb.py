"""Metrics writer: TensorBoard when available, JSONL always; copy of
`taseg_tpu/utils/tb.py`.

Counterpart of the reference's rank-0 SummaryWriter usage
(`train.py:315, 396-397, 441-445, 581-585`): per-iter loss/LR scalars and
per-epoch per-class IoU.  A JSONL mirror is always written so metrics
survive without TensorBoard tooling.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsWriter:
    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(str(self.log_dir / "tensorboard"))
        except Exception:  # tensorboard optional
            self._tb = None

    def scalar(self, tag: str, value: float, step: int):
        rec = {"t": time.time(), "tag": tag, "value": float(value), "step": step}
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def scalars(self, values: dict, step: int, prefix: str = ""):
        for k, v in values.items():
            self.scalar(f"{prefix}{k}", v, step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
