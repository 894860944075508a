"""Logging, timing meters, and small utilities; copy of
`taseg_tpu/utils/common.py`.

Counterparts of the reference's `common_utils.create_logger`
(common_utils.py:82-96) and `AverageMeter` (:251-267), and the three-way
d_time/f_time/b_time step timing of train.py:372-435.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path


def create_logger(log_file=None, name: str = "taseg_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    # re-point handlers each call: repeated in-process runs (staged
    # recipes, tests) must log to THEIR output dir, not the first one's
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class StepTimer:
    """data / forward+backward / total wall-clock split per step."""

    def __init__(self):
        self.d_time = AverageMeter()
        self.f_time = AverageMeter()
        self.b_time = AverageMeter()
        self._t0 = time.perf_counter()

    def data_done(self):
        now = time.perf_counter()
        self.d_time.update(now - self._t0)
        self._t1 = now

    def step_done(self):
        now = time.perf_counter()
        self.f_time.update(now - self._t1)
        self.b_time.update(now - self._t0)
        self._t0 = now
