"""Narrow range models for the port's tests.

The recipes build SalsaNext and RangeNet at their full widths, and
`build_segmentor` reads no width key.  Inside `narrow_range_models(...)`
the engine's `Segmenter` / `Trainer` and `init_params_numpy` build the
range models named in its arguments with those keyword arguments
instead, e.g. `narrow_range_models(SalsaNext={"base": 8})`; other names
as `build_segmentor` builds them.
"""

from __future__ import annotations

import contextlib

import pytest

from taseg_tpu_torch import engine
from taseg_tpu_torch.models import RANGE_SEGMENTORS, build_segmentor
from taseg_tpu_torch.utils import params_from_jax


@contextlib.contextmanager
def narrow_range_models(**widths):
    """Yields the builder, `build_segmentor`'s signature."""

    def build(cfg: dict, device=None, compute_dtype: str = None):
        m = cfg["MODEL"]
        kw = widths.get(m["NAME"])
        if kw is None:
            return build_segmentor(cfg, device=device, compute_dtype=compute_dtype)
        return RANGE_SEGMENTORS[m["NAME"]](
            num_classes=m["NUM_CLASS"], in_channels=m.get("IN_FEATURE_DIM", 6), device=device, **kw
        )

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "build_segmentor", build)
        mp.setattr(params_from_jax, "build_segmentor", build)
        yield build
