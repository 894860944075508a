"""Config system of the port.

Port of `taseg_tpu/utils/config.py` (reference
`tools/utils/train/config.py:15-84`): top-level MODALITY / DATA / MODEL /
OPTIM blocks over an attribute-dict, `_BASE_CONFIG_` inheritance and
dotted-path `--set KEY.SUBKEY value` overrides.  The port reads no YAML
(the machine with the card has no YAML parser guaranteed): `load_config`
and `_BASE_CONFIG_` resolve a recipe's path, relative to the repository,
through the registry `configs.RECIPES`, whose entries a test holds equal
to their YAML files.
"""

from __future__ import annotations

import ast
import copy
from pathlib import Path

from ..configs import RECIPES

REPO = Path(__file__).resolve().parents[2]


class Config(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj


def _recipe(path) -> dict:
    """A deep copy of the registered recipe at `path` (relative to the
    repository, or absolute inside it)."""
    p = Path(path)
    if p.is_absolute():
        try:
            p = p.resolve().relative_to(REPO)
        except ValueError:
            pass
    key = p.as_posix()
    if key.startswith("./"):
        key = key[2:]
    if key not in RECIPES:
        raise KeyError(
            f"no recipe registered for {path}; the port serves "
            f"{sorted(RECIPES)} (taseg_tpu_torch/configs.py)"
        )
    return copy.deepcopy(RECIPES[key])


def _merge(base: dict, new: dict) -> dict:
    """Recursive merge; `new` wins.  Handles nested `_BASE_CONFIG_`."""
    if "_BASE_CONFIG_" in new:
        base = _merge(base, _recipe(new.pop("_BASE_CONFIG_")))
    out = dict(base)
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path) -> Config:
    cfg = Config.wrap(_merge({}, _recipe(path)))
    cfg.TAG = Path(path).stem
    return cfg


def _parse_value(s: str):
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def apply_overrides(cfg: Config, kv_list) -> Config:
    """Apply ['KEY.SUB', 'value', ...] pairs (reference `cfg_from_list`,
    config.py:15-47)."""
    assert len(kv_list) % 2 == 0, "--set expects KEY VALUE pairs"
    for key, raw in zip(kv_list[0::2], kv_list[1::2]):
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            if p not in node:
                node[p] = Config()
            node = node[p]
        leaf = parts[-1]
        val = _parse_value(raw)
        if leaf in node and node[leaf] is not None and not isinstance(
            node[leaf], (dict, list)
        ):
            val = type(node[leaf])(val) if not isinstance(val, bool) else val
        node[leaf] = val
    return cfg
