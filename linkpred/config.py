"""Unified configuration tree with CLI overrides.

The reference scatters configuration across four mechanisms (SURVEY.md §5):
a path-constants module (`constant.py`), argparse CLIs, hard-coded
hyperparameter literals, and an Optuna space in code. Here everything is one
nested frozen-dataclass tree with dotted-path CLI overrides:

    python -m linkpred.cli twowl --set twowl.epochs=500 --set seed=7

Any dataclass field can be overridden; values are parsed with the field's
type (bools accept true/false/1/0).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from linkpred.models.word2vec import SGNSConfig
from linkpred.pipelines.logistic_pipeline import LogisticConfig
from linkpred.pipelines.seal_pipeline import SEALConfig
from linkpred.pipelines.twowl_pipeline import TwoWLRunConfig


@dataclasses.dataclass(frozen=True)
class Paths:
    """Central path registry (the reference's `constant.py:1-10`)."""

    data_dir: str | None = None  # None -> auto-discover (repo, then reference)
    records_dir: str = "records_auc"
    checkpoints_dir: str = "checkpoints"
    assets_dir: str = "assets/img"
    metrics_log: str = "logs/metrics.jsonl"
    hpo_log: str = "logs.json"


@dataclasses.dataclass(frozen=True)
class Config:
    seed: int = 0
    paths: Paths = Paths()
    logistic: LogisticConfig = LogisticConfig()
    seal: SEALConfig = SEALConfig()
    twowl: TwoWLRunConfig = TwoWLRunConfig()
    twowl_trials: int = 10


def _parse_value(raw: str, typ: Any):
    if typ is bool or str(typ) == "bool":
        return raw.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    try:  # typing unions like `str | int`
        return int(raw)
    except (TypeError, ValueError):
        pass
    try:
        return float(raw)
    except (TypeError, ValueError):
        pass
    return raw


def apply_overrides(cfg: Any, overrides: list[str]) -> Any:
    """Apply `a.b.c=value` overrides to a frozen-dataclass tree, returning a
    new tree."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        path, raw = ov.split("=", 1)
        cfg = _set_path(cfg, path.split("."), raw)
    return cfg


def _set_path(node: Any, keys: list[str], raw: str) -> Any:
    if not dataclasses.is_dataclass(node):
        raise ValueError(f"cannot descend into non-dataclass at {keys}")
    name = keys[0]
    fields = {f.name: f for f in dataclasses.fields(node)}
    if name not in fields:
        raise ValueError(
            f"unknown config field {name!r}; valid: {sorted(fields)}"
        )
    cur = getattr(node, name)
    if len(keys) == 1:
        typ = type(cur) if cur is not None else fields[name].type
        value = _parse_value(raw, typ)
    else:
        value = _set_path(cur, keys[1:], raw)
    return dataclasses.replace(node, **{name: value})
