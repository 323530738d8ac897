"""Experiment utilities (port of ``fsrl_tpu/utils/exp_util.py``): seeding,
automatic run names and reloading a run's config and checkpoint."""

from __future__ import annotations

import dataclasses
import os.path as osp
import random
import uuid

import numpy as np
import torch


def seed_all(seed: int = 1029) -> None:
    """Seed Python, numpy and torch's global generators. The port's own
    draws come from explicit ``torch.Generator`` objects."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


DEFAULT_SKIP_KEYS = {
    "task", "logdir", "project", "group", "name", "prefix", "suffix",
    "verbose", "use_default_cfg", "save_interval", "episode_per_test",
    "reward_threshold",
}


def _abbr(name: str) -> str:
    return "_".join(p[:4] for p in name.split("_"))


def auto_name(default_cfg, cfg, prefix: str = "", suffix: str = "",
              skip_keys=DEFAULT_SKIP_KEYS) -> str:
    """Experiment name: the fields of ``cfg`` that differ from
    ``default_cfg``, abbreviated, plus a short random token."""
    d0 = dataclasses.asdict(default_cfg)
    d1 = dataclasses.asdict(cfg)
    diffs = []
    for k in sorted(d1):
        if k in skip_keys:
            continue
        if d0.get(k) != d1[k]:
            diffs.append(f"{_abbr(k)}{str(d1[k]).replace(' ', '')}")
    name = "-".join(p for p in [prefix] + diffs if p)
    token = uuid.uuid4().hex[:4]
    name = f"{name}-{token}" if name else token
    if suffix:
        name = f"{name}-{suffix}"
    return name


def load_config_and_model(path: str, best: bool = False,
                          target=None) -> tuple[dict, object]:
    """Reload ``config.yaml`` and the checkpoint (``model.pt`` or
    ``model_best.pt``) of a run directory."""
    import yaml

    from fsrl_torch.utils.checkpoint import load_checkpoint
    with open(osp.join(path, "config.yaml")) as f:
        config = yaml.safe_load(f)
    name = "model_best.pt" if best else "model.pt"
    state = load_checkpoint(osp.join(path, "checkpoint", name), target)
    return config, state
