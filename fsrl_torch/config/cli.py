"""Dataclass-driven command line (port of ``fsrl_tpu/config/cli.py``).

Flags are generated from a config dataclass's fields, ``--config file.yaml``
merges a file's values (flags win, unknown keys are ignored), and the final
config serializes back to yaml next to the checkpoints, so an evaluation can
rebuild the run exactly.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import typing
from typing import Any, Callable, Type, get_args, get_origin


def _parse_value(ftype, raw: str):
    import yaml
    origin = get_origin(ftype)
    if ftype is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if ftype in (int, float, str):
        return ftype(raw)
    if origin in (tuple, list):
        args = get_args(ftype)
        elem = args[0] if args else float
        if elem is Ellipsis:
            elem = float
        vals = [v for v in raw.replace("[", "").replace("]", "")
                .replace("(", "").replace(")", "").split(",") if v.strip()]
        seq = [(_parse_value(elem, v.strip())) for v in vals]
        return tuple(seq) if origin is tuple else seq
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def parse_config(cfg_cls: Type, argv: list[str] | None = None):
    """A ``cfg_cls`` instance from ``--config`` yaml and per-field flags."""
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser(
        description=f"{cfg_cls.__name__} (auto-generated flags)")
    parser.add_argument("--config", type=str, default=None,
                        help="yaml file with field overrides")
    # resolve string annotations (``from __future__ import annotations``
    # makes a field's type a string) to real types; unwrap Optional[X]
    hints = typing.get_type_hints(cfg_cls)
    ftypes: dict[str, Any] = {}
    for f in dataclasses.fields(cfg_cls):
        ftype = hints.get(f.name, f.type)
        if get_origin(ftype) is typing.Union:
            args = [a for a in get_args(ftype) if a is not type(None)]
            if len(args) == 1:
                ftype = args[0]
        ftypes[f.name] = ftype
        parser.add_argument(f"--{f.name}", type=str, default=None,
                            help=f"type {getattr(ftype, '__name__', ftype)}")
    ns = parser.parse_args(argv)

    values: dict[str, Any] = {}
    if ns.config:
        import yaml
        with open(ns.config) as fh:
            file_vals = yaml.safe_load(fh) or {}
        for k, v in file_vals.items():
            if k in ftypes:
                if isinstance(v, list) and get_origin(ftypes[k]) is tuple:
                    v = tuple(v)
                values[k] = v
    for name, ftype in ftypes.items():
        raw = getattr(ns, name)
        if raw is not None:
            values[name] = _parse_value(ftype, raw)
    return cfg_cls(**values)


def cli(cfg_cls: Type) -> Callable:
    """Decorator: ``@cli(TrainCfg)`` above ``def main(cfg)`` gives
    ``main(argv=None)``, which parses the config and calls the function."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(argv: list[str] | None = None):
            return fn(parse_config(cfg_cls, argv))

        return wrapper

    return deco


def asdict(cfg) -> dict:
    """Recursively convert a (possibly nested) config dataclass to a dict."""
    return dataclasses.asdict(cfg)
