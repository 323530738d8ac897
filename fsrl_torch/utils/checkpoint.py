"""Checkpointing: the whole training state in one file (port of
``fsrl_tpu/utils/checkpoint.py``).

The file is ``torch.save`` of a nested dict of CPU tensors addressed by
field name: a state dataclass becomes ``{field: ...}``, a module its
``state_dict``, a tensor a CPU copy. Restoring copies the tensors by name
into a target state of the same structure, in place, so the parameters stay
views of the state's flat vector.

* Fields the file predates keep the target's values (forward migration).
* A name the target does not have, or a shape that differs, raises.

This is the port's own format: it does not read the JAX package's orbax
checkpoints.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
from torch import nn

# the flat vector aliases the module's parameters, which are saved by name
_ALIASES = ("flat",)


def to_state_dict(state: Any) -> Any:
    """Nested dict of CPU tensors, addressed by field name."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().clone()
    if isinstance(state, nn.Module):
        return {k: to_state_dict(v) for k, v in state.state_dict().items()}
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return {f.name: to_state_dict(getattr(state, f.name))
                for f in dataclasses.fields(state)
                if f.name not in _ALIASES}
    raise TypeError(f"cannot checkpoint a {type(state).__name__}")


def save_checkpoint(path: str, state: Any) -> None:
    """Write ``state`` (a training state dataclass) to the file ``path``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(to_state_dict(state), tmp)
    os.replace(tmp, path)


def _restore(target: Any, saved: Any, where: str) -> None:
    """Copy ``saved`` into ``target`` by name, in place."""
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or \
                saved.shape != target.shape:
            got = tuple(saved.shape) if isinstance(saved, torch.Tensor) \
                else type(saved).__name__
            raise ValueError(f"checkpoint mismatch at {where}: target "
                             f"{tuple(target.shape)}, file {got}")
        with torch.no_grad():
            target.copy_(saved)
        return
    if isinstance(target, nn.Module):
        children = dict(target.state_dict(keep_vars=True))
    else:
        children = {f.name: getattr(target, f.name)
                    for f in dataclasses.fields(target)
                    if f.name not in _ALIASES}
    if not isinstance(saved, dict):
        raise ValueError(f"checkpoint mismatch at {where}: the file holds a "
                         f"{type(saved).__name__}, not a dict")
    unknown = sorted(set(saved) - set(children))
    if unknown:
        raise ValueError(f"checkpoint mismatch at {where}: the target has "
                         f"no {unknown}")
    for name, child in children.items():
        if name in saved:     # a field the file predates keeps its value
            _restore(child, saved[name], f"{where}.{name}")


def load_checkpoint(path: str, target: Any = None) -> Any:
    """Read a checkpoint. With ``target`` (a matching training state, e.g.
    ``algo.init()``) the tensors are copied into it by name and it is
    returned; without, the nested dict is returned."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    if target is None:
        return saved
    _restore(target, saved, "state")
    return target
