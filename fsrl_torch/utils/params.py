"""The weight bridge between the JAX package's flax parameter trees and the
port's modules, and the flat parameter vector.

This is the one place where layouts are converted:

* a flax ``Dense`` kernel is ``(in, out)``; the port's weight is ``(out, in)``;
* the critic ensemble is stacked under
  ``critics/params/Vmap_VHead_0/MLP_0/Dense_{i}`` with a leading K axis:
  kernels ``(K, in, out)`` become ``critics.w.{i}`` of shape ``(K, out, in)``,
  biases ``(K, out)`` stay ``critics.b.{i}``;
* the actor is ``actor/params/MLP_0/Dense_{i}`` (trunk), ``Dense_0`` (mean
  head) and a free ``log_sigma``.

Both directions work on numpy arrays, so the bridge needs neither JAX nor
flax: the tests hand it ``jax.device_get(params)``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """Flax ``{"actor": ..., "critics": ...}`` tree (numpy leaves) → the
    state dict of :class:`fsrl_torch.nets.mlp.ActorCritic`."""
    out: dict[str, torch.Tensor] = {}
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    ap = tree["actor"]["params"]
    trunk = ap["MLP_0"]
    for i in range(len(trunk)):
        d = trunk[f"Dense_{i}"]
        out[f"actor.trunk.layers.{i}.weight"] = t(d["kernel"]).T.contiguous()
        out[f"actor.trunk.layers.{i}.bias"] = t(d["bias"])
    out["actor.mu.weight"] = t(ap["Dense_0"]["kernel"]).T.contiguous()
    out["actor.mu.bias"] = t(ap["Dense_0"]["bias"])
    out["actor.log_sigma"] = t(ap["log_sigma"])
    cp = tree["critics"]["params"]["Vmap_VHead_0"]["MLP_0"]
    for i in range(len(cp)):
        d = cp[f"Dense_{i}"]
        out[f"critics.w.{i}"] = t(d["kernel"]).transpose(1, 2).contiguous()
        out[f"critics.b.{i}"] = t(d["bias"])
    return out


def to_jax_params(sd: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`from_jax_params`: a state dict (or gradient dict of
    the same names) → the flax tree layout, numpy leaves."""
    n = lambda x: x.detach().cpu().float().numpy()
    n_trunk = sum(1 for k in sd if k.startswith("actor.trunk.layers.")
                  and k.endswith(".weight"))
    n_crit = sum(1 for k in sd if k.startswith("critics.w."))
    trunk = {f"Dense_{i}": {
        "kernel": n(sd[f"actor.trunk.layers.{i}.weight"]).T,
        "bias": n(sd[f"actor.trunk.layers.{i}.bias"])} for i in range(n_trunk)}
    actor = {"params": {
        "MLP_0": trunk,
        "Dense_0": {"kernel": n(sd["actor.mu.weight"]).T,
                    "bias": n(sd["actor.mu.bias"])},
        "log_sigma": n(sd["actor.log_sigma"])}}
    crit = {f"Dense_{i}": {
        "kernel": n(sd[f"critics.w.{i}"]).transpose(0, 2, 1),
        "bias": n(sd[f"critics.b.{i}"])} for i in range(n_crit)}
    return {"actor": actor,
            "critics": {"params": {"Vmap_VHead_0": {"MLP_0": crit}}}}


def flatten_parameters_(module: nn.Module,
                        names: list[str]) -> torch.Tensor:
    """Move the named parameters of ``module`` into one contiguous float32
    vector, in ``names`` order, and make each parameter a view of it.
    In-place updates of the returned vector update the module."""
    params = dict(module.named_parameters())
    if sorted(names) != sorted(params):
        raise ValueError(f"flat layout {names} does not cover {list(params)}")
    flat = torch.cat([params[k].detach().reshape(-1) for k in names])
    off = 0
    for k in names:
        p = params[k]
        p.data = flat[off: off + p.numel()].view_as(p)
        off += p.numel()
    return flat


def unflatten(flat: torch.Tensor, module: nn.Module,
              names: list[str]) -> dict[str, torch.Tensor]:
    """Views of ``flat`` with the shapes of ``module``'s named parameters."""
    params = dict(module.named_parameters())
    out, off = {}, 0
    for k in names:
        shape = params[k].shape
        n = params[k].numel()
        out[k] = flat[off: off + n].view(shape)
        off += n
    return out
