"""The weight bridge between the JAX package's flax parameter trees and the
port's modules, and the flat parameter vector.

This is the one place where layouts are converted:

* a flax ``Dense`` kernel is ``(in, out)``; the port's weight is ``(out, in)``;
* the critic ensemble is stacked under
  ``critics/params/Vmap_VHead_0/MLP_0/Dense_{i}`` with a leading K axis:
  kernels ``(K, in, out)`` become ``critics.w.{i}`` of shape ``(K, out, in)``,
  biases ``(K, out)`` stay ``critics.b.{i}``;
* the actor is ``actor/params/MLP_0/Dense_{i}`` (trunk), ``Dense_0`` (mean
  head) and a free ``log_sigma``;
* the off-policy Q-critic ensemble sits under
  ``critics/params/VmapVmap_QHead_0/MLP_0/Dense_{i}`` with leading (M, Q)
  axes: kernels ``(M, Q, in, out)`` become ``critics.w.{i}`` of shape
  ``(M, Q, out, in)``, biases ``(M, Q, out)`` stay ``critics.b.{i}``;
* the SAC / CVPO actor has a second head ``Dense_1`` (log-sigma,
  ``actor.sigma``) instead of ``log_sigma``; the DDPG actor has only
  ``Dense_0``.
* the recurrent actor's ``GRUCell_0`` has six denses, ``i{r,z,n}`` on the
  input with biases and ``h{r,z,n}`` on the carry, of which only ``hn`` has
  one: their kernels ``(in, H)`` are stacked in the gate order (r, z, n)
  into ``actor.cell.weight_ih`` (3H, in) and ``weight_hh`` (3H, H), the
  input biases into ``bias_ih`` (3H), and ``hn``'s bias is
  ``actor.cell.bias_hn``.

Either half of a tree may be missing (a target critic, an old actor): the
state dict then holds the other half only.

Both directions work on numpy arrays, so the bridge needs neither JAX nor
flax: the tests hand it ``jax.device_get(params)``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


_CRITIC_KEYS = ("Vmap_VHead_0", "VmapVmap_QHead_0")


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """Flax ``{"actor": ..., "critics": ...}`` tree (numpy leaves) → the
    state dict of :class:`fsrl_torch.nets.mlp.ActorCritic` or
    :class:`fsrl_torch.nets.mlp.ActorQCritic`."""
    out: dict[str, torch.Tensor] = {}
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    if "actor" in tree:
        ap = tree["actor"]["params"]
        trunk = ap.get("MLP_0", {})
        if "GRUCell_0" in ap:
            cell = ap["GRUCell_0"]
            out["actor.cell.weight_ih"] = torch.cat(
                [t(cell[f"i{g}"]["kernel"]).T for g in "rzn"]).contiguous()
            out["actor.cell.weight_hh"] = torch.cat(
                [t(cell[f"h{g}"]["kernel"]).T for g in "rzn"]).contiguous()
            out["actor.cell.bias_ih"] = torch.cat(
                [t(cell[f"i{g}"]["bias"]) for g in "rzn"])
            out["actor.cell.bias_hn"] = t(cell["hn"]["bias"])
        for i in range(len(trunk)):
            d = trunk[f"Dense_{i}"]
            out[f"actor.trunk.layers.{i}.weight"] = t(d["kernel"]).T.contiguous()
            out[f"actor.trunk.layers.{i}.bias"] = t(d["bias"])
        heads = {"Dense_0": "mu", "Dense_1": "sigma"}
        for key, name in heads.items():
            if key in ap:
                out[f"actor.{name}.weight"] = t(ap[key]["kernel"]).T.contiguous()
                out[f"actor.{name}.bias"] = t(ap[key]["bias"])
        if "log_sigma" in ap:
            out["actor.log_sigma"] = t(ap["log_sigma"])
    if "critics" in tree:
        ens = tree["critics"]["params"]
        (key,) = [k for k in _CRITIC_KEYS if k in ens]
        cp = ens[key]["MLP_0"]
        for i in range(len(cp)):
            d = cp[f"Dense_{i}"]
            out[f"critics.w.{i}"] = t(d["kernel"]).transpose(-1, -2).contiguous()
            out[f"critics.b.{i}"] = t(d["bias"])
    return out


def to_jax_params(sd: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`from_jax_params`: a state dict (or gradient dict of
    the same names) → the flax tree layout, numpy leaves."""
    n = lambda x: x.detach().cpu().float().numpy()
    out = {}
    if "actor.mu.weight" in sd:
        n_trunk = sum(1 for k in sd if k.startswith("actor.trunk.layers.")
                      and k.endswith(".weight"))
        trunk = {f"Dense_{i}": {
            "kernel": n(sd[f"actor.trunk.layers.{i}.weight"]).T,
            "bias": n(sd[f"actor.trunk.layers.{i}.bias"])}
            for i in range(n_trunk)}
        actor = {"MLP_0": trunk}
        for key, name in (("Dense_0", "mu"), ("Dense_1", "sigma")):
            if f"actor.{name}.weight" in sd:
                actor[key] = {"kernel": n(sd[f"actor.{name}.weight"]).T,
                              "bias": n(sd[f"actor.{name}.bias"])}
        if "actor.log_sigma" in sd:
            actor["log_sigma"] = n(sd["actor.log_sigma"])
        out["actor"] = {"params": actor}
    n_crit = sum(1 for k in sd if k.startswith("critics.w."))
    if n_crit:
        crit = {f"Dense_{i}": {
            "kernel": np.swapaxes(n(sd[f"critics.w.{i}"]), -1, -2),
            "bias": n(sd[f"critics.b.{i}"])} for i in range(n_crit)}
        key = _CRITIC_KEYS[sd["critics.w.0"].dim() == 4]
        out["critics"] = {"params": {key: {"MLP_0": crit}}}
    return out


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
