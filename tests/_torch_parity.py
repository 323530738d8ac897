"""Helpers for the parity tests between ``fsrl_tpu`` (JAX) and its PyTorch
port ``fsrl_torch``: data crosses between the two as numpy arrays."""

import dataclasses

import jax
import numpy as np
import torch

from fsrl_torch.envs.base import EnvState
from fsrl_torch.types import Transition
from fsrl_torch.utils.params import from_jax_params


def t(x) -> torch.Tensor:
    """JAX or numpy array → CPU tensor of the same dtype (bool stays
    bool, floats become float32)."""
    a = np.asarray(jax.device_get(x))
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def env_state(js) -> EnvState:
    """A batched JAX env state → the port's ``EnvState``."""
    sim = {f.name: t(getattr(js.sim, f.name))
           for f in dataclasses.fields(js.sim)}
    return EnvState(sim=sim, obs=t(js.obs), t=t(js.t))


def transition(jt) -> Transition:
    return Transition(**{f.name: t(getattr(jt, f.name))
                         for f in dataclasses.fields(jt)})


def state_dict(params) -> dict:
    """Flax ``{"actor", "critics"}`` params → the port's state dict."""
    return from_jax_params(jax.device_get(params))
