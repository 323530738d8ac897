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


def actor_tree(model, vec, jparams):
    """The port's flat actor vector (or a vector of that layout) → the flax
    actor tree. ``jparams`` lends the critics the bridge wants."""
    from fsrl_torch.utils.params import to_jax_params, unflatten
    sd = state_dict(jparams)
    sd.update({f"actor.{k}": v for k, v in
               unflatten(vec, model.actor, model.actor_names()).items()})
    return jax.tree.map(np.asarray, to_jax_params(sd)["actor"])


def actor_vec(model, tree, jparams):
    """A flax actor tree (or a tree of that structure) → the port's flat
    actor layout."""
    sd = state_dict({"actor": tree, "critics": jparams["critics"]})
    return torch.cat([sd[f"actor.{k}"].reshape(-1)
                      for k in model.actor_names()])


def rollout_transitions(T, N, D, A, M=1, seed=0, p_term=0.03, p_trunc=0.1):
    """Random JAX transitions ``(T, N, ...)`` from a numpy seed."""
    import jax.numpy as jnp

    from fsrl_tpu.types import Transition as JTransition
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    term = rng.random((T, N)) < p_term
    trunc = (rng.random((T, N)) < p_trunc) & ~term
    return JTransition(
        obs=jnp.asarray(f(T, N, D)), act=jnp.asarray(f(T, N, A)),
        obs_next=jnp.asarray(f(T, N, D)), reward=jnp.asarray(f(T, N)),
        cost=jnp.asarray(rng.random((T, N, M)).astype(np.float32)),
        terminated=jnp.asarray(term), truncated=jnp.asarray(trunc),
        logp=jnp.asarray(f(T, N) - 2.0))


def full_vec(model, tree):
    """A flax ``{"actor", "critics"}`` tree (parameters, gradients or Adam
    moments) → the port's flat layout (``model.flat_names()`` order)."""
    sd = state_dict(tree)
    return torch.cat([sd[k].reshape(-1) for k in model.flat_names()])


def adam_state(opt_state):
    """The ``ScaleByAdamState`` inside an optax optimizer state."""
    import optax
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)
    return next(s for s in jax.tree.leaves(opt_state, is_leaf=is_adam)
                if is_adam(s))


def scan_perms(rng, size, n_epochs, n_mb):
    """The tile permutations ``(n_epochs, usable)`` and roll offsets
    ``(n_epochs,)`` that ``fsrl_tpu.types.minibatch_scan`` draws when an
    update splits ``rng`` into one key per epoch (one block)."""
    from fsrl_torch.types import TileLayout
    layout = TileLayout.of(size, n_mb)
    perms, rolls = [], []
    for key in jax.random.split(rng, n_epochs):
        _, k_perm, k_roll = jax.random.split(key, 3)
        if layout.tile_size > 1:     # the block-wise branch splits again
            k_perm = jax.random.split(k_perm, 1)[0]
        perms.append(np.asarray(
            jax.random.permutation(k_perm, layout.n_tiles)[: layout.usable]))
        rolls.append(int(jax.random.randint(k_roll, (), 0, size))
                     if layout.needs_roll else 0)
    return (torch.from_numpy(np.stack(perms)).long(), torch.tensor(rolls),
            layout)
