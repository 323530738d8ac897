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


# ---------------------------------------------------------------------------
# Off-policy parity: one replay buffer on both sides, JAX's draws recreated
# ---------------------------------------------------------------------------

def offpolicy_buffers(D, A, M=1, C=16, N=4, seed=0, segments=(10, 10)):
    """A JAX ring buffer and the port's holding the same random segments
    (the second write wraps around), with terminations and truncations."""
    from fsrl_torch.data.buffer import ReplayBuffer
    from fsrl_tpu.data.buffer import ReplayBuffer as JReplayBuffer
    jbuf, tbuf = JReplayBuffer(C, N), ReplayBuffer(C, N, device="cpu")
    js, ts = jbuf.init(D, A, M), tbuf.init(D, A, M)
    for i, T in enumerate(segments):
        seg = rollout_transitions(T, N, D, A, M=M, seed=seed + i,
                                  p_term=0.05, p_trunc=0.05)
        js = jbuf.add_segment(js, seg)
        ts = tbuf.add_segment(ts, transition(seg))
    return jbuf, js, tbuf, ts


def offpolicy_draws(rng, batch_size, filled, n_envs, act_dim, kind,
                    n_particles=0):
    """The draws a JAX off-policy ``update_step`` makes from ``rng``, for
    the port's ``draws``: rows from ``rng`` and envs from ``fold_in(rng,
    1)`` (``sample_indices``); SAC-Lag's target and actor noise from
    ``split(rng)``; CVPO's target noise and ``n_particles`` particle draws
    from ``split(rng)`` and ``split(rng_p, Kp)``."""
    B = batch_size
    out = dict(
        rows=t(jax.random.randint(rng, (B,), 0, filled)).long(),
        envs=t(jax.random.randint(jax.random.fold_in(rng, 1), (B,), 0,
                                  n_envs)).long())
    normal = lambda k: t(jax.random.normal(k, (B, act_dim)))
    if kind == "sac_lag":
        k_t, k_a = jax.random.split(rng)
        out.update(noise_t=normal(k_t), noise_a=normal(k_a))
    elif kind == "cvpo":
        k_t, k_p = jax.random.split(rng)
        out.update(noise_t=normal(k_t), noise_p=torch.stack(
            [normal(k) for k in jax.random.split(k_p, n_particles)]))
    return out


def module_vec(module, tree, prefix):
    """A flax tree (parameters or Adam moments) of one network → the flat
    layout of the port's ``module`` (parameter order)."""
    sd = from_jax_params({prefix: jax.device_get(tree)})
    return torch.cat([sd[f"{prefix}.{k}"].reshape(-1)
                      for k, _ in module.named_parameters()])


def adam_moments(opt_state):
    """``(count, mu, nu)`` of the Adam state inside an optax state."""
    s = adam_state(opt_state)
    return int(s.count), s.mu, s.nu


def offpolicy_chain(jalgo, talgo, kind, n_steps, M=1, batch_size=64,
                    seed=0):
    """``n_steps`` chained ``update_step``s of a JAX algorithm and its port
    from the same weights on the same replay buffer, with JAX's draws
    injected and a nonzero multiplier. Yields ``(jstate, jmetrics, tstate,
    tmetrics)`` after each step."""
    import jax.numpy as jnp

    from fsrl_torch.algos.offpolicy_base import make_nstep_view
    from fsrl_tpu.algos.offpolicy_base import make_nstep_view as j_view
    D, A = talgo.obs_dim, talgo.act_dim
    jbuf, js, tbuf, ts = offpolicy_buffers(D, A, M, seed=seed)
    lam = np.linspace(0.5, 1.5, M).astype(np.float32)
    jstate = jax.jit(jalgo.init)(jax.random.PRNGKey(seed))
    jstate = jstate.replace(lag=jstate.lag.replace(multiplier=jnp.asarray(lam)))
    tstate = talgo.init(state_dict=state_dict(jstate.params))
    tstate.lag.multiplier = torch.from_numpy(lam)
    jv, tv = j_view(jbuf, js), make_nstep_view(tbuf, ts)
    step = jax.jit(lambda s, k: jalgo.update_step(s, jbuf, js, k, view=jv))
    kp = getattr(talgo, "hp", {}).get("sample_act_num", 0)
    for i in range(n_steps):
        key = jax.random.PRNGKey(100 + i)
        jstate, jm = step(jstate, key)
        draws = offpolicy_draws(key, batch_size, int(js.filled), tbuf.N, A,
                                kind, kp)
        tstate, tm = talgo.update_step(tstate, tbuf, ts, view=tv, draws=draws)
        yield jstate, jm, tstate, tm


def module_params(module):
    """The port module's parameters as one vector (parameter order)."""
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()])


def assert_adam_matches(opt_t, opt_j, module, prefix, rtol):
    """The port's Adam state of ``module`` against optax's, moments held to
    ``rtol`` of each entry (and of the largest)."""
    count, mu, nu = adam_moments(opt_j)
    assert int(opt_t.count) == count
    for m_j, m_t in ((mu, opt_t.mu), (nu, opt_t.nu)):
        want = module_vec(module, m_j, prefix)
        np.testing.assert_allclose(n(m_t), n(want), rtol=rtol,
                                   atol=rtol * float(want.abs().max()),
                                   err_msg=prefix)


def assert_first_step_close(got, want, lr, max_flipped=0.01):
    """Parameters after one Adam step from the same start, where bf16
    rounding may flip the sign of a gradient entry near 0: Adam's first
    step moves every entry by about ``lr * sign(g)``, so no entry may
    differ by more than two steps, and at most ``max_flipped`` of the
    entries by more than one."""
    diff = (got - want).abs()
    assert float(diff.max()) <= 2 * lr * (1 + 1e-3) + 1e-7
    assert float((diff > lr).float().mean()) <= max_flipped
