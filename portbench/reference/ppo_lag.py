"""Plain reference of PPO-Lagrangian training (Ray et al. 2019's
PPO-Lagrangian, Stooke et al. 2020's PID multiplier), in float32 with
TF32 off, one cycle after another:

1. collect ``T`` steps of ``N`` envs with the Gaussian policy
   (``mean = tanh(mu(trunk(obs)))``, a free log-sigma), auto-resetting;
2. step the filtered PID multiplier on the collect's mean episodic cost;
3. critics over every observation and true next observation, GAE per
   channel (reward, then each cost), the lambda chain broken at episode
   ends and no bootstrap past a termination;
4. ``repeat`` epochs of ``n_minibatches`` minibatches drawn as tiles of
   the env-major batch; per minibatch the clipped surrogate on the reward
   advantage, ``sum_i lambda_i mean(ratio A_i)``, both times
   ``1 / (sum lambda + 1)``, plus ``vf_coef`` times the critics' squared
   error, advantages normalized per channel over the minibatch; the
   gradient by autograd, its global norm clipped, Adam; after an epoch
   whose mean KL passes ``1.5 target_kl`` no more steps are applied.

The random draws come from one generator seeded with the run's seed, in
this order: the envs' first starts; per env step the policy's normal
draw, then a fresh start for every env; per update one permutation of the
tiles per epoch (and a roll offset where the tiles do not cover the
batch). The benchmark hands the program a generator seeded alike and the
same weights.
"""

from __future__ import annotations

import torch

from portbench.reference.common import (Adam, Episodes, FilteredPID,
                                        gaussian_logp, set_tf32, tower)
from portbench.reference.envs import VecEnv

Tensor = torch.Tensor


def actor(p: dict, obs: Tensor) -> tuple[Tensor, Tensor]:
    h = torch.relu(obs @ p["actor.trunk.layers.0.weight"].T
                   + p["actor.trunk.layers.0.bias"])
    h = torch.relu(h @ p["actor.trunk.layers.1.weight"].T
                   + p["actor.trunk.layers.1.bias"])
    mean = torch.tanh(h @ p["actor.mu.weight"].T + p["actor.mu.bias"])
    return mean, torch.exp(p["actor.log_sigma"]).expand(mean.shape)


def critics(p: dict, obs: Tensor) -> Tensor:
    """``(..., K)``: one ReLU tower per channel."""
    lead, x = obs.shape[:-1], obs.reshape(-1, obs.shape[-1])
    ws = [p[f"critics.w.{i}"] for i in range(3)]
    bs = [p[f"critics.b.{i}"] for i in range(3)]
    cols = [tower(x, [w[k] for w in ws], [b[k] for b in bs])
            for k in range(ws[0].shape[0])]
    return torch.cat(cols, 1).reshape(lead + (-1,))


def tile_rows(size: int, n_mb: int, repeat: int, g: torch.Generator
              ) -> Tensor:
    """Row indices of every minibatch, ``(repeat * n_mb, rows)``: the batch
    cut into 4096 tiles (of ``size // 4096`` rows, at least 1), each epoch
    a fresh permutation of them, as many whole minibatches of tiles as
    fit."""
    ts = max(1, size // 4096)
    n_tiles = size // ts
    usable = n_tiles // n_mb * n_mb
    perms = [torch.randperm(n_tiles, generator=g, device=g.device)[:usable]
             for _ in range(repeat)]
    roll = (torch.randint(0, size, (), generator=g, device=g.device)
            if size % ts else 0)
    tiles = torch.stack(perms).reshape(repeat * n_mb, usable // n_mb)
    rows = (tiles[..., None] * ts
            + torch.arange(ts, device=g.device)).reshape(repeat * n_mb, -1)
    return torch.remainder(rows - roll, size)


def gae(delta: Tensor, done: Tensor, gamma_lam: float) -> Tensor:
    """Advantages from TD errors ``(T, N, K)``, the chain broken after a
    step where the episode ended."""
    disc = (1.0 - done.float())[..., None] * gamma_lam
    adv = torch.empty_like(delta)
    run = torch.zeros_like(delta[0])
    for t in range(delta.shape[0] - 1, -1, -1):
        run = delta[t] + disc[t] * run
        adv[t] = run
    return adv


def normalized(adv: Tensor, eps: float = 1e-8) -> Tensor:
    a = adv.double()
    mean = a.mean(0, keepdim=True)
    std = torch.sqrt(torch.clamp((a * a).mean(0, keepdim=True)
                                 - mean * mean, min=0.0))
    return (adv - mean.float()) / (std.float() + eps)


def minibatch_loss(p: dict, mb: dict, lam: Tensor, resc: Tensor,
                   hp: dict) -> tuple[Tensor, Tensor]:
    mean, std = actor(p, mb["obs"])
    logp = gaussian_logp(mb["act"], mean, std)
    ratio = torch.exp(logp - mb["logp"])
    adv = normalized(mb["adv"])
    eps = hp["eps_clip"]
    surr = torch.minimum(ratio * adv[:, 0],
                         torch.clamp(ratio, 1 - eps, 1 + eps) * adv[:, 0])
    safety = (lam * (ratio[:, None] * adv[:, 1:]).mean(0)).sum()
    loss_actor = resc * (-surr.mean() + safety)
    loss_vf = ((mb["ret"] - critics(p, mb["obs"])) ** 2).mean(0).sum()
    return loss_actor + hp["vf_coef"] * loss_vf, (mb["logp"] - logp).mean()


class PPOLagReference:
    """Training state and one cycle at a time."""

    def __init__(self, cfg: dict, traffic: dict, weights: dict, seed: int,
                 device, half_batch: bool = False):
        self.hp, self.traffic = cfg["algorithm_kwargs"], traffic
        self.half_batch = half_batch
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.env = VecEnv(cfg["task"], traffic["n_envs"], self.g,
                          stagger=True)
        self.params = {k: v.detach().clone() for k, v in weights.items()}
        self.adam = Adam(self.hp["lr"], self.hp["max_grad_norm"])
        self.opt = self.adam.init(self.params)
        m = cfg["task"]["num_costs"]
        self.pid = FilteredPID(m, cfg["cost_limit"],
                               self.hp["lagrangian_pid"],
                               cfg["pid_horizon"], device)
        self.episodes = Episodes(traffic["n_envs"], m, device)
        # the first gradient and the leaves after the first grad steps
        self.first_grad: dict | None = None
        # the multiplier each update trains with
        self.multipliers: list[float] = []
        self.steps = 0
        self.after: dict[int, dict] = {}

    @torch.no_grad()
    def collect(self) -> dict:
        self.episodes.reset_collect()
        steps = []
        for _ in range(self.traffic["steps_per_collect"]):
            obs = self.env.obs
            mean, std = actor(self.params, obs)
            act = mean + std * torch.randn(mean.shape, generator=self.g,
                                           device=self.g.device)
            logp = gaussian_logp(act, mean, std)
            obs_next, reward, cost, done = self.env.step(act)
            self.episodes.add(cost, done)
            steps.append(dict(obs=obs, act=act, logp=logp,
                              obs_next=obs_next, reward=reward, cost=cost,
                              done=done))
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    def update(self, seg: dict) -> float:
        """The PID step, GAE and the minibatch epochs; the mean loss."""
        hp = self.hp
        lam = self.pid.step(self.episodes.mean_cost(),
                            self.episodes.n_episodes)
        self.multipliers.extend(lam.tolist())
        resc = 1.0 / (lam.sum() + 1.0)
        with torch.no_grad():
            v = critics(self.params, seg["obs"])
            # no env of these tasks terminates: every next value bootstraps
            v_next = critics(self.params, seg["obs_next"])
            m = torch.cat([seg["reward"][..., None], seg["cost"]], -1)
            adv = gae(m + hp["gamma"] * v_next - v, seg["done"],
                      hp["gamma"] * hp["gae_lambda"])
            T, N = seg["reward"].shape
            flat = lambda x: x.transpose(0, 1).reshape((N * T,)
                                                       + x.shape[2:])
            batch = dict(obs=flat(seg["obs"]), act=flat(seg["act"]),
                         logp=flat(seg["logp"]), adv=flat(adv),
                         ret=flat(adv + v))
        n_mb = hp["n_minibatches"]
        rows = tile_rows(N * T, n_mb, hp["repeat"], self.g)
        stopped, kl_sum, losses = False, 0.0, []
        for s in range(rows.shape[0]):
            idx = rows[s]
            if self.half_batch:
                idx = idx[: idx.shape[0] // 2]
            mb = {k: x[idx] for k, x in batch.items()}
            leaves = {k: x.detach().requires_grad_(True)
                      for k, x in self.params.items()}
            with torch.enable_grad():
                loss, kl = minibatch_loss(leaves, mb, lam, resc, hp)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            self.params = {k: x.detach() for k, x in leaves.items()}
            if self.first_grad is None:
                self.first_grad = dict(zip(leaves, grads))
            if not stopped:
                self.params, self.opt = self.adam.step(
                    self.params, dict(zip(leaves, grads)), self.opt)
            self.steps += 1
            self.after[self.steps] = self.params
            losses.append(loss.detach())
            kl_sum += kl.detach()
            if (s + 1) % n_mb == 0:
                stopped = stopped or bool(kl_sum / n_mb
                                          > 1.5 * hp["target_kl"])
                kl_sum = 0.0
        return float(torch.stack(losses).mean())


def run(cfg: dict, traffic: dict, weights: dict, seed: int, device,
        checked: int, tf32: bool = False, half_batch: bool = False) -> dict:
    """From ``weights``, ``checked`` cycles: each update's loss (the mean
    of its minibatch losses) and multiplier, the first gradient (before
    clipping) and the leaves after ``checked`` grad steps. ``tf32`` runs
    it with TF32 products (the control); ``half_batch`` trains on half of
    each minibatch (a planted fault)."""
    set_tf32(tf32)
    try:
        ref = PPOLagReference(cfg, traffic, weights, seed, device,
                              half_batch)
        loss = [ref.update(ref.collect()) for _ in range(checked)]
        return dict(loss=loss, multiplier=ref.multipliers,
                    grad=ref.first_grad, params=ref.after[checked])
    finally:
        set_tf32(False)
