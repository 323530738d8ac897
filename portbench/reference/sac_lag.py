"""Plain reference of SAC-Lagrangian training (Haarnoja et al. 2018's SAC
with automatic temperature, a PID Lagrangian multiplier on the cost
critics), in float32 with TF32 off:

1. collect ``T`` steps of ``N`` envs with the tanh-squashed Gaussian
   policy (a state-conditioned log-sigma clipped to [-20, 2]) into a ring
   buffer of ``buffer_size // N`` rows per env;
2. step the filtered PID multiplier on the collect's mean episodic cost;
3. ``update_per_step * N * T`` grad steps, each on ``batch_size`` rows
   drawn uniformly (a row, then an env) from the filled rows:

   * n-step targets: each row's successor is the same env's next row,
     except at an episode's end and at the newest row (the newest row
     counts as an end); the discounted sum of the chain's rewards and
     costs plus ``gamma^k`` times the target critics' value of the
     chain's last next observation under a fresh action of the current
     policy: the smaller of the two heads minus ``alpha logp`` for the
     reward, the larger head for a cost; cost targets clamped at 0;
   * the critics (both heads against the same target, squared error
     summed over the channels) by Adam;
   * the actor on ``1 / (sum lambda + 1)`` times ``mean(alpha logp -
     Q_reward) + sum_i lambda_i mean(relu(Q_cost_i))`` with a fresh action
     and the updated critics, by Adam;
   * ``log alpha`` by Adam on ``-mean(log alpha (logp - A))``, clipped to
     [-20, 2];
   * the target critics ``(1 - tau) target + tau critic``.

The random draws come from one generator seeded with the run's seed, in
this order: the envs' first starts; per env step the policy's normal draw,
then fresh starts for every env; per grad step the rows, the envs, the
terminal action's normal draw and the actor loss's normal draw.
"""

from __future__ import annotations

import math

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
    mean = h @ p["actor.mu.weight"].T + p["actor.mu.bias"]
    log_std = torch.clamp(h @ p["actor.sigma.weight"].T
                          + p["actor.sigma.bias"], -20.0, 2.0)
    return mean, torch.exp(log_std)


def sample(p: dict, obs: Tensor, g: torch.Generator
           ) -> tuple[Tensor, Tensor]:
    """A squashed action and its log-density."""
    mean, std = actor(p, obs)
    x = mean + std * torch.randn(mean.shape, generator=g, device=g.device)
    # log(1 - tanh(x)^2), written stably
    corr = 2.0 * (math.log(2.0) - x - torch.logaddexp(
        -2.0 * x, torch.zeros((), device=x.device)))
    return torch.tanh(x), gaussian_logp(x, mean, std) - corr.sum(-1)


def q_values(p: dict, obs: Tensor, act: Tensor, prefix: str) -> Tensor:
    """``(B, K, 2)``: two ReLU towers per channel on ``[obs, act]``."""
    x = torch.cat([obs, act], -1)
    ws = [p[f"{prefix}w.{i}"] for i in range(3)]
    bs = [p[f"{prefix}b.{i}"] for i in range(3)]
    K, Q = ws[0].shape[:2]
    return torch.stack([torch.stack([
        tower(x, [w[k, q] for w in ws], [b[k, q] for b in bs])[:, 0]
        for q in range(Q)], -1) for k in range(K)], 1)


def heads(q: Tensor) -> Tensor:
    """The reward channel's smaller head, the costs' larger."""
    return torch.cat([q[:, :1].amin(-1), q[:, 1:].amax(-1)], 1)


class SACLagReference:
    def __init__(self, cfg: dict, traffic: dict, weights: dict, seed: int,
                 device, half_batch: bool = False):
        self.hp, self.traffic = cfg["algorithm_kwargs"], traffic
        self.half_batch = half_batch
        self.g = torch.Generator(device=device).manual_seed(seed)
        n, t = traffic["n_envs"], traffic["steps_per_collect"]
        self.env = VecEnv(cfg["task"], n, self.g, stagger=True)
        p = {k: v.detach().clone() for k, v in weights.items()}
        self.actor_p = {k: v for k, v in p.items() if k.startswith("actor.")}
        self.critic_p = {k: v for k, v in p.items()
                         if k.startswith("critics.")}
        self.target = {k: v.clone() for k, v in self.critic_p.items()}
        self.log_alpha = torch.zeros((), device=device)
        self.target_entropy = -float(cfg["task"]["act_dim"])
        hp = self.hp
        self.actor_adam, self.critic_adam = (Adam(hp["actor_lr"]),
                                             Adam(hp["critic_lr"]))
        self.alpha_adam = Adam(hp["alpha_lr"])
        self.actor_opt = self.actor_adam.init(self.actor_p)
        self.critic_opt = self.critic_adam.init(self.critic_p)
        self.alpha_opt = self.alpha_adam.init({"log_alpha": self.log_alpha})
        m = cfg["task"]["num_costs"]
        self.pid = FilteredPID(m, cfg["cost_limit"], hp["lagrangian_pid"],
                               cfg["pid_horizon"], device)
        self.episodes = Episodes(n, m, device)
        self.C = max(traffic["buffer_size"] // n, t)
        d, a = cfg["task"]["obs_dim"], cfg["task"]["act_dim"]
        z = lambda *s: torch.zeros((self.C, n) + s, device=device)
        self.buf = dict(obs=z(d), act=z(a), obs_next=z(d),
                        m=z(1 + m), done=z().bool())
        self.pos, self.filled = 0, 0
        self.first_grad: dict | None = None
        # the multiplier each grad step trains with
        self.multipliers: list[float] = []
        self.steps = 0
        self.after: dict[int, dict] = {}

    @torch.no_grad()
    def collect(self) -> None:
        self.episodes.reset_collect()
        for _ in range(self.traffic["steps_per_collect"]):
            obs = self.env.obs
            act, _ = sample(self.actor_p, obs, self.g)
            obs_next, reward, cost, done = self.env.step(act)
            self.episodes.add(cost, done)
            row = self.pos % self.C
            self.buf["obs"][row], self.buf["act"][row] = obs, act
            self.buf["obs_next"][row] = obs_next
            self.buf["m"][row] = torch.cat([reward[:, None], cost], 1)
            self.buf["done"][row] = done
            self.pos += 1
        self.filled = min(self.filled + self.traffic["steps_per_collect"],
                          self.C)
        self.lam = self.pid.step(self.episodes.mean_cost(),
                                 self.episodes.n_episodes).clone()

    def targets(self, rows: Tensor, envs: Tensor) -> tuple[dict, Tensor]:
        """The sampled rows and their n-step targets."""
        hp, C, N = self.hp, self.C, self.traffic["n_envs"]
        newest = (self.pos - 1) % C
        phys = rows if self.filled < C else (self.pos % C + rows) % C
        chain = [phys]
        for _ in range(hp["n_step"] - 1):
            r = chain[-1]
            stall = self.buf["done"][r, envs] | (r == newest)
            chain.append(torch.where(stall, r, (r + 1) % C))
        batch = dict(obs=self.buf["obs"][phys, envs],
                     act=self.buf["act"][phys, envs])
        ret = torch.zeros_like(self.buf["m"][phys, envs])
        k = torch.full_like(rows, hp["n_step"])
        for n in range(hp["n_step"] - 1, -1, -1):
            r = chain[n]
            ended = self.buf["done"][r, envs] | (r == newest)
            k = torch.where(ended, n + 1, k)
            ret = self.buf["m"][r, envs] + hp["gamma"] * torch.where(
                ended[:, None], torch.zeros_like(ret), ret)
        last = chain[-1]
        obs_next = self.buf["obs_next"][last, envs]
        a, logp = sample(self.actor_p, obs_next, self.g)
        q = heads(q_values(self.target, obs_next, a, "critics."))
        alpha = torch.exp(self.log_alpha)
        q = torch.cat([q[:, :1] - alpha * logp[:, None], q[:, 1:]], 1)
        # no env of these tasks terminates: every chain end bootstraps
        y = q * torch.pow(hp["gamma"], k.float())[:, None] + ret
        y = torch.cat([y[:, :1], torch.clamp(y[:, 1:], min=0.0)], 1)
        return batch, y

    def grad_step(self) -> list[float]:
        hp, N = self.hp, self.traffic["n_envs"]
        B = hp["batch_size"]
        dev = self.g.device
        rows = torch.randint(0, self.filled, (B,), generator=self.g,
                             device=dev)
        envs = torch.randint(0, N, (B,), generator=self.g, device=dev)
        with torch.no_grad():
            batch, y = self.targets(rows, envs)
        if self.half_batch:
            batch = {k: v[: B // 2] for k, v in batch.items()}
            y = y[: B // 2]
        alpha = torch.exp(self.log_alpha)
        crit = {k: v.detach().requires_grad_(True)
                for k, v in self.critic_p.items()}
        with torch.enable_grad():
            q = q_values(crit, batch["obs"], batch["act"], "critics.")
            q_loss = ((q - y[..., None]) ** 2).mean(0).sum()
            cg = torch.autograd.grad(q_loss, list(crit.values()))
        cg = dict(zip(crit, cg))
        crit = {k: v.detach() for k, v in crit.items()}
        self.critic_p, self.critic_opt = self.critic_adam.step(
            crit, cg, self.critic_opt)

        lam = self.lam
        self.multipliers.extend(lam.tolist())
        resc = 1.0 / (lam.sum() + 1.0)
        act_p = {k: v.detach().requires_grad_(True)
                 for k, v in self.actor_p.items()}
        with torch.enable_grad():
            a, logp = sample(act_p, batch["obs"], self.g)
            q = heads(q_values(self.critic_p, batch["obs"], a, "critics."))
            loss_rew = (alpha * logp - q[:, 0]).mean()
            safety = (lam * torch.relu(q[:, 1:]).mean(0)).sum()
            a_loss = resc * (loss_rew + safety)
            ag = torch.autograd.grad(a_loss, list(act_p.values()))
        ag = dict(zip(act_p, ag))
        act_p = {k: v.detach() for k, v in act_p.items()}
        self.actor_p, self.actor_opt = self.actor_adam.step(
            act_p, ag, self.actor_opt)

        alpha_g = -(logp.detach() + self.target_entropy).mean()
        new, self.alpha_opt = self.alpha_adam.step(
            {"log_alpha": self.log_alpha}, {"log_alpha": alpha_g},
            self.alpha_opt)
        self.log_alpha = torch.clamp(new["log_alpha"], -20.0, 2.0)

        tau = hp["tau"]
        self.target = {k: (1.0 - tau) * v + tau * self.critic_p[k]
                       for k, v in self.target.items()}
        if self.first_grad is None:
            self.first_grad = {**cg, **ag, "log_alpha": alpha_g}
        self.steps += 1
        self.after[self.steps] = {**self.critic_p, **self.actor_p,
                                  "log_alpha": self.log_alpha}
        return [float(q_loss.detach()), float(a_loss.detach())]



def run(cfg: dict, traffic: dict, weights: dict, seed: int, device,
        checked: int, tf32: bool = False, half_batch: bool = False) -> dict:
    """``traffic["fill_collects"]`` collects and one more, then
    ``checked`` grad steps: each one's critic and actor losses and
    multiplier, the first gradients and the leaves after the last.
    ``tf32``: the control; ``half_batch``: each grad step on half of its
    batch (a planted fault)."""
    set_tf32(tf32)
    try:
        ref = SACLagReference(cfg, traffic, weights, seed, device,
                              half_batch)
        for _ in range(traffic["fill_collects"] + 1):
            ref.collect()
        loss = [x for _ in range(checked) for x in ref.grad_step()]
        return dict(loss=loss, multiplier=ref.multipliers,
                    grad=ref.first_grad, params=ref.after[checked])
    finally:
        set_tf32(False)
