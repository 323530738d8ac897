"""Actor and critic networks (port of ``fsrl_tpu/nets/mlp.py``).

Weights use PyTorch's ``(out, in)`` layout; ``utils/params.py`` converts from
flax's ``(in, out)``. The critic ensemble keeps the JAX layout, K towers
stacked on a leading axis; each tower is evaluated as a plain matmul chain.

Initialization follows the JAX package: orthogonal weights, zero biases,
free log-sigma at ``sigma_init`` (-0.5), and the optional 0.01 scale of the
mean head.

``compute_dtype=torch.bfloat16`` reproduces flax's mixed-precision cast
points (``nets/mlp.py:53-67``): the trunk's input, weights and biases are cast
to bf16, each layer is a bf16 matmul followed by a bf16 bias add, and the
trunk output is cast back to float32. The actor's mean head runs in float32
on that output. Parameters stay float32.

The recurrent PPO-Lag actor (``nets/mlp.py:279-307``): a GRU cell with
flax's gates (no bias on the r and z gates' recurrent products) and a
Gaussian head; its critics stay the feedforward ensemble.

The off-policy nets (``nets/mlp.py:100-104,126-139,176-221``): the SAC / CVPO
actor's state-conditioned log-sigma head, clipped to
[``SIGMA_MIN``, ``SIGMA_MAX``]; the deterministic DDPG actor; and the
(M metrics x Q heads) Q-critic ensemble, whose towers run as one matmul
chain batched over the M x Q axis.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from fsrl_torch.nets.distributions import DiagGaussian

SIGMA_MIN, SIGMA_MAX = -20.0, 2.0


class Dense(nn.Module):
    """Affine layer ``x @ W.T + b``, the matmul and the bias add done as two
    operations in the compute dtype, as flax's ``Dense`` does."""

    def __init__(self, in_dim: int, out_dim: int, scale: float = 1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        nn.init.orthogonal_(self.weight, gain=scale, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.to(x.dtype).T + self.bias.to(x.dtype)


class MLP(nn.Module):
    """ReLU trunk with an optional linear output layer."""

    def __init__(self, in_dim: int, hidden_sizes: Sequence[int],
                 out_dim: int | None = None, out_scale: float = 1.0,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [in_dim, *hidden_sizes]
        self.layers = nn.ModuleList(
            Dense(a, b, generator=generator)
            for a, b in zip(dims[:-1], dims[1:]))
        self.out = (Dense(dims[-1], out_dim, out_scale, generator)
                    if out_dim is not None else None)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        for layer in self.layers:
            x = torch.relu(layer(x))
        if self.out is not None:
            x = self.out(x)
        return x.float()


class GaussianActor(nn.Module):
    """Gaussian policy; mean ``max_action * tanh(mu)`` unless ``unbounded``.

    * ``conditioned_sigma=False``: a free log-sigma parameter (the
      PPO / TRPO / CPO / FOCOPS recipe);
    * ``conditioned_sigma=True``: a log-sigma head on the trunk, clipped to
      [``SIGMA_MIN``, ``SIGMA_MAX``] (the SAC / CVPO recipe). The clip is
      ``minimum(maximum(.))``, whose backward passes half the gradient at a
      bound, as ``jnp.clip`` does (``torch.clamp`` passes all of it)."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden_sizes: Sequence[int] = (128, 128),
                 max_action: float = 1.0, unbounded: bool = False,
                 conditioned_sigma: bool = False,
                 last_layer_scale: bool = False, sigma_init: float = -0.5,
                 sigma_floor: float | None = None,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.trunk = MLP(obs_dim, hidden_sizes, compute_dtype=compute_dtype,
                         generator=generator)
        self.mu = Dense(hidden_sizes[-1], act_dim,
                        0.01 if last_layer_scale else 1.0, generator)
        self.conditioned_sigma = conditioned_sigma
        if conditioned_sigma:
            self.sigma = Dense(hidden_sizes[-1], act_dim, generator=generator)
            self.register_buffer("sigma_lo", torch.tensor(SIGMA_MIN),
                                 persistent=False)
            self.register_buffer("sigma_hi", torch.tensor(SIGMA_MAX),
                                 persistent=False)
        else:
            self.log_sigma = nn.Parameter(torch.full((act_dim,), sigma_init))
        self.max_action, self.unbounded = max_action, unbounded
        self.sigma_floor = sigma_floor

    def std(self) -> torch.Tensor:
        """``exp(log_sigma)``, with the exploration floor ``sigma >= floor``
        where one is set. ``torch.maximum`` splits the gradient 0.5 / 0.5
        at ``log_sigma == log(floor)``, as ``jnp.maximum`` does; the
        floor's logarithm is taken in float32, as there."""
        log_sigma = self.log_sigma
        if self.sigma_floor is not None:
            log_sigma = torch.maximum(log_sigma, torch.log(torch.full_like(
                log_sigma, self.sigma_floor)))
        return torch.exp(log_sigma)

    def forward(self, obs: torch.Tensor) -> DiagGaussian:
        trunk = self.trunk(obs)
        mu = self.mu(trunk)
        if not self.unbounded:
            mu = self.max_action * torch.tanh(mu)
        if self.conditioned_sigma:
            log_sigma = torch.minimum(
                torch.maximum(self.sigma(trunk), self.sigma_lo), self.sigma_hi)
            return DiagGaussian(mean=mu, std=torch.exp(log_sigma))
        return DiagGaussian(mean=mu, std=self.std().expand(mu.shape))


class DeterministicActor(nn.Module):
    """The DDPG policy: ``max_action * tanh(mu(trunk(obs)))``."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden_sizes: Sequence[int] = (128, 128),
                 max_action: float = 1.0,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.trunk = MLP(obs_dim, hidden_sizes, compute_dtype=compute_dtype,
                         generator=generator)
        self.mu = Dense(hidden_sizes[-1], act_dim, generator=generator)
        self.max_action = max_action

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.max_action * torch.tanh(self.mu(self.trunk(obs)))


class VCriticEnsemble(nn.Module):
    """K independent V(s) towers stacked on a leading axis. Output
    ``(..., K)``: column 0 the reward critic, columns 1..M the cost
    critics. Tower weights are ``w[i]`` of shape ``(K, out, in)``."""

    def __init__(self, obs_dim: int, num_critics: int,
                 hidden_sizes: Sequence[int] = (128, 128),
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [obs_dim, *hidden_sizes, 1]
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for a, b in zip(dims[:-1], dims[1:]):
            w = torch.empty(num_critics, b, a)
            for k in range(num_critics):
                nn.init.orthogonal_(w[k], generator=generator)
            self.w.append(nn.Parameter(w))
            self.b.append(nn.Parameter(torch.zeros(num_critics, b)))
        self.compute_dtype = compute_dtype

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """Each tower is evaluated as its own chain of plain matmuls on
        its slice of the stacked weights. One batched matmul over the K
        axis computes the same values, but its backward pass is a batched
        product with the whole batch of rows as the inner dimension and
        only K problems to spread over the card, which the library runs
        several times slower at the training widths."""
        lead = obs.shape[:-1]
        dt = self.compute_dtype or obs.dtype
        x = obs.reshape(-1, obs.shape[-1]).to(dt)
        n = len(self.w)
        cols = []
        for k in range(self.w[0].shape[0]):
            h = x
            for i in range(n):
                h = h @ self.w[i][k].to(dt).T + self.b[i][k].to(dt)
                if i < n - 1:
                    h = torch.relu(h)
            cols.append(h)                                  # (B, 1)
        return torch.cat(cols, 1).reshape(lead + (-1,)).float()


class QCriticEnsemble(nn.Module):
    """(M metrics x Q heads) Q(s, a) towers on ``concat(obs, act)``. Q = 1
    is a single critic per metric (DDPG-Lag), Q = 2 a double critic (SAC-Lag,
    CVPO). Output ``(..., M, Q)``. Tower weights are ``w[i]`` of shape
    ``(M, Q, out, in)``, biases ``b[i]`` of shape ``(M, Q, out)``.

    The M x Q towers run as one matmul chain batched over the tower axis:
    an off-policy batch is a few hundred rows (a few thousand in CVPO's
    particle sweep), where the batched products' weight gradients are small
    and one launch per layer beats one per tower."""

    def __init__(self, obs_dim: int, act_dim: int, num_metrics: int,
                 num_q: int = 2, hidden_sizes: Sequence[int] = (128, 128),
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [obs_dim + act_dim, *hidden_sizes, 1]
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for a, b in zip(dims[:-1], dims[1:]):
            w = torch.empty(num_metrics, num_q, b, a)
            for m in range(num_metrics):
                for q in range(num_q):
                    nn.init.orthogonal_(w[m, q], generator=generator)
            self.w.append(nn.Parameter(w))
            self.b.append(nn.Parameter(torch.zeros(num_metrics, num_q, b)))
        self.num_metrics, self.num_q = num_metrics, num_q
        self.compute_dtype = compute_dtype

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        lead = obs.shape[:-1]
        dt = self.compute_dtype or obs.dtype
        x = torch.cat([obs, act], -1).reshape(-1, obs.shape[-1]
                                              + act.shape[-1]).to(dt)
        MQ = self.num_metrics * self.num_q
        n = len(self.w)
        h = x
        for i in range(n):
            w = self.w[i].to(dt)
            w = w.reshape(MQ, w.shape[-2], w.shape[-1]).transpose(1, 2)
            # layer 1 broadcasts the shared input over the towers
            h = torch.matmul(h, w) + self.b[i].to(dt).reshape(MQ, 1, -1)
            if i < n - 1:
                h = torch.relu(h)
        q = h[..., 0].T                                      # (B, M*Q)
        return q.reshape(lead + (self.num_metrics, self.num_q)).float()

    def predict(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        """Min over the Q heads: ``(..., M)``."""
        return self(obs, act).amin(-1)


class ActorQCritic(nn.Module):
    """The off-policy parameter set: an actor (Gaussian or deterministic)
    and a Q-critic ensemble. ``flat_names`` fixes the order of the flat
    vector: the actor's parameters, then the critics'."""

    def __init__(self, actor: nn.Module, critics: QCriticEnsemble):
        super().__init__()
        self.actor, self.critics = actor, critics

    def flat_names(self) -> list[str]:
        return ([f"actor.{k}" for k, _ in self.actor.named_parameters()]
                + [f"critics.{k}" for k, _ in
                   self.critics.named_parameters()])


class ActorCritic(nn.Module):
    """The on-policy parameter set: a Gaussian actor and a V-critic
    ensemble. ``flat_names`` fixes the order of the one flat parameter vector
    the optimizers and the fused grad kernel work on."""

    def __init__(self, actor: GaussianActor, critics: VCriticEnsemble):
        super().__init__()
        self.actor, self.critics = actor, critics
        widths = [layer.weight.shape[0] for layer in actor.trunk.layers]
        # the stacked chain needs the PPO recipe: two hidden layers, of the
        # same widths in both nets
        self.fused = (len(widths) == 2 and len(critics.w) == 3
                      and [w.shape[1] for w in critics.w[:2]] == widths)

    def forward(self, obs: torch.Tensor):
        """``(DiagGaussian, values (B, K))``, through the stacked chain
        where the nets allow it."""
        if self.fused:
            return fused_pi_v_apply(self.actor, self.critics, obs)
        return self.actor(obs), self.critics(obs)

    def actor_names(self) -> list[str]:
        """The actor's parameters, named within ``self.actor``, in flat
        order."""
        names = []
        for i in range(len(self.actor.trunk.layers)):
            names += [f"trunk.layers.{i}.weight", f"trunk.layers.{i}.bias"]
        return names + ["mu.weight", "mu.bias", "log_sigma"]

    def critic_names(self) -> list[str]:
        """The critics' parameters, named within ``self.critics``."""
        names = []
        for i in range(len(self.critics.w)):
            names += [f"w.{i}", f"b.{i}"]
        return names

    def flat_names(self) -> list[str]:
        """Actor first, then critics: both halves of the flat vector are
        contiguous."""
        return ([f"actor.{k}" for k in self.actor_names()]
                + [f"critics.{k}" for k in self.critic_names()])


class GRUCell(nn.Module):
    """flax's ``nn.GRUCell`` (input denses ``ir``, ``iz``, ``in`` with
    biases, recurrent denses ``hr``, ``hz`` without and ``hn`` with):

        r = sigmoid(x W_ir + b_ir + h W_hr)
        z = sigmoid(x W_iz + b_iz + h W_hz)
        n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
        h' = (1 - z) * n + z * h

    The weights are stacked in ``torch.nn.GRUCell``'s gate order (r, z, n):
    ``weight_ih`` (3H, D), ``bias_ih`` (3H), ``weight_hh`` (3H, H). Where a
    ``torch.nn.GRUCell`` has ``bias_hh`` for all three gates this cell has
    only the n gate's (``bias_hn``), so the r and z ones stay 0 under
    training, as in flax. Init as flax's: LeCun-normal input weights,
    orthogonal recurrent ones per gate, zero biases."""

    def __init__(self, in_dim: int, hidden_size: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        H = hidden_size
        self.hidden_size = H
        # flax's lecun_normal: a normal truncated to +-2 std, std corrected
        # for the truncation
        std = (1.0 / in_dim) ** 0.5 / 0.87962566103423978
        w_ih = torch.empty(3 * H, in_dim)
        nn.init.trunc_normal_(w_ih, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        w_hh = torch.empty(3 * H, H)
        for i in range(3):
            nn.init.orthogonal_(w_hh[i * H:(i + 1) * H], generator=generator)
        self.weight_ih = nn.Parameter(w_ih)
        self.weight_hh = nn.Parameter(w_hh)
        self.bias_ih = nn.Parameter(torch.zeros(3 * H))
        self.bias_hn = nn.Parameter(torch.zeros(H))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return gru_step(x, h, self.weight_ih, self.weight_hh, self.bias_ih,
                        self.bias_hn)


def gru_step(x, h, weight_ih, weight_hh, bias_ih, bias_hn):
    """One step of :class:`GRUCell` on explicit weights (the recurrent
    update's unroll reads them as views of its flat vector)."""
    H = h.shape[-1]
    gi = x @ weight_ih.T + bias_ih
    gh = h @ weight_hh.T
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * (gh[..., 2 * H:] + bias_hn))
    return (1.0 - z) * n + z * h


class RecurrentGaussianActor(nn.Module):
    """GRU-backed Gaussian policy: ``forward(obs, carry)`` returns the
    action distribution and the next carry. Mean head scaled by 0.01 at
    init, ``max_action * tanh`` mean, free log-sigma at -0.5."""

    def __init__(self, obs_dim: int, act_dim: int, hidden_size: int = 128,
                 max_action: float = 1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cell = GRUCell(obs_dim, hidden_size, generator)
        self.mu = Dense(hidden_size, act_dim, 0.01, generator)
        self.log_sigma = nn.Parameter(torch.full((act_dim,), -0.5))
        self.max_action = max_action
        self.hidden_size = hidden_size

    def forward(self, obs: torch.Tensor, carry: torch.Tensor):
        h = self.cell(obs, carry)
        mu = self.max_action * torch.tanh(self.mu(h))
        return DiagGaussian(mean=mu, std=torch.exp(self.log_sigma).expand(
            mu.shape)), h


class RecurrentActorCritic(nn.Module):
    """The recurrent PPO-Lag parameter set: a GRU actor and the feedforward
    V-critic ensemble, behind one flat vector (actor first)."""

    def __init__(self, actor: RecurrentGaussianActor,
                 critics: VCriticEnsemble):
        super().__init__()
        self.actor, self.critics = actor, critics

    def actor_names(self) -> list[str]:
        return ["cell.weight_ih", "cell.weight_hh", "cell.bias_ih",
                "cell.bias_hn", "mu.weight", "mu.bias", "log_sigma"]

    critic_names = ActorCritic.critic_names
    flat_names = ActorCritic.flat_names


def fused_pi_v_apply(actor: GaussianActor, critics: VCriticEnsemble,
                     obs: torch.Tensor):
    """Actor and critic ensemble as one stacked matmul chain
    (``nets/mlp.py:224-276``): the K+1 towers share input and hidden shape,
    so layer 1 is one matmul over the stacked output axis and layer 2 one
    batched matmul. Same parameters and cast points as the separate
    forwards. Requires two hidden layers, of the same widths in both nets.
    Returns ``(DiagGaussian, values (B, K))``."""
    dt = critics.compute_dtype or obs.dtype
    a1, a2 = actor.trunk.layers
    w1 = torch.cat([a1.weight[None], critics.w[0]]).to(dt)    # (K+1, H1, D)
    b1 = torch.cat([a1.bias[None], critics.b[0]]).to(dt)
    w2 = torch.cat([a2.weight[None], critics.w[1]]).to(dt)
    b2 = torch.cat([a2.bias[None], critics.b[1]]).to(dt)
    x = obs.to(dt)
    h = torch.relu(torch.matmul(x, w1.transpose(1, 2)) + b1[:, None])
    h = torch.relu(torch.matmul(h, w2.transpose(1, 2)) + b2[:, None])
    v = (torch.matmul(h[1:], critics.w[2].to(dt).transpose(1, 2))
         + critics.b[2].to(dt)[:, None])                        # (K, B, 1)
    values = v[..., 0].T.float()
    mu = actor.mu(h[0].float())
    if not actor.unbounded:
        mu = actor.max_action * torch.tanh(mu)
    return DiagGaussian(mean=mu, std=actor.std().expand(mu.shape)), values
