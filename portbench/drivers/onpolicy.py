"""An on-policy configuration's program: the agent the configuration
names, its algorithm given the benchmark's weights, and an
``OnpolicyTrainer`` at the traffic's env batch, horizon and ``fuse_iters``;
a dispatch is one ``OnpolicyTrainer._run_iter``."""

from __future__ import annotations

import torch

from portbench.drivers.common import TrainerProgram, draw_weights


def weight_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The actor (a ReLU trunk, a tanh mean head, a free log-sigma) and the
    K critic towers, by the names the agent's state dict uses."""
    d, a = cfg["task"]["obs_dim"], cfg["task"]["act_dim"]
    h1, h2 = cfg["algorithm_kwargs"]["hidden_sizes"]
    k = 1 + cfg["task"]["num_costs"]
    return {"actor.trunk.layers.0.weight": (h1, d),
            "actor.trunk.layers.0.bias": (h1,),
            "actor.trunk.layers.1.weight": (h2, h1),
            "actor.trunk.layers.1.bias": (h2,),
            "actor.mu.weight": (a, h2), "actor.mu.bias": (a,),
            "actor.log_sigma": (a,),
            "critics.w.0": (k, h1, d), "critics.b.0": (k, h1),
            "critics.w.1": (k, h2, h1), "critics.b.1": (k, h2),
            "critics.w.2": (k, 1, h2), "critics.b.2": (k, 1)}


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """:func:`draw_weights`, with the mean head's times 0.01 and
    log-sigma -0.5 (the recipe's scale and start)."""
    out = draw_weights(weight_shapes(cfg), seed, device)
    out["actor.mu.weight"] *= 0.01
    out["actor.log_sigma"].fill_(-0.5)
    return out


class Program(TrainerProgram):
    """The configuration's agent and an ``OnpolicyTrainer``."""

    def build(self, cfg: dict, traffic: dict, seed: int, device) -> None:
        from fsrl_torch.agent import agents
        from fsrl_torch.trainer.trainer import OnpolicyTrainer

        agent = getattr(agents, cfg["agent"])(
            cfg["task"]["id"], cost_limit=cfg["cost_limit"], seed=seed,
            device=device, **self.algorithm_kwargs(cfg))
        self.weights = make_weights(cfg, seed, device)
        agent.state = agent.algo.init(seed, state_dict=self.weights)
        self.trainer = OnpolicyTrainer(
            agent.algo, agent.env, None, epochs=1, step_per_epoch=1,
            n_envs=traffic["n_envs"],
            steps_per_collect=traffic["steps_per_collect"],
            cost_limit=cfg["cost_limit"], seed=seed, verbose=False,
            state=agent.state, fuse_iters=traffic["fuse_iters"])
        self.steps_per_dispatch = (traffic["n_envs"]
                                   * traffic["steps_per_collect"]
                                   * traffic["fuse_iters"])

    def loss_source(self):
        """Each update's reported loss (the mean of its minibatches')."""
        return (self.trainer.algo, "update",
                lambda out: [float(out[1]["loss/total"])])

    def optimizers(self):
        st = self.trainer.state
        flat, model = st.flat, st.params
        return [(self.trainer.algo, "tx", lambda: flat,
                 lambda f: self.split(f, model))]

    def graphed(self):
        tr = self.trainer
        return [(tr, "graph" if tr.graph is not None else "_cycles")]

    def plant_zero_cost(self) -> None:
        algo = self.trainer.algo
        update = algo.update

        def blind(state, tr, ep_cost_mean, *args, **kwargs):
            return update(state, tr, torch.zeros_like(ep_cost_mean), *args,
                          **kwargs)
        algo.update = blind

    def plant_half_batch(self) -> None:
        """The update trains on the first half of the envs' rows only."""
        algo = self.trainer.algo
        update = algo.update

        def half(state, tr, *args, **kwargs):
            n = tr.reward.shape[1] // 2
            cut = type(tr)(**{k: x[:, :n] for k, x in vars(tr).items()})
            return update(state, cut, *args, **kwargs)
        algo.update = half
