"""An off-policy configuration's program: the agent the configuration
names, its algorithm given the benchmark's weights, and an
``OffpolicyTrainer`` at the traffic's env batch, horizon, buffer, grad
steps a collect and ``update_chunk``. The set-up fills the buffer with the
trainer's own ``collect()`` (the chunk graphs hold the fill count, so a
window at a full buffer captures nothing); a dispatch is one
``OffpolicyTrainer._run_iter``."""

from __future__ import annotations

import torch

from portbench.drivers.common import TrainerProgram, draw_weights


def weight_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The actor (a ReLU trunk, a mean and a log-sigma head) and two Q
    towers per channel on ``[obs, act]``, by the agent's state dict
    names."""
    d, a = cfg["task"]["obs_dim"], cfg["task"]["act_dim"]
    h1, h2 = cfg["algorithm_kwargs"]["hidden_sizes"]
    k = 1 + cfg["task"]["num_costs"]
    return {"actor.trunk.layers.0.weight": (h1, d),
            "actor.trunk.layers.0.bias": (h1,),
            "actor.trunk.layers.1.weight": (h2, h1),
            "actor.trunk.layers.1.bias": (h2,),
            "actor.mu.weight": (a, h2), "actor.mu.bias": (a,),
            "actor.sigma.weight": (a, h2), "actor.sigma.bias": (a,),
            "critics.w.0": (k, 2, h1, d + a), "critics.b.0": (k, 2, h1),
            "critics.w.1": (k, 2, h2, h1), "critics.b.1": (k, 2, h2),
            "critics.w.2": (k, 2, 1, h2), "critics.b.2": (k, 2, 1)}


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    return draw_weights(weight_shapes(cfg), seed, device)


class Program(TrainerProgram):
    """The configuration's agent and an ``OffpolicyTrainer`` with a full
    buffer."""

    def build(self, cfg: dict, traffic: dict, seed: int, device) -> None:
        from fsrl_torch.agent import agents
        from fsrl_torch.trainer.trainer import OffpolicyTrainer

        agent = getattr(agents, cfg["agent"])(
            cfg["task"]["id"], cost_limit=cfg["cost_limit"], seed=seed,
            device=device, **self.algorithm_kwargs(cfg))
        self.weights = make_weights(cfg, seed, device)
        agent.state = agent.algo.init(seed, state_dict=self.weights)
        self.trainer = tr = OffpolicyTrainer(
            agent.algo, agent.env, None, epochs=1, step_per_epoch=1,
            n_envs=traffic["n_envs"],
            steps_per_collect=traffic["steps_per_collect"],
            cost_limit=cfg["cost_limit"], seed=seed, verbose=False,
            state=agent.state, buffer_size=traffic["buffer_size"],
            update_per_step=traffic["update_per_step"],
            update_chunk=traffic["update_chunk"],
            fuse_iters=traffic["fuse_iters"])
        self.steps_per_dispatch = (traffic["n_envs"]
                                   * traffic["steps_per_collect"]
                                   * traffic["fuse_iters"])

    def prepare(self) -> None:
        """The buffer filled by the trainer's own ``collect()``."""
        for _ in range(self.traffic["fill_collects"]):
            self.trainer.collect()

    def loss_source(self):
        """Each grad step's critic and actor losses."""
        return (self.trainer.algo, "update_step",
                lambda out: [float(out[1]["loss/q_total"]),
                             float(out[1]["loss/actor_total"])])

    def optimizers(self):
        from fsrl_torch.algos.common import split_flat

        algo, st = self.trainer.algo, self.trainer.state
        model = st.params
        flat_a, flat_c = split_flat(model, model.flat)
        log_alpha = st.log_alpha.detach().clone()
        return [
            (algo, "critic_tx", lambda: flat_c,
             lambda f: self.split(f, model.critics, "critics.")),
            (algo, "actor_tx", lambda: flat_a,
             lambda f: self.split(f, model.actor, "actor.")),
            (algo, "alpha_tx", log_alpha, lambda f: {"log_alpha": f})]

    def graphed(self):
        """Each chunk's graph; where the trainer has none (off the card),
        the eager call it makes in its place, put in the graph's slot."""
        from functools import partial

        tr = self.trainer
        for n in set(tr.chunk_sizes):
            tr.chunk_graphs.setdefault(n, partial(tr._grad_steps, n=n))
        return [(tr.chunk_graphs, n) for n in sorted(tr.chunk_graphs)]

    def plant_zero_cost(self) -> None:
        algo = self.trainer.algo
        step = algo.update_lagrangian

        def blind(state, ep_cost_mean, *args, **kwargs):
            return step(state, torch.zeros_like(ep_cost_mean), *args,
                        **kwargs)
        algo.update_lagrangian = blind

    def plant_half_batch(self) -> None:
        """Each grad step samples half of its batch."""
        self.trainer.algo.hp["batch_size"] //= 2
