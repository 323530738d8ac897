"""What the drivers share: a program built from a configuration and a
traffic mix, driven one dispatch at a time through its trainer's
``_run_iter``; the readings of its first steps that the comparison with
the reference takes; and the check that a replayed dispatch equals the
eager first one bit for bit."""

from __future__ import annotations

import dataclasses
import gc
import math

import torch

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
# dispatches of the set-up: the warm-up, the capture, a replay
SETUP_DISPATCHES = 3
# the first updates (or grad steps) whose losses the comparison reads, and
# grad steps whose gradients and parameters it reads
CHECKED_STEPS = 3


def draw_weights(shapes: dict[str, tuple[int, ...]], seed: int, device
                 ) -> dict[str, torch.Tensor]:
    """Normal weights of standard deviation ``1 / sqrt(fan_in)`` and zero
    biases (names with ``bias`` or ``.b.``): one draw on the device from a
    generator seeded from ``seed`` (not the program's own seed stream)."""
    g = torch.Generator(device=device).manual_seed(
        (seed + 0x9E3779B97F4A7C15) % 2 ** 64)
    draw = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=g, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = (torch.zeros(shape, device=device)
                     if "bias" in name or ".b." in name else
                     draw[off:off + n].view(shape) / math.sqrt(shape[-1]))
        off += n
    return out


def tensors(tree, path: str = "") -> list[tuple[str, torch.Tensor]]:
    """Every tensor of ``tree`` (dataclasses, dicts, lists, tuples; of a
    module its parameters, buffers and tensor attributes, its own and its
    submodules') with its path; anything else holds none."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, torch.nn.Module):
        items = list(tree.state_dict(keep_vars=True).items()) + [
            (f"{name}.{k}", v) for name, m in tree.named_modules()
            for k, v in vars(m).items() if isinstance(v, torch.Tensor)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return []
    return [x for k, v in items for x in tensors(v, f"{path}/{k}")]


def snapshot(tree) -> list[tuple[str, torch.Tensor]]:
    """Host copies of ``tree``'s tensors: kept off the device, so that the
    device's allocator is left as a dispatch leaves it."""
    return [(p, x.detach().to("cpu", copy=True)) for p, x in tensors(tree)]


def restore(tree, saved: list) -> None:
    """Copy ``saved`` (a :func:`snapshot`) into ``tree``'s own tensors."""
    live = tensors(tree)
    if [p for p, _ in live] != [p for p, _ in saved]:
        raise RuntimeError("the trainer's state changed structure")
    with torch.no_grad():
        for (_, dst), (_, src) in zip(live, saved):
            dst.copy_(src)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = (x.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
            for x in (a, b))
    return torch.equal(a, b)


def differing(tree, saved: list) -> list[str]:
    """The paths at which ``tree`` and ``saved`` differ in a single bit
    (``structure`` where their tensors do not pair up)."""
    live = tensors(tree)
    if [p for p, _ in live] != [p for p, _ in saved]:
        return ["structure"]
    return [p for (p, a), (_, b) in zip(live, saved) if not same_bits(a, b)]


class Watched:
    """An optimizer seen from outside: the gradient it is given at each of
    the first grad steps, and the parameters it updates as the next step
    finds them. Passes every call on unchanged (``frozen``: returns no
    update and the state it was given, a planted fault)."""

    def __init__(self, tx, params, frozen: bool = False,
                 reading=lambda: True):
        """``params``: a callable giving the vector the optimizer's updates
        are written into in place, or the start of a leaf that each step
        replaces by itself plus the update. ``reading()``: whether a step
        is read (the eager first dispatch's only: a graph's capture reads
        nothing)."""
        self.tx, self.frozen, self.reading = tx, frozen, reading
        self.params = params if callable(params) else None
        self.grads: list[torch.Tensor] = []
        self.seen: list[torch.Tensor] = [] if callable(params) else [params]

    def __getattr__(self, name):
        return getattr(self.tx, name)

    def update(self, grad, state):
        read = self.reading()
        if read and len(self.grads) < CHECKED_STEPS:
            self.grads.append(grad.detach().clone())
        if (read and self.params is not None
                and len(self.seen) <= CHECKED_STEPS):
            self.seen.append(self.params().detach().clone())
        upd, new = ((torch.zeros_like(grad), state) if self.frozen
                    else self.tx.update(grad, state))
        if (read and self.params is None
                and len(self.seen) <= CHECKED_STEPS):
            self.seen.append(self.seen[-1] + upd.detach())
        return upd, new


class TrainerProgram:
    """A subclass builds ``self.trainer``, ``self.weights`` and
    ``self.steps_per_dispatch`` in :meth:`build` and says where its
    optimizers, losses and leaves are."""

    FAULTS = ("frozen", "half_batch", "frozen_replay", "zero_cost")

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 fault: str | None = None):
        if fault not in (None,) + self.FAULTS:
            raise ValueError(f"no fault {fault!r}")
        self.cfg, self.traffic, self.fault = cfg, traffic, fault
        self.device = torch.device(device)
        self.dispatches = 0
        self.build(cfg, traffic, seed, device)
        if fault == "half_batch":
            self.plant_half_batch()
        elif fault == "zero_cost":
            self.plant_zero_cost()
        elif fault == "frozen_replay":
            self.plant_frozen_replay()
        self.prepare()
        self.readings: dict | None = None

    # -- what a driver gives ----------------------------------------------
    def build(self, cfg, traffic, seed, device) -> None:
        raise NotImplementedError

    def prepare(self) -> None:
        """What the set-up does before its first dispatch, once any fault
        is planted."""

    def loss_source(self) -> tuple:
        """``(owner, attribute, losses)``: the call that reports losses,
        ``getattr(owner, attribute)``, and ``losses(result)`` the floats
        one call's result holds. The call returns ``(state, metrics)``;
        the multiplier is read from that state's ``lag``."""
        raise NotImplementedError

    def optimizers(self) -> list[tuple]:
        """``(owner, attribute, params, leaves)`` of each optimizer:
        ``getattr(owner, attribute)`` is it, ``params`` as
        :class:`Watched` takes it, ``leaves(flat)`` that vector (or its
        gradient) by leaf name."""
        raise NotImplementedError

    def plant_half_batch(self) -> None:
        raise NotImplementedError

    def plant_zero_cost(self) -> None:
        """The PID multiplier's step sees a mean episodic cost of 0."""
        raise NotImplementedError

    def graphed(self) -> list[tuple]:
        """``(owner, key)`` of each callable that a dispatch replays from
        a graph on the card (and runs eagerly elsewhere): an attribute of
        ``owner``, or where ``owner`` is a dict, its item."""
        raise NotImplementedError

    # -- shared -----------------------------------------------------------
    @staticmethod
    def algorithm_kwargs(cfg: dict) -> dict:
        kw = dict(cfg["algorithm_kwargs"])
        kw["hidden_sizes"] = tuple(kw["hidden_sizes"])
        kw["lagrangian_pid"] = tuple(kw["lagrangian_pid"])
        kw["compute_dtype"] = DTYPES[cfg["compute_dtype"]]
        return kw

    @staticmethod
    def split(flat: torch.Tensor, module, prefix: str = ""
              ) -> dict[str, torch.Tensor]:
        """``flat`` cut into ``module``'s parameters, in its flat order."""
        shapes = {k: p.shape for k, p in module.named_parameters()}
        names = (module.flat_names() if hasattr(module, "flat_names")
                 else list(shapes))
        out, off = {}, 0
        for k in names:
            n = shapes[k].numel()
            out[prefix + k] = flat[off:off + n].view(shapes[k])
            off += n
        return out

    def plant_frozen_replay(self) -> None:
        """Each graphed callable returns the carry it was given, and the
        first dispatch's metrics, from the second dispatch on: a replay
        that leaves its state unchanged."""
        for owner, key in self.graphed():
            fn, last = (owner[key] if isinstance(owner, dict)
                        else getattr(owner, key)), {}

            def frozen(carry, *reads, _fn=fn, _last=last):
                if self.dispatches <= 1:
                    _last["out"] = _fn(carry, *reads)
                    return _last["out"]
                return carry, _last["out"][1]
            if isinstance(owner, dict):
                owner[key] = frozen
            else:
                setattr(owner, key, frozen)

    @property
    def mode(self) -> str:
        return self.trainer.dispatch_mode

    def carry(self) -> tuple:
        """What a dispatch reads and replaces: the trainer's ``CARRY``."""
        return tuple(getattr(self.trainer, n) for n in self.trainer.CARRY)

    def generators(self) -> list[torch.Generator]:
        """The trainer's generator and the device's default one."""
        default = (torch.cuda.default_generators[self.device.index or 0]
                   if self.device.type == "cuda" else torch.default_generator)
        return [self.trainer.generator, default]

    def dispatch(self) -> dict:
        self.dispatches += 1
        return self.trainer._run_iter()

    def check_dispatches(self) -> None:
        """The set-up's dispatches, through the window's own call: the
        first runs eagerly (the graphs' warm-up), the second captures, the
        third replays. Read in the first dispatch, which has to run at
        least ``CHECKED_STEPS`` updates (or grad steps): the losses
        and the multiplier the first ``CHECKED_STEPS`` calls of
        :meth:`loss_source` report, and at the optimizers
        (:class:`Watched`) the first gradient and the parameters after
        ``CHECKED_STEPS`` grad steps. Then :meth:`check_replay`."""
        watched = []
        first_dispatch = lambda: self.dispatches == 1
        for owner, attr, params, leaves in self.optimizers():
            w = Watched(getattr(owner, attr), params,
                        frozen=self.fault == "frozen",
                        reading=first_dispatch)
            setattr(owner, attr, w)
            watched.append((w, leaves))
        owner, attr, losses = self.loss_source()
        call, loss, mult, calls = getattr(owner, attr), [], [], [0]

        def reported(*args, **kwargs):
            out = call(*args, **kwargs)
            if first_dispatch() and calls[0] < CHECKED_STEPS:
                calls[0] += 1
                loss.extend(losses(out))
                mult.extend(out[0].lag.multiplier.tolist())
            return out
        setattr(owner, attr, reported)
        start = dict(carry=snapshot(self.carry()),
                     rng=[g.get_state() for g in self.generators()])
        metrics = self.dispatch()
        first = dict(carry=snapshot(self.carry()), metrics=snapshot(metrics))
        for _ in range(SETUP_DISPATCHES - 1):
            self.dispatch()
        if calls[0] < CHECKED_STEPS or any(
                len(w.seen) <= CHECKED_STEPS for w, _ in watched):
            raise RuntimeError("the first dispatch ran fewer steps than "
                               "the check reads")
        grad, params, params0 = {}, {}, {}
        for w, leaves in watched:
            grad.update(leaves(w.grads[0]))
            params.update(leaves(w.seen[CHECKED_STEPS]))
            params0.update(leaves(w.seen[0]))
        differ = self.check_replay(start, first)
        self.readings = dict(loss=loss, multiplier=mult, grad=grad,
                             params=params, params0=params0,
                             replay_differs=differ)

    def check_replay(self, start: dict, first: dict) -> list[str]:
        """Once the graphs are captured: the trainer's state and
        generators set back to where the first dispatch started, one more
        dispatch through the window's own call (on the card a replay of
        every graph), its state and metrics held bit for bit against the
        first dispatch's; then the state and generators put back as they
        were. The paths that differ (``captured`` if the dispatch captured
        a graph, so replayed none that it had)."""
        from fsrl_torch.trainer import graphs

        gens = self.generators()
        now = dict(carry=snapshot(self.carry()),
                   rng=[g.get_state() for g in gens])
        restore(self.carry(), start["carry"])
        for g, s in zip(gens, start["rng"]):
            g.set_state(s)
        captures = sum(graphs.CAPTURES.values())
        metrics = self.dispatch()
        differ = (differing(self.carry(), first["carry"])
                  + differing(metrics, first["metrics"]))
        if sum(graphs.CAPTURES.values()) != captures:
            differ.append("captured")
        restore(self.carry(), now["carry"])
        for g, s in zip(gens, now["rng"]):
            g.set_state(s)
        return differ

    def free(self) -> None:
        self.trainer = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
