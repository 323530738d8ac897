"""CUDA graphs: the port's counterpart of ``jax.jit`` with donated
arguments.

Where the JAX package puts several steps into one compiled dispatch (the
trainers' ``fuse_iters`` and ``update_chunk``, the collector's ``unroll``),
the port records the eager code once into a CUDA graph and replays it.
:class:`Dispatch` wraps a function ``fn(carry, *reads) -> (carry, out)``:

* ``carry`` is a tree (dataclasses, dicts, lists, tuples) of tensors that
  the function replaces or updates, e.g. the training state, the env state
  and the episode statistics. A module in the tree is kept by identity:
  its parameters must be updated in place, as every algorithm of the port
  does. An int, float, bool, string or None in the tree is static: a call
  whose static values differ (the replay buffer's fill count, say) is a
  different graph.
* ``reads`` are trees of tensors the function only reads (the replay
  buffer, its n-step view).
* ``out`` is what the function returns besides the carry (the metrics).

The first call runs ``fn`` eagerly on the capture stream: the warm-up
(cuBLAS handles, the kernel library, the autograd engine) that a capture
needs, with the same results as any eager call. A later call captures
``fn`` and replays it. A call with another structure captures anew; a
``Dispatch`` keeps one graph.

The carry is donated, as a JAX buffer under ``donate_argnums`` is. The
graph's inputs are the carry's own tensors at capture: they cannot be
copies, since the carry's modules may view them (PPO-Lag's parameters
view its flat vector). Each graph ends by copying the new carry into
those inputs, and the carry that comes back holds them; so each replay
reads the previous one's result in place. A call given other tensors
(a state set from outside) copies their values into the inputs first.
So a later call writes into every carry tensor that a call was given or
returned: a caller that needs such a tensor's value after the next call
clones it. ``out`` lives in the graph's memory, and the next replay
overwrites it too.

The reads are the ``Dispatch``'s own: it clones them at capture and
copies the caller's values into its clones at each call, so it never
writes into a tensor that the caller only lent it.

Random draws: every generator the function draws from is registered with
the graph (``CUDAGraph.register_generator_state``), so each replay draws
what the eager call would have drawn from the generator's current state,
and eager draws after it continue the same stream.

Kernel launches: the kernel wrappers count their launches in Python
(``fsrl_torch.ops.kernels.LAUNCHES``), which a replay does not run. A
``Dispatch`` keeps the launches counted while it captured (``launches``)
and counts its replays (``replays``); a graphed path launched each kernel
``launches[name] * replays`` times. ``CAPTURES`` and ``REPLAYS`` count
the captures and replays of every ``Dispatch`` by name, over the
process, as ``LAUNCHES`` counts launches: a caller that cannot reach a
path's ``Dispatch`` objects (a runner's trainer) reads them there.

No garbage collection runs during a capture: a graph freed in it (a
trainer gone out of use and its graph refer to each other, so the
collector frees them) would end the capture. Nothing falls back: a
capture or replay that fails raises. Data-parallel
training (collectives through the host over gloo) is not graphed; the
trainers run it eagerly.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
from typing import Any, Callable, Hashable, Sequence

import torch
from torch import nn

from fsrl_torch.device import capturing
from fsrl_torch.ops import kernels

Tensor = torch.Tensor

# captures and replays by dispatch name, over the process
CAPTURES: collections.Counter = collections.Counter()
REPLAYS: collections.Counter = collections.Counter()


def flatten(tree: Any) -> tuple[list[Tensor], Hashable]:
    """The tensors of ``tree`` in a fixed order, and its spec: the
    structure with each tensor's shape, dtype and device, each module's
    identity and each static value."""
    leaves: list[Tensor] = []
    return leaves, _spec(tree, leaves)


def _spec(tree: Any, leaves: list) -> Hashable:
    if isinstance(tree, Tensor):
        leaves.append(tree)
        return ("tensor",) + _layout(tree)
    if isinstance(tree, nn.Module):
        return ("module", id(tree))
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return ("static", type(tree), tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree), tuple(
            (f.name, _spec(getattr(tree, f.name), leaves))
            for f in dataclasses.fields(tree) if f.init))
    if isinstance(tree, dict):
        return (dict, tuple((k, _spec(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_spec(v, leaves) for v in tree))
    raise TypeError(f"a graph's carry cannot hold a {type(tree).__name__}")


def rebuild(tree: Any, tensors: Sequence[Tensor]) -> Any:
    """``tree`` with its tensors, in :func:`flatten`'s order, replaced by
    ``tensors``."""
    it = iter(tensors)
    out = _rebuild(tree, it)
    if next(it, None) is not None:
        raise ValueError("more tensors than the tree holds")
    return out


def _rebuild(tree: Any, it) -> Any:
    if isinstance(tree, Tensor):
        return next(it)
    if isinstance(tree, nn.Module) or tree is None or isinstance(
            tree, (bool, int, float, str)):
        return tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), it)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    items = [_rebuild(v, it) for v in tree]
    if hasattr(tree, "_fields"):                      # a NamedTuple
        return type(tree)(*items)
    return type(tree)(items)


def _layout(x: Tensor) -> tuple:
    return tuple(x.shape), x.dtype, x.device


def _storage(x: Tensor) -> int:
    return x.untyped_storage().data_ptr()


def assign(dst: Sequence[Tensor], src: Sequence[Tensor]) -> None:
    """``dst[i].copy_(src[i])`` wherever the two are not the same tensor.
    A source that shares memory with a destination other than itself is
    cloned before the first copy, so no copy reads a value another one
    wrote."""
    taken = {_storage(d) for d in dst}
    src = [s if s is d or _storage(s) not in taken else s.clone()
           for d, s in zip(dst, src)]
    for d, s in zip(dst, src):
        if s is not d:
            d.copy_(s)


def distinct(tree: Any) -> Any:
    """``tree`` with every tensor that shares memory with an earlier one
    cloned, so that copying into one tensor changes no other."""
    leaves, _ = flatten(tree)
    seen, out = set(), []
    for x in leaves:
        out.append(x.clone() if _storage(x) in seen else x)
        seen.add(_storage(x))
    return rebuild(tree, out)


class _Captured:
    """One captured graph: its inputs, the carry and output it returns."""

    def __init__(self, key, graph, inputs, reads, carry, out, launches):
        self.key, self.graph = key, graph
        self.inputs, self.reads = inputs, reads
        self.carry, self.out = carry, out
        self.launches = launches


class Dispatch:
    """``fn(carry, *reads) -> (carry, out)`` replayed from a CUDA graph
    (see the module's docstring). ``generators`` are the generators ``fn``
    draws from; ``name`` labels errors."""

    def __init__(self, fn: Callable, generators: Sequence[torch.Generator]
                 = (), name: str = "dispatch"):
        self.fn, self.generators, self.name = fn, tuple(generators), name
        self.stream: torch.cuda.Stream | None = None
        self.captured: _Captured | None = None
        self.captures = 0
        self.replays = 0

    @property
    def launches(self) -> collections.Counter:
        """Kernel launches of one replay, as counted while capturing."""
        return (collections.Counter() if self.captured is None
                else self.captured.launches)

    def _side(self):
        """The capture stream, made to wait for the current one."""
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        self.stream.wait_stream(torch.cuda.current_stream())
        return torch.cuda.stream(self.stream)

    def __call__(self, carry: Any, *reads: Any) -> tuple[Any, Any]:
        if capturing():
            raise RuntimeError(f"{self.name}: a graph cannot be captured "
                               "inside another graph's capture")
        if self.stream is None:                 # the warm-up, eager
            with self._side():
                res = self.fn(carry, *reads)
            torch.cuda.current_stream().wait_stream(self.stream)
            return res
        key = (flatten(carry)[1], flatten(reads)[1])
        cap = self.captured
        if cap is None or cap.key != key:
            cap = self._capture(key, carry, reads)
        assign(cap.inputs, flatten(carry)[0])
        assign(flatten(cap.reads)[0], flatten(reads)[0])
        cap.graph.replay()
        self.replays += 1
        REPLAYS[self.name] += 1
        return cap.carry, cap.out

    def _capture(self, key, carry, reads) -> _Captured:
        if self.captured is not None:           # one graph at a time
            self.captured.graph.reset()
            self.captured = None
        carry = distinct(carry)
        inputs, _ = flatten(carry)
        reads = rebuild(reads, [x.clone() for x in flatten(reads)[0]])
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = collections.Counter(kernels.LAUNCHES)
        # a graph freed during the capture would end it, and the garbage
        # collector frees graphs (a trainer and its graph's function refer
        # to each other): it does not run in a capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with self._side():
                # the graph context makes its own stream wait for this one
                with torch.cuda.graph(graph, stream=self.stream):
                    new, out = self.fn(carry, *reads)
                    new_leaves, _ = flatten(new)
                    if [_layout(x) for x in new_leaves] != [
                            _layout(x) for x in inputs]:
                        raise ValueError(
                            f"{self.name}: the carry's tensors changed "
                            "number, shape, dtype or place across the call")
                    # an output that is one of the inputs would change
                    # with the copies below
                    taken = {_storage(x) for x in inputs}
                    out_leaves, _ = flatten(out)
                    out = rebuild(out, [x.clone() if _storage(x) in taken
                                        else x for x in out_leaves])
                    assign(inputs, new_leaves)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream().wait_stream(self.stream)
        self.captures += 1
        CAPTURES[self.name] += 1
        launches = collections.Counter(kernels.LAUNCHES)
        launches.subtract(before)
        self.captured = _Captured(
            key, graph, inputs, reads, rebuild(new, inputs), out,
            +launches)
        return self.captured
