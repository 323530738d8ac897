"""The on-policy program of :mod:`portbench.drivers.onpolicy` at fewer
fused cycles a dispatch (``fuse_iters``) than the updates the check reads
(``CHECKED_STEPS``).

The check reads the program's first ``CHECKED_STEPS`` updates in the
set-up's first dispatch, whose eager cycles are the graph's warm-up. Here
that dispatch, once its ``fuse_iters`` cycles have run, runs eagerly the
cycles that follow until the check has read its updates, then sets the
trainer's state and generators back to where its own cycles left them:
the program goes on from there as it would have, the graph is captured
and replayed from there, and the replay is held against the first
dispatch's own cycles. The cycles run ahead are what the program's next
dispatch computes (the replay's equality to the eager cycles is what the
check holds), so the check reads the program's first updates.
"""

from __future__ import annotations

from portbench.drivers import onpolicy
from portbench.drivers.common import CHECKED_STEPS, restore, snapshot


class Program(onpolicy.Program):

    def dispatch(self) -> dict:
        metrics = super().dispatch()
        if self.dispatches == 1:
            self.look_ahead(CHECKED_STEPS - self.trainer.fuse_iters)
        return metrics

    def look_ahead(self, cycles: int) -> None:
        """``cycles`` eager cycles, counted in the first dispatch; then the
        state and generators set back."""
        if cycles <= 0:
            return
        gens = self.generators()
        carry = snapshot(self.carry())
        rng = [g.get_state() for g in gens]
        for _ in range(cycles):
            self.trainer.cycle()
        restore(self.carry(), carry)
        for g, s in zip(gens, rng):
            g.set_state(s)
