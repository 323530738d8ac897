"""The port's navigation envs for the car robot against JAX's: reset,
step and step_autoreset on JAX's initial states, per-step draws and reset
states, 20 steps of 8 envs (tolerance and scenarios in ``_torch_nav.py``)."""

import pytest
import torch
from _torch_nav import check_task

torch.set_num_threads(1)


@pytest.mark.parametrize("task", [
    f"SafetyCar{fam}{lvl}-v0" for fam in ("Goal", "Button", "Push", "Circle")
    for lvl in (1, 2)])
def test_car_task_matches_jax(task):
    check_task(task)
