"""The port's ``HostOffpolicyTrainer`` against the JAX package's on the
stub env of ``_torch_host.py``: the buffer's capacity and ``n_updates``,
the replay buffer after one collected segment (mean actions of the same
weights), and one ``update_block`` of SAC-Lag (the PID step, the grad
steps, the hooks) with JAX's draws injected, held to
``test_torch_sac_lag.py``'s tolerances."""

import jax
import numpy as np
import pytest
import torch
from _torch_host import A, D, stub_venvs
from _torch_parity import n, offpolicy_draws, state_dict
from test_torch_sac_lag import assert_state_matches

from fsrl_torch.algos.sac_lag import SACLag
from fsrl_torch.trainer.host_trainer import HostOffpolicyTrainer
from fsrl_tpu.algos.sac_lag import SACLag as JSACLag
from fsrl_tpu.trainer.host_trainer import \
    HostOffpolicyTrainer as JHostOffpolicyTrainer

torch.set_num_threads(1)

T, N, B = 12, 4, 16
ALGO = dict(hidden_sizes=(32, 32), batch_size=B, cost_limit=0.5,
            deterministic_eval=True)
TRAIN = dict(steps_per_collect=T, buffer_size=64, update_per_step=0.05,
             seed=0, verbose=False)


@pytest.fixture(scope="module")
def trainers():
    jv, tv = stub_venvs(N)
    jalgo, talgo = JSACLag(D, A, **ALGO), SACLag(D, A, device="cpu", **ALGO)
    jtr = JHostOffpolicyTrainer(jalgo, jv, **TRAIN)
    ttr = HostOffpolicyTrainer(talgo, tv, **TRAIN)
    ttr.state = talgo.init(state_dict=state_dict(jtr.state.params))
    jtr.act_fn = jax.jit(jalgo.act_fn_eval)
    ttr.act_fn = talgo.act_fn_eval
    jseg, tseg = jtr.collect_segment(), ttr.collect_segment()
    jtr.buf_state = jtr.buffer.add_segment(jtr.buf_state, jseg[0])
    ttr.buf_state = ttr.buffer.add_segment(ttr.buf_state, tseg[0])
    return jtr, ttr, jseg, tseg


def test_buffer_and_update_count_match_jax(trainers):
    jtr, ttr, _, _ = trainers
    # max(64 // 4, 12) rows a env; round(0.05 * 12 * 4) grad steps
    assert (ttr.buffer.C, ttr.buffer.N) == (jtr.buffer.C, jtr.buffer.N) \
        == (16, N)
    assert ttr.n_updates == jtr.n_updates == 2
    js, ts = jtr.buf_state, ttr.buf_state
    assert (ts.pos, ts.filled) == (int(js.pos), int(js.filled)) == (T, T)
    for name in ("obs", "obs_next", "reward", "cost", "terminated",
                 "truncated"):
        want, got = np.asarray(getattr(js.data, name)), \
            n(getattr(ts.data, name))
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("act", "logp"):
        np.testing.assert_allclose(n(getattr(ts.data, name)),
                                   np.asarray(getattr(js.data, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_update_block_matches_jax(trainers):
    jtr, ttr, (_, jc, jn), (_, tc, tn) = trainers
    assert float(tc[0]) == pytest.approx(float(jc[0])) and int(tn) == int(jn)
    assert float(tc[0]) > ALGO["cost_limit"]     # the multiplier moves
    rng = jax.random.PRNGKey(9)
    jstate, jm = jtr.update_block(jtr.state, jtr.buf_state, jc, jn, rng)
    draws = [offpolicy_draws(k, B, int(jtr.buf_state.filled), N, A,
                             "sac_lag")
             for k in jax.random.split(rng, jtr.n_updates)]
    tm = ttr.update_block(tc, tn, draws=draws)
    tstate = ttr.state
    assert int(tstate.gradient_steps) == int(jstate.gradient_steps) == 2
    assert float(tstate.lag.multiplier[0]) > 0.0
    np.testing.assert_allclose(n(tstate.lag.multiplier),
                               np.asarray(jstate.lag.multiplier), rtol=1e-6)
    assert_state_matches(jstate, tstate, p_atol=1e-6, mom_rtol=1e-3)
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                             abs=1e-6), k
