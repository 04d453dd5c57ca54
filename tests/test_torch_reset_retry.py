"""The port's bad-init retry in Environment.reset against the JAX package's.

JAX's three cases (tests/test_reset_retry.py) against the port's
Environment at B = 64: with ``max_reset_attempts`` N an env keeps its
first finite draw of up to N, and N = 1 is a plain reset. The draws come
from different generators (jax.random against torch's), so the failure
counts are held to the JAX test's bounds, and a good init to JAX's state
bit for bit. Each case runs in well under a second on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu.physics import make_state as jax_make_state
from mujoco_mbrl_tpu.physics import mjcf as jax_mjcf
from mujoco_mbrl_tpu.suite import base as jax_base
from mujoco_mbrl_tpu.suite import control as jax_control
from mujoco_mbrl_tpu_torch import suite
from mujoco_mbrl_tpu_torch.physics import make_state, mjcf
from mujoco_mbrl_tpu_torch.suite import base, control

B = 64

# JAX's test model (tests/test_reset_retry.py)
_XML = """
<mujoco model='m'>
  <option timestep='0.01'/>
  <worldbody>
    <body name='b' pos='0 0 1'>
      <joint name='j' type='hinge' axis='0 1 0' limited='false'/>
      <geom name='g' type='sphere' size='.1'/>
    </body>
  </worldbody>
</mujoco>"""


class _FlakyInit(base.Task):
    """A NaN qpos where the env's uniform draw falls under `fail_prob`
    (JAX's _FlakyInit, one draw an env)."""

    OBSERVES_ACC = False

    def __init__(self, fail_prob):
        self._fail_prob = fail_prob

    def initialize_episode(self, model, batch, generator):
        u = torch.rand((batch,), generator=generator,
                       device=generator.device).to(model.device)
        st = make_state(model, batch=batch)
        qpos = torch.where((u < self._fail_prob)[:, None],
                           torch.full_like(st.qpos, float('nan')), st.qpos)
        return st.replace(qpos=qpos), ()

    def get_observation(self, model, phys, data):
        return {'pos': phys.qpos}

    def get_reward(self, model, phys, data, ctrl):
        return torch.zeros_like(phys.time)


class _JaxFlakyInit(jax_base.Task):
    """JAX's _FlakyInit, as tests/test_reset_retry.py defines it."""

    OBSERVES_ACC = False

    def __init__(self, fail_prob):
        self._fail_prob = fail_prob

    def initialize_episode(self, model, key):
        u = jax.random.uniform(key)
        st = jax_make_state(model)
        qpos = jnp.where(u < self._fail_prob,
                         jnp.full_like(st.qpos, jnp.nan), st.qpos)
        return st.replace(qpos=qpos), ()

    def get_observation(self, model, phys, data):
        return {'pos': phys.qpos}

    def get_reward(self, model, phys, data, ctrl):
        return jnp.zeros(())


def _env(fail_prob, attempts=1):
    return control.Environment(mjcf.parse(_XML), _FlakyInit(fail_prob),
                               max_reset_attempts=attempts)


def _count_bad(env, seed=0):
    state, _ = env.reset(B, torch.Generator().manual_seed(seed))
    return int((~torch.isfinite(state.physics.qpos)).any(1).sum())


def test_default_single_attempt_keeps_failures():
    assert _count_bad(_env(0.5)) > 10          # ~half fail with no retries


def test_retries_rescue_bad_inits():
    # P(all 6 draws bad) = 0.5^6; with 64 envs expect ~1 residual failure
    assert _count_bad(_env(0.5, 6)) <= 3


def test_good_inits_unchanged_by_retry_config():
    s1, ts1 = _env(0.0).reset(B, torch.Generator().manual_seed(7))
    s6, ts6 = _env(0.0, 6).reset(B, torch.Generator().manual_seed(7))
    assert torch.equal(s1.physics.qpos, s6.physics.qpos)
    assert torch.equal(ts1.observation['pos'], ts6.observation['pos'])


def test_good_init_reset_is_jaxs_state():
    """The port's N = 1 reset of a good init holds JAX's state, bit for
    bit, and so does each package's N = 6 reset."""
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    m = jax_mjcf.parse(_XML)
    for attempts in (1, 6):
        env = jax_control.Environment(m, _JaxFlakyInit(0.0),
                                      max_reset_attempts=attempts)
        ref, ref_ts = jax.jit(jax.vmap(env.reset))(keys)
        state, ts = _env(0.0, attempts).reset(
            B, torch.Generator().manual_seed(0))
        for ours, theirs in ((state.physics.qpos, ref.physics.qpos),
                             (state.physics.qvel, ref.physics.qvel),
                             (state.physics.time, ref.physics.time),
                             (ts.observation['pos'],
                              ref_ts.observation['pos'])):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_single_attempt_is_a_plain_reset():
    """N = 1 draws once: the reset and the generator's stream after it are
    those of the task's own initialize_episode, as before retries were
    ported; a walker draw never diverges, so N = 6 resets the same."""
    env = suite.load('walker', 'walk', device='cpu')
    g_ref = torch.Generator().manual_seed(3)
    phys, params = env.task.initialize_episode(env.model, 16, g_ref)
    ref, ref_ts = env.start(phys, params)
    for attempts in (1, 6):
        env6 = suite.load('walker', 'walk', device='cpu',
                          environment_kwargs={'max_reset_attempts': attempts})
        g = torch.Generator().manual_seed(3)
        state, ts = env6.reset(16, g)
        assert torch.equal(state.physics.qpos, ref.physics.qpos)
        assert torch.equal(state.physics.qvel, ref.physics.qvel)
        for k, v in ref_ts.observation.items():
            assert torch.equal(ts.observation[k], v), k
        if attempts == 1:
            assert torch.equal(g.get_state(), g_ref.get_state())


def test_zero_attempts_is_refused():
    with pytest.raises(ValueError, match='max_reset_attempts'):
        _env(0.0, 0)


def test_autoreset_retries_too():
    """autoreset_step's reset takes the retries, as JAX's does."""
    env = _env(0.5, 6)
    g = torch.Generator().manual_seed(1)
    state, _ = env.reset(B, g)
    state = control.EnvState(physics=state.physics, params=state.params,
                             step_count=state.step_count,
                             last=torch.ones_like(state.last))
    state, ts = env.autoreset_step(state, torch.zeros((B, 0)), g)
    assert int((~torch.isfinite(state.physics.qpos)).any(1).sum()) <= 3
    assert bool((ts.step_type == control.FIRST).all())


@pytest.mark.parametrize('domain,task', suite.all_tasks())
def test_environment_kwargs_reach_the_retries(domain, task):
    """suite.load's environment_kwargs reach max_reset_attempts in every
    task, as in JAX (and contact_fn is stored as JAX stores it)."""
    env = suite.load(domain_name=domain, task_name=task, device='cpu',
                     environment_kwargs={'max_reset_attempts': 4,
                                         'contact_fn': None})
    assert env._max_reset_attempts == 4
    assert env._contact_fn is None
