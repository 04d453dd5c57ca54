"""The composer stack, port against the JAX package: ``composer``
(entities, attach, observables and their options, the task adapter,
``make_env``), ``observation`` (the buffer pipeline and
``BufferedEnvironment``), ``variation`` and ``props``.

The same entities are built through both packages from one source (the
factories below take the package's modules; observables index with
``...`` so one body reads JAX's unbatched and the port's batched
arrays). Inputs are drawn with numpy or by JAX's vmapped reset (B = 4)
and carried across with ``convert``:

* the composed Models field by field (rtol 1e-5: ``assert_model_matches``);
* ``update_buffer`` / ``read_buffer`` over one value sequence per env,
  exactly, the even-count median (the mean of the two middle values, as
  ``jnp.median``) included;
* three control steps of a buffered composed env from JAX-drawn resets
  (delay 1, buffer 4, mean), qpos, qvel, every observation and reward
  within 1e-5;
* the props' observables and detections (2-D, 3-D, inverted) on numpy
  poses (JAX's functions read the port's kinematics), exactly for the
  flags and within 1e-6 for the values, and a
  ball falling into a detector's zone in the buffered scene's steps;
* the variations by their law (their draws cannot match ``jax.random``'s),
  and ``evaluate``'s sub-streams by the sorted order of the keys.

The JAX environments are built once a module and one step is jitted
(the buffered scene's: two pendulums and a falling ball).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu import composer as jcomposer
from mujoco_mbrl_tpu import observation as jobservation
from mujoco_mbrl_tpu import props as jprops
from mujoco_mbrl_tpu import variation as jvariation
from mujoco_mbrl_tpu.locomotion import arenas as jarenas
from mujoco_mbrl_tpu.physics import builder as jbuilder
from mujoco_mbrl_tpu_torch import composer, convert, observation, props
from mujoco_mbrl_tpu_torch import variation
from mujoco_mbrl_tpu_torch.locomotion import arenas
from mujoco_mbrl_tpu_torch.physics import builder, engine
from mujoco_mbrl_tpu_torch.physics import model as M
from test_torch_cartpole import assert_model_matches

B = 4
TOL = dict(rtol=1e-5, atol=1e-5)
JAX = dict(composer=jcomposer, builder=jbuilder, props=jprops,
           arenas=jarenas, observation=jobservation, cos=jnp.cos)
PORT = dict(composer=composer, builder=builder, props=props, arenas=arenas,
            observation=observation, cos=torch.cos)


# ---- one source, both packages ----------------------------------------------

def swingup_task(pkg, buffered=True):
    """The pendulums of JAX's tests/test_observation.py: an arena, a
    torque-driven pendulum with `angle`, `velocity` and (buffered) a
    delayed mean of the velocity over 4 steps, a second one geared 3x,
    and (buffered) a ball Primitive dropped into a PositionDetector's
    zone."""
    C, bld = pkg['composer'], pkg['builder']

    class Arena(C.Entity):
        def _build(self):
            root = bld.RootElement(model='arena')
            root.option(timestep=0.01)
            root.worldbody.add('geom', name='floor', type='plane',
                               size=[5, 5, 0.1])
            return root

    class Pendulum(C.Entity):
        def _build(self, gear=1.0):
            root = bld.RootElement(model='pendulum')
            body = root.worldbody.add('body', name='pole', pos=[0, 0, 1])
            body.add('joint', name='hinge', type='hinge', axis=[0, 1, 0],
                     damping=0.05)
            body.add('geom', name='mass', type='sphere', size=[0.05],
                     mass=1, pos=[0.4, 0, 0])
            root.actuator.add('motor', name='torque', joint='hinge',
                              gear=gear)
            return root

        @C.observable
        def angle(self, model, phys, data):
            j = model.names['joint'][self.name('hinge')]
            return phys.qpos[..., model.jnt_qposadr[j]]

        @C.observable
        def tip_height(self, model, phys, data):
            return data.xpos[..., model.names['body'][self.name('pole')], 2]

        @C.observable
        def velocity(self, model, phys, data):
            j = model.names['joint'][self.name('hinge')]
            return phys.qvel[..., model.jnt_dofadr[j]]

    if buffered:
        class Smoothed(Pendulum):
            @C.observable(buffer_size=4, aggregator='mean', delay=1)
            def smoothed_velocity(self, model, phys, data):
                j = model.names['joint'][self.name('hinge')]
                return phys.qvel[..., model.jnt_dofadr[j]]
        pend_cls = Smoothed
    else:
        pend_cls = Pendulum

    class SwingUp(C.Task):
        control_timestep = 0.02

        def __init__(self):
            super().__init__(Arena())
            self.pendulum = self.attach(pend_cls(), 'pend/')
            self.other = self.attach(Pendulum(gear=3.0), 'other/')
            if buffered:
                # a ball dropped beside the pendulums into a detector zone
                P = pkg['props']
                self.ball = self.attach(P.Primitive(
                    geom_type='sphere', size=[0.1], pos=(2.0, 0.0, 0.5)),
                    'prop/')
                self.detector = self.attach(P.PositionDetector(
                    pos=[2.0, 0.0, 0.15], size=[0.3, 0.3, 0.15]), 'det/')
                self.detector.register_entities(self.ball)

        def get_reward(self, model, phys, data, ctrl):
            j = model.names['joint']['pend/hinge']
            return pkg['cos'](phys.qpos[..., model.jnt_qposadr[j]])

    return SwingUp()


def prop_task(pkg, inverted=False, size=(0.3, 0.3, 0.15)):
    """Floor + a sphere and a box Primitive + a PositionDetector (2-D or
    3-D after len(size)) registering both (JAX's tests/test_props.py)."""
    C, P = pkg['composer'], pkg['props']

    class PropTask(C.Task):
        OBSERVES_ACC = False

        def __init__(self):
            super().__init__(pkg['arenas'].Floor(size=(4.0, 4.0)))
            self.ball = self.attach(P.Primitive(
                geom_type='sphere', size=[0.1], pos=(0.0, 0.0, 0.5)),
                'prop/')
            self.box = self.attach(P.Primitive(
                geom_type='box', size=[0.1, 0.1, 0.1], pos=(0.5, 0.5, 0.4),
                name='crate'), 'box/')
            self.detector = self.attach(P.PositionDetector(
                pos=[1.0, 0.0, 0.15], size=list(size), inverted=inverted),
                'det/')
            self.detector.register_entities(self.ball, self.box)

        def get_reward(self, model, phys, data, ctrl):
            return self.detector.detections(model, data).sum(-1) * 1.0

    return PropTask()


_ENVS = {}


def envs(name):
    """(port env on the CPU, JAX env, JAX task, port task), built once."""
    if name not in _ENVS:
        make = {'swingup': lambda pkg: swingup_task(pkg),
                'props': lambda pkg: prop_task(pkg)}[name]
        kw = {'props': dict(control_timestep=0.02)}.get(name, {})
        # both packages' scenes from one source
        jt, pt = make(JAX), make(PORT)
        _ENVS[name] = (composer.make_env(pt, time_limit=1.0, device='cpu',
                                         **kw),
                       jcomposer.make_env(jt, time_limit=1.0, **kw), jt, pt)
    return _ENVS[name]


_JSTEPS = {}


def jax_step(name):
    if name not in _JSTEPS:
        _JSTEPS[name] = jax.jit(jax.vmap(envs(name)[1].step))
    return _JSTEPS[name]


def jax_reset(env, seed, n=B):
    """JAX's reset of n envs (vmapped, jitted: an eager reset runs its
    forward op by op)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.jit(jax.vmap(env.reset))(keys)


def as_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def assert_obs_close(ours, ref, tol=TOL):
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(as_np(ours[k]), as_np(ref[k]),
                                   err_msg=k, **tol)


# ---- models -------------------------------------------------------------------

@pytest.mark.parametrize('name', ['swingup', 'props'])
def test_composed_model_matches_jax(name):
    env, jenv, _, _ = envs(name)
    m, jm = env.model, jenv.model
    assert_model_matches(jm, m)
    assert m.device.type == 'cpu'


def test_observables_specs_and_adapter_match_jax():
    env, jenv, jt, pt = envs('swingup')
    assert isinstance(env, observation.BufferedEnvironment)
    assert isinstance(jenv, jobservation.BufferedEnvironment)
    assert sorted(pt.observables()) == sorted(jt.observables())
    specs, jspecs = pt.observable_specs(), jt.observable_specs()
    assert sorted(specs) == sorted(jspecs) == ['pend/smoothed_velocity']
    for k in specs:
        for f in ('update_interval', 'buffer_size', 'delay', 'enabled'):
            assert getattr(specs[k], f) == getattr(jspecs[k], f), (k, f)
    # no get_termination on the task: none surfaced on the adapter
    assert not hasattr(env.task, 'get_termination')
    assert not hasattr(jenv.task, 'get_termination')


def test_enable_observable_is_per_instance():
    from mujoco_mbrl_tpu_torch.locomotion import walkers
    a, b = walkers.PlanarWalker(), walkers.PlanarWalker()
    a.enable_observable('egocentric_camera')
    assert composer._collect_observable_specs(a)[
        'egocentric_camera'].enabled
    assert not composer._collect_observable_specs(b)[
        'egocentric_camera'].enabled
    with pytest.raises(KeyError):
        a.enable_observable('no_such_observable')


# ---- the buffer pipeline --------------------------------------------------------

_SPECS = {
    'passthrough': dict(),
    'delay2': dict(delay=2),
    'interval3': dict(update_interval=3),
    'interval2_delay1': dict(update_interval=2, delay=1),
    'mean3': dict(buffer_size=3, aggregator='mean'),
    'median4': dict(buffer_size=4, aggregator='median', delay=2),
    'median3': dict(buffer_size=3, aggregator='median'),
    'max4': dict(buffer_size=4, aggregator='max', delay=1),
    'min2': dict(buffer_size=2, aggregator='min'),
    'sum3': dict(buffer_size=3, aggregator='sum', update_interval=2),
    'stack2': dict(buffer_size=2),
}


@pytest.mark.parametrize('case', sorted(_SPECS))
def test_update_and_read_buffer_match_jax_exactly(case):
    """Ten steps of one numpy value sequence per env (B = 3 envs, a (2,)
    observable), JAX per env against the port's batch, bit for bit."""
    rng = np.random.default_rng(len(case))
    values = rng.normal(size=(11, 3, 2)).astype(np.float32)
    spec = observation.ObservableSpec(**_SPECS[case])
    jspec = jobservation.ObservableSpec(**_SPECS[case])
    st = observation.init_buffer(spec, torch.tensor(values[0]))
    jst = [jobservation.init_buffer(jspec, jnp.asarray(values[0, b]))
           for b in range(3)]
    for t in range(1, 11):
        st = observation.update_buffer(spec, st, torch.tensor(values[t]))
        jst = [jobservation.update_buffer(jspec, s, jnp.asarray(values[t, b]))
               for b, s in enumerate(jst)]
        ours = observation.read_buffer(spec, st).numpy()
        ref = np.stack([np.asarray(jobservation.read_buffer(jspec, s))
                        for s in jst])
        np.testing.assert_array_equal(ours, ref, err_msg=f'{case} step {t}')
    ref_st = jax.tree_util.tree_map(lambda *x: np.stack(x), *jst)
    conv = convert.buffer_state(ref_st)
    for f in ('pending', 'ring', 'step'):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      getattr(conv, f).numpy(), err_msg=f)


def test_even_count_median_is_the_mean_of_the_middle_two():
    buf = torch.tensor([[[4.0], [1.0], [3.0], [2.0]]])
    assert float(observation.AGGREGATORS['median'](buf)) == 2.5
    assert float(jnp.median(jnp.array([4.0, 1.0, 3.0, 2.0]))) == 2.5


def test_corruptor_needs_a_generator():
    spec = observation.ObservableSpec(corruptor=variation.Additive(
        variation.Normal(0.0, 0.1)))
    st = observation.init_buffer(spec, torch.zeros(2))
    with pytest.raises(ValueError):
        observation.update_buffer(spec, st, torch.zeros(2))


def test_buffered_env_steps_like_jax_from_jax_resets():
    """Three control steps from JAX-drawn resets with numpy actions: the
    inner state, every observation (the delayed mean included), reward and
    step type within 1e-5; the converted buffers equal JAX's."""
    env, jenv, _, _ = envs('swingup')
    jstate, jts = jax_reset(jenv, 3)
    state = convert.composed_env_state(jstate)
    # a swung-out start, so the pendulum moves
    qpos = np.asarray(jstate['inner'].physics.qpos).copy()
    qpos[:, :2] += np.random.default_rng(0).normal(0, 0.5, (B, 2))
    jstate = dict(jstate, inner=jstate['inner'].replace(
        physics=jstate['inner'].physics.replace(qpos=jnp.asarray(qpos))))
    state['inner'] = dataclasses.replace(state['inner'], physics=state[
        'inner'].physics.replace(qpos=torch.tensor(qpos)))
    acts = np.random.default_rng(1).uniform(-1, 1, (3, B, 2)).astype(
        np.float32)
    step = jax_step('swingup')
    for k in range(3):
        jstate, jts = step(jstate, jnp.asarray(acts[k]))
        state, ts = env.step(state, torch.tensor(acts[k]))
        for f in ('qpos', 'qvel'):
            np.testing.assert_allclose(
                as_np(getattr(state['inner'].physics, f)),
                as_np(getattr(jstate['inner'].physics, f)), **TOL)
        assert_obs_close(ts.observation, jts.observation)
        np.testing.assert_allclose(as_np(ts.reward), as_np(jts.reward),
                                   **TOL)
        np.testing.assert_array_equal(as_np(ts.step_type),
                                      as_np(jts.step_type))
    conv = convert.composed_env_state(jax.tree_util.tree_map(np.asarray,
                                                             jstate))
    for name, st in conv['buffers'].items():
        np.testing.assert_allclose(state['buffers'][name].ring.numpy(),
                                   st.ring.numpy(), **TOL)
        np.testing.assert_array_equal(state['buffers'][name].step.numpy(),
                                      st.step.numpy())


def test_buffered_env_reset_and_determinism():
    env = envs('swingup')[0]
    s1, ts1 = env.reset(B, torch.Generator().manual_seed(5))
    assert 'pend/smoothed_velocity' in ts1.observation
    assert ts1.observation['pend/smoothed_velocity'].shape == (B,)
    a = torch.full((B, 2), 0.5)
    out1 = env.step(s1, a)[1].observation
    out2 = env.step(s1, a)[1].observation       # the same state again
    for k in out1:
        assert torch.equal(out1[k], out2[k]), k


def test_corruptor_noise_by_its_law():
    """An Additive(Normal(0, 0.1)) corruptor on a pipeline observable:
    over 4096 envs the noise has mean 0 and std 0.1 (4 sigma bands), and
    a state stepped twice draws the same noise."""
    base = swingup_task(PORT, buffered=False)

    class Noisy(composer.Task):
        OBSERVES_ACC = False

        def __init__(self):
            super().__init__(base.root_entity)
            self.attach(base.other, 'p/')

        @composer.observable(corruptor=variation.Additive(
            variation.Normal(0.0, 0.1)))
        def noisy_angle(self, model, phys, data):
            return phys.qpos[:, 0]

        def get_reward(self, model, phys, data, ctrl):
            return torch.zeros_like(phys.qpos[:, 0])

    env = composer.make_env(Noisy(), device='cpu')
    n = 4096
    s, ts = env.reset(n, torch.Generator().manual_seed(0))
    s1, ts1 = env.step(s, torch.zeros(n, env.model.nu))
    noise = ts1.observation['noisy_angle'] - s1['inner'].physics.qpos[:, 0]
    assert abs(float(noise.mean())) < 4 * 0.1 / np.sqrt(n)
    assert abs(float(noise.std()) - 0.1) < 4 * 0.1 / np.sqrt(2 * n)
    _, ts2 = env.step(s, torch.zeros(n, env.model.nu))
    assert torch.equal(ts1.observation['noisy_angle'],
                       ts2.observation['noisy_angle'])


# ---- variation ----------------------------------------------------------------

def test_distributions_by_their_law():
    g = torch.Generator().manual_seed(0)
    n = 20000
    u = variation.Uniform(2.0, 3.0)(g, (n,))
    assert float(u.min()) >= 2.0 and float(u.max()) < 3.0
    assert abs(float(u.mean()) - 2.5) < 4 * (1 / np.sqrt(12)) / np.sqrt(n)
    x = variation.Normal(5.0, 0.1)(g, (n,))
    assert abs(float(x.mean()) - 5.0) < 4 * 0.1 / np.sqrt(n)
    assert abs(float(x.std()) - 0.1) < 0.005
    ln = variation.LogNormal(0.5, 0.2)(g, (n,))
    assert abs(float(torch.log(ln).mean()) - 0.5) < 4 * 0.2 / np.sqrt(n)
    e = variation.Exponential(2.0)(g, (n,))
    assert float(e.min()) >= 0 and abs(float(e.mean()) - 2.0) < 0.1
    bern = variation.Bernoulli(0.3)(g, (n,))
    assert bern.dtype == torch.bool
    assert abs(float(bern.float().mean()) - 0.3) < 4 * np.sqrt(.21 / n)
    c = variation.UniformChoice([1., 4., 9.])(g, (600,))
    assert set(np.unique(c.numpy())) == {1., 4., 9.}
    s = variation.UniformPointOnSphere()(g, (10,))
    assert s.shape == (10, 3)
    np.testing.assert_allclose(np.linalg.norm(s.numpy(), axis=-1), 1.0,
                               rtol=1e-6)
    # the same laws as JAX's draws, on JAX's own samples' first moments
    jn = jvariation.Normal(5.0, 0.1)(jax.random.PRNGKey(0), (n,))
    assert abs(float(jn.mean()) - float(x.mean())) < 8 * 0.1 / np.sqrt(n)


def test_noises_and_evaluate():
    g = torch.Generator().manual_seed(1)
    v = torch.ones(5000)
    a = variation.Additive(variation.Normal(0.0, 0.2))(g, v)
    m = variation.Multiplicative(variation.Uniform(0.5, 1.5))(g, v)
    assert abs(float((a - 1).std()) - 0.2) < 0.01
    assert float(m.min()) >= 0.5 and float(m.max()) < 1.5
    tree = {'b': 3.0, 'a': variation.Uniform(0, 1),
            'c': [variation.Normal(), 2.0]}
    out = variation.evaluate(tree, torch.Generator().manual_seed(0))
    jout = jvariation.evaluate(tree_j := {
        'b': 3.0, 'a': jvariation.Uniform(0, 1),
        'c': [jvariation.Normal(), 2.0]}, jax.random.PRNGKey(0))
    assert set(out) == set(jout) == set(tree_j)
    assert isinstance(out['a'], torch.Tensor) and out['a'].shape == ()
    assert out['b'] == 3.0 and out['c'][1] == 2.0
    # sub-streams follow the sorted keys, not the insertion order
    again = variation.evaluate({'c': [variation.Normal(), 2.0], 'b': 3.0,
                                'a': variation.Uniform(0, 1)},
                               torch.Generator().manual_seed(0))
    assert float(again['a']) == float(out['a'])
    assert float(again['c'][0]) == float(out['c'][0])


# ---- props ----------------------------------------------------------------------

_JaxData = collections.namedtuple(
    '_JaxData', ('xpos', 'xquat', 'xipos', 'cvel', 'site_xpos'))
_JaxPhys = collections.namedtuple('_JaxPhys', ('qpos', 'qvel'))

def _prop_poses(m, n, seed):
    """qpos with the sphere and the box placed in, near and out of the
    detector's zone (x in [0.4, 1.6], y in [-0.5, 0.5], z in [0, 0.5])."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.qpos0), (n, 1)).astype(np.float32)
    for body in ('prop/prop', 'box/crate'):
        j = m.names['joint'][body + '_root']
        a = int(m.jnt_qposadr[j])
        qpos[:, a:a + 3] = rng.uniform([0.4, -0.5, 0.0], [1.6, 0.5, 0.5],
                                       (n, 3))
        q = rng.normal(size=(n, 4))
        qpos[:, a + 3:a + 7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return qpos


@pytest.mark.parametrize('inverted,size', [
    (False, (0.3, 0.3, 0.15)), (True, (0.3, 0.3, 0.15)),
    (False, (0.4, 0.2))])
def test_props_observables_and_detections_match_jax(inverted, size):
    pt, jt = prop_task(PORT, inverted, size), prop_task(JAX, inverted, size)
    m = composer.make_env(pt, device='cpu').model
    jm = jcomposer.make_env(jt).model
    qpos = _prop_poses(m, 16, seed=len(size) + inverted)
    qvel = np.random.default_rng(2).normal(size=(16, m.nv)).astype(
        np.float32)
    state = M.make_state(m, qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))
    data = engine.forward(m, state, torch.zeros((16, 0)), acc_stage=False)
    # JAX's prop functions read the port's kinematics (held to JAX's in
    # the builder's and the domains' tests), so this holds them alone
    jdata = _JaxData(**{f: jnp.asarray(getattr(data, f).numpy())
                        for f in _JaxData._fields})
    jphys = _JaxPhys(jnp.asarray(qpos), jnp.asarray(qvel))
    det = pt.detector.detections(m, data).numpy()
    jdet = np.asarray(jax.vmap(lambda d: jt.detector.detections(jm, d))(
        jdata))
    np.testing.assert_array_equal(det, jdet)
    assert 0 < det.sum() < det.size            # both kinds of flags
    np.testing.assert_array_equal(
        pt.detector.activated(m, data).numpy(),
        np.asarray(jax.vmap(lambda d: jt.detector.activated(jm, d))(jdata)))
    obs = pt.observables()
    jobs = jt.observables()
    assert sorted(obs) == sorted(jobs)
    for k in obs:
        ours = obs[k](m, state, data)
        ref = jax.vmap(lambda s, d: jobs[k](jm, s, d))(jphys, jdata)
        np.testing.assert_allclose(as_np(ours), as_np(ref), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_prop_falls_like_jax():
    """The buffered scene's ball, lifted per env by numpy heights, falls
    into the detector's zone: three control steps, qpos and qvel within
    1e-5 of JAX's, the prop's observables and ``det/detected`` equal."""
    env, jenv, jt, pt = envs('swingup')
    jstate, _ = jax_reset(jenv, 0)
    m = env.model
    a = m.jnt_qposadr[m.names['joint']['prop/prop_root']]
    inner = jstate['inner']
    qpos = np.asarray(inner.physics.qpos).copy()
    qpos[:, a + 2] += np.random.default_rng(3).uniform(0.0, 0.3, (B,))
    jstate = dict(jstate, inner=inner.replace(physics=inner.physics.replace(
        qpos=jnp.asarray(qpos))))
    state = convert.composed_env_state(jstate)
    step = jax_step('swingup')
    for _ in range(3):
        jstate, jts = step(jstate, jnp.zeros((B, 2)))
        state, ts = env.step(state, torch.zeros((B, 2)))
        for f in ('qpos', 'qvel'):
            np.testing.assert_allclose(
                as_np(getattr(state['inner'].physics, f)),
                as_np(getattr(jstate['inner'].physics, f)), **TOL)
        assert_obs_close(ts.observation, jts.observation)
    assert (state['inner'].physics.qpos[:, a + 2].numpy()
            < qpos[:, a + 2]).all()
    assert ts.observation['det/detected'].shape == (B, 1)


def test_prop_set_pose_and_validation():
    pt = prop_task(PORT)
    m = composer.make_env(pt, device='cpu').model
    qpos = pt.ball.set_pose(m, M.make_state(m, batch=2).qpos,
                            pos=[1.0, 0.0, 0.1])
    data = engine.forward(m, M.make_state(m, qpos=qpos),
                          torch.zeros((2, 0)), acc_stage=False)
    assert pt.detector.detections(m, data)[:, 0].all()
    with pytest.raises(ValueError, match='size'):
        props.Primitive(geom_type='box', size=[0.1])
    with pytest.raises(ValueError):
        props.PositionDetector(pos=[0, 0, 0], size=[1.0])


def test_make_env_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        composer.make_env(swingup_task(PORT))
