"""The port's MJCF compiler against JAX's on what JAX drops or refuses.

One parametrised test: each case is a scene, and either both parses
raise the same exception type, or both return a Model and the Models are
equal field by field. The lenient cases are the elements JAX's compiler
drops silently (``<sensor>``, ``<contact><pair>``, non-tendon
``<equality>``, ``tendon2``, non-hfield ``<asset>`` children, a fixed
tendon's limits, via-point spatial tendons, unknown integrators and
actuators, lights and other body children) and what it takes that the
port used to refuse (ball joints, velocity servos, ``fromto`` on a box,
a plane-typed site); the raising cases are unknown geom and joint types,
names no element has, an actuator with no transmission and a root other
than ``<mujoco>``. Tensors agree within 1e-5, the invweights (inverses
of a float32 mass matrix) within 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mujoco_mbrl_tpu.physics import mjcf as jmjcf
from mujoco_mbrl_tpu_torch.physics import mjcf

BASE = """
<mujoco model='scene'>
  <option timestep='0.004'{option}/>
  {asset}
  <worldbody>
    <geom name='floor' type='plane' size='2 2 .1'/>
    <site name='anchor' pos='0 0 1.5'/>
    {world}
    <body name='a' pos='0 0 1'>
      <joint name='j1' type='hinge' axis='0 1 0' range='-45 45'
             limited='true'/>
      <geom name='ga' type='capsule' fromto='0 0 0 0.3 0 0' size='0.05'/>
      <site name='sa' pos='0.3 0 0'/>
      {body}
      <body name='b' pos='0.3 0 0'>
        <joint name='j2' type='hinge' axis='0 1 0'/>
        <geom name='gb' type='sphere' size='0.06'/>
        <site name='sb' pos='0 0 -0.1'/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name='t1'{tendon_attrs}>
      <joint joint='j1' coef='1'/><joint joint='j2' coef='-0.5'/>
    </fixed>
    <fixed name='t2'><joint joint='j2' coef='1'/></fixed>
    <spatial name='string' limited='true' range='0 0.9'>
      <site site='anchor'/><site site='sb'/>
    </spatial>
    {tendon}
  </tendon>
  <equality>
    <tendon tendon1='t1' solref='0.01 1'{eq_attrs}/>
    {equality}
  </equality>
  <actuator>
    <motor name='m1' joint='j1' gear='2'/>
    {actuator}
  </actuator>
  {extra}
</mujoco>
"""

SLOTS = ('option', 'asset', 'world', 'body', 'tendon_attrs', 'tendon',
         'eq_attrs', 'equality', 'actuator', 'extra')


def scene(**kw):
    return BASE.format(**{k: kw.get(k, '') for k in SLOTS})


LENIENT = {
    'sensor': dict(extra="<sensor><jointpos joint='j1'/>"
                         "<touch site='sa'/></sensor>"),
    'contact_pair': dict(extra="<contact><pair geom1='floor' geom2='gb'/>"
                               "<exclude body1='a' body2='b'/></contact>"),
    'equality_connect_weld_joint': dict(
        equality="<connect body1='a' body2='b' anchor='0 0 0'/>"
                 "<weld body1='b'/><joint joint1='j1' joint2='j2'/>"),
    'equality_tendon2': dict(eq_attrs=" tendon2='t2'"),
    'asset_mesh_texture_material': dict(
        asset="<asset><texture name='tx' type='2d' builtin='checker'/>"
              "<material name='mt' texture='tx'/>"
              "<mesh name='ms' vertex='0 0 0 1 0 0 0 1 0 0 0 1'/>"
              "<hfield name='hf' nrow='3' ncol='4' size='1 1 .2 .1'/>"
              "</asset>"),
    'fixed_tendon_limits': dict(tendon_attrs=" limited='true' "
                                             "range='-0.1 0.1'"),
    'via_point_spatial': dict(tendon="<spatial name='via'><site site='sa'/>"
                                     "<site site='anchor'/><site site='sb'/>"
                                     "</spatial>"),
    'tendon_other_child': dict(tendon="<pulley divisor='2'/><fixed "
                                      "name='t3'><joint joint='j1' "
                                      "coef='2'/></fixed>"),
    'integrator_implicit': dict(option=" integrator='implicit'"),
    'integrator_implicitfast': dict(option=" integrator='implicitfast'"),
    'integrator_rk4': dict(option=" integrator='RK4'"),
    'cone_elliptic_impratio': dict(option=" cone='elliptic' impratio='2'"),
    'unknown_actuators': dict(actuator="<cylinder joint='j2'/>"
                                       "<intvelocity joint='j2' kp='3'/>"),
    'velocity_servo': dict(actuator="<velocity name='v' joint='j2' kv='4'/>"),
    'ball_joint': dict(body="<body name='c' pos='0 0 -0.2'><joint "
                            "name='bj' type='ball' range='0 30' "
                            "limited='true' springref='5'/><geom "
                            "type='capsule' fromto='0 0 0 0 0 -0.2' "
                            "size='0.03'/></body>"),
    'lights_and_body_extras': dict(body="<light pos='0 0 1'/>"
                                        "<composite type='x'/>",
                                   world="<light name='l' pos='0 0 3'/>"),
    'worldbody_joint_and_inertial': dict(
        world="<joint name='wj' type='slide'/>"
              "<inertial pos='0 0 0' mass='3' diaginertia='1 1 1'/>"
              "<camera name='c0' pos='0 -2 1' xyaxes='1 0 0 0 0 1'/>"),
    'fromto_box_and_plane_site': dict(
        body="<geom type='box' fromto='0 0 0 0 0 0.2' size='0.02 0.02 0.1'/>"
             "<site name='sp' type='plane' size='0.1'/>"),
}

RAISING = {
    'geom_type_mesh': dict(body="<geom type='mesh' mesh='m'/>"),
    'joint_type_unknown': dict(body="<joint name='x' type='screw'/>"),
    'equality_unknown_tendon': dict(equality="<tendon tendon1='nope'/>"),
    'actuator_unknown_joint': dict(actuator="<motor joint='nope'/>"),
    'actuator_no_transmission': dict(actuator="<motor name='lost'/>"),
    'exclude_unknown_body': dict(extra="<contact><exclude body1='a' "
                                       "body2='nope'/></contact>"),
    'spatial_unknown_site': dict(tendon="<spatial><site site='sa'/>"
                                        "<site site='nope'/></spatial>"),
    'hfield_without_size': dict(asset="<asset><hfield name='h' nrow='2' "
                                      "ncol='2'/></asset>"),
    'fixed_unknown_joint': dict(tendon="<fixed><joint joint='nope' "
                                       "coef='1'/></fixed>"),
}


def _parse(fn, xml):
    try:
        return fn(xml), None
    except Exception as e:          # noqa: BLE001 -- compared below
        return None, e


def _equal(jm, tm):
    for f in dataclasses.fields(tm):
        ours, ref = getattr(tm, f.name), getattr(jm, f.name, None)
        if f.name == 'opt':
            for name in ('timestep', 'gravity', 'viscosity', 'density',
                         'wind'):
                np.testing.assert_allclose(getattr(ours, name).numpy(),
                                           np.asarray(getattr(ref, name)))
            for name in ('integrator', 'disableflags', 'solver_iterations',
                         'solver', 'cone', 'impratio'):
                assert getattr(ours, name) == getattr(ref, name), name
        elif isinstance(ours, torch.Tensor):
            # the invweights invert a float32 mass matrix (the light
            # sphere's hinge: 773): 1e-4 there, 1e-5 elsewhere
            tol = 1e-4 if f.name.endswith('invweight0') else 1e-5
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       rtol=tol, atol=1e-6, err_msg=f.name)
        elif f.name == 'names':
            assert {k: v for k, v in ours.items() if v} == {
                k: v for k, v in ref.items() if v}
        elif f.name == 'spatial_tendons':
            assert len(ours) == len(ref)
            for o, r in zip(ours, ref):
                assert o[:5] == r[:5]
                np.testing.assert_allclose(o[5], r[5], rtol=1e-4)
        elif ours is None or ref is None:
            assert ours is None and ref is None, f.name
        else:
            assert ours == ref, f.name


CASES = ([(k, v, False) for k, v in LENIENT.items()]
         + [(k, v, True) for k, v in RAISING.items()]
         + [('root_not_mujoco', None, True), ('base', {}, False)])


@pytest.mark.parametrize('kw,raises', [(c[1], c[2]) for c in CASES],
                         ids=[c[0] for c in CASES])
def test_parse_matches_jax(kw, raises):
    xml = ("<mjcf><worldbody/></mjcf>" if kw is None else scene(**kw))
    jm, jerr = _parse(jmjcf.parse, xml)
    tm, terr = _parse(mjcf.parse, xml)
    if raises:
        assert jerr is not None and terr is not None, (jerr, terr)
        assert type(terr) is type(jerr), (terr, jerr)
        return
    assert jerr is None and terr is None, (jerr, terr)
    _equal(jm, tm)


def test_unknown_suite_domain_fails_as_jax():
    """suite.load takes JAX's capitalized humanoid_CMU and fails on an
    unknown domain with JAX's exception type (JAX imports the domain's
    module)."""
    from mujoco_mbrl_tpu import suite as jsuite
    from mujoco_mbrl_tpu_torch import suite

    _, jerr = _parse(lambda d: jsuite.load(d, 'walk'), 'no_such_domain')
    _, terr = _parse(lambda d: suite.load(d, 'walk', device='cpu'),
                     'no_such_domain')
    assert type(terr) is type(jerr) is ModuleNotFoundError
    _, terr = _parse(lambda d: suite.load(d, 'no_such_task', device='cpu'),
                     'humanoid_CMU')
    assert type(terr) is ValueError
