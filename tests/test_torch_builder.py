"""The model builder and the physics utilities around it, port against the
JAX package: ``physics.builder`` (programmatic construction, attach,
document mode, compile), ``physics.schema`` (validation errors, typed
reads, bindings), ``physics.debugging`` (provenance, dumps, export),
``physics.named`` and MJCF cameras with ``xyaxes``.

Every case builds the same thing through both packages' modules (the
helpers below take the builder module as an argument, so both run the
same source lines) and compares: serialized XML, error types and
messages, warnings and debug reports exactly; compiled arrays exactly
between the port's builder and its direct parse; camera quaternions at
1e-6; the attached pendulum pair's 200 steps at 1e-5 against JAX's.
JAX Models whose weights no comparison reads are compiled without JAX's
mj_setConst probe (``jax_parse``), which would jit for minutes on
humanoid_cmu.
"""

import dataclasses
import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mujoco_mbrl_tpu.physics import builder as jbuilder
from mujoco_mbrl_tpu.physics import debugging as jdebugging
from mujoco_mbrl_tpu.physics import engine as jengine
from mujoco_mbrl_tpu.physics import mjcf as jmjcf
from mujoco_mbrl_tpu.physics import named as jnamed
from mujoco_mbrl_tpu.physics import schema as jschema
from mujoco_mbrl_tpu.physics.model import make_state as jmake_state
from mujoco_mbrl_tpu_torch.physics import builder, debugging, engine, mjcf
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.physics import named, schema

# the scene of JAX's tests/test_raycast.py:22, with its extra bodies
RAYCAST_SCENE = """
<mujoco model='scene'>
  <worldbody>
    <camera name='front' pos='0 -3 1' xyaxes='1 0 0 0 0 1'/>
    <geom name='floor' type='plane' pos='0 0 0' size='5 5 .1'/>
    <body name='b' pos='0 0 1'>
      <geom name='ball' type='sphere' size='.5'/>
      <camera name='tilted' pos='0 -1 0.5' xyaxes='0.8 0.6 0 -0.3 0.4 1'
              fovy='60' mode='trackcom'/>
    </body>
    <body name='c' pos='1.5 0 .5'>
      <geom name='box' type='box' size='.3 .3 .5'/>
    </body>
    <body name='d' pos='-1.5 0 .5'>
      <geom name='cap' type='capsule' fromto='0 0 -.3 0 0 .3' size='.2'/>
    </body>
  </worldbody>
</mujoco>"""


def jax_parse(xml):
    """JAX's compile without its mj_setConst probe (names, addresses,
    poses and cameras do not read the weights)."""
    real = jmjcf._with_invweight0
    jmjcf._with_invweight0 = lambda m: m
    try:
        return jmjcf.parse(xml)
    finally:
        jmjcf._with_invweight0 = real


# ---- the suite corpus: every XML a ported domain compiles -----------------

def _corpus_makers():
    """name -> f(suite module) -> XML: JAX's ``tests/test_schema.py``
    ``_domain_xmls`` corpus, plus the domains it leaves out (cartpole,
    humanoid_cmu, lqr, manipulator, stacker)."""
    const = {f'{d}._XML': (d, lambda mod: mod._XML) for d in (
        'acrobot', 'ball_in_cup', 'cheetah', 'finger', 'fish', 'hopper',
        'humanoid', 'pendulum', 'point_mass', 'reacher', 'walker')}
    gen = {
        'quadruped._make_xml': ('quadruped', lambda m: m._make_xml(10.0)),
        'quadruped._make_xml_walls': ('quadruped', lambda m: m._make_xml(
            10.0, walls_and_ball=True)),
        'swimmer._make_model_xml_6': ('swimmer',
                                      lambda m: m._make_model_xml(6)),
        'swimmer._make_model_xml_15': ('swimmer',
                                       lambda m: m._make_model_xml(15)),
        'cartpole._make_model_xml_1': ('cartpole',
                                       lambda m: m._make_model_xml(1)),
        'cartpole._make_model_xml_3': ('cartpole',
                                       lambda m: m._make_model_xml(3)),
        'humanoid_cmu._make_xml': ('humanoid_cmu', lambda m: m._make_xml()),
        'lqr._make_model_xml_6_2': ('lqr', lambda m: m._make_model_xml(
            6, 2, np.random.RandomState(3))),
        'manipulator._make_model_xml': ('manipulator',
                                        lambda m: m._make_model_xml()),
        'manipulator._make_model_xml_peg_insert': (
            'manipulator', lambda m: m._make_model_xml(True, True)),
        'stacker._make_model_xml_4': ('stacker', lambda m: m._make_model_xml(
            props=m._props_xml(4), geom_solref='.01 1')),
    }
    return {**const, **gen}


CORPUS = _corpus_makers()


def corpus_xml(name, package):
    domain, make = CORPUS[name]
    return make(importlib.import_module(f'{package}.suite.{domain}'))


def assert_models_equal(a, b, path='model'):
    """Every field of two port Models (or Options) equal: tensors exactly
    (shape, dtype and values), everything else by ==."""
    assert type(a) is type(b), path
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        where = f'{path}.{f.name}'
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor), where
            assert x.shape == y.shape and x.dtype == y.dtype, where
            assert torch.equal(x, y), where
        elif dataclasses.is_dataclass(x):
            assert_models_equal(x, y, where)
        else:
            assert x == y, where


# ---- construction through both builders ----------------------------------

def _pendulum(bmod, name='pendulum', gear=1.0):
    root = bmod.RootElement(model=name)
    root.option(timestep=0.002)
    body = root.worldbody.add('body', name='pole', pos=[0, 0, 1])
    body.add('joint', name='hinge', type='hinge', axis=[0, 1, 0],
             damping=0.05)
    body.add('geom', name='mass', type='sphere', size=[0.05], mass=1,
             pos=[0.5, 0, 0])
    root.actuator.add('motor', name='torque', joint='hinge', gear=gear)
    return root


def _pair(bmod):
    """Two pendulums attached under `a/` and `b/`, b's gear twice a's."""
    root = bmod.RootElement(model='pair')
    root.option(timestep=0.002)
    frame_a = root.worldbody.add('body', name='mount_a', pos=[0, 0, 1])
    frame_b = root.worldbody.add('body', name='mount_b', pos=[1, 0, 1])
    frame_a.attach(_pendulum(bmod), 'a/')
    frame_b.attach(_pendulum(bmod, gear=2.0), 'b/')
    return root


def test_programmatic_construction_serializes_as_jax():
    for make in (_pendulum, _pair):
        assert make(builder).to_xml_string() == make(jbuilder).to_xml_string()
    ours, ref = _pendulum(builder), _pendulum(jbuilder)
    for root in (ours, ref):
        root.find('geom', 'mass').set(mass=2.0, rgba=[1, 0, 0, 1])
    assert ours.to_xml_string() == ref.to_xml_string()
    g, jg = ours.find('geom', 'mass'), ref.find('geom', 'mass')
    for attr in ('pos', 'mass', 'type', 'rgba', 'quat'):
        a, b = g.get(attr), jg.get(attr)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b and type(a) is type(b), attr
    assert [e.attrs for e in ours.all('body')] == [
        e.attrs for e in ref.all('body')]


def test_compile_places_the_model_and_matches_the_direct_parse():
    root = _pair(builder)
    m = root.compile(device='cpu')
    assert m.device.type == 'cpu' and m.nq == 2 and m.nu == 2
    assert_models_equal(m, mjcf.parse(root.to_xml_string()))
    ua, ub = m.names['actuator']['a/torque'], m.names['actuator']['b/torque']
    assert float(m.actuator_gear[ub]) == 2 * float(m.actuator_gear[ua])
    m64 = root.compile(device='cpu', dtype=torch.float64)
    assert m64.dtype == torch.float64


def test_attached_pair_steps_like_jax():
    """200 steps of the attached pair from qpos0 with ctrl 1 on both
    motors, qpos and qvel within 1e-5 of JAX's at every step."""
    m = _pair(builder).compile(device='cpu')
    jm = _pair(jbuilder).compile()
    state = M.make_state(m)
    ctrl = torch.ones((1, 2))

    def roll(s):
        def body(st, _):
            st = jengine.step(jm, st, jnp.ones(2))
            return st, (st.qpos, st.qvel)
        return jax.lax.scan(body, s, None, length=200)[1]

    jq, jv = (np.asarray(x) for x in jax.jit(roll)(jmake_state(jm)))
    for k in range(200):
        state = engine.step(m, state, ctrl)
        np.testing.assert_allclose(state.qpos[0].numpy(), jq[k], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(state.qvel[0].numpy(), jv[k], atol=1e-5,
                                   rtol=0)
    assert abs(jq[-1, 0]) > 1e-3


# ---- schema: the invalid cases of JAX's tests/test_schema.py -------------

def _unknown_tag(b):
    b.RootElement(model='t').worldbody.add('bodyy', name='oops')


def _misplaced_child(b):
    b.RootElement(model='t').worldbody.add('motor', name='m')


def _unknown_attribute(b):
    b.RootElement(model='t').worldbody.add('body', name='b', poss=[0, 0, 1])


def _bad_keyword(b):
    b.RootElement(model='t').worldbody.add('body', name='b').add(
        'joint', name='j', type='hingee')


def _bad_array_length(b):
    b.RootElement(model='t').worldbody.add('body', name='b').add(
        'geom', type='sphere', size=[0.1], pos=[1.0, 2.0])


def _context_joint(b):
    root = b.RootElement(model='t')
    root.worldbody.add('body', name='b').add('joint', name='j1',
                                              type='hinge', axis=[0, 1, 0])
    fx = root.tendon.add('fixed', name='t')
    fx.add('joint', joint='j1', coef=1.0)
    fx.add('joint', name='j2', type='hinge')


def _document_mode_ill_typed(b):
    b.RootElement.from_xml_string(
        "<mujoco model='x'><worldbody><body name='b' "
        "pos='not a number'/></worldbody></mujoco>", strict=True)


def _strict_construction_after_parse(b):
    b.RootElement(model='t').worldbody.add('body', custom_attr='1')


def _bad_bool(b):
    b.RootElement(model='t').worldbody.add('body', name='b').add(
        'joint', name='j', limited='maybe')


def _set_ill_typed(b):
    b.RootElement(model='t').worldbody.add('body', name='b').set(
        euler=[1, 2])


def _non_mujoco_root(b):
    b.RootElement.from_xml_string('<robot/>')


def _unbindable(b):
    root = _pendulum(b)
    sch = schema if b is builder else jschema
    sch.bind(None, root.worldbody)


def _unnamed_bind(b):
    root = _pendulum(b)
    sch = schema if b is builder else jschema
    sch.bind(None, root.worldbody.find('body').add('site', type='sphere'))


INVALID = (_unknown_tag, _misplaced_child, _unknown_attribute, _bad_keyword,
           _bad_array_length, _context_joint, _document_mode_ill_typed,
           _strict_construction_after_parse, _bad_bool, _set_ill_typed,
           _non_mujoco_root, _unbindable, _unnamed_bind)


def _raised(case, bmod):
    with pytest.raises(Exception) as info:
        case(bmod)
    return info.value


@pytest.mark.parametrize('case', INVALID, ids=lambda c: c.__name__[1:])
def test_invalid_cases_raise_as_jax(case):
    ours, ref = _raised(case, builder), _raised(case, jbuilder)
    assert type(ours).__name__ == type(ref).__name__
    assert isinstance(ours, ValueError) and isinstance(ref, ValueError)
    assert str(ours) == str(ref)
    if isinstance(ref, jschema.SchemaError):
        assert isinstance(ours, schema.SchemaError)


def test_document_mode_warnings_match_jax():
    doc = ("<mujoco model='x'><visual><global offwidth='640'/>"
           "<headlight diffuse='.6 .6 .6'/></visual>"
           "<sensor><jointpos joint='j'/></sensor>"
           "<worldbody><body name='b' custom_attr='1'/>"
           "</worldbody></mujoco>")
    ours = builder.RootElement.from_xml_string(doc, strict=True)
    ref = jbuilder.RootElement.from_xml_string(doc, strict=True)
    assert ours.schema_warnings == ref.schema_warnings
    assert len(ours.schema_warnings) >= 2
    loose = builder.RootElement.from_xml_string(doc, strict=False)
    assert loose.schema_warnings == []
    assert loose.to_xml_string() == jbuilder.RootElement.from_xml_string(
        doc, strict=False).to_xml_string()


def test_schema_tables_are_a_copy():
    assert schema.ATTRS == jschema.ATTRS
    assert schema.CHILDREN == jschema.CHILDREN
    assert schema._CONTEXT_ATTRS == jschema._CONTEXT_ATTRS
    for tag, attr, raw in (('geom', 'size', '0.1 0.2'), ('joint', 'limited',
                                                           'true'),
                           ('option', 'iterations', '50'),
                           ('camera', 'xyaxes', '1 0 0 0 0 1'),
                           ('site', 'name', 'tip')):
        a, b = (schema.parse_value(tag, attr, raw),
                jschema.parse_value(tag, attr, raw))
        np.testing.assert_array_equal(a, b)
        assert type(a) is type(b)


# ---- the suite corpus round-trips -----------------------------------------

@pytest.mark.parametrize('name', sorted(CORPUS))
def test_suite_xml_round_trips_and_compiles_as_its_parse(name):
    """Document-mode parse with no schema warning, the same serialization
    as JAX's builder, and a compile whose Model equals the direct parse's
    in every field."""
    xml = corpus_xml(name, 'mujoco_mbrl_tpu_torch')
    assert xml == corpus_xml(name, 'mujoco_mbrl_tpu')
    root = builder.RootElement.from_xml_string(xml, strict=True)
    assert root.schema_warnings == [], root.schema_warnings[:5]
    jroot = jbuilder.RootElement.from_xml_string(xml, strict=True)
    assert root.to_xml_string() == jroot.to_xml_string()
    assert_models_equal(root.compile(device='cpu'), mjcf.parse(xml))


# ---- cameras and xyaxes ---------------------------------------------------

@pytest.mark.parametrize('name', ['raycast_scene', 'walker', 'cartpole',
                                  'cheetah', 'pendulum'])
def test_camera_fields_match_jax(name):
    """ncam, cam_body / mode / fovy and names exactly, cam_pos and the
    quaternions (xyaxes for the scene's, walker's back camera, cheetah's
    and pendulum's) at 1e-6; body and geom quaternions too."""
    if name == 'raycast_scene':
        xml = RAYCAST_SCENE
    else:
        mod = importlib.import_module(f'mujoco_mbrl_tpu_torch.suite.{name}')
        xml = mod._make_model_xml(1) if name == 'cartpole' else mod._XML
    m, jm = mjcf.parse(xml), jax_parse(xml)
    assert m.ncam == jm.ncam >= 1
    assert m.cam_body == jm.cam_body and m.cam_mode == jm.cam_mode
    assert m.cam_fovy == jm.cam_fovy
    assert m.names['camera'] == jm.names['camera']
    for f in ('cam_pos', 'cam_quat', 'body_quat', 'geom_quat', 'site_quat'):
        np.testing.assert_allclose(getattr(m, f).numpy(),
                                   np.asarray(getattr(jm, f)), atol=1e-6,
                                   err_msg=f)
    if 'xyaxes' in xml:
        np.testing.assert_allclose(
            np.linalg.norm(m.cam_quat.numpy(), axis=1), 1.0, atol=1e-6)


def test_xyaxes_on_bodies_geoms_and_sites():
    xml = """<mujoco><worldbody>
      <body name='b' xyaxes='0 1 0 -1 0 0'>
        <joint type='hinge' axis='0 0 1'/>
        <geom type='box' size='.1 .2 .3' xyaxes='1 0 0 0 0.6 0.8'/>
        <site name='s' xyaxes='0 0 1 0 1 0'/>
      </body></worldbody></mujoco>"""
    m, jm = mjcf.parse(xml), jax_parse(xml)
    for f in ('body_quat', 'geom_quat', 'site_quat'):
        np.testing.assert_allclose(getattr(m, f).numpy(),
                                   np.asarray(getattr(jm, f)), atol=1e-6)
    # a quarter turn about z
    np.testing.assert_allclose(m.body_quat[1].numpy(),
                               [np.sqrt(.5), 0, 0, np.sqrt(.5)], atol=1e-6)


# ---- debugging ------------------------------------------------------------

def _debug_build(bmod, dmod):
    dmod.enable_debug_mode()
    try:
        root = _pendulum(bmod, name='dbg_pendulum')
        geom = root.worldbody.find('geom', 'mass')
        geom.set(mass=2)
        return root, geom, dmod.debug_context(geom)
    finally:
        dmod.disable_debug_mode()


def test_debugging_provenance_dump_and_export_match_jax(tmp_path):
    """Built from the same lines, the provenance reports, the annotated
    dump and the exported files are JAX's, character for character."""
    (root, geom, ctx), (jroot, jgeom, jctx) = [
        _debug_build(b, d) for b, d in ((builder, debugging),
                                        (jbuilder, jdebugging))]
    assert ctx == jctx
    assert 'test_torch_builder.py' in ctx
    assert "attribute 'mass' last set at" in ctx
    assert not debugging.debug_mode()
    dumps = []
    for r, d, sub in ((root, debugging, 'ours'), (jroot, jdebugging, 'ref')):
        os.makedirs(tmp_path / sub)
        xml = d.dump_full_debug_info(r, str(tmp_path / sub / 'dump.xml'))
        dumps.append((xml, (tmp_path / sub / 'dump.xml').read_text()))
        r.assets['readme.txt'] = 'asset payload'
        path = d.export_with_assets(r, str(tmp_path / sub / 'export'))
        assert path.endswith('dbg_pendulum.xml')
    assert dumps[0] == dumps[1]
    assert '<!-- created at test_torch_builder.py:' in dumps[0][0]
    assert 'ELEMENT PROVENANCE' in dumps[0][1]
    for f in ('dbg_pendulum.xml', 'readme.txt'):
        assert ((tmp_path / 'ours' / 'export' / f).read_text()
                == (tmp_path / 'ref' / 'export' / f).read_text())
    m = builder.RootElement.from_xml_string(
        (tmp_path / 'ours' / 'export' / 'dbg_pendulum.xml').read_text()
    ).compile(device='cpu')
    assert m.nq == 1
    plain = _pendulum(builder).worldbody.find('geom', 'mass')
    jplain = _pendulum(jbuilder).worldbody.find('geom', 'mass')
    assert debugging.debug_context(plain) == jdebugging.debug_context(jplain)
    for d, r in ((debugging, root), (jdebugging, jroot)):
        with pytest.raises(ValueError):
            d.export_with_assets(r, str(tmp_path / 'x'),
                                 out_file_name='model.txt')


# ---- named indexing and bindings ------------------------------------------

_KINDS = ('body', 'joint', 'geom', 'site', 'actuator', 'tendon')


@pytest.mark.parametrize('name', sorted(CORPUS))
def test_named_and_bind_indices_match_jax(name):
    """Every name of every kind resolves to JAX's id; every joint's qpos
    and dof slices, the indexer's ragged spans (a free joint's 7 / 6)
    and each binding's id equal JAX's."""
    xml = corpus_xml(name, 'mujoco_mbrl_tpu_torch')
    m, jm = mjcf.parse(xml), jax_parse(xml)
    for kind in _KINDS:
        assert m.names.get(kind, {}) == jm.names.get(kind, {}), kind
    bound, jbound = named.indexer(m).bind(), jnamed.indexer(jm).bind()
    assert bound._jnt_q._map == jbound._jnt_q._map
    assert bound._jnt_d._map == jbound._jnt_d._map
    for j in m.names['joint']:
        assert m.jnt_qpos_slice(j) == jm.jnt_qpos_slice(j)
        assert m.jnt_dof_slice(j) == jm.jnt_dof_slice(j)
        b, jb = schema.bind(m, 'joint', j), jschema.bind(jm, 'joint', j)
        assert (b.element_id, b.qpos_slice(), b.dof_slice()) == (
            jb.element_id, jb.qpos_slice(), jb.dof_slice())
    for kind in ('body', 'geom', 'site', 'actuator'):
        for n in m.names.get(kind, {}):
            assert schema.bind(m, kind, n).element_id == jschema.bind(
                jm, kind, n).element_id


_FREE = """<mujoco model='free'><worldbody>
  <geom name='floor' type='plane' size='5 5 .1'/>
  <body name='torso' pos='0 0 1'><freejoint name='root'/>
    <geom name='core' type='sphere' size='.1'/>
    <site name='tip' pos='.1 0 0'/>
    <body name='arm' pos='.2 0 0'>
      <joint name='elbow' type='hinge' axis='0 1 0'/>
      <joint name='slide' type='slide' axis='1 0 0'/>
      <geom name='upper' type='capsule' fromto='0 0 0 .3 0 0' size='.04'/>
    </body></body></worldbody>
  <actuator><motor name='m_elbow' joint='elbow'/>
            <motor name='m_slide' joint='slide'/></actuator>
</mujoco>"""


_MODEL_FIELDS = ('geom_size', 'body_mass', 'jnt_range')


def test_named_reads_batched_state_as_jax_per_env():
    """On a batch of 3 random states of a model with a free joint, every
    read of the port's indexer, NamedView and bindings equals JAX's
    indexer / view / binding applied to each env's rows of the same
    arrays (numpy copies), exactly."""
    m, jm = mjcf.parse(_FREE), jax_parse(_FREE)
    rng = np.random.default_rng(0)
    B = 3
    qpos = torch.tensor(rng.normal(size=(B, m.nq)), dtype=torch.float32)
    qvel = torch.tensor(rng.normal(size=(B, m.nv)), dtype=torch.float32)
    ctrl = torch.tensor(rng.normal(size=(B, m.nu)), dtype=torch.float32)
    state = M.make_state(m, qpos=qpos, qvel=qvel)
    data = engine.forward(m, state, ctrl, acc_stage=False)
    fields = ('xpos', 'xquat', 'xipos', 'ximat', 'geom_xpos', 'geom_xmat',
              'site_xpos', 'actuator_force')
    d = named.indexer(m).bind(state=state, data=data, ctrl=ctrl)
    view = named.NamedView(m)
    reads = [
        ('qpos', 'root'), ('qpos', 'elbow'), ('qpos', ['root', 'slide']),
        ('qvel', 'root'), ('qvel', 'slide'), ('ctrl', 'm_slide'),
        ('xpos', 'arm'), ('xpos', ('torso', 'z')),
        ('xpos', (['arm', 'torso'], ['x', 'z'])), ('xquat', ('arm', 'qw')),
        ('xmat', ('torso', ['xx', 'zy'])), ('ximat', 'arm'),
        ('geom_xpos', 'upper'), ('geom_xmat', ('core', 'yz')),
        ('site_xpos', 'tip'), ('geom_size', 'upper'),
        ('body_mass', ['torso', 'arm']), ('jnt_range', 'elbow')]
    for b in range(B):
        js = SimpleNamespace(qpos=jnp.asarray(qpos[b].numpy()),
                             qvel=jnp.asarray(qvel[b].numpy()))
        jd = SimpleNamespace(**{f: jnp.asarray(getattr(data, f)[b].numpy())
                                for f in fields})
        jdb = jnamed.indexer(jm).bind(state=js, data=jd,
                                      ctrl=jnp.asarray(ctrl[b].numpy()))
        for field, key in reads:
            ours = getattr(d, field)[key]
            if field not in _MODEL_FIELDS:
                ours = ours[b]
            np.testing.assert_array_equal(
                ours.numpy(), np.asarray(getattr(jdb, field)[key]),
                err_msg=f'{field}[{key!r}]')
        assert d.qpos.at('root').tolist() == jdb.qpos.at('root').tolist()
        jview = jnamed.NamedView(jm)
        for fn, key in (('qpos', 'root'), ('qpos', 'elbow'),
                        ('qvel', 'root'), ('xpos', 'arm'),
                        ('xmat', 'torso'), ('geom_xpos', 'upper'),
                        ('site_xpos', 'tip')):
            src = state if fn in ('qpos', 'qvel') else data
            jsrc = js if fn in ('qpos', 'qvel') else jd
            np.testing.assert_array_equal(
                getattr(view, fn)(src, key)[b].numpy(),
                np.asarray(getattr(jview, fn)(jsrc, key)), err_msg=fn)
        for kind, n, fn, src, jsrc in (
                ('joint', 'root', 'qpos', state, js),
                ('joint', 'slide', 'qvel', state, js),
                ('body', 'arm', 'xpos', data, jd),
                ('geom', 'upper', 'xmat', data, jd),
                ('site', 'tip', 'xpos', data, jd),
                ('body', 'torso', 'xquat', data, jd),
                ('actuator', 'm_slide', 'force', data, jd)):
            np.testing.assert_array_equal(
                getattr(schema.bind(m, kind, n), fn)(src)[b].numpy(),
                np.asarray(getattr(jschema.bind(jm, kind, n), fn)(jsrc)))
        np.testing.assert_array_equal(
            schema.bind(m, 'actuator', 'm_elbow').ctrl(ctrl)[b].numpy(),
            np.asarray(jschema.bind(jm, 'actuator', 'm_elbow').ctrl(
                jnp.asarray(ctrl[b].numpy()))))
    # writes: the ragged span and a scalar joint, every env
    s2 = view.set_qpos(state, 'root', torch.arange(7.0))
    s2 = view.set_qvel(s2, 'elbow', 5.0)
    assert torch.equal(s2.qpos[:, :7], torch.arange(7.0).expand(B, 7))
    assert torch.equal(s2.qvel[:, 6], torch.full((B,), 5.0))
    assert torch.equal(s2.qpos[:, 7:], state.qpos[:, 7:])
    with pytest.raises(KeyError):
        d.qpos['nope']


def test_bind_reads_builder_elements():
    root = _pendulum(builder)
    m = root.compile(device='cpu')
    jb = schema.bind(m, root.find('joint', 'hinge'))
    assert jb.kind == 'joint' and jb.element_id == m.name2id('joint',
                                                             'hinge')
    state = M.make_state(m, batch=4)
    assert jb.qpos(state).shape == (4, 1) and jb.qvel(state).shape == (4, 1)
    data = engine.forward(m, state, torch.zeros((4, 1)))
    np.testing.assert_allclose(
        schema.bind(m, 'body', 'pole').xpos(data).numpy(),
        np.tile([0.0, 0.0, 1.0], (4, 1)), atol=1e-6)
    ab = schema.bind(m, root.actuator.find('motor', 'torque'))
    assert ab.kind == 'actuator' and ab.element_id == 0


def test_compile_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA'):
        _pendulum(builder).compile()
