"""MJCF schema: element nesting rules + typed attributes + bindings.

Port of mujoco_mbrl_tpu/physics/schema.py, the role of PyMJCF's
generated schema layer (reference ``dm_control/dm_control/mjcf/
schema.py``; ``element.py`` validates every add/set against it, and
``physics.py:bind`` maps elements to compiled addresses). The attribute
and child tables are this package's own copy of the JAX module's: the
curated MJCF subset the compilers understand plus the presentational
attributes they ignore, so validation catches typos and ill-typed values
at build time.

Three services:
  * ``validate(tag, attrs, parent_tag)`` — unknown tag under a parent,
    unknown attribute, or unparseable value for a typed attribute
    raises ``SchemaError`` (strict mode) or returns warnings.
  * ``parse_value(tag, attr, raw)`` — typed view of an attribute
    string (float array / int / keyword / bool / string).
  * ``bind(model, kind, name)`` — resolve a named element to its
    compiled addresses (ids, qpos/dof slices) and read its fields out of
    the port's batched ``State`` / ``Data`` (leading env axis kept).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# attribute kinds
# ---------------------------------------------------------------------------
FLOAT = 'float'          # scalar float
INT = 'int'              # scalar int
ARRAY = 'array'          # float vector (any length unless shape given)
KEYWORD = 'keyword'      # enumerated string
STRING = 'string'        # free string (names, references, assets)
BOOL = 'bool'            # true/false


class SchemaError(ValueError):
    """Invalid element tag, attribute name, or attribute value."""


def _kw(*choices: str) -> Tuple[str, Tuple[str, ...]]:
    return (KEYWORD, choices)


# Common attribute groups -----------------------------------------------------
_POSE = {'pos': (ARRAY, 3), 'quat': (ARRAY, 4), 'axisangle': (ARRAY, 4),
         'euler': (ARRAY, 3), 'xyaxes': (ARRAY, 6), 'zaxis': (ARRAY, 3)}
_SOL = {'solref': (ARRAY, 2), 'solimp': (ARRAY, None)}
_LIMITSOL = {'solreflimit': (ARRAY, 2), 'solimplimit': (ARRAY, None)}
_LOOK = {'rgba': (ARRAY, 4), 'material': (STRING, None),
         'group': (INT, None)}

# tag -> {attr: (kind, extra)}; extra is array length / keyword choices
ATTRS: Dict[str, Dict[str, tuple]] = {
    'mujoco': {'model': (STRING, None)},
    'compiler': {'angle': _kw('radian', 'degree'),
                 'coordinate': _kw('local', 'global'),
                 'inertiafromgeom': _kw('true', 'false', 'auto'),
                 'settotalmass': (FLOAT, None),
                 'autolimits': (BOOL, None),
                 'meshdir': (STRING, None), 'texturedir': (STRING, None)},
    'option': {'timestep': (FLOAT, None), 'gravity': (ARRAY, 3),
               'wind': (ARRAY, 3), 'density': (FLOAT, None),
               'viscosity': (FLOAT, None), 'integrator':
               _kw('Euler', 'RK4', 'implicit', 'implicitfast'),
               'iterations': (INT, None), 'tolerance': (FLOAT, None),
               'impratio': (FLOAT, None), 'cone':
               _kw('pyramidal', 'elliptic'), 'solver':
               _kw('PGS', 'CG', 'Newton'), 'timeconst': (FLOAT, None),
               'collision': _kw('all', 'predefined', 'dynamic'),
               'jacobian': _kw('dense', 'sparse', 'auto')},
    'flag': {'contact': _kw('enable', 'disable'),
             'constraint': _kw('enable', 'disable'),
             'gravity': _kw('enable', 'disable'),
             'limit': _kw('enable', 'disable'),
             'actuation': _kw('enable', 'disable'),
             'filterparent': _kw('enable', 'disable'),
             'frictionloss': _kw('enable', 'disable')},
    'size': {'nstack': (INT, None), 'njmax': (INT, None),
             'nconmax': (INT, None), 'nkey': (INT, None),
             'nuser_body': (INT, None), 'nuser_jnt': (INT, None),
             'nuser_geom': (INT, None), 'nuser_site': (INT, None),
             'nuser_sensor': (INT, None), 'nuser_actuator': (INT, None)},
    'visual': {}, 'statistic': {'extent': (FLOAT, None),
                                'center': (ARRAY, 3),
                                'meansize': (FLOAT, None)},
    'default': {'class': (STRING, None)},
    'worldbody': {},
    'body': {'name': (STRING, None), 'childclass': (STRING, None),
             **_POSE},
    'inertial': {'pos': (ARRAY, 3), 'quat': (ARRAY, 4),
                 'mass': (FLOAT, None), 'diaginertia': (ARRAY, 3),
                 'fullinertia': (ARRAY, 6)},
    'joint': {'name': (STRING, None), 'class': (STRING, None),
              'type': _kw('free', 'ball', 'slide', 'hinge'),
              'pos': (ARRAY, 3), 'axis': (ARRAY, 3),
              'range': (ARRAY, 2), 'limited': (BOOL, None),
              'damping': (FLOAT, None), 'stiffness': (FLOAT, None),
              'springref': (FLOAT, None), 'armature': (FLOAT, None),
              'frictionloss': (FLOAT, None), 'margin': (FLOAT, None),
              'ref': (FLOAT, None), **_LIMITSOL, **_SOL},
    'freejoint': {'name': (STRING, None)},
    'geom': {'name': (STRING, None), 'class': (STRING, None),
             'type': _kw('plane', 'hfield', 'sphere', 'capsule',
                         'ellipsoid', 'cylinder', 'box', 'mesh'),
             'size': (ARRAY, None), 'fromto': (ARRAY, 6),
             'mass': (FLOAT, None), 'density': (FLOAT, None),
             'contype': (INT, None), 'conaffinity': (INT, None),
             'condim': (INT, None), 'priority': (INT, None),
             'friction': (ARRAY, None), 'solmix': (FLOAT, None),
             'margin': (FLOAT, None), 'gap': (FLOAT, None),
             'hfield': (STRING, None), 'mesh': (STRING, None),
             **_POSE, **_SOL, **_LOOK},
    'site': {'name': (STRING, None), 'class': (STRING, None),
             'type': _kw('sphere', 'capsule', 'ellipsoid', 'cylinder',
                         'box'),
             'size': (ARRAY, None), **_POSE, **_LOOK},
    'camera': {'name': (STRING, None), 'mode':
               _kw('fixed', 'track', 'trackcom', 'targetbody',
                   'targetbodycom'),
               'target': (STRING, None), 'fovy': (FLOAT, None),
               **_POSE},
    'light': {'name': (STRING, None), 'mode': (STRING, None),
              'target': (STRING, None), 'directional': (BOOL, None),
              'castshadow': (BOOL, None), 'diffuse': (ARRAY, 3),
              'specular': (ARRAY, 3), 'ambient': (ARRAY, 3),
              'cutoff': (FLOAT, None), 'exponent': (FLOAT, None),
              'attenuation': (ARRAY, 3), 'pos': (ARRAY, 3),
              'dir': (ARRAY, 3)},
    'tendon': {},
    'spatial': {'name': (STRING, None), 'class': (STRING, None),
                'limited': (BOOL, None), 'range': (ARRAY, 2),
                'width': (FLOAT, None), **_SOL, **_LOOK},
    'fixed': {'name': (STRING, None), 'class': (STRING, None),
              'limited': (BOOL, None), 'range': (ARRAY, 2),
              'stiffness': (FLOAT, None), 'damping': (FLOAT, None),
              **_SOL},
    'equality': {},
    'connect': {'name': (STRING, None), 'body1': (STRING, None),
                'body2': (STRING, None), 'anchor': (ARRAY, 3),
                'active': (BOOL, None), **_SOL},
    'weld': {'name': (STRING, None), 'body1': (STRING, None),
             'body2': (STRING, None), 'relpose': (ARRAY, 7),
             'active': (BOOL, None), **_SOL},
    'actuator': {},
    'motor': {'name': (STRING, None), 'class': (STRING, None),
              'joint': (STRING, None), 'tendon': (STRING, None),
              'site': (STRING, None), 'gear': (ARRAY, None),
              'ctrllimited': (BOOL, None), 'ctrlrange': (ARRAY, 2),
              'forcelimited': (BOOL, None), 'forcerange': (ARRAY, 2)},
    'position': {'name': (STRING, None), 'class': (STRING, None),
                 'joint': (STRING, None), 'tendon': (STRING, None),
                 'kp': (FLOAT, None), 'gear': (ARRAY, None),
                 'ctrllimited': (BOOL, None), 'ctrlrange': (ARRAY, 2),
                 'forcelimited': (BOOL, None), 'forcerange': (ARRAY, 2)},
    'velocity': {'name': (STRING, None), 'class': (STRING, None),
                 'joint': (STRING, None), 'tendon': (STRING, None),
                 'kv': (FLOAT, None), 'gear': (ARRAY, None),
                 'ctrllimited': (BOOL, None), 'ctrlrange': (ARRAY, 2),
                 'forcelimited': (BOOL, None), 'forcerange': (ARRAY, 2)},
    'general': {'name': (STRING, None), 'class': (STRING, None),
                'joint': (STRING, None), 'tendon': (STRING, None),
                'site': (STRING, None), 'gear': (ARRAY, None),
                'ctrllimited': (BOOL, None), 'ctrlrange': (ARRAY, 2),
                'forcelimited': (BOOL, None), 'forcerange': (ARRAY, 2),
                'dyntype': _kw('none', 'integrator', 'filter', 'muscle'),
                'dynprm': (ARRAY, None), 'gaintype': (STRING, None),
                'gainprm': (ARRAY, None), 'biastype': (STRING, None),
                'biasprm': (ARRAY, None)},
    'contact': {},
    'pair': {'geom1': (STRING, None), 'geom2': (STRING, None),
             'condim': (INT, None), 'friction': (ARRAY, None),
             'margin': (FLOAT, None), **_SOL},
    'exclude': {'body1': (STRING, None), 'body2': (STRING, None)},
    'sensor': {},
    'touch': {'name': (STRING, None), 'site': (STRING, None)},
    'accelerometer': {'name': (STRING, None), 'site': (STRING, None)},
    'velocimeter': {'name': (STRING, None), 'site': (STRING, None)},
    'gyro': {'name': (STRING, None), 'site': (STRING, None)},
    'force': {'name': (STRING, None), 'site': (STRING, None)},
    'torque': {'name': (STRING, None), 'site': (STRING, None)},
    'rangefinder': {'name': (STRING, None), 'site': (STRING, None)},
    'subtreelinvel': {'name': (STRING, None), 'body': (STRING, None)},
    'asset': {},
    'hfield': {'name': (STRING, None), 'nrow': (INT, None),
               'ncol': (INT, None), 'size': (ARRAY, 4),
               'file': (STRING, None)},
    'texture': {'name': (STRING, None), 'type': (STRING, None),
                'builtin': (STRING, None), 'rgb1': (ARRAY, 3),
                'rgb2': (ARRAY, 3), 'width': (INT, None),
                'height': (INT, None), 'mark': (STRING, None),
                'markrgb': (ARRAY, 3), 'random': (FLOAT, None),
                'file': (STRING, None), 'gridsize': (ARRAY, 2),
                'gridlayout': (STRING, None)},
    'material': {'name': (STRING, None), 'texture': (STRING, None),
                 'texrepeat': (ARRAY, 2), 'texuniform': (BOOL, None),
                 'reflectance': (FLOAT, None), 'shininess': (FLOAT, None),
                 'specular': (FLOAT, None), 'rgba': (ARRAY, 4)},
    'mesh': {'name': (STRING, None), 'file': (STRING, None),
             'scale': (ARRAY, 3)},
}

# tag -> allowed child tags
CHILDREN: Dict[str, Tuple[str, ...]] = {
    'mujoco': ('compiler', 'option', 'size', 'visual', 'statistic',
               'default', 'asset', 'worldbody', 'contact', 'tendon',
               'equality', 'actuator', 'sensor'),
    'option': ('flag',),
    'default': ('default', 'joint', 'geom', 'site', 'motor', 'position',
                'velocity', 'general', 'spatial', 'fixed', 'pair',
                'camera', 'light'),
    'worldbody': ('body', 'geom', 'site', 'camera', 'light'),
    'body': ('body', 'inertial', 'joint', 'freejoint', 'geom', 'site',
             'camera', 'light'),
    'tendon': ('spatial', 'fixed'),
    'spatial': ('site', 'geom'),
    'fixed': ('joint',),
    'equality': ('connect', 'weld', 'joint', 'tendon'),
    'actuator': ('motor', 'position', 'velocity', 'general'),
    'contact': ('pair', 'exclude'),
    'sensor': ('touch', 'accelerometer', 'velocimeter', 'gyro', 'force',
               'torque', 'rangefinder', 'subtreelinvel'),
    'asset': ('hfield', 'texture', 'material', 'mesh'),
}

# children of <tendon><fixed> / <equality><joint|tendon> reuse tags with
# different attribute sets; resolve those by (parent, tag)
_CONTEXT_ATTRS: Dict[Tuple[str, str], Dict[str, tuple]] = {
    ('fixed', 'joint'): {'joint': (STRING, None), 'coef': (FLOAT, None)},
    ('spatial', 'site'): {'site': (STRING, None)},
    ('spatial', 'geom'): {'geom': (STRING, None),
                          'sidesite': (STRING, None)},
    ('equality', 'joint'): {'name': (STRING, None),
                            'joint1': (STRING, None),
                            'joint2': (STRING, None),
                            'polycoef': (ARRAY, None),
                            'active': (BOOL, None), **_SOL},
    ('equality', 'tendon'): {'name': (STRING, None),
                             'tendon1': (STRING, None),
                             'tendon2': (STRING, None),
                             'polycoef': (ARRAY, None),
                             'active': (BOOL, None), **_SOL},
}


def attr_spec(tag: str, attr: str,
              parent_tag: Optional[str] = None) -> Optional[tuple]:
    ctx = _CONTEXT_ATTRS.get((parent_tag, tag)) if parent_tag else None
    if ctx is not None:
        # context-dependent tags (e.g. <joint> inside <tendon><fixed>)
        # REPLACE the global attribute set, as in the MuJoCo grammar
        return ctx.get(attr)
    spec = ATTRS.get(tag)
    return spec.get(attr) if spec is not None else None


def validate(tag: str, attrs: Dict[str, str],
             parent_tag: Optional[str] = None,
             warn: Optional[list] = None) -> None:
    """Raise SchemaError on unknown tag/attribute or ill-typed value.

    With ``warn`` (a list) the *unknown*-tag/attribute cases append a
    warning string instead of raising — the document-parsing mode:
    full MuJoCo accepts many presentational elements this engine's
    curated subset doesn't model (<visual><global/>, <option><flag>,
    sensor tags), and a parsed file carrying them must round-trip, not
    explode. Ill-typed values of *known* attributes always raise: those
    are genuine authoring errors regardless of mode.
    """
    known_ctx = ((parent_tag, tag) in _CONTEXT_ATTRS
                 if parent_tag else False)
    if tag not in ATTRS and not known_ctx:
        if warn is None:
            raise SchemaError(f'unknown MJCF element <{tag}>')
        warn.append(f'unknown MJCF element <{tag}> (accepted untyped)')
        return
    if parent_tag is not None and parent_tag in CHILDREN:
        if tag not in CHILDREN[parent_tag]:
            msg = (f'<{tag}> is not a valid child of <{parent_tag}> '
                   f'(allowed: {", ".join(CHILDREN[parent_tag])})')
            if warn is None:
                raise SchemaError(msg)
            warn.append(msg)
            # fall through: the tag itself is KNOWN, so its attribute
            # values still get type-checked — a misplaced element must
            # not smuggle ill-typed values past the documented
            # 'known attributes always raise' contract
    for name, raw in attrs.items():
        spec = attr_spec(tag, name, parent_tag)
        if spec is None:
            msg = (f'unknown attribute {name!r} on <{tag}>'
                   + (f' (inside <{parent_tag}>)' if parent_tag else ''))
            if warn is None:
                raise SchemaError(msg)
            warn.append(msg)
            continue
        _parse(tag, name, raw, spec)


def parse_value(tag: str, attr: str, raw: str,
                parent_tag: Optional[str] = None):
    """Typed view of an attribute string (PyMJCF typed attributes)."""
    spec = attr_spec(tag, attr, parent_tag)
    if spec is None:
        return raw
    return _parse(tag, attr, raw, spec)


def _parse(tag: str, attr: str, raw, spec):
    kind, extra = spec
    try:
        if kind == FLOAT:
            return float(raw)
        if kind == INT:
            return int(float(raw))
        if kind == BOOL:
            s = str(raw).strip().lower()
            if s not in ('true', 'false'):
                raise ValueError(s)
            return s == 'true'
        if kind == ARRAY:
            if isinstance(raw, str):
                arr = np.array([float(t) for t in raw.split()])
            else:
                arr = np.asarray(raw, float).reshape(-1)
            if extra is not None and arr.size != extra:
                raise ValueError(f'expected {extra} values, got {arr.size}')
            return arr
        if kind == KEYWORD:
            if str(raw) not in extra:
                raise ValueError(f'one of {extra}')
            return str(raw)
        return str(raw)
    except (TypeError, ValueError) as e:
        raise SchemaError(
            f'<{tag} {attr}="{raw}">: invalid {kind} value ({e})') from e


# ---------------------------------------------------------------------------
# element -> compiled-model bindings (physics.bind analogue)
# ---------------------------------------------------------------------------

class Binding:
    """Resolved addresses of one named element in a compiled Model.

    ``bind(model, 'joint', 'hinge')`` gives the element's id plus
    accessors into the batched State / Data: reads take them as an
    argument (the dm_control ``physics.bind(mjcf_element)`` workflow,
    reference mjcf/physics.py:276-410) and keep the env axis first.
    """

    def __init__(self, model, kind: str, name: str):
        self.model = model
        self.kind = kind
        self.name = name
        self.element_id = model.name2id(kind, name)

    # --- joints ---------------------------------------------------------
    def qpos_slice(self) -> slice:
        assert self.kind == 'joint'
        return self.model.jnt_qpos_slice(self.name)

    def dof_slice(self) -> slice:
        assert self.kind == 'joint'
        return self.model.jnt_dof_slice(self.name)

    def qpos(self, state):
        return state.qpos[..., self.qpos_slice()]

    def qvel(self, state):
        return state.qvel[..., self.dof_slice()]

    # --- bodies / geoms / sites ----------------------------------------
    def xpos(self, data):
        return {'body': data.xpos, 'geom': data.geom_xpos,
                'site': data.site_xpos}[self.kind][:, self.element_id]

    def xquat(self, data):
        assert self.kind == 'body'
        return data.xquat[:, self.element_id]

    def xmat(self, data):
        assert self.kind in ('body', 'geom')
        return (data.ximat if self.kind == 'body'
                else data.geom_xmat)[:, self.element_id]

    # --- actuators ------------------------------------------------------
    def ctrl(self, ctrl_vec):
        assert self.kind == 'actuator'
        return ctrl_vec[..., self.element_id]

    def force(self, data):
        assert self.kind == 'actuator'
        return data.actuator_force[:, self.element_id]


def bind(model, kind_or_element, name: Optional[str] = None) -> Binding:
    """Bind a named element (or a builder Element) to model addresses."""
    if name is None:  # builder Element: infer kind from its tag
        el = kind_or_element
        tag_kind = {'body': 'body', 'joint': 'joint', 'geom': 'geom',
                    'site': 'site', 'motor': 'actuator',
                    'position': 'actuator', 'velocity': 'actuator',
                    'general': 'actuator', 'spatial': 'tendon',
                    'fixed': 'tendon'}.get(el.tag)
        if tag_kind is None:
            raise SchemaError(f'cannot bind <{el.tag}> elements')
        el_name = el.attrs.get('name')
        if not el_name:
            raise SchemaError(f'cannot bind unnamed <{el.tag}>')
        return Binding(model, tag_kind, el_name)
    return Binding(model, kind_or_element, name)
