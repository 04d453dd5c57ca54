"""MJCF-subset compiler: XML string -> :class:`Model` (host-side numpy).

Port of mujoco_mbrl_tpu/physics/mjcf.py: ``<compiler angle
settotalmass>``, ``<option timestep gravity integrator density viscosity
wind cone impratio iterations>`` (RK4, else Euler; pyramidal or elliptic
cones) with its ``<flag contact gravity limit actuation>``, nested
``<default>`` classes with ``childclass``, bodies with ``pos`` and
orientation and an optional ``<inertial>``, free, ball, hinge and slide
joints with limits and friction loss (``<freejoint>`` takes no default
but its name; a ball joint's qpos0 is (1, 0, 0, 0)), plane, sphere,
capsule, cylinder, ellipsoid and box geoms (placed by ``pos`` +
orientation or by ``fromto``; mass given or from density), sites
(MuJoCo's default size 0.005), fixed tendons, two-site spatial tendons
with their length limits (the limit row's invweight at qpos0),
``<equality><tendon>`` couplings (a fixed tendon held at length 0 by a
soft row with its own solref and solimp), motors, ``<position>`` servos
(kp into gainprm[0], -kp into biasprm[1]), ``<velocity>`` servos (kv
into gainprm[0], -kv into biasprm[2]) and ``<general>`` actuators
(gainprm, biasprm: affine once given; dyntype none, integrator or filter
with dynprm, one activation slot each) on a joint or a fixed tendon; one
``<asset><hfield>`` (its data zeros until a task writes it) and the hfield
geom placed on it; the fluid model's per-body equivalent inertia box and
principal frame; ``<contact><exclude body1 body2>`` pairs; ``<camera>``
in the worldbody and in bodies; every orientation MJCF gives.

What JAX's compiler drops, this one drops too, silently and with JAX's
result (mujoco_mbrl_tpu/physics/mjcf.py, by line):
  * ``<sensor>`` (never read, :22);
  * ``<contact>`` children other than ``<exclude>`` (``<pair>``, :710-716);
  * ``<equality>`` children other than ``<tendon>`` (``<connect>``,
    ``<weld>``, ``<joint>``; :674), and an equality's ``tendon2`` (only
    ``tendon1`` is read, :676-677);
  * ``<asset>`` children other than ``<hfield>`` (meshes, textures,
    materials; :697-700);
  * a fixed tendon's ``limited`` and ``range`` (:637-652), and
    ``<tendon>`` children other than ``<fixed>`` and ``<spatial>``;
  * spatial tendons with other than two sites (via points; :659-660);
  * an ``integrator`` other than RK4, which integrates as Euler (:323-324);
  * actuators other than motor, position, velocity and general (:724-725);
  * body children other than joint, freejoint, geom, site, inertial,
    camera and body (lights and the like, :532), and worldbody children
    other than body, geom, site and camera (:551-558).
Where JAX raises, this compiler raises the same exception type: an
unknown geom or joint type or a name no element has (``KeyError``), an
actuator with neither joint nor tendon (``ValueError``), a root tag other
than ``<mujoco>`` (``AssertionError``).
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np
import torch

from . import model as M

def _nquat_mul(u, v):
    w1, x1, y1, z1 = u
    w2, x2, y2, z2 = v
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _nquat_axis_angle(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-14:
        return np.array([1.0, 0, 0, 0])
    axis = axis / n
    return np.concatenate([[math.cos(angle / 2)], axis * math.sin(angle / 2)])


def _nquat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _zaxis_quat(z):
    """Minimal rotation taking (0,0,1) to direction z."""
    z = np.asarray(z, dtype=np.float64)
    z = z / np.linalg.norm(z)
    e = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(e, z))
    if c > 1 - 1e-12:
        return np.array([1.0, 0, 0, 0])
    if c < -1 + 1e-12:
        return np.array([0.0, 1.0, 0, 0])
    return _nquat_axis_angle(np.cross(e, z), math.acos(max(-1.0, min(1.0, c))))


def _mat_to_nquat(R):
    """Rotation matrix -> unit quaternion (w, x, y, z)."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split()], dtype=np.float64)


def _skew(p):
    return np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])


_JOINT_TYPES = {'free': M.FREE, 'ball': M.BALL, 'slide': M.SLIDE,
                'hinge': M.HINGE}
_GEOM_TYPES = {'plane': M.PLANE, 'hfield': M.HFIELD, 'sphere': M.SPHERE,
               'capsule': M.CAPSULE, 'ellipsoid': M.ELLIPSOID,
               'cylinder': M.CYLINDER, 'box': M.BOX}
_DYN_TYPES = {'none': M.DYN_NONE, 'integrator': M.DYN_INTEGRATOR,
              'filter': M.DYN_FILTER}
_SITE_SIZE = 0.005                    # MuJoCo's default site size
_DEFAULT_SOLREF = np.array([0.02, 1.0])
_DEFAULT_SOLIMP = np.array([0.9, 0.95, 0.001, 0.5, 2.0])


class _Defaults:
    """Nested default-class resolution (MJCF <default> tree)."""

    def __init__(self):
        self.classes: Dict[str, Dict[str, Dict[str, str]]] = {'main': {}}
        self.parent: Dict[str, Optional[str]] = {'main': None}

    def parse(self, elem: ET.Element, parent: str = 'main'):
        cls = elem.get('class', parent if elem.tag == 'default' else 'main')
        if cls not in self.classes:
            self.classes[cls] = {}
            self.parent[cls] = parent
        for child in elem:
            if child.tag == 'default':
                self.parse(child, cls)
            else:
                self.classes[cls].setdefault(child.tag, {}).update(
                    child.attrib)

    def resolve(self, tag: str, attrib: Dict[str, str],
                cls: Optional[str]) -> Dict[str, str]:
        chain: List[str] = []
        c = cls or 'main'
        while c is not None:
            chain.append(c)
            c = self.parent.get(c)
        if 'main' not in chain:
            chain.append('main')
        merged: Dict[str, str] = {}
        for c in reversed(chain):
            merged.update(self.classes.get(c, {}).get(tag, {}))
        merged.update(attrib)
        return merged


def _orientation(attrs: Dict[str, str], deg: bool) -> np.ndarray:
    if 'quat' in attrs:
        q = _floats(attrs['quat'])
        return q / np.linalg.norm(q)
    if 'xyaxes' in attrs:
        # x normalized, y made orthogonal to it, z = x cross y
        v = _floats(attrs['xyaxes'])
        x = v[:3] / np.linalg.norm(v[:3])
        y = v[3:] - (v[3:] @ x) * x
        y = y / np.linalg.norm(y)
        return _mat_to_nquat(np.stack([x, y, np.cross(x, y)], axis=1))
    if 'euler' in attrs:
        e = [math.radians(a) if deg else a for a in _floats(attrs['euler'])]
        q = np.array([1.0, 0, 0, 0])
        for ax, ang in zip(np.eye(3), e):    # intrinsic xyz
            q = _nquat_mul(q, _nquat_axis_angle(ax, ang))
        return q
    if 'zaxis' in attrs:
        return _zaxis_quat(_floats(attrs['zaxis']))
    if 'axisangle' in attrs:
        aa = _floats(attrs['axisangle'])
        return _nquat_axis_angle(aa[:3], math.radians(aa[3]) if deg
                                 else aa[3])
    return np.array([1.0, 0, 0, 0])


def _geom_volume(gtype: int, size) -> float:
    r = size[0]
    if gtype == M.SPHERE:
        return 4.0 / 3.0 * math.pi * r ** 3
    if gtype == M.CAPSULE:
        return math.pi * r * r * (2 * size[1]) + 4.0 / 3.0 * math.pi * r ** 3
    if gtype == M.CYLINDER:
        return math.pi * r * r * 2 * size[1]
    if gtype == M.BOX:
        return 8.0 * size[0] * size[1] * size[2]
    if gtype == M.ELLIPSOID:
        return 4.0 / 3.0 * math.pi * size[0] * size[1] * size[2]
    return 0.0                                     # plane: massless


def _geom_inertia(gtype: int, size, mass: float) -> np.ndarray:
    """Diagonal inertia about the geom's CoM in its frame (z = axis), as
    MuJoCo's compiler computes it."""
    r = size[0]
    if gtype == M.SPHERE:
        return np.diag([0.4 * mass * r * r] * 3)
    if gtype == M.CAPSULE:
        height = 2 * size[1]
        sphere_mass = mass * 4 * r / (4 * r + 3 * height)
        cyl_mass = mass - sphere_mass
        ixy = cyl_mass * (3 * r * r + height * height) / 12.0
        iz = cyl_mass * r * r / 2.0
        sph_i = 0.4 * sphere_mass * r * r
        ixy += sph_i + sphere_mass * height * (3 * r + 2 * height) / 8.0
        iz += sph_i
        return np.diag([ixy, ixy, iz])
    if gtype == M.CYLINDER:
        ixy = mass * (3 * r * r + (2 * size[1]) ** 2) / 12.0
        return np.diag([ixy, ixy, mass * r * r / 2.0])
    if gtype == M.BOX:
        a2, b2, c2 = (2 * np.asarray(size)) ** 2
        return np.diag([mass * (b2 + c2) / 12.0, mass * (a2 + c2) / 12.0,
                        mass * (a2 + b2) / 12.0])
    if gtype == M.ELLIPSOID:
        a2, b2, c2 = np.asarray(size) ** 2
        return np.diag([mass * (b2 + c2) / 5.0, mass * (a2 + c2) / 5.0,
                        mass * (a2 + b2) / 5.0])
    return np.zeros((3, 3))


def _fluid_boxes(body_mass, body_inertia):
    """The fluid model's equivalent inertia box of each massive body,
    half-sizes a_i = sqrt(3 (I_j + I_k - I_i) / (2 m)) over the principal
    moments, and the principal frame (eigenvectors of the inertia), as
    the JAX compiler computes them."""
    nbody = len(body_mass)
    box = np.zeros((nbody, 3))
    frame = np.tile(np.eye(3), (nbody, 1, 1))
    for i in range(nbody):
        mm = body_mass[i]
        if mm > 1e-12:
            evals, evecs = np.linalg.eigh(body_inertia[i])
            frame[i] = evecs
            for ax in range(3):
                j, k = (ax + 1) % 3, (ax + 2) % 3
                box[i, ax] = np.sqrt(3.0 * max(
                    evals[j] + evals[k] - evals[ax], 1e-14) / (2.0 * mm))
    return box, frame


def parse(xml_string: str, dtype=torch.float32) -> M.Model:
    """Compile an MJCF XML string into a CPU :class:`Model`."""
    root = ET.fromstring(xml_string)
    if root.tag != 'mujoco':
        raise AssertionError('not an MJCF document (root tag is not '
                             '<mujoco>)')
    contact_el = root.find('contact')
    # the heightfield asset (the last one; quadruped escape)
    hfield_nrow = hfield_ncol = 0
    hfield_size = None
    for ael in (root.find('asset') if root.find('asset') is not None
                else ()):
        if ael.tag == 'hfield':
            hfield_nrow = int(ael.get('nrow', 0))
            hfield_ncol = int(ael.get('ncol', 0))
            hfield_size = _floats(ael.attrib['size'])

    compiler = root.find('compiler')
    deg, settotalmass = True, None
    if compiler is not None:
        deg = compiler.get('angle') != 'radian'
        if 'settotalmass' in compiler.attrib:
            settotalmass = float(compiler.get('settotalmass'))

    timestep = 0.002
    gravity = np.array([0.0, 0.0, -9.81])
    integrator = M.EULER
    viscosity = density = 0.0
    wind = np.zeros(3)
    solver_iterations = 30
    disableflags = 0
    cone, impratio = 'pyramidal', 1.0
    opt_el = root.find('option')
    if opt_el is not None:
        timestep = float(opt_el.get('timestep', timestep))
        solver_iterations = int(opt_el.get('iterations', 30))
        if 'gravity' in opt_el.attrib:
            gravity = _floats(opt_el.get('gravity'))
        if opt_el.get('integrator', 'Euler') == 'RK4':
            integrator = M.RK4
        cone = opt_el.get('cone', cone)
        impratio = float(opt_el.get('impratio', impratio))
        viscosity = float(opt_el.get('viscosity', 0.0))
        density = float(opt_el.get('density', 0.0))
        if 'wind' in opt_el.attrib:
            wind = _floats(opt_el.get('wind'))
        flag = opt_el.find('flag')
        if flag is not None:
            for attr, bit in (('contact', M.DSBL_CONTACT),
                              ('gravity', M.DSBL_GRAVITY),
                              ('limit', M.DSBL_LIMIT),
                              ('actuation', M.DSBL_ACTUATION)):
                if flag.get(attr) == 'disable':
                    disableflags |= bit

    defaults = _Defaults()
    for d in root.findall('default'):
        defaults.parse(d)

    body_parent, body_pos, body_quat = [0], [np.zeros(3)], [
        np.array([1.0, 0, 0, 0])]
    body_names = {'world': 0}
    body_mass, body_fm, body_io = [0.0], [np.zeros(3)], [np.zeros((3, 3))]
    jnts, jnt_names = [], {}
    geoms, geom_names = [], {}
    sites, site_names = [], {}
    cameras, camera_names = [], {}

    def add_geom(attrs, body_id):
        gtype = _GEOM_TYPES[attrs.get('type', 'sphere')]
        if 'fromto' in attrs and gtype == M.SPHERE:
            gtype = M.CAPSULE          # fromto implies an elongated geom
        size = np.zeros(3)
        if 'size' in attrs:
            s = _floats(attrs['size'])
            size[:len(s)] = s
        quat = _orientation(attrs, deg)
        pos = _floats(attrs['pos']) if 'pos' in attrs else np.zeros(3)
        if 'fromto' in attrs:
            ft = _floats(attrs['fromto'])
            p0, p1 = ft[:3], ft[3:]
            # the frame's +z is the minimal rotation onto (from - to), as
            # the JAX compiler (and mjModel) places it
            pos = 0.5 * (p0 + p1)
            quat = _zaxis_quat(p0 - p1)
            size[1] = 0.5 * np.linalg.norm(p1 - p0)
        mass = (float(attrs['mass']) if 'mass' in attrs else
                float(attrs.get('density', 1000.0))
                * _geom_volume(gtype, size))
        friction = np.array([1.0, 0.005, 0.0001])
        if 'friction' in attrs:
            f = _floats(attrs['friction'])
            friction[:len(f)] = f
        solref = _DEFAULT_SOLREF.copy()
        if 'solref' in attrs:
            solref[:] = _floats(attrs['solref'])[:2]
        solimp = _DEFAULT_SOLIMP.copy()
        if 'solimp' in attrs:
            si = _floats(attrs['solimp'])
            solimp[:len(si)] = si
        if attrs.get('name'):
            geom_names[attrs['name']] = len(geoms)
        geoms.append(dict(
            type=gtype, body=body_id, pos=pos, quat=quat, size=size,
            friction=friction, solref=solref, solimp=solimp,
            margin=float(attrs.get('margin', 0.0)),
            contype=int(attrs.get('contype', 1)),
            conaffinity=int(attrs.get('conaffinity', 1)),
            condim=int(attrs.get('condim', 3)),
            priority=int(attrs.get('priority', 0)),
            solmix=float(attrs.get('solmix', 1.0))))
        if mass > 0.0:
            R = _nquat_to_mat(quat)
            inertia_com = R @ _geom_inertia(gtype, size, mass) @ R.T
            cx = _skew(pos)
            body_mass[body_id] += mass
            body_fm[body_id] = body_fm[body_id] + mass * pos
            body_io[body_id] = body_io[body_id] + inertia_com + mass * (
                cx @ cx.T)

    def add_site(attrs, body_id):
        size = np.full(3, _SITE_SIZE)
        if 'size' in attrs:
            s = _floats(attrs['size'])
            size[:len(s)] = s
            if len(s) == 1:
                size[:] = s[0]
        if attrs.get('name'):
            site_names[attrs['name']] = len(sites)
        sites.append(dict(
            body=body_id,
            pos=_floats(attrs['pos']) if 'pos' in attrs else np.zeros(3),
            quat=_orientation(attrs, deg),
            type=_GEOM_TYPES.get(attrs.get('type', 'sphere'), M.SPHERE),
            size=size))

    def add_camera(attrs, body_id):
        if attrs.get('name'):
            camera_names[attrs['name']] = len(cameras)
        cameras.append(dict(
            body=body_id,
            pos=_floats(attrs['pos']) if 'pos' in attrs else np.zeros(3),
            quat=_orientation(attrs, deg),
            fovy=float(attrs.get('fovy', 45.0)),
            mode=attrs.get('mode', 'fixed')))

    def add_joint(attrs, body_id):
        jtype = _JOINT_TYPES[attrs.get('type', 'hinge')]
        limited = attrs.get('limited', 'false') in ('true', '1')
        rng = np.zeros(2)
        if 'range' in attrs:
            rng = _floats(attrs['range'])
            # a ball joint's range is its largest angle, in degrees too
            if jtype in (M.HINGE, M.BALL) and limited and deg:
                rng = np.radians(rng)
        solref = _DEFAULT_SOLREF.copy()
        if 'solreflimit' in attrs:
            solref[:] = _floats(attrs['solreflimit'])[:2]
        solimp = _DEFAULT_SOLIMP.copy()
        if 'solimplimit' in attrs:
            si = _floats(attrs['solimplimit'])
            solimp[:len(si)] = si
        to_rad = (lambda a: math.radians(a)) if (
            deg and jtype == M.HINGE) else (lambda a: a)
        if attrs.get('name'):
            jnt_names[attrs['name']] = len(jnts)
        jnts.append(dict(
            type=jtype, body=body_id,
            pos=_floats(attrs['pos']) if 'pos' in attrs else np.zeros(3),
            axis=(_floats(attrs['axis']) if 'axis' in attrs
                  else np.array([0.0, 0.0, 1.0])),
            range=rng, limited=limited, solref=solref, solimp=solimp,
            stiffness=float(attrs.get('stiffness', 0.0)),
            springref=to_rad(float(attrs.get('springref', 0.0))),
            ref=to_rad(float(attrs.get('ref', 0.0))),
            damping=float(attrs.get('damping', 0.0)),
            armature=float(attrs.get('armature', 0.0)),
            frictionloss=float(attrs.get('frictionloss', 0.0)),
            margin=float(attrs.get('margin', 0.0))))

    def add_inertial(attrs, body_id):
        # an explicit inertial replaces what the body's geoms gave so far,
        # as the JAX compiler does
        mass = float(attrs['mass'])
        ipos = _floats(attrs.get('pos', '0 0 0'))
        if 'diaginertia' in attrs:
            inert = np.diag(_floats(attrs['diaginertia']))
        else:
            f = _floats(attrs.get('fullinertia', '1 1 1 0 0 0'))
            inert = np.array([[f[0], f[3], f[4]], [f[3], f[1], f[5]],
                              [f[4], f[5], f[2]]])
        R = _nquat_to_mat(_orientation(attrs, deg))
        cx = _skew(ipos)
        body_mass[body_id] = mass
        body_fm[body_id] = mass * ipos
        body_io[body_id] = R @ inert @ R.T + mass * (cx @ cx.T)

    def add_child(child, body_id, cls):
        tag = child.tag
        cattrs = defaults.resolve(tag, child.attrib,
                                  child.attrib.get('class', cls))
        if tag == 'joint':
            add_joint(cattrs, body_id)
        elif tag == 'freejoint':
            # a free joint ignores every default but its name
            add_joint({'type': 'free', 'name': cattrs.get('name', '')},
                      body_id)
        elif tag == 'geom':
            add_geom(cattrs, body_id)
        elif tag == 'site':
            add_site(cattrs, body_id)
        elif tag == 'inertial':
            add_inertial(cattrs, body_id)
        elif tag == 'body':
            walk_body(child, body_id, cls)
        elif tag == 'camera':
            add_camera(cattrs, body_id)
        # anything else (lights) is dropped, as in JAX

    def walk_body(elem, parent_id, childclass):
        cls = elem.get('childclass', childclass)
        body_id = len(body_parent)
        body_parent.append(parent_id)
        body_pos.append(_floats(elem.attrib['pos']) if 'pos' in elem.attrib
                        else np.zeros(3))
        body_quat.append(_orientation(elem.attrib, deg))
        body_names[elem.attrib.get('name', f'body{body_id}')] = body_id
        body_mass.append(0.0)
        body_fm.append(np.zeros(3))
        body_io.append(np.zeros((3, 3)))
        for child in elem:
            add_child(child, body_id, cls)

    worldbody = root.find('worldbody')
    for child in (worldbody if worldbody is not None else ()):
        if child.tag == 'body':
            walk_body(child, 0, child.get('childclass'))
        elif child.tag in ('geom', 'site', 'camera'):
            add_child(child, 0, None)

    nbody, njnt = len(body_parent), len(jnts)
    jnt_qposadr, jnt_dofadr, dof_jnt = [], [], []
    nq = nv = 0
    for ji, j in enumerate(jnts):
        jnt_qposadr.append(nq)
        jnt_dofadr.append(nv)
        nq += M.QPOS_WIDTH[j['type']]
        nv += M.DOF_WIDTH[j['type']]
        dof_jnt += [ji] * M.DOF_WIDTH[j['type']]
    dof = lambda key: [jnts[ji][key] for ji in dof_jnt]
    # a free joint's qpos0 is its body's frame (position, unit quaternion),
    # a ball joint's the identity rotation
    qpos0, qpos_spring = np.zeros(nq), np.zeros(nq)
    for ji, j in enumerate(jnts):
        adr = jnt_qposadr[ji]
        if j['type'] == M.FREE:
            qpos0[adr:adr + 7] = np.concatenate([body_pos[j['body']],
                                                 body_quat[j['body']]])
            qpos_spring[adr:adr + 7] = qpos0[adr:adr + 7]
        elif j['type'] == M.BALL:
            qpos0[adr] = qpos_spring[adr] = 1.0
        else:
            qpos0[adr], qpos_spring[adr] = j['ref'], j['springref']

    # the world body stays massless (mjModel semantics)
    body_mass[0], body_fm[0], body_io[0] = 0.0, np.zeros(3), np.zeros((3, 3))
    if settotalmass is not None:
        total = sum(body_mass)
        if total > 0:
            scale = settotalmass / total
            body_mass = [mm * scale for mm in body_mass]
            body_fm = [fm * scale for fm in body_fm]
            body_io = [ii * scale for ii in body_io]
    bmass = np.array(body_mass)
    body_ipos = np.zeros((nbody, 3))
    body_inertia = np.zeros((nbody, 3, 3))
    for i in range(nbody):
        if bmass[i] > 0:
            com = body_fm[i] / bmass[i]
            cx = _skew(com)
            body_ipos[i] = com
            body_inertia[i] = body_io[i] - bmass[i] * (cx @ cx.T)
    body_fluid_box, body_principal_mat = _fluid_boxes(bmass, body_inertia)

    # fixed tendons: one moment row (d length / d qvel) each; spatial
    # ones between two sites: (site1, site2, limited, lo, hi), their
    # invweight0 appended by _with_invweight0
    tendon_names, tendons, spatial = {}, [], []
    tendon_el = root.find('tendon')
    for tel in (tendon_el if tendon_el is not None else ()):
        if tel.tag == 'spatial':
            attrs = defaults.resolve('spatial', tel.attrib,
                                     tel.attrib.get('class'))
            ends = [site_names[x.get('site')] for x in tel.findall('site')]
            if len(ends) != 2:
                continue            # via points: dropped, as in JAX
            rng = (_floats(attrs['range']) if 'range' in attrs
                   else np.zeros(2))
            spatial.append((ends[0], ends[1],
                            attrs.get('limited', 'false') in ('true', '1'),
                            float(rng[0]), float(rng[1])))
            continue
        if tel.tag != 'fixed':
            continue
        # a fixed tendon's limits are not read, as in JAX
        attrs = defaults.resolve('fixed', tel.attrib, tel.attrib.get('class'))
        row, pairs = np.zeros(nv), []
        for jref in tel.findall('joint'):
            ji = jnt_names[jref.get('joint')]
            coef = float(jref.get('coef'))
            row[jnt_dofadr[ji]] = coef
            pairs.append((ji, coef))
        if attrs.get('name'):
            tendon_names[attrs['name']] = len(tendons)
        tendons.append(dict(row=row, jnt=tuple(pairs),
                            stiffness=float(attrs.get('stiffness', 0.0)),
                            damping=float(attrs.get('damping', 0.0))))
    ntendon = len(tendons)

    # tendon equality: (tendon, solref, solimp), a row holding the fixed
    # tendon tendon1's length at 0 (the manipulator's finger coupling);
    # other equalities and tendon2 are dropped, as in JAX
    eq_tendon = []
    for eel in (root.find('equality') if root.find('equality') is not None
                else ()):
        if eel.tag != 'tendon':
            continue
        attrs = defaults.resolve('equality', eel.attrib, None)
        solref = _DEFAULT_SOLREF.copy()
        if 'solref' in attrs:
            solref[:] = _floats(attrs['solref'])[:2]
        solimp = _DEFAULT_SOLIMP.copy()
        if 'solimp' in attrs:
            si = _floats(attrs['solimp'])
            solimp[:len(si)] = si
        eq_tendon.append((tendon_names[attrs['tendon1']],
                          tuple(solref.tolist()), tuple(solimp.tolist())))

    # explicit contact excludes: (body1, body2) pairs no contact joins
    contact_excludes = tuple(
        (body_names[cel.attrib['body1']], body_names[cel.attrib['body2']])
        for cel in (contact_el if contact_el is not None else ())
        if cel.tag == 'exclude')

    act_names, acts = {}, []
    actuator_el = root.find('actuator')
    for ael in (actuator_el if actuator_el is not None else ()):
        if ael.tag not in ('motor', 'position', 'velocity', 'general'):
            continue
        attrs = defaults.resolve(ael.tag, ael.attrib,
                                 ael.attrib.get('class'))
        if 'joint' in attrs:
            trntype, trnid = M.TRN_JOINT, jnt_names[attrs['joint']]
        elif 'tendon' in attrs:
            trntype, trnid = M.TRN_TENDON, tendon_names[attrs['tendon']]
        else:
            raise ValueError(f'actuator {attrs} needs joint or tendon')
        if attrs.get('name'):
            act_names[attrs['name']] = len(acts)
        gainprm, biasprm, biastype = [1.0, 0.0, 0.0], [0.0] * 3, M.BIAS_NONE
        if ael.tag == 'position':
            kp = float(attrs.get('kp', 1.0))
            gainprm, biasprm = [kp, 0.0, 0.0], [0.0, -kp, 0.0]
            biastype = M.BIAS_AFFINE
        elif ael.tag == 'velocity':
            kv = float(attrs.get('kv', 1.0))
            gainprm, biasprm = [kv, 0.0, 0.0], [0.0, 0.0, -kv]
            biastype = M.BIAS_AFFINE
        elif ael.tag == 'general':
            # a given biasprm makes the bias affine, as in the JAX compiler
            if 'gainprm' in attrs:
                gp = _floats(attrs['gainprm'])[:3]
                gainprm[:len(gp)] = gp
            if 'biasprm' in attrs:
                bp = _floats(attrs['biasprm'])[:3]
                biasprm[:len(bp)] = bp
                biastype = M.BIAS_AFFINE
        dynprm = [1.0, 0.0, 0.0]
        if 'dynprm' in attrs:
            dp = _floats(attrs['dynprm'])[:3]
            dynprm[:len(dp)] = dp
        acts.append(dict(
            trntype=trntype, trnid=trnid,
            gear=float(_floats(attrs.get('gear', '1'))[0]),
            ctrllimited=attrs.get('ctrllimited', 'false') in ('true', '1'),
            ctrlrange=(_floats(attrs['ctrlrange']) if 'ctrlrange' in attrs
                       else np.zeros(2)),
            forcelimited=attrs.get('forcelimited', 'false') in ('true', '1'),
            forcerange=(_floats(attrs['forcerange'])
                        if 'forcerange' in attrs else np.zeros(2)),
            gainprm=gainprm, biasprm=biasprm, biastype=biastype,
            dyntype=_DYN_TYPES[attrs.get('dyntype', 'none')],
            dynprm=dynprm))
    nu = len(acts)
    # one activation slot per stateful actuator, in actuator order
    actadr, na = [], 0
    for a in acts:
        actadr.append(na if a['dyntype'] != M.DYN_NONE else -1)
        na += a['dyntype'] != M.DYN_NONE
    hfield_pos = np.zeros(3)
    for g in geoms:
        if g['type'] == M.HFIELD:
            hfield_pos = g['pos']

    def arr(x, shape):
        a = np.asarray(x, dtype=np.float64)
        if a.size == 0:
            a = a.reshape(shape)
        return torch.as_tensor(a, dtype=dtype)

    ng, ns = len(geoms), len(sites)
    model = M.Model(
        opt=M.Option(timestep=arr(timestep, ()), gravity=arr(gravity, (3,)),
                     viscosity=arr(viscosity, ()), density=arr(density, ()),
                     wind=arr(wind, (3,)), integrator=integrator,
                     disableflags=disableflags,
                     solver_iterations=solver_iterations, cone=cone,
                     impratio=impratio),
        nq=nq, nv=nv, nu=nu, nbody=nbody, njnt=njnt, ngeom=ng, nsite=ns,
        ntendon=ntendon,
        body_parent=tuple(body_parent),
        jnt_type=tuple(j['type'] for j in jnts),
        jnt_body=tuple(j['body'] for j in jnts),
        jnt_qposadr=tuple(jnt_qposadr), jnt_dofadr=tuple(jnt_dofadr),
        jnt_limited=tuple(bool(j['limited']) for j in jnts),
        dof_jnt=tuple(dof_jnt),
        geom_type=tuple(g['type'] for g in geoms),
        geom_body=tuple(g['body'] for g in geoms),
        site_body=tuple(s['body'] for s in sites),
        actuator_trntype=tuple(a['trntype'] for a in acts),
        actuator_trnid=tuple(a['trnid'] for a in acts),
        actuator_ctrllimited=tuple(a['ctrllimited'] for a in acts),
        names={'body': body_names, 'joint': jnt_names, 'geom': geom_names,
               'site': site_names, 'actuator': act_names,
               'tendon': tendon_names, 'camera': camera_names},
        body_pos=arr(body_pos, (nbody, 3)),
        body_quat=arr(body_quat, (nbody, 4)),
        body_mass=arr(bmass, (nbody,)),
        body_ipos=arr(body_ipos, (nbody, 3)),
        body_inertia=arr(body_inertia, (nbody, 3, 3)),
        jnt_pos=arr([j['pos'] for j in jnts], (njnt, 3)),
        jnt_axis=arr([j['axis'] / np.linalg.norm(j['axis']) for j in jnts],
                     (njnt, 3)),
        jnt_range=arr([j['range'] for j in jnts], (njnt, 2)),
        jnt_solref=arr([j['solref'] for j in jnts], (njnt, 2)),
        jnt_solimp=arr([j['solimp'] for j in jnts], (njnt, 5)),
        jnt_stiffness=arr([j['stiffness'] for j in jnts], (njnt,)),
        jnt_margin=arr([j['margin'] for j in jnts], (njnt,)),
        dof_damping=arr(dof('damping'), (nv,)),
        dof_armature=arr(dof('armature'), (nv,)),
        dof_frictionloss=arr(dof('frictionloss'), (nv,)),
        geom_pos=arr([g['pos'] for g in geoms], (ng, 3)),
        geom_quat=arr([g['quat'] for g in geoms], (ng, 4)),
        geom_size=arr([g['size'] for g in geoms], (ng, 3)),
        geom_friction=arr([g['friction'] for g in geoms], (ng, 3)),
        geom_solref=arr([g['solref'] for g in geoms], (ng, 2)),
        geom_solimp=arr([g['solimp'] for g in geoms], (ng, 5)),
        geom_margin=arr([g['margin'] for g in geoms], (ng,)),
        geom_contype=tuple(g['contype'] for g in geoms),
        geom_conaffinity=tuple(g['conaffinity'] for g in geoms),
        geom_condim=tuple(g['condim'] for g in geoms),
        geom_priority=tuple(g['priority'] for g in geoms),
        geom_solmix=arr([g['solmix'] for g in geoms], (ng,)),
        site_pos=arr([s['pos'] for s in sites], (ns, 3)),
        site_quat=arr([s['quat'] for s in sites], (ns, 4)),
        site_size=arr([s['size'] for s in sites], (ns, 3)),
        site_type=tuple(s['type'] for s in sites),
        body_fluid_box=arr(body_fluid_box, (nbody, 3)),
        body_principal_mat=arr(body_principal_mat, (nbody, 3, 3)),
        actuator_gear=arr([a['gear'] for a in acts], (nu,)),
        actuator_ctrlrange=arr([a['ctrlrange'] for a in acts], (nu, 2)),
        actuator_gainprm=arr([a['gainprm'] for a in acts], (nu, 3)),
        actuator_biasprm=arr([a['biasprm'] for a in acts], (nu, 3)),
        actuator_forcerange=arr([a['forcerange'] for a in acts], (nu, 2)),
        actuator_forcelimited=tuple(a['forcelimited'] for a in acts),
        actuator_biastype=tuple(a['biastype'] for a in acts),
        qpos0=arr(qpos0, (nq,)), qpos_spring=arr(qpos_spring, (nq,)),
        na=na, actuator_dyntype=tuple(a['dyntype'] for a in acts),
        actuator_actadr=tuple(actadr),
        actuator_dynprm=arr([a['dynprm'] for a in acts], (nu, 3)),
        hfield_nrow=hfield_nrow, hfield_ncol=hfield_ncol,
        hfield_data=(torch.zeros((hfield_nrow, hfield_ncol), dtype=dtype)
                     if hfield_nrow else None),
        hfield_size=(arr(hfield_size, (4,)) if hfield_size is not None
                     else None),
        hfield_pos=arr(hfield_pos, (3,)) if hfield_nrow else None,
        tendon_moment=arr([t['row'] for t in tendons], (ntendon, nv)),
        tendon_stiffness=arr([t['stiffness'] for t in tendons], (ntendon,)),
        tendon_damping=arr([t['damping'] for t in tendons], (ntendon,)),
        tendon_jnt=tuple(t['jnt'] for t in tendons),
        spatial_tendons=tuple(spatial), eq_tendon=tuple(eq_tendon),
        contact_excludes=contact_excludes,
        ncam=len(cameras), cam_body=tuple(c['body'] for c in cameras),
        cam_mode=tuple(c['mode'] for c in cameras),
        cam_fovy=tuple(c['fovy'] for c in cameras),
        cam_pos=arr([c['pos'] for c in cameras], (len(cameras), 3)),
        cam_quat=arr([c['quat'] for c in cameras], (len(cameras), 4)))
    return _with_invweight0(model)


def _with_invweight0(model: M.Model) -> M.Model:
    """dof/body/tendon invweight0 at qpos0 (mj_setConst), as the JAX
    ``_with_invweight0`` computes them."""
    from . import smooth
    from .solver import ancestor_dof_mask

    meta = smooth.tree_meta(model)
    q0 = model.qpos0[None]
    xpos, xquat, _, _, _, site_xpos, xanchor, xaxis = smooth.kinematics(
        model, q0, meta)
    xipos = smooth.com_positions(model, xpos, xquat)
    cdof = smooth.motion_subspace(model, xquat, xanchor, xaxis, meta)
    cinert = smooth.body_spatial_inertia(model, xquat, xipos)
    qM = smooth.crba(model, cdof, cinert, meta)
    Minv = np.linalg.inv(qM[0].double().numpy())
    dof_iw = np.diag(Minv).copy()
    # a free joint's translation and rotation triples, and a ball joint's
    # rotation triple, each take their group's mean of diag(M^-1)
    for j in range(model.njnt):
        adr = model.jnt_dofadr[j]
        if model.jnt_type[j] == M.FREE:
            dof_iw[adr:adr + 3] = dof_iw[adr:adr + 3].mean()
            dof_iw[adr + 3:adr + 6] = dof_iw[adr + 3:adr + 6].mean()
        elif model.jnt_type[j] == M.BALL:
            dof_iw[adr:adr + 3] = dof_iw[adr:adr + 3].mean()

    amask = ancestor_dof_mask(model, meta).astype(np.float64)
    cdof_np = cdof[0].double().numpy()
    xipos_np = xipos[0].double().numpy()
    body_ipos_np = model.body_ipos.double().numpy()
    body_mass_np = model.body_mass.double().numpy()
    jnt_axis_np = model.jnt_axis.double().numpy()
    has_child = set(model.body_parent[1:])

    def _simple2(bb):
        """Axis-aligned slide-only leaf body off the world, CoM at origin."""
        joints = [j for j in range(model.njnt) if model.jnt_body[j] == bb]
        if not joints or bb in has_child or model.body_parent[bb] != 0:
            return False
        for j in joints:
            if model.jnt_type[j] != M.SLIDE:
                return False
            if np.count_nonzero(np.abs(jnt_axis_np[j]) > 1e-12) != 1:
                return False
        return bool(np.all(np.abs(body_ipos_np[bb]) < 1e-12))

    has_free = {model.jnt_body[j] for j in range(model.njnt)
                if model.jnt_type[j] == M.FREE}
    body_iw = np.zeros((model.nbody, 2))
    for bb in range(1, model.nbody):
        if _simple2(bb) and body_mass_np[bb] > 0:
            body_iw[bb] = (1.0 / body_mass_np[bb], 0.0)
            continue
        mask = amask[bb][:, None]
        Jt = (cdof_np[:, 3:]
              + np.cross(cdof_np[:, :3], xipos_np[bb][None, :])) * mask
        Jr = cdof_np[:, :3] * mask
        iw_t = np.trace(Jt.T @ Minv @ Jt) / 3.0
        # a free leaf body takes 1/mass (a free body with children keeps
        # the trace form), as mjModel and the JAX compiler give it
        if bb in has_free and bb not in has_child and body_mass_np[bb] > 0:
            iw_t = 1.0 / body_mass_np[bb]
        body_iw[bb] = (iw_t, np.trace(Jr.T @ Minv @ Jr) / 3.0)
    ten_moment = model.tendon_moment.double().numpy()
    ten_iw = np.array([r @ Minv @ r for r in ten_moment])
    # a spatial tendon's limit row weighs r M^-1 r with r = dL/dq at
    # qpos0, as the JAX compiler appends it
    sxp = site_xpos[0].double().numpy()
    spatial = []
    for s1, s2, limited, lo, hi in model.spatial_tendons:
        diff = sxp[s1] - sxp[s2]
        u = diff / max(np.linalg.norm(diff), 1e-9)
        r = np.zeros(model.nv)
        for site, sgn in ((s1, 1.0), (s2, -1.0)):
            Jt = (cdof_np[:, 3:] + np.cross(cdof_np[:, :3], sxp[site])) \
                * amask[model.site_body[site]][:, None]
            r += sgn * (Jt @ u)
        spatial.append((s1, s2, limited, lo, hi, float(r @ Minv @ r)))
    dt = model.dtype
    return model.replace(dof_invweight0=torch.as_tensor(dof_iw, dtype=dt),
                         body_invweight0=torch.as_tensor(body_iw, dtype=dt),
                         tendon_invweight0=torch.as_tensor(
                             ten_iw.reshape(model.ntendon), dtype=dt),
                         spatial_tendons=tuple(spatial))
