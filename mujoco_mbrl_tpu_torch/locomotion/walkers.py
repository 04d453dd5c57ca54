"""Walker entities (port of mujoco_mbrl_tpu/locomotion/walkers.py).

:class:`Walker` carries the reference walker base class's observable
suite (``locomotion/walkers/base.py`` WalkerObservables, 319-495):
egocentric joint / end-effector / orientation features, IMU-style
kinematic sensors derived from the engine's body spatial velocities, an
egocentric camera, and the semantic groupings (``proprioception``,
``kinematic_sensors``). :class:`PlanarWalker` is a torque-controlled
biped in the sagittal plane; :class:`CMUHumanoid` wraps the 56-actuator
CMU-mocap model. Every observable takes a batch of envs: the root frame
``ximat[:, b]`` rotates each env's vectors by a batched contraction.
"""

from __future__ import annotations

import torch

from .. import composer
from ..physics import builder


def _rows_times(v: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """v @ R[b] per env: v (B, 3) or (B, n, 3), R (B, 3, 3)."""
    return torch.einsum('b...i,bij->b...j', v, R)


def _transpose_times(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R[b].T @ v[b] per env: R (B, 3, 3), v (B, 3)."""
    return torch.einsum('bji,bj->bi', R, v)


class Walker(composer.Entity):
    """Shared walker observables (walkers/base.py:319 WalkerObservables).

    Subclasses set ``ROOT_BODY`` (base name of the root body) and
    ``END_EFFECTORS`` (base names of the end-effector bodies) and define
    ``joints_pos`` / ``joints_vel``; everything below derives from the
    forward Data: ``data.cvel`` (world spatial velocities about the
    origin) takes the role of the reference's gyro / velocimeter sensors,
    ``data.ximat`` gives the egocentric frame.
    """

    ROOT_BODY = 'torso'
    END_EFFECTORS: tuple = ()

    def _root_id(self, model):
        return model.names['body'][self.name(self.ROOT_BODY)]

    # -- egocentric frame helpers (walkers/base.py:93-163) -----------------
    def transform_vec_to_egocentric_frame(self, model, data, vec):
        """World vectors (B, 3) or (B, n, 3) -> root frame (base.py:93)."""
        return _rows_times(vec, data.ximat[:, self._root_id(model)])

    def transform_xmat_to_egocentric_frame(self, model, data, xmat):
        """World rotations (B, 3, 3) -> root frame (base.py:132)."""
        return data.ximat[:, self._root_id(model)].transpose(-1, -2) @ xmat

    # -- observables -------------------------------------------------------
    @composer.observable
    def body_height(self, model, phys, data):
        return data.xpos[:, self._root_id(model), 2]

    @composer.observable
    def world_zaxis(self, model, phys, data):
        """World z in the root frame (base.py:345 xmat[6:] row)."""
        return data.ximat[:, self._root_id(model), 2, :]

    @composer.observable
    def end_effectors_pos(self, model, phys, data):
        """End-effector positions, egocentric (base.py:335)."""
        return self._egocentric_positions(model, data, self.END_EFFECTORS)

    def _egocentric_positions(self, model, data, names):
        b = self._root_id(model)
        ids = [model.names['body'][self.name(n)] for n in names]
        delta = data.xpos[:, ids] - data.xpos[:, b, None]
        return _rows_times(delta, data.ximat[:, b]).reshape(
            delta.shape[0], -1)

    @composer.observable
    def position(self, model, phys, data):
        return data.xpos[:, self._root_id(model)]

    @composer.observable
    def orientation(self, model, phys, data):
        x = data.ximat[:, self._root_id(model)]
        return x.reshape(x.shape[0], 9)

    @composer.observable
    def sensors_gyro(self, model, phys, data):
        """Root angular velocity in the root frame (base.py:350)."""
        b = self._root_id(model)
        return _transpose_times(data.ximat[:, b], data.cvel[:, b, :3])

    @composer.observable
    def sensors_velocimeter(self, model, phys, data):
        """Root-point linear velocity in the root frame (base.py:354)."""
        b = self._root_id(model)
        v = data.cvel[:, b, 3:] + torch.linalg.cross(data.cvel[:, b, :3],
                                                     data.xpos[:, b])
        return _transpose_times(data.ximat[:, b], v)

    @composer.observable(enabled=False, observes_acc=True)
    def sensors_accelerometer(self, model, phys, data):
        """Proper acceleration at the root, root frame (base.py:358),
        from acceleration-stage Data (``observes_acc``)."""
        from ..suite import sensors as _s
        b = self._root_id(model)
        A = _s.body_cacc(model, data, phys.qvel)[:, b]
        v6 = data.cvel[:, b]
        p = data.xpos[:, b]
        v_p = v6[:, 3:] + torch.linalg.cross(v6[:, :3], p)
        a_p = (A[:, 3:] + torch.linalg.cross(A[:, :3], p)
               + torch.linalg.cross(v6[:, :3], v_p))
        return _transpose_times(data.ximat[:, b], a_p)

    @composer.observable(enabled=False)
    def egocentric_camera(self, model, phys, data):
        """(B, 64, 64, 3) RGB from the walker-mounted camera named
        ``egocentric`` (base.py:392); enabled per task."""
        from ..utils.raycast import Camera
        cam_id = model.names['camera'][self.name('egocentric')]
        return Camera(model, height=64, width=64,
                      camera_id=cam_id).render(data)

    # -- semantic groupings (base.py:430-452) ------------------------------
    @property
    def proprioception(self):
        return ['joints_pos', 'joints_vel', 'body_height',
                'end_effectors_pos', 'world_zaxis']

    @property
    def kinematic_sensors(self):
        return ['sensors_gyro', 'sensors_velocimeter',
                'sensors_accelerometer']

    def aliveness(self, model, phys, data):
        """[-1, 0] upright measure (base.py:168: 0 = alive)."""
        return (data.ximat[:, self._root_id(model), 2, 2] - 1.0) / 2.0


class PlanarWalker(Walker):
    ROOT_BODY = 'torso'
    END_EFFECTORS = ('right_foot', 'left_foot')
    _JOINTS = ('right_hip', 'right_knee', 'right_ankle', 'left_hip',
               'left_knee', 'left_ankle')

    def _build(self, torso_length=0.3, initial_z=1.3):
        self.initial_z = initial_z
        root = builder.RootElement(model='planar_walker')
        wb = root.worldbody
        torso = wb.add('body', name='torso', pos=[0, 0, initial_z])
        torso.add('joint', name='rootx', type='slide', axis=[1, 0, 0],
                  limited=False)
        torso.add('joint', name='rootz', type='slide', axis=[0, 0, 1],
                  limited=False)
        torso.add('joint', name='rooty', type='hinge', axis=[0, 1, 0],
                  limited=False)
        torso.add('geom', name='torso', type='capsule', size=[0.07],
                  fromto=[0, 0, -torso_length, 0, 0, torso_length])
        # forward-looking egocentric camera (walkers/base.py:275)
        torso.add('camera', name='egocentric', pos=[0.3, 0, 0],
                  quat=[0.5, 0.5, -0.5, -0.5])
        for side, off in (('right', -0.05), ('left', 0.05)):
            thigh = torso.add('body', name=f'{side}_thigh',
                              pos=[0, off, -torso_length])
            thigh.add('joint', name=f'{side}_hip', type='hinge',
                      axis=[0, 1, 0], range=[-20, 100], limited=True,
                      damping=0.1)
            thigh.add('geom', name=f'{side}_thigh', type='capsule',
                      size=[0.05], fromto=[0, 0, 0, 0, 0, -0.225])
            leg = thigh.add('body', name=f'{side}_leg', pos=[0, 0, -0.25])
            leg.add('joint', name=f'{side}_knee', type='hinge',
                    axis=[0, 1, 0], range=[-150, 0], limited=True,
                    damping=0.1)
            leg.add('geom', name=f'{side}_leg', type='capsule',
                    size=[0.04], fromto=[0, 0, 0, 0, 0, -0.25])
            foot = leg.add('body', name=f'{side}_foot', pos=[0, 0, -0.25])
            foot.add('joint', name=f'{side}_ankle', type='hinge',
                     axis=[0, 1, 0], range=[-45, 45], limited=True,
                     damping=0.1)
            foot.add('geom', name=f'{side}_foot', type='capsule',
                     size=[0.05], fromto=[-0.05, 0, 0, 0.15, 0, 0],
                     friction=[1.5])
        for j, gear in (('right_hip', 100), ('right_knee', 50),
                        ('right_ankle', 20), ('left_hip', 100),
                        ('left_knee', 50), ('left_ankle', 20)):
            root.actuator.add('motor', name=j, joint=j, gear=gear,
                              ctrllimited=True, ctrlrange=[-1, 1])
        return root

    # -- egocentric observables --------------------------------------------
    def _root_dofs(self, model):
        return tuple(model.jnt_dofadr[model.names['joint'][self.name(n)]]
                     for n in ('rootx', 'rootz', 'rooty'))

    @composer.observable
    def joints_pos(self, model, phys, data):
        qadr = [model.jnt_qposadr[model.names['joint'][self.name(n)]]
                for n in self._JOINTS]
        return phys.qpos[:, qadr]

    @composer.observable
    def joints_vel(self, model, phys, data):
        dadr = [model.jnt_dofadr[model.names['joint'][self.name(n)]]
                for n in self._JOINTS]
        return phys.qvel[:, dadr]

    @composer.observable
    def torso_height(self, model, phys, data):
        return data.xpos[:, model.names['body'][self.name('torso')], 2]

    @composer.observable
    def torso_upright(self, model, phys, data):
        return data.ximat[:, model.names['body'][self.name('torso')], 2, 2]

    @composer.observable
    def velocity(self, model, phys, data):
        return phys.qvel[:, list(self._root_dofs(model))]

    def forward_velocity(self, model, phys, data):
        return phys.qvel[:, self._root_dofs(model)[0]]

    def root_xy(self, model, phys, data):
        return data.xpos[:, model.names['body'][self.name('torso')], :2]


class CMUHumanoid(Walker):
    """CMU-mocap humanoid (56 actuated dofs) as a reusable walker entity.

    The locomotion/walkers/cmu_humanoid.py analogue: the suite's
    humanoid_cmu MJCF (``suite.humanoid_cmu._make_xml``) is parsed into
    an editable element tree (``builder.RootElement.from_xml_string``)
    and stripped of its floor: arenas own the ground plane. Exposes the
    same egocentric observable set as :class:`PlanarWalker`.
    """

    ROOT_BODY = 'root'
    END_EFFECTORS = ('rhand', 'lhand', 'rfoot', 'lfoot')

    def _build(self):
        from ..suite.humanoid_cmu import _make_xml
        root = builder.RootElement.from_xml_string(_make_xml())
        wb = root.worldbody
        wb.children = [c for c in wb.children
                       if not (c.tag == 'geom'
                               and c.attrs.get('name') == 'floor')]
        # forward-looking egocentric camera on the root body
        # (cmu_humanoid.py:243 egocentric_camera)
        rb = root.worldbody.find('body', 'root')
        if rb is not None and root.worldbody.find(
                'camera', 'egocentric') is None:
            rb.add('camera', name='egocentric', pos=[0.3, 0.3, 0],
                   quat=[0.5, 0.5, -0.5, -0.5])
        return root

    @composer.observable
    def appendages_pos(self, model, phys, data):
        """end_effectors_pos with the head appended, egocentric
        (cmu_humanoid.py:329-339)."""
        return self._egocentric_positions(model, data,
                                          self.END_EFFECTORS + ('head',))

    @composer.observable
    def head_height(self, model, phys, data):
        return data.xpos[:, model.names['body'][self.name('head')], 2]

    @property
    def proprioception(self):
        # cmu_humanoid.py:341-350 adds appendages_pos to the base group
        return super().proprioception + ['appendages_pos']

    # -- egocentric observables --------------------------------------------
    def _joint_ids(self, model):
        """All of this entity's joints but the free root joint."""
        prefix = self.name('')
        return [j for name, j in model.names['joint'].items()
                if name.startswith(prefix) and name != self.name('root')]

    @composer.observable
    def joints_pos(self, model, phys, data):
        return phys.qpos[:, sorted(int(model.jnt_qposadr[j])
                                   for j in self._joint_ids(model))]

    @composer.observable
    def joints_vel(self, model, phys, data):
        return phys.qvel[:, sorted(int(model.jnt_dofadr[j])
                                   for j in self._joint_ids(model))]

    @composer.observable
    def torso_height(self, model, phys, data):
        return data.xpos[:, model.names['body'][self.name('root')], 2]

    @composer.observable
    def torso_upright(self, model, phys, data):
        return data.ximat[:, model.names['body'][self.name('root')], 2, 2]

    @composer.observable
    def velocity(self, model, phys, data):
        d = int(model.jnt_dofadr[model.names['joint'][self.name('root')]])
        return phys.qvel[:, d:d + 6]

    def forward_velocity(self, model, phys, data):
        j = model.names['joint'][self.name('root')]
        return phys.qvel[:, int(model.jnt_dofadr[j])]

    def root_xy(self, model, phys, data):
        return data.xpos[:, model.names['body'][self.name('root')], :2]
