"""CMU .amc motion-capture conversion for the humanoid_CMU skeleton.

Port of mujoco_mbrl_tpu/suite/parse_amc.py (itself the functional
equivalent of dm_control's ``suite/utils/parse_amc.py``): parses the CMU
mocap database's .amc text format and converts each frame to (qpos, qvel)
trajectories for the humanoid_cmu model, resampled to a target timestep
by scipy's cubic B-spline (``splrep`` / ``splev``), or linearly where
scipy is missing. Host-side numpy throughout: ``convert``
reads only the model's ``nq``, ``names['joint']`` and ``jnt_qposadr``, so
the port's Model (on any device) serves.
"""

from __future__ import annotations

import collections
from typing import List

import numpy as np

MOCAP_DT = 1.0 / 120.0
CONVERSION_LENGTH = 0.056444          # CMU units -> meters

# Joint order of the CMU mocap database channels (after the 6 root dofs).
_CMU_MOCAP_JOINT_ORDER = (
    'root0', 'root1', 'root2', 'root3', 'root4', 'root5',
    'lowerbackrx', 'lowerbackry', 'lowerbackrz',
    'upperbackrx', 'upperbackry', 'upperbackrz',
    'thoraxrx', 'thoraxry', 'thoraxrz',
    'lowerneckrx', 'lowerneckry', 'lowerneckrz',
    'upperneckrx', 'upperneckry', 'upperneckrz',
    'headrx', 'headry', 'headrz',
    'rclaviclery', 'rclaviclerz',
    'rhumerusrx', 'rhumerusry', 'rhumerusrz',
    'rradiusrx', 'rwristry', 'rhandrx', 'rhandrz',
    'rfingersrx', 'rthumbrx', 'rthumbrz',
    'lclaviclery', 'lclaviclerz',
    'lhumerusrx', 'lhumerusry', 'lhumerusrz',
    'lradiusrx', 'lwristry', 'lhandrx', 'lhandrz',
    'lfingersrx', 'lthumbrx', 'lthumbrz',
    'rfemurrx', 'rfemurry', 'rfemurrz',
    'rtibiarx', 'rfootrx', 'rfootrz', 'rtoesrx',
    'lfemurrx', 'lfemurry', 'lfemurrz',
    'ltibiarx', 'lfootrx', 'lfootrz', 'ltoesrx',
)

Converted = collections.namedtuple('Converted', ['qpos', 'qvel', 'time'])


def parse(file_name: str) -> List[np.ndarray]:
    """Parse an .amc file into a list of per-frame channel arrays."""
    with open(file_name) as f:
        lines = [ln.strip() for ln in f]
    frames = []
    current = None
    for ln in lines:
        if not ln or ln.startswith((':', '#')):
            continue
        tokens = ln.split()
        if len(tokens) == 1 and tokens[0].isdigit():
            if current:
                frames.append(np.array(current, dtype=np.float64))
            current = []
        elif current is not None:
            current.extend(float(t) for t in tokens[1:])
    if current:
        frames.append(np.array(current, dtype=np.float64))
    return frames


# -- quaternion helpers (numpy ports of the mju_* calls) --------------------

def _quat_mul(q, r):
    w1, x1, y1, z1 = q
    w2, x2, y2, z2 = r
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _quat_neg(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def _quat2vel(q, dt):
    """Angular velocity realizing rotation q over dt (mju_quat2Vel)."""
    axis = q[1:]
    sin_half = np.linalg.norm(axis)
    if sin_half < 1e-12:
        return np.zeros(3)
    angle = 2.0 * np.arctan2(sin_half, q[0])
    # wrap to [-pi, pi] like MuJoCo
    if angle > np.pi:
        angle -= 2 * np.pi
    return axis / sin_half * (angle / dt)


def _euler2quat(ax, ay, az):
    """zyx-order euler (degrees) -> quaternion, as the reference defines."""
    c1, s1 = np.cos(np.deg2rad(az / 2)), np.sin(np.deg2rad(az / 2))
    c2, s2 = np.cos(np.deg2rad(ay / 2)), np.sin(np.deg2rad(ay / 2))
    c3, s3 = np.cos(np.deg2rad(ax / 2)), np.sin(np.deg2rad(ax / 2))
    return np.array([
        c1 * c2 * c3 + s1 * s2 * s3,
        c1 * c2 * s3 - s1 * s2 * c3,
        c1 * s2 * c3 + s1 * c2 * s3,
        s1 * c2 * c3 - c1 * s2 * s3])


def _frame_to_qpos(amc_val: np.ndarray, model) -> np.ndarray:
    """One .amc frame -> qpos for the humanoid_CMU model."""
    qpos = np.zeros(model.nq)
    # root position: CMU axes (x, z, -y) scaled to meters
    xyz_transform = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]],
                             np.float64) * CONVERSION_LENGTH
    qpos[:3] = xyz_transform @ amc_val[:3]
    # root orientation: euler (deg) + 90deg X pre-rotation (the model's
    # root body carries euler='90 0 0')
    quat = _quat_mul(_euler2quat(90, 0, 0),
                     _euler2quat(amc_val[3], amc_val[4], amc_val[5]))
    qpos[3:7] = quat
    # named hinge channels in degrees
    jnames = model.names['joint']
    for ch, name in enumerate(_CMU_MOCAP_JOINT_ORDER[6:], start=6):
        j = jnames.get(name)
        if j is not None:
            qpos[model.jnt_qposadr[j]] = np.deg2rad(amc_val[ch])
    return qpos


def convert(file_name: str, model, timestep: float) -> Converted:
    """Convert an .amc file to resampled (qpos, qvel, time) trajectories.

    Args:
      file_name: path to the .amc mocap file.
      model: the compiled humanoid_CMU physics Model.
      timestep: desired output frame interval (e.g. the control timestep).
    """
    frames = parse(file_name)
    qpos_values = np.stack([_frame_to_qpos(f, model) for f in frames])

    time_vals = np.arange(0, len(frames) * MOCAP_DT - 1e-8, MOCAP_DT)
    time_new = np.arange(0, len(frames) * MOCAP_DT, timestep)
    while time_new[-1] > time_vals[-1]:
        time_new = time_new[:-1]

    try:
        from scipy import interpolate
        cols = [interpolate.splev(time_new,
                                  interpolate.splrep(time_vals,
                                                     qpos_values[:, i]))
                for i in range(qpos_values.shape[1])]
    except ImportError:
        cols = [np.interp(time_new, time_vals, qpos_values[:, i])
                for i in range(qpos_values.shape[1])]
    qpos_resampled = np.stack(cols)          # (nq, T)

    qvel_list = []
    for t in range(qpos_resampled.shape[1] - 1):
        p_t = qpos_resampled[:, t]
        p_tp1 = qpos_resampled[:, t + 1]
        qdiff = _quat_mul(_quat_neg(p_t[3:7]), p_tp1[3:7])
        qvel_list.append(np.concatenate([
            (p_tp1[:3] - p_t[:3]) / timestep,
            _quat2vel(qdiff, timestep),
            (p_tp1[7:] - p_t[7:]) / timestep]))
    qvel_resampled = np.stack(qvel_list).T   # (nv, T-1)

    return Converted(qpos_resampled, qvel_resampled, time_new)
