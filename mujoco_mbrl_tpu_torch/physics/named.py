"""Named indexing: string-addressed views over model, state and data.

Port of mujoco_mbrl_tpu/physics/named.py. Names resolve to static Python
indices when a view is built, so ``view.qpos(state, 'shoulder')`` costs
one slice of the tensor. The port's State, Data and ctrl carry the env
batch as their leading dimension: a name picks along the axis after it
(``view.xpos(data, 'torso')`` is (B, 3)); model arrays have no batch
axis.

    view = named.NamedView(model)
    view.qpos(state, 'hinge_1')        # (B,) or (B, width)
    view.qvel(state, 'slider')
    view.xpos(data, 'torso')           # (B, 3)
    view.xmat(data, 'torso')           # (B, 3, 3)
    view.geom_xpos(data, 'target')
    view.site_xpos(data, 'tip')
"""

from __future__ import annotations

import numpy as np
import torch

from . import model as M


def _pick(arr, rows, batch_dims: int):
    """``arr`` indexed by ``rows`` (an int, a slice or an index array) on
    the axis after its ``batch_dims`` leading ones."""
    if isinstance(rows, np.ndarray) and isinstance(arr, torch.Tensor):
        rows = torch.as_tensor(rows, dtype=torch.long, device=arr.device)
    if batch_dims == 0:
        return arr[rows]
    return arr[(slice(None),) * batch_dims + (rows,)]


class NamedView:
    """String-name accessors for a fixed compiled model."""

    def __init__(self, model: M.Model):
        self._m = model

    # -- state -----------------------------------------------------------
    def qpos(self, state_or_qpos, joint_name: str):
        qpos = getattr(state_or_qpos, 'qpos', state_or_qpos)
        out = qpos[..., self._m.jnt_qpos_slice(joint_name)]
        return out[..., 0] if out.shape[-1] == 1 else out

    def qvel(self, state_or_qvel, joint_name: str):
        qvel = getattr(state_or_qvel, 'qvel', state_or_qvel)
        out = qvel[..., self._m.jnt_dof_slice(joint_name)]
        return out[..., 0] if out.shape[-1] == 1 else out

    def set_qpos(self, state, joint_name: str, value):
        qpos = state.qpos.clone()
        qpos[..., self._m.jnt_qpos_slice(joint_name)] = torch.as_tensor(
            value, dtype=qpos.dtype, device=qpos.device)
        return state.replace(qpos=qpos)

    def set_qvel(self, state, joint_name: str, value):
        qvel = state.qvel.clone()
        qvel[..., self._m.jnt_dof_slice(joint_name)] = torch.as_tensor(
            value, dtype=qvel.dtype, device=qvel.device)
        return state.replace(qvel=qvel)

    # -- data (batched: (B, n, ...)) ----------------------------------------
    def xpos(self, data: M.Data, body_name: str):
        return data.xpos[:, self._m.name2id('body', body_name)]

    def xquat(self, data: M.Data, body_name: str):
        return data.xquat[:, self._m.name2id('body', body_name)]

    def xmat(self, data: M.Data, body_name: str):
        return data.ximat[:, self._m.name2id('body', body_name)]

    def xipos(self, data: M.Data, body_name: str):
        return data.xipos[:, self._m.name2id('body', body_name)]

    def geom_xpos(self, data: M.Data, geom_name: str):
        return data.geom_xpos[:, self._m.name2id('geom', geom_name)]

    def geom_xmat(self, data: M.Data, geom_name: str):
        return data.geom_xmat[:, self._m.name2id('geom', geom_name)]

    def site_xpos(self, data: M.Data, site_name: str):
        return data.site_xpos[:, self._m.name2id('site', site_name)]

    # -- model -----------------------------------------------------------
    def jnt_range(self, joint_name: str):
        return self._m.jnt_range[self._m.name2id('joint', joint_name)]

    def geom_size(self, geom_name: str):
        return self._m.geom_size[self._m.name2id('geom', geom_name)]

    def actuator_id(self, name: str) -> int:
        return self._m.name2id('actuator', name)


def named(model: M.Model) -> NamedView:
    return NamedView(model)


# --------------------------------------------------------------------------
# FieldIndexer: dm_control-style string-sliced array views
# --------------------------------------------------------------------------

_XYZ = ('x', 'y', 'z')
_QUAT = ('qw', 'qx', 'qy', 'qz')
_MAT9 = ('xx', 'xy', 'xz', 'yx', 'yy', 'yz', 'zx', 'zy', 'zz')


class _Axis:
    """Resolves a name / list of names / int / slice to static indices."""

    def __init__(self, names2rows):
        # names2rows: name -> int or tuple of ints (ragged axes)
        self._map = dict(names2rows)

    def resolve(self, key):
        if isinstance(key, str):
            rows = self._map.get(key)
            if rows is None:
                raise KeyError(
                    f'unknown name {key!r}; known: {sorted(self._map)}')
            return rows if isinstance(rows, int) else np.asarray(rows)
        if isinstance(key, (list, tuple)):
            out = []
            for k in key:
                r = self.resolve(k)
                out.extend([r] if isinstance(r, int) else list(np.ravel(r)))
            return np.asarray(out)
        return key   # int / slice / array passthrough


class FieldIndexer:
    """String-addressed view of one array (dm_control index.py:442).

    Reads only. ``fi['name']`` returns the row(s) for that name, after
    the array's ``batch_dims`` leading env axes; 2-D fields accept a
    second key of column names (('x','y','z'), quaternion components, or
    flattened-matrix entries):

        d = indexer(model).bind(state, data)
        d.qpos['shoulder']            # (B, width) ragged joint span
        d.xpos['torso', 'z']          # (B,)
        d.xpos[['head', 'torso']]     # (B, 2, 3)

    Writes go through ``.at(key)``, the resolved row indices.
    """

    def __init__(self, array, row_axis: _Axis, col_axis=None,
                 batch_dims: int = 0):
        self._arr = array
        self._rows = row_axis
        self._cols = _Axis({n: i for i, n in enumerate(col_axis)}) \
            if col_axis else None
        self._bd = batch_dims

    def at(self, key):
        """Resolved row indices, for an indexed write."""
        return self._rows.resolve(key)

    def __getitem__(self, key):
        if isinstance(key, tuple) and self._cols is not None:
            rkey, ckey = key
            r = self._rows.resolve(rkey)
            c = self._cols.resolve(ckey)
            out = _pick(self._arr, r, self._bd)
            # matrix fields: column picks into the flattened 3 x 3 (by the
            # field's columns, not its shape: a batch of 3 envs is not one)
            if len(self._cols._map) == 9:
                out = out.reshape(tuple(out.shape[:-2]) + (9,))
            if isinstance(c, np.ndarray):
                c = torch.as_tensor(c, dtype=torch.long, device=out.device)
            return out[..., c]
        return _pick(self._arr, self._rows.resolve(key), self._bd)

    @property
    def names(self):
        return sorted(self._rows._map)


class BoundIndexer:
    """All FieldIndexers for one (model, state / data / ctrl) triple; the
    state's, data's and ctrl's leading axis is the env batch."""

    def __init__(self, model: M.Model, state=None, data=None, ctrl=None):
        self._m = model
        jm, dm = {}, {}
        for j, name in _names_of(model, 'joint').items():
            q0, qw = model.jnt_qposadr[j], M.QPOS_WIDTH[model.jnt_type[j]]
            d0, dw = model.jnt_dofadr[j], M.DOF_WIDTH[model.jnt_type[j]]
            jm[name] = (int(q0) if qw == 1
                        else tuple(range(q0, q0 + qw)))
            dm[name] = (int(d0) if dw == 1
                        else tuple(range(d0, d0 + dw)))
        self._jnt_q, self._jnt_d = _Axis(jm), _Axis(dm)
        self._state, self._data, self._ctrl = state, data, ctrl

    def _axis(self, kind):
        return _Axis(self._m.names.get(kind, {}))

    def __getattr__(self, field):
        if field.startswith('_'):
            raise AttributeError(field)
        m, st, da = self._m, self._state, self._data
        if field == 'qpos':
            return FieldIndexer(st.qpos, self._jnt_q, batch_dims=1)
        if field == 'qvel':
            return FieldIndexer(st.qvel, self._jnt_d, batch_dims=1)
        if field == 'ctrl':
            return FieldIndexer(self._ctrl, self._axis('actuator'),
                                batch_dims=1)
        if field in ('xpos', 'xipos'):
            return FieldIndexer(getattr(da, field), self._axis('body'), _XYZ,
                                batch_dims=1)
        if field == 'xquat':
            return FieldIndexer(da.xquat, self._axis('body'), _QUAT,
                                batch_dims=1)
        if field in ('xmat', 'ximat'):
            return FieldIndexer(da.ximat, self._axis('body'), _MAT9,
                                batch_dims=1)
        if field == 'geom_xpos':
            return FieldIndexer(da.geom_xpos, self._axis('geom'), _XYZ,
                                batch_dims=1)
        if field == 'geom_xmat':
            return FieldIndexer(da.geom_xmat, self._axis('geom'), _MAT9,
                                batch_dims=1)
        if field == 'site_xpos':
            return FieldIndexer(da.site_xpos, self._axis('site'), _XYZ,
                                batch_dims=1)
        # model arrays addressed by their natural axis
        if field in ('jnt_range', 'jnt_axis', 'jnt_stiffness'):
            return FieldIndexer(getattr(m, field), self._axis('joint'))
        if field.startswith('geom_'):
            return FieldIndexer(getattr(m, field), self._axis('geom'), None)
        if field.startswith('body_'):
            return FieldIndexer(getattr(m, field), self._axis('body'), None)
        raise AttributeError(field)


class NamedIndexer:
    """Factory bound to a model; ``.bind(state=..., data=..., ctrl=...)``."""

    def __init__(self, model: M.Model):
        self._m = model

    def bind(self, state=None, data=None, ctrl=None) -> BoundIndexer:
        return BoundIndexer(self._m, state, data, ctrl)


def _names_of(model: M.Model, kind: str):
    """{index: name} for a kind, from the model's name tables."""
    return {v: k for k, v in model.names.get(kind, {}).items()}


def indexer(model: M.Model) -> NamedIndexer:
    return NamedIndexer(model)
