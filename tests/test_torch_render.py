"""Rendering, port against the JAX package: ``utils.raycast`` (``cast``,
``Camera`` fixed and trackcom, the reward tint, ``MovableCamera``),
``utils.render`` (the orthographic rasterizer), ``utils.recorder``,
``suite.wrappers`` (``PixelWrapper``, ``ActionNoiseWrapper``) and
``envs`` ``record_rollout``.

Both packages' renderers read the same kinematics: the port's forward of
qpos drawn with numpy, handed to JAX's renderers as numpy copies (the
kinematics are held to JAX's in the domains' own tests), so each case
compares the renderers alone. JAX runs them eagerly: its per-primitive
compiles are shared across the cases.

The pixel rule is ``chip_smoke.hold_pixels``, the one path 46 holds the
card to: a pixel whose segmentation id differs, or whose depth or shade
differs beyond the tolerance while it lies on an edge of the reference
image (a neighbour with another id: a ray grazing a silhouette, whose
root rounding moves; or with another shade: two faces' normals tie at a
box edge), is decided by rounding, and at most 0.5% of the pixels may
be. Every other pixel's depth is within 1e-4 (or 1e-5 of the distance
past 10 m: floor pixels near the horizon lie 100 m and more away) and
its RGB within 1e-4. uint8 frames: within one level but for 0.5% of the
pixels. ActionNoiseWrapper's draws
differ from ``jax.random``'s, so its noise is held to its distribution.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mujoco_mbrl_tpu.suite import wrappers as jwrappers
from mujoco_mbrl_tpu.utils import raycast as jraycast
from mujoco_mbrl_tpu.utils import render as jrender
from mujoco_mbrl_tpu_torch import envs, suite
from mujoco_mbrl_tpu_torch.physics import engine, mjcf
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.suite import acrobot, cartpole, cheetah, walker
from mujoco_mbrl_tpu_torch.suite import wrappers
from mujoco_mbrl_tpu_torch.utils import raycast, recorder, render
from chip_smoke import PIX_SHARE, PIX_TOL, hold_pixels
from test_torch_builder import RAYCAST_SCENE, jax_parse

SHAPES = RAYCAST_SCENE.replace('</worldbody>', """
    <body name='e' pos='-0.8 -1 .3'>
      <geom name='cyl' type='cylinder' size='.2 .3'/>
    </body>
    <body name='f' pos='0.8 -1 .3' euler='20 30 40'>
      <geom name='ell' type='ellipsoid' size='.2 .3 .1'/>
    </body>
  </worldbody>""")
XMLS = {'walker': walker._XML, 'cheetah': cheetah._XML,
        'cartpole': cartpole._make_model_xml(1), 'acrobot': acrobot._XML,
        'shapes': SHAPES}


_FIELDS = ('xpos', 'ximat', 'xipos', 'geom_xpos', 'geom_xmat')


def jax_view(data, b):
    """Env b of the port's Data as the arrays JAX's renderers read."""
    return SimpleNamespace(**{f: jnp.asarray(getattr(data, f)[b].numpy())
                              for f in _FIELDS})


def jax_frames(fn, data):
    """``fn(env b's view)`` for every env, stacked."""
    return np.stack([np.asarray(fn(jax_view(data, b)))
                     for b in range(data.xpos.shape[0])])


def port_data(m, qpos):
    state = M.make_state(m, qpos=torch.as_tensor(np.asarray(qpos),
                                                 dtype=torch.float32))
    return engine.forward(m, state, torch.zeros((state.qpos.shape[0], m.nu)),
                          acc_stage=False)


def both(cam, jcam, data, reward=None):
    """(seg, depth, rgb) of every env from both cameras; ``reward`` (B,)
    tints the RGB."""
    ours = (cam.render(data, segmentation=True).numpy(),
            cam.render(data, depth=True).numpy(),
            cam.render(data, reward=None if reward is None
                       else torch.tensor(reward)).numpy())
    ref = (jax_frames(lambda d: jcam.render(d, segmentation=True), data),
           jax_frames(lambda d: jcam.render(d, depth=True), data),
           np.stack([np.asarray(jcam.render(
               jax_view(data, b), reward=None if reward is None
               else float(reward[b]))) for b in range(data.xpos.shape[0])]))
    return ours, ref


_MODELS = {}


def models(name):
    """(port Model, JAX Model) of XMLS[name], compiled once."""
    if name not in _MODELS:
        _MODELS[name] = (mjcf.parse(XMLS[name]), jax_parse(XMLS[name]))
    return _MODELS[name]


def random_qpos(m, n, seed, scale=0.4):
    rng = np.random.default_rng(seed)
    return np.asarray(m.qpos0) + rng.normal(0, scale, (n, m.nq))


def test_cast_matches_jax_on_every_geom_type():
    """4,000 random rays through the scene of every geom type: the same
    ids but for grazing rays, hit distances within 1e-4 and normals
    within 1e-4 where they agree, but at tied box faces (0.5% in all)."""
    m, jm = models('shapes')
    data = port_data(m, np.zeros((1, 0)))
    rng = np.random.default_rng(0)
    N = 4000
    o = rng.uniform([-2, -3, 0.2], [2, -1.5, 2], (N, 3))
    d = rng.uniform([-1.8, -1.2, 0], [1.8, 0.4, 1.2], (N, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t, gid, n = (x[0].numpy() for x in raycast.cast(
        m, data, torch.tensor(o, dtype=torch.float32),
        torch.tensor(d, dtype=torch.float32)))
    jt, jgid, jn = (np.asarray(x) for x in jraycast.cast(
        jm, jax_view(data, 0), jnp.asarray(o, jnp.float32),
        jnp.asarray(d, jnp.float32)))
    assert set(jgid.tolist()) >= {-1, 0, 1, 2, 3, 4, 5}
    same = gid == jgid
    hit = same & (jgid >= 0)
    close = ((np.abs(t - jt) <= PIX_TOL)
             & (np.abs(n - jn).max(-1) <= PIX_TOL))
    assert (~same).sum() + (hit & ~close).sum() <= PIX_SHARE * N


def test_direct_ray_hits_the_sphere():
    """JAX's test_ray_cast_direct_sphere_normal, on 2 envs."""
    m, _ = models('shapes')
    data = port_data(m, np.zeros((2, 0)))
    t, gid, n = raycast.cast(m, data, torch.tensor([[0.0, -3.0, 1.0]]),
                             torch.tensor([[0.0, 1.0, 0.0]]))
    np.testing.assert_allclose(t.numpy(), 2.5, atol=1e-5)
    assert gid.tolist() == [[m.names['geom']['ball']]] * 2
    np.testing.assert_allclose(n.numpy(), [[[0, -1, 0]]] * 2, atol=1e-5)


@pytest.mark.parametrize('camera', ['front', 'tilted'])
def test_scene_camera_matches_jax(camera):
    """A fixed camera with xyaxes in the worldbody and a trackcom one on a
    body: segmentation, depth, RGB with the reward tint, at 33 x 41."""
    m, jm = models('shapes')
    data = port_data(m, np.zeros((1, 0)))
    cam = raycast.Camera(m, 33, 41, camera)
    ours, ref = both(cam, jraycast.Camera(jm, 33, 41, camera), data,
                     reward=np.array([0.7], np.float32))
    hold_pixels(camera, ours, ref)
    if camera == 'front':
        # the ball's centre pixel is 2.5 m away (JAX's test)
        np.testing.assert_allclose(ours[1][0, 16, 20], 2.5, atol=1e-3)


def test_movable_camera_matches_jax():
    m, jm = models('shapes')
    data = port_data(m, np.zeros((1, 0)))
    kw = dict(lookat=(0, 0, 1), distance=3.0, azimuth=60.0, elevation=-20.0)
    cam = raycast.MovableCamera(m, 24, 32, **kw)
    jcam = jraycast.MovableCamera(jm, 24, 32, **kw)
    hold_pixels('movable', *both(cam, jcam, data))
    cam.set_pose((0, 0, 1), 2.0, 0.0, -90.0)
    jcam.set_pose((0, 0, 1), 2.0, 0.0, -90.0)
    ours, ref = both(cam, jcam, data)
    hold_pixels('from above', ours, ref)
    assert cam.get_pose()[1:] == jcam.get_pose()[1:]
    np.testing.assert_allclose(ours[1][0, 12, 16], 1.5, atol=0.02)
    assert ours[0][0, 12, 16] == m.names['geom']['ball']


@pytest.mark.parametrize('domain,camera', [('walker', 'side'),
                                           ('walker', 'back'),
                                           ('cartpole', 'fixed'),
                                           ('cheetah', 'side')])
def test_suite_cameras_match_jax(domain, camera):
    """trackcom (walker, cheetah) and fixed (cartpole) cameras on 3
    random configurations at 32 x 40, rewards 0, 0.5, 1 tinting."""
    m, jm = models(domain)
    data = port_data(m, random_qpos(m, 3, 1))
    ours, ref = both(raycast.Camera(m, 32, 40, camera),
                     jraycast.Camera(jm, 32, 40, camera), data,
                     reward=np.array([0.0, 0.5, 1.0], np.float32))
    hold_pixels(f'{domain} {camera}', ours, ref)
    assert (ours[0] >= 0).sum() > 10


@pytest.mark.parametrize('plane', ['xz', 'xy'])
def test_rasterizer_matches_jax(plane):
    """The orthographic rasterizer on 3 walker configurations (following
    the first moving body, then a fixed centre) at 40 x 48: within
    1e-5, and the same uint8 frames."""
    m, jm = models('walker')
    data = port_data(m, random_qpos(m, 3, 2))
    for center in (None, (0.3, 0.9)):
        img = render.render(m, data, 40, 48, center=center, plane=plane)
        jimg = jax_frames(lambda d: jrender.render(
            jm, d, 40, 48, center=center, plane=plane), data)
        np.testing.assert_allclose(img.numpy(), jimg, atol=1e-5)
        np.testing.assert_array_equal(render.render_to_uint8(img),
                                      jrender.render_to_uint8(jimg))


class SimpleEnv:
    """What JAX's wrappers read of an env when they are built."""

    def __init__(self, model=None, spec=None):
        self.model = model
        self._spec = spec

    def action_spec(self):
        return self._spec


@pytest.mark.parametrize('domain', ['walker', 'cartpole', 'acrobot'])
def test_pixel_wrapper_matches_jax(domain):
    """PixelWrapper at 32 x 32 through reset and one step of 4 envs:
    camera 0 (walker's trackcom 'side', cartpole's fixed) or, for the
    camera-less acrobot, the rasterizer; held to JAX's PixelWrapper's
    renderer on the same configurations."""
    task = {'walker': 'walk', 'cartpole': 'swingup',
            'acrobot': 'swingup'}[domain]
    env = suite.load(domain, task, device='cpu')
    px = wrappers.PixelWrapper(env, height=32, width=32)
    state, ts = px.reset(4, torch.Generator().manual_seed(3))
    assert list(ts.observation) == ['pixels']
    zeros = torch.zeros((4, env.model.nu))
    state, ts = px.step(state, zeros)
    pixels = ts.observation['pixels'].numpy()
    assert pixels.shape == (4, 32, 32, 3) and ts.reward.shape == (4,)
    _, ts2 = wrappers.PixelWrapper(env, pixels_only=False, height=32,
                                   width=32).step(state, zeros)
    assert 'pixels' in ts2.observation and len(ts2.observation) > 1
    _, ts3, _ = px.step_with_data(state, zeros)
    assert ts3.observation['pixels'].shape == (4, 32, 32, 3)
    jm = models(domain)[1]
    jpx = jwrappers.PixelWrapper(SimpleEnv(jm), height=32, width=32)
    data = port_data(env.model, state.physics.qpos)
    if jm.ncam:
        cam = px._camera
        ours = (cam.render(data, segmentation=True).numpy(),
                cam.render(data, depth=True).numpy(), pixels)
        ref = (jax_frames(lambda d: jpx._camera.render(
            d, segmentation=True), data),
            jax_frames(lambda d: jpx._camera.render(d, depth=True), data),
            jax_frames(jpx._camera.render, data))
        hold_pixels(domain, ours, ref)
    else:
        assert px._camera is None and jpx._camera is None
        ref = jax_frames(lambda d: jrender.render(jm, d, 32, 32, plane='xz',
                                                  extent=2.0), data)
        np.testing.assert_allclose(pixels, ref, atol=1e-5)


def test_record_rollout_frames_match_jax(tmp_path, monkeypatch):
    """One cartpole rollout of 10 steps: the replayed qpos trajectory is
    the rollout's own, its 10 frames are JAX's camera-0 frames of the
    same trajectory (JAX's record_rollout rendering: camera 0, then
    clip(255 x) as uint8), and the GIF holds them (3-3-2 palette) as 10
    images."""
    w = envs.load('cartpole', 'swingup', device='cpu')
    seen = {}
    real = type(w).render_frames

    def spy(self, qposes, *a, **k):
        seen['qposes'] = qposes.clone()
        seen['frames'] = real(self, qposes, *a, **k)
        return seen['frames']

    monkeypatch.setattr(type(w), 'render_frames', spy)
    rolls = w.record_rollout(torch.Generator().manual_seed(5), 10,
                             mp4path=str(tmp_path / 'roll'), height=32,
                             width=40)
    nq = w.env.model.nq
    np.testing.assert_array_equal(seen['qposes'].numpy(),
                                  rolls.states[0, 1:, :nq].numpy())
    jm = models('cartpole')[1]
    cam = jraycast.Camera(jm, height=32, width=40, camera_id=0)
    data = port_data(w.env.model, seen['qposes'])
    jframes = jax_frames(lambda d: jnp.clip(cam.render(d) * 255.0, 0, 255)
                         .astype(jnp.uint8), data)
    frames = seen['frames']
    assert frames.shape == jframes.shape == (10, 32, 40, 3)
    level = np.abs(frames.astype(int) - jframes.astype(int)).max(-1)
    assert (level > 1).sum() <= PIX_SHARE * level.size
    gif = str(tmp_path / 'roll.gif')
    assert recorder.gif_frame_count(gif) == 10
    from PIL import Image
    im = Image.open(gif)
    assert im.n_frames == 10
    for k in range(10):
        im.seek(k)
        np.testing.assert_array_equal(
            np.asarray(im.convert('RGB')),
            recorder._PALETTE[recorder.quantize(frames[k])])


def test_record_rollout_through_the_rasterizer(tmp_path):
    """A camera-less model (swimmer) records through the rasterizer: 4
    frames of the 'xy' plane, as many as the steps."""
    w = envs.load('swimmer', 'swimmer6', device='cpu')
    assert w.env.model.ncam == 0
    w.record_rollout(torch.Generator().manual_seed(0), 4,
                     mp4path=str(tmp_path / 's.gif'), height=24, width=24,
                     plane='xy')
    assert recorder.gif_frame_count(str(tmp_path / 's.gif')) == 4


def test_recorder_writes_gif_and_npz(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (4, 40, 30, 3), dtype=np.uint8)
    with recorder.Recorder(fps=10) as rec:
        for f in frames:
            rec.record_frame(f)
    assert rec.make_movie(str(tmp_path / 'a')) == str(tmp_path / 'a.gif')
    assert recorder.gif_frame_count(str(tmp_path / 'a.gif')) == 4
    out = rec.save_frames(str(tmp_path / 'a'))
    np.testing.assert_array_equal(np.load(out)['frames'], frames)
    assert recorder.Recorder().make_movie(str(tmp_path / 'none')) == ''


def test_action_noise_by_its_distribution():
    """scale 0.05 of cartpole's [-1, 1] ctrlrange: JAX's std (0.1); mean
    0 within 4 standard errors and std within 3% over 20,000 draws;
    clipped to the range; the same generator state, the same noise."""
    env = suite.load('cartpole', 'swingup', device='cpu')
    w = wrappers.ActionNoiseWrapper(env, scale=0.05)
    jw = jwrappers.ActionNoiseWrapper(SimpleEnv(spec=env.action_spec()),
                                      scale=0.05)
    np.testing.assert_allclose(w._std.numpy(), np.asarray(jw._std),
                               rtol=1e-6)
    N = 20000
    a = torch.zeros((N, env.model.nu))
    eps = w.noisy(a, torch.Generator().manual_seed(0)) - a
    assert abs(float(eps.mean())) < 4 * 0.1 / np.sqrt(N)
    assert abs(float(eps.std()) / 0.1 - 1) < 0.03
    edge = w.noisy(torch.ones((N, env.model.nu)),
                   torch.Generator().manual_seed(1))
    assert float(edge.max()) <= 1.0
    assert float((edge < 1).float().mean()) > 0.4
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    assert torch.equal(w.noisy(a[:8], g1), w.noisy(a[:8], g2))
    state, _ = w.reset(4, torch.Generator().manual_seed(0))
    state, ts = w.step(state, torch.zeros((4, 1)),
                       torch.Generator().manual_seed(2))
    assert ts.reward.shape == (4,)
    state, ts, _ = w.step_with_data(state, torch.zeros((4, 1)))
    assert bool(torch.isfinite(state.physics.qpos).all())


def test_camera_refuses_a_model_without_cameras():
    m = models('acrobot')[0]
    assert m.ncam == 0
    with pytest.raises(ValueError, match='no cameras'):
        raycast.Camera(m)
