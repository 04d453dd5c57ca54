"""The viewer, the explorer and ``visualize_reward``, port against the
JAX package.

* ``Task.visualize_reward``'s bool check and ``Environment.render``'s
  reward tint: the port's render of cartpole balance states (the tint
  from the task's reward) against JAX's render of the same kinematics
  with the reward JAX's task computes there, under the pixel rule of
  ``chip_smoke.hold_pixels`` (JAX's renderers read the port's kinematics,
  run eagerly, as in tests/test_torch_render.py);
* ``viewer.launch``: rewards, frames, the GIF (its frame count) and the
  HTML player, whose embedded PNGs (this package's own encoder) decode
  with PIL to the rendered frames exactly; the frames against JAX's
  renderer on the episode's recorded states;
* ``LiveSession`` steps, policy switch, perturbation and reset; ``serve``
  through a real loopback socket;
* ``explore.main``: the name surface against JAX's, a bad name, an episode
  with action noise and the reward tint.
"""

import base64
import io
import json
import os
import re
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from mujoco_mbrl_tpu.suite import explore as jexplore
from mujoco_mbrl_tpu.utils import raycast as jraycast
from mujoco_mbrl_tpu_torch import suite, viewer
from mujoco_mbrl_tpu_torch.physics import model as M
from mujoco_mbrl_tpu_torch.suite import explore
from mujoco_mbrl_tpu_torch.utils import recorder
from chip_smoke import hold_pixels
from test_torch_render import jax_frames, jax_view, port_data
from test_torch_builder import jax_parse
from mujoco_mbrl_tpu_torch.suite import cartpole

H, W = 24, 32


def cartpole_env():
    return suite.load('cartpole', 'balance', device='cpu')


def test_visualize_reward_property_validation():
    env = cartpole_env()
    assert env.task.visualize_reward is False
    env.task.visualize_reward = True
    assert env.task.visualize_reward is True
    with pytest.raises(ValueError):
        env.task.visualize_reward = 1
    assert suite.load('cartpole', 'balance',
                      device='cpu').task.visualize_reward is False


def test_render_tint_matches_jax():
    """Four balance states near and far from upright: the port's tinted
    render against JAX's camera on the same kinematics with the reward
    JAX's cartpole task gives them; the tint changes body pixels only."""
    from mujoco_mbrl_tpu import suite as jsuite
    env = cartpole_env()
    jenv = jsuite.load('cartpole', 'balance')
    rng = np.random.default_rng(0)
    qpos = np.zeros((4, 2), np.float32)
    qpos[:, 0] = rng.uniform(-0.5, 0.5, 4)
    qpos[:, 1] = [0.0, 0.3, 1.2, 2.5]
    state = env.start(M.make_state(env.model, qpos=torch.tensor(qpos)))[0]
    plain = env.render(state, height=H, width=W)
    seg = env.render(state, height=H, width=W, segmentation=True)
    depth = env.render(state, height=H, width=W, depth=True)
    env.task.visualize_reward = True
    tinted = env.render(state, height=H, width=W)
    body = seg >= 0
    assert float((plain - tinted).abs()[body].max()) > 0.05
    assert torch.equal(plain[~body], tinted[~body])
    # JAX: its task's reward and its camera, both on the port's
    # kinematics (the cartpole's are held to JAX's in its own tests)
    data = port_data(env.model, qpos)
    jm = jenv.model
    jrew = [float(jenv.task.get_reward(
        jm, SimpleNamespace(qpos=jnp.asarray(qpos[b]), qvel=jnp.zeros(2)),
        SimpleNamespace(ximat=jnp.asarray(data.ximat[b].numpy())),
        jnp.zeros(jm.nu))) for b in range(4)]
    ours_rew = env.task.get_reward(env.model, state.physics, data,
                                   torch.zeros(4, 1))
    np.testing.assert_allclose(ours_rew.numpy(), jrew, rtol=1e-5, atol=1e-6)
    jcam = jraycast.Camera(jax_parse(cartpole._make_model_xml(1)), H, W, 0)
    ref = (jax_frames(lambda d: jcam.render(d, segmentation=True), data),
           jax_frames(lambda d: jcam.render(d, depth=True), data),
           np.stack([np.asarray(jcam.render(jax_view(data, b),
                                            reward=jrew[b]))
                     for b in range(4)]))
    held = hold_pixels('cartpole tint', (seg.numpy(), depth.numpy(),
                                         tinted.numpy()), ref)
    assert held['decided_share'] <= 0.005


def _decode_html_frames(path):
    doc = open(path).read()
    srcs = re.findall(r'data:image/png;base64,([A-Za-z0-9+/=]+)', doc)
    return doc, [np.asarray(Image.open(io.BytesIO(base64.b64decode(s))))
                 for s in srcs]


def test_launch_renders_writes_gif_and_html(tmp_path):
    env = cartpole_env()
    out = viewer.launch(env, policy=viewer.zero_policy(env), steps=12,
                        path=str(tmp_path / 'roll'), height=H, width=W,
                        frame_stride=4, verbose=False, html=True,
                        device='cpu')
    assert out['rewards'].shape == (12,)
    assert np.isfinite(out['rewards']).all()
    assert out['frames'].shape == (3, H, W, 3)
    assert out['frames'].dtype == np.uint8 and out['frames'].max() > 0
    assert os.path.exists(out['gif'])
    assert recorder.gif_frame_count(out['gif']) == 3
    doc, frames = _decode_html_frames(out['html'])
    assert doc.count('data:image/png;base64,') == 3
    for control_id in ('play', 'scrub', 'speed', 'stepf', 'stepb'):
        assert f"'{control_id}'" in doc
    assert '__FRAMES__' not in doc
    for f, g in zip(frames, out['frames']):
        np.testing.assert_array_equal(f, g)


def test_launch_frames_match_jax_renderer():
    """The frames of a random-policy pendulum episode against JAX's camera
    on the episode's own states (the port's kinematics), as uint8 frames
    within one level but for 0.5% of the pixels."""
    env = suite.load('pendulum', 'swingup', device='cpu')
    states = []
    real_step = env.step

    def recording_step(state, action):
        state, ts = real_step(state, action)
        states.append(state.physics.qpos.clone())
        return state, ts

    env.step = recording_step
    out = viewer.launch(env, steps=8, height=H, width=W, frame_stride=4,
                        verbose=False, device='cpu')
    assert out['gif'] == '' and out['frames'].shape == (2, H, W, 3)
    qpos = torch.cat([states[0], states[4]]).numpy()
    data = port_data(env.model, qpos)
    from mujoco_mbrl_tpu.suite import pendulum as jpendulum
    jcam = jraycast.Camera(jax_parse(jpendulum._XML), H, W, 0)
    ref = jax_frames(lambda d: jcam.render(d), data)
    ref8 = np.clip(ref * 255.0, 0, 255).astype(np.uint8)
    off = np.abs(out['frames'].astype(int) - ref8.astype(int)) > 1
    assert off.any(-1).mean() <= 0.005


def test_png_bytes_decode():
    frame = np.random.default_rng(0).integers(0, 256, (5, 7, 3),
                                              dtype=np.uint8)
    png = viewer.png_bytes(frame)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  frame)


def test_live_session_policy_loop():
    env = cartpole_env()
    s = viewer.LiveSession(env, height=H, width=W, device='cpu')
    snap = s.reset()
    assert snap['t'] == 0 and 'frame' in snap
    img = Image.open(io.BytesIO(base64.b64decode(snap['frame'])))
    assert img.size == (W, H)
    s.step()
    r2 = s.step('zero')
    assert r2['t'] == 2
    assert np.isfinite(r2['reward']) and np.isfinite(r2['ret'])
    before = float(s.state.physics.qvel[0, 0])
    s.perturb(dof=0, dv=3.0)
    assert abs(float(s.state.physics.qvel[0, 0]) - before - 3.0) < 1e-5
    snap = s.reset()
    assert snap['t'] == 0 and snap['ret'] == 0.0


def test_live_viewer_http_round_trip():
    env = suite.load('pendulum', 'swingup', device='cpu')
    httpd = viewer.make_server(env, port=0, height=H, width=W, device='cpu')
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        page = urllib.request.urlopen(f'http://127.0.0.1:{port}/',
                                      timeout=30).read().decode()
        assert 'live viewer' in page and "'kick'" in page

        def post(path, body=None):
            req = urllib.request.Request(
                f'http://127.0.0.1:{port}{path}',
                data=json.dumps(body or {}).encode(),
                headers={'Content-Type': 'application/json'})
            return json.loads(urllib.request.urlopen(req, timeout=30).read())

        assert post('/reset')['t'] == 0
        snap = post('/step', {'policy': 'random'})
        assert snap['t'] == 1 and 'frame' in snap
        assert post('/perturb', {'dof': 0, 'dv': 1.0})['t'] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_explore_name_surface_matches_jax():
    names = explore._all_names()
    assert names == jexplore._all_names()
    assert 'cartpole.swingup' in names and len(names) >= 40


def test_explore_runs_an_episode(tmp_path):
    with pytest.raises(SystemExit):
        explore.main(['nope.nope', '--device', 'cpu'])
    out = explore.main(['pendulum.swingup', '--steps', '5',
                        '--action_noise', '0.2', '--visualize_reward',
                        '--out', str(tmp_path / 'ep'), '--device', 'cpu'])
    assert out['rewards'].shape == (5,)
    assert os.path.exists(out['gif']) and os.path.exists(out['html'])


def test_viewer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    env = cartpole_env()
    with pytest.raises(RuntimeError, match='CUDA'):
        viewer.launch(env, steps=2, verbose=False)
    with pytest.raises(RuntimeError, match='CUDA'):
        explore.main(['pendulum.swingup', '--steps', '2'])
