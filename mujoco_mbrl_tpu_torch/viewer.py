"""Offline rollout viewer and live policy server (`viewer.launch(env,
policy)` analogue).

Port of mujoco_mbrl_tpu/viewer.py. The reference ships an interactive
GLFW application (``dm_control/viewer/application.py:183``); on a
headless host the same surface is an *offline* viewer: one episode is
stepped on the env's device, the recorded trajectory is rendered as one
batch of frames through ``utils.raycast.Camera``, and the result is
written as an animated GIF (``utils.recorder``, its own GIF89a writer)
and an interactive HTML player. :class:`LiveSession` and :func:`serve`
run the policy in the loop behind a loopback HTTP server.

PNG frames are encoded here with ``zlib`` and ``struct`` (the JAX module
writes them through PIL, which the card machine lacks).

    from mujoco_mbrl_tpu_torch import suite, viewer
    env = suite.load('cartpole', 'swingup')
    viewer.launch(env, steps=100, path='/tmp/roll')

`policy` is ``(observation_dict, generator) -> action (B, nu)``; None
draws uniform random actions within the action spec (the reference
viewer's passive default is ``policy=viewer.zero_policy(env)``).
``launch``, ``LiveSession`` and ``serve`` run on ``cuda`` unless the
caller passes ``device='cpu'``; the env must live on that device.
"""

from __future__ import annotations

import base64
import dataclasses
import struct
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from .device import resolve_device
from .physics import engine
from .physics import model as M
from .utils.raycast import Camera
from .utils.recorder import Recorder


def _batch_of(obs) -> int:
    return next(iter(obs.values())).shape[0] if obs else 1


def zero_policy(env) -> Callable:
    nu = env.action_spec().shape[0]

    def policy(obs, generator):
        return torch.zeros((_batch_of(obs), nu), dtype=env.model.dtype,
                           device=env.model.device)

    return policy


def random_policy(env) -> Callable:
    spec = env.action_spec()
    lo = np.where(np.isfinite(spec.minimum), spec.minimum, -1.0)
    hi = np.where(np.isfinite(spec.maximum), spec.maximum, 1.0)
    dev, dt = env.model.device, env.model.dtype
    lo_t = torch.as_tensor(lo, dtype=dt, device=dev)
    span = torch.as_tensor(hi - lo, dtype=dt, device=dev)

    def policy(obs, generator):
        u = torch.rand((_batch_of(obs),) + spec.shape, generator=generator,
                       device=generator.device).to(dev, dt)
        return lo_t + span * u

    return policy


def png_bytes(frame: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 RGB frame as PNG: IHDR (8-bit truecolour), one
    zlib IDAT of the rows (filter type 0), IEND."""
    frame = np.ascontiguousarray(frame, np.uint8)
    h, w = frame.shape[:2]

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack('>I', len(body)) + tag + body
                + struct.pack('>I', zlib.crc32(tag + body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           frame.reshape(h, w * 3)], 1)
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
            + chunk(b'IEND', b''))


def _png_data_url(frame: np.ndarray) -> str:
    return 'data:image/png;base64,' + base64.b64encode(
        png_bytes(frame)).decode()


def export_html(frames: np.ndarray, rewards: np.ndarray, path: str,
                fps: int = 20, frame_stride: int = 1,
                title: str = 'rollout') -> str:
    """Write a self-contained HTML player for a rendered rollout: frames
    embedded as base64 PNGs, play / pause, single-step, a scrub slider,
    speed control and the per-frame reward readout (the headless
    counterpart of the reference's GLFW window, viewer/gui/glfw_gui.py)."""
    if not path.endswith('.html'):
        path = path + '.html'
    srcs = [_png_data_url(f) for f in frames]
    rew = [float(r) for r in np.asarray(rewards).reshape(len(rewards), -1)
           .mean(-1)]
    html = f"""<!DOCTYPE html>
<html><head><meta charset='utf-8'><title>{title}</title><style>
body{{font-family:monospace;background:#111;color:#ddd;margin:1em}}
img{{image-rendering:pixelated;width:{frames.shape[2] * 3}px;
     border:1px solid #444}}
button,input{{font-family:monospace}}
#bar{{margin:0.5em 0}}
</style></head><body>
<h3>{title}</h3>
<img id='view'/>
<div id='bar'>
<button id='play'>&#9654;</button>
<button id='stepb'>&#8676;</button>
<button id='stepf'>&#8677;</button>
<input id='scrub' type='range' min='0' max='{len(srcs) - 1}' value='0'
 style='width:{frames.shape[2] * 3 - 180}px'/>
<select id='speed'><option>0.25</option><option>0.5</option>
<option selected>1</option><option>2</option><option>4</option></select>x
</div>
<div id='info'></div>
<script>
const F=__FRAMES__;const R={rew};
const stride={frame_stride};const fps={fps};
let i=0,playing=false,timer=null;
const img=document.getElementById('view'),
 scrub=document.getElementById('scrub'),
 info=document.getElementById('info'),
 play=document.getElementById('play');
function show(k){{i=(k+F.length)%F.length;img.src=F[i];scrub.value=i;
 const s=i*stride;
 info.textContent='frame '+i+'/'+(F.length-1)+'  step '+s+
  '  reward '+(R[s]!==undefined?R[s].toFixed(4):'-');}}
function tick(){{if(playing){{show(i+1);}}}}
function setspeed(){{if(timer)clearInterval(timer);
 timer=setInterval(tick,1000/(fps*parseFloat(
  document.getElementById('speed').value)));}}
play.onclick=()=>{{playing=!playing;
 play.innerHTML=playing?'&#9646;&#9646;':'&#9654;';}};
document.getElementById('stepf').onclick=()=>{{playing=false;show(i+1);}};
document.getElementById('stepb').onclick=()=>{{playing=false;show(i-1);}};
scrub.oninput=()=>{{playing=false;show(parseInt(scrub.value));}};
document.getElementById('speed').onchange=setspeed;
setspeed();show(0);
</script></body></html>
"""
    # the frame array goes in by substitution, outside the f-string
    html = html.replace('__FRAMES__',
                        '[' + ','.join(f'"{s}"' for s in srcs) + ']')
    with open(path, 'w') as fh:
        fh.write(html)
    return path


def _env_device(env, device):
    dev = resolve_device(device)
    if env.model.device.type != dev.type:
        raise ValueError(f'the env lives on {env.model.device}, the viewer '
                         f'was asked to run on {dev}')
    return dev


def _repeat_envs(tree, n):
    """Every tensor of a one-env tree repeated to n envs."""
    if isinstance(tree, torch.Tensor):
        return tree.expand((n,) + tuple(tree.shape[1:]))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_repeat_envs(x, n) for x in tree)
    if isinstance(tree, dict):
        return {k: _repeat_envs(v, n) for k, v in tree.items()}
    return tree


def _inner_state(state):
    """The control.EnvState of a state (a BufferedEnvironment's dict)."""
    return state['inner'] if isinstance(state, dict) else state


def render_states(env, phys: M.State, params, camera, rewards=None):
    """RGB frames (F, H, W, 3) uint8 of F physics states sharing one
    env's params: their forward to the velocity stage, then one batched
    render through `camera`; `rewards` (F,) tint the body geoms where the
    task's ``visualize_reward`` is set."""
    F = phys.qpos.shape[0]
    m = env._model_with(_repeat_envs(params, F))
    data = engine.forward(m, phys, torch.zeros(
        (F, m.nu), dtype=phys.qpos.dtype, device=phys.qpos.device),
        acc_stage=False)
    viz = bool(getattr(env.task, 'visualize_reward', False))
    rgb = camera.render(data, reward=rewards if viz else None)
    return (torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)
            .cpu().numpy())


def launch(env, policy: Optional[Callable] = None, steps: int = 200,
           path: Optional[str] = None, camera_id=0, height: int = 120,
           width: int = 160, frame_stride: int = 2, fps: int = 20,
           seed: int = 0, verbose: bool = True, html: bool = False,
           device=None) -> dict:
    """Run one episode under `policy` and render it.

    Returns {'rewards': (steps,) or (steps, k) numpy, 'frames': (F, H, W,
    3) uint8, 'gif': written path or '', 'html': written path or ''}.
    The episode steps on the device (one env); the states at every
    `frame_stride`-th step are then rendered as one batch of F frames.
    ``html=True`` also writes the interactive player (:func:`export_html`).
    """
    dev = _env_device(env, device)
    policy = policy or random_policy(env)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state, ts = env.reset(1, gen)
    pol_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    idx = list(range(0, steps, frame_stride))
    kept, rewards = [], []
    for i in range(steps):
        action = policy(ts.observation, pol_gen)
        state, ts = env.step(state, action)
        rewards.append(ts.reward[0])
        if i % frame_stride == 0:
            kept.append(_inner_state(state).physics)
    rewards = torch.stack(rewards).cpu().numpy()

    frames = np.zeros((0, height, width, 3), np.uint8)
    gif = html_path = ''
    if env.model.ncam > 0:
        inner = _inner_state(state)
        traj = M.State(qpos=torch.cat([p.qpos for p in kept]),
                       qvel=torch.cat([p.qvel for p in kept]),
                       time=torch.cat([p.time for p in kept]))
        cam = Camera(env.model, height=height, width=width,
                     camera_id=camera_id)
        r = (torch.as_tensor(rewards[idx], device=dev)
             if rewards.ndim == 1 else None)
        frames = render_states(env, traj, inner.params, cam, r)
        if path:
            rec = Recorder(fps=fps)
            for f in frames:
                rec.record_frame(f)
            gif = rec.make_movie(path)
        if html and path:
            html_path = export_html(frames, rewards, path, fps=fps,
                                    frame_stride=frame_stride,
                                    title=getattr(env, 'name', 'rollout'))
    elif verbose:
        print('# model has no cameras; skipping frames '
              '(rewards still returned)')

    if verbose:
        # compact reward strip, one glyph per ~2% of the episode
        glyphs = ' .:-=+*#%@'
        per_step = rewards.reshape(len(rewards), -1).mean(-1)
        n = max(len(per_step) // 50, 1)
        chunks = [per_step[i:i + n].mean()
                  for i in range(0, len(per_step), n)]
        strip = ''.join(glyphs[min(max(int(c * (len(glyphs) - 1) + 0.5), 0),
                                   len(glyphs) - 1)] for c in chunks)
        print(f'# reward [{strip}] total={per_step.sum():.2f}'
              + (f' gif={gif}' if gif else ''))

    return {'rewards': rewards, 'frames': frames, 'gif': gif,
            'html': html_path}


# ---------------------------------------------------------------------------
# live viewer: policy-in-the-loop HTTP server
# ---------------------------------------------------------------------------

_LIVE_HTML = """<!DOCTYPE html>
<html><head><meta charset='utf-8'><title>live viewer</title><style>
body{font-family:monospace;background:#111;color:#ddd;margin:1em}
img{image-rendering:pixelated;width:480px;border:1px solid #444}
button,select,input{font-family:monospace}
#bar{margin:0.5em 0}
</style></head><body>
<h3>live viewer</h3>
<img id='view'/>
<div id='bar'>
<button id='play'>&#9654;</button>
<button id='stepf'>step</button>
<button id='reset'>reset</button>
<select id='pol'><option selected>policy</option><option>zero</option>
<option>random</option></select>
speed <select id='speed'><option>0.25</option><option>0.5</option>
<option selected>1</option><option>2</option></select>x
</div>
<div id='bar'>perturb dof <input id='dof' type='number' value='0'
 style='width:4em'/> dv <input id='dv' type='number' value='2.0'
 step='0.5' style='width:4em'/>
<button id='kick'>kick</button>
(keys: space=play, r=reset, k=kick)</div>
<div id='info'></div>
<script>
let playing=false,busy=false,t=0;
const img=document.getElementById('view'),
 info=document.getElementById('info'),
 play=document.getElementById('play');
async function post(u,b){const r=await fetch(u,{method:'POST',
 headers:{'Content-Type':'application/json'},
 body:JSON.stringify(b||{})});return r.json();}
function show(d){if(d.frame)img.src='data:image/png;base64,'+d.frame;
 t=d.t;info.textContent='t='+d.t+'  reward='+d.reward.toFixed(4)+
  '  return='+d.ret.toFixed(2)+(d.last?'  [EPISODE END]':'');}
async function step(){if(busy)return;busy=true;
 show(await post('/step',{policy:document.getElementById('pol').value}));
 busy=false;}
async function loop(){if(playing){await step();}
 setTimeout(loop,50/parseFloat(document.getElementById('speed').value));}
play.onclick=()=>{playing=!playing;
 play.innerHTML=playing?'&#9646;&#9646;':'&#9654;';};
document.getElementById('stepf').onclick=()=>{playing=false;step();};
document.getElementById('reset').onclick=async()=>{
 show(await post('/reset'));};
document.getElementById('kick').onclick=async()=>{
 show(await post('/perturb',{dof:parseInt(
   document.getElementById('dof').value),
  dv:parseFloat(document.getElementById('dv').value)}));};
document.body.onkeydown=(e)=>{if(e.key===' ')play.onclick();
 if(e.key==='r')document.getElementById('reset').onclick();
 if(e.key==='k')document.getElementById('kick').onclick();};
loop();post('/reset').then(show);
</script></body></html>
"""


class LiveSession:
    """Policy-in-the-loop stepping and perturbation, transport-agnostic
    (the reference viewer's runtime loop, viewer/application.py:183: step
    / pause / reset and a body perturbation, here a velocity impulse on
    one dof). One env on the device; :func:`serve` exposes the session to
    a browser, tests drive it directly."""

    def __init__(self, env, policy=None, height=120, width=160,
                 camera_id=0, seed=0, device=None):
        self.env = env
        self.device = _env_device(env, device)
        self.policy = policy or random_policy(env)
        self._zero = zero_policy(env)
        self._random = random_policy(env)
        self._seed = seed
        self._episode = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._cam = (Camera(env.model, height=height, width=width,
                            camera_id=camera_id)
                     if env.model.ncam > 0 else None)
        self._start()

    def _start(self):
        g = torch.Generator(device=self.device).manual_seed(
            self._seed + 7 * self._episode)
        self.state, self._ts = self.env.reset(1, g)
        self.t = 0
        self.ret = 0.0
        self.last_reward = 0.0
        self.last_flag = False

    # -- commands ----------------------------------------------------------
    def reset(self):
        self._episode += 1
        self._start()
        return self.snapshot()

    def step(self, policy_name: str = 'policy'):
        pol = {'policy': self.policy, 'zero': self._zero,
               'random': self._random}.get(policy_name, self.policy)
        action = pol(self._ts.observation, self._gen)
        self.state, self._ts = self.env.step(self.state, action)
        self.t += 1
        self.last_reward = float(self._ts.reward.float().mean())
        self.ret += self.last_reward
        self.last_flag = bool(_inner_state(self.state).last[0])
        return self.snapshot()

    def perturb(self, dof: int = 0, dv: float = 2.0):
        """Velocity impulse on one dof (the reference's mouse
        perturbation)."""
        dof = int(np.clip(dof, 0, self.env.model.nv - 1))
        inner = _inner_state(self.state)
        qvel = inner.physics.qvel.clone()
        qvel[:, dof] += dv
        inner = dataclasses.replace(inner, physics=inner.physics.replace(
            qvel=qvel))
        if isinstance(self.state, dict):
            self.state = dict(self.state, inner=inner)
        else:
            self.state = inner
        return self.snapshot()

    def snapshot(self):
        out = {'t': self.t, 'reward': self.last_reward, 'ret': self.ret,
               'last': self.last_flag}
        if self._cam is not None:
            inner = _inner_state(self.state)
            frame = render_states(
                self.env, inner.physics, inner.params, self._cam,
                torch.full((1,), self.last_reward, device=self.device))[0]
            out['frame'] = base64.b64encode(png_bytes(frame)).decode()
        return out


def make_server(env, policy=None, host: str = '127.0.0.1', port: int = 8000,
                **session_kw):
    """An ``http.server.HTTPServer`` over a :class:`LiveSession`: GET /
    the page, POST /reset, /step ({"policy": ...}) and /perturb ({"dof",
    "dv"}) a JSON snapshot. Port 0 takes a free one
    (``server.server_address``)."""
    import http.server
    import json as _json

    session = LiveSession(env, policy, **session_kw)

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, body: bytes, kind: str):
            self.send_response(200)
            self.send_header('Content-Type', kind)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._reply(_LIVE_HTML.encode(), 'text/html')

        def do_POST(self):
            n = int(self.headers.get('Content-Length', 0))
            req = _json.loads(self.rfile.read(n) or b'{}')
            if self.path == '/reset':
                out = session.reset()
            elif self.path == '/perturb':
                out = session.perturb(int(req.get('dof', 0)),
                                      float(req.get('dv', 2.0)))
            else:
                out = session.step(str(req.get('policy', 'policy')))
            self._reply(_json.dumps(out).encode(), 'application/json')

    httpd = http.server.HTTPServer((host, port), Handler)
    httpd.session = session
    return httpd


def serve(env, policy=None, host: str = '127.0.0.1', port: int = 8000,
          **session_kw):
    """Serve the live viewer until Ctrl-C: open http://host:port in a
    browser. The simulation steps on demand (one control step a /step
    POST), so the policy runs in the loop."""
    httpd = make_server(env, policy, host, port, **session_kw)
    print(f'# live viewer at http://{host}:{httpd.server_address[1]} '
          '(Ctrl-C to stop)')
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def _main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description='live policy viewer')
    ap.add_argument('--env', default='cartpole_swingup')
    ap.add_argument('--port', type=int, default=8000)
    ap.add_argument('--policy', default='random', choices=('random', 'zero'))
    ap.add_argument('--device', default=None,
                    help="torch device (default cuda; 'cpu' for the plain "
                         'versions)')
    args = ap.parse_args(argv)
    from . import suite
    domain, task = args.env.rsplit('_', 1)
    env = suite.load(domain, task, device=args.device)
    pol = zero_policy(env) if args.policy == 'zero' else None
    serve(env, pol, port=args.port, device=args.device)


if __name__ == '__main__':
    _main()
