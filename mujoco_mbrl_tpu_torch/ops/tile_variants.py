"""Time the MLP sampler kernel (#2) through variant builds of its source.

Run on a CUDA machine from the repository root:

    python -m mujoco_mbrl_tpu_torch.ops.tile_variants [hopper|manipulator]

It copies the package four times into ``_build/tile_variants/<shape>/``
(ignored by git), keeps ``csrc/cem_sample_rollout.cu`` and the headers in
each, and changes one thing per copy: none (the tree as it is), the
shape's sized tiles held to two blocks an SM (128 registers a thread, as
the other narrow exact tiles), the same tiles with the other loop bounds
(run-time ones where they are exact, and the other way round), or their
branch taken out of ``dispatch`` (the guarded instantiation). The shapes:
the hopper observation's exact (3, 7, 2) tiles (sd 15, ad 4; the
default) and the manipulator's featured state's (5, 7, 4) with run-time
loop bounds (sd 29, ad 5). The four build in parallel; then each times
the kernel at B 1024, K 1000, H 30, hidden 50 (random weights and states
from fixed seeds), holds its costs to the plain cost of its own actions
(rtol 1e-4) and prints the instantiation ``dispatch`` took, three timings
of 10 launches (CUDA events) and ptxas's registers and spills. Nothing
runs on import.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_OUT = os.path.join(_PKG, '_build', 'tile_variants')
# shape -> (sd, ad, its (ni, nso) tiles, their dispatch branch)
SHAPES = {
    'hopper': (15, 4, (3, 2), '  if (L.ni == 3 && L.nso == 2) return '
               'f.template run<3, 7, 2, true, true>();\n'),
    'manipulator': (29, 5, (5, 4), '  if (L.ni == 5) return f.template '
                    'run<5, 7, 4, false, true>();\n'),
}
_MIN_BLOCKS = 'smem && ni <= 4 && !(ni == 3 && nso == 2) ? kMinBlocks : 1'


def _two_blocks(csrc, shape):
    p = os.path.join(csrc, 'cem_mma.cuh')
    s = open(p).read()
    assert _MIN_BLOCKS in s, 'min_blocks changed'
    ni, nso = SHAPES[shape][2]
    open(p, 'w').write(s.replace(_MIN_BLOCKS, (
        f'smem && ((ni <= 4 && !(ni == 3 && nso == 2)) || (ni == {ni} && '
        f'nso == {nso})) ? kMinBlocks : 1')))


def _guarded(csrc, shape):
    p = os.path.join(csrc, 'cem_mma.cuh')
    s = open(p).read()
    ni, nso = SHAPES[shape][2]
    sized = f'(L.ni == {ni} && L.nso == {nso}) ||'
    branch = SHAPES[shape][3]
    assert branch in s and sized in s
    open(p, 'w').write(s.replace(branch, '').replace(sized, ''))


def _other_loop_bounds(csrc, shape):
    """The shape's tiles with exact loop bounds where they are built with
    run-time ones (the manipulator's), or the other way round."""
    p = os.path.join(csrc, 'cem_mma.cuh')
    s = open(p).read()
    branch = SHAPES[shape][3]
    assert branch in s
    flip = (branch.replace('true, true>', 'false, true>')
            if 'true, true>' in branch
            else branch.replace('false, true>', 'true, true>'))
    open(p, 'w').write(s.replace(branch, flip))


VARIANTS = {'as_built': None, 'two_blocks_an_sm': _two_blocks,
            'other_loop_bounds': _other_loop_bounds, 'guarded': _guarded}

_RUN = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from mujoco_mbrl_tpu_torch.models import MLPDynamics
from mujoco_mbrl_tpu_torch.ops import _build, cem_rollout as C
dev = torch.device('cuda')
B, K, H, hid = 1024, 1000, 30, 50
sd, ad = int(sys.argv[3]), int(sys.argv[4])
params = MLPDynamics(sd, ad, hidden_units=hid).init(
    torch.Generator().manual_seed(1), device=dev)
g = torch.Generator(device=dev).manual_seed(26)
s0 = torch.randn((B, sd), generator=g, device=dev)
mean = (0.3 * torch.randn((B, H, ad), generator=g, device=dev)).clamp(-.9, .9)
std = 0.2 + torch.rand((B, H, ad), generator=g, device=dev)
goal = torch.zeros(sd, device=dev)
goal[1] = 1.0
w = torch.ones(sd, device=dev)
args = (params, 7, s0, mean, std, goal, w, K)
taken = C.sampler_instantiation(K, H, sd, ad, hid)
costs, acts = C.mlp_sample_rollout_costs(*args)
ref = C.rollout_costs_of_actions(params, s0, acts, goal, w)
torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
for _ in range(3):
    C.mlp_sample_rollout_costs(*args)
ms = []
for _ in range(3):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(10):
        C.mlp_sample_rollout_costs(*args)
    e1.record()
    torch.cuda.synchronize()
    ms.append(e0.elapsed_time(e1) / 10)
tag = 'ILi%dELi%dELi%dELb%dELb%dE' % tuple(int(x) for x in taken)
lines = _build.build_log('cem_sample_rollout').splitlines()
ptxas = [' | '.join(x.strip() for x in lines[i + 1:i + 3])
         for i, x in enumerate(lines) if 'Compiling entry' in x and tag in x]
print(f'{sys.argv[2]}: instantiation {taken}; ms per launch {ms}; '
      f'max|cost - plain| {float((costs - ref).abs().max()):.3e}; '
      f'ptxas {ptxas}', flush=True)
'''


def main(argv=None) -> int:
    shape = (argv if argv is not None else sys.argv[1:] or ['hopper'])[0]
    sd, ad = SHAPES[shape][:2]
    dirs = {}
    for name, patch in VARIANTS.items():
        root = os.path.join(_OUT, shape, name)
        shutil.rmtree(root, ignore_errors=True)
        pkg = os.path.join(root, 'mujoco_mbrl_tpu_torch')
        shutil.copytree(_PKG, pkg, ignore=shutil.ignore_patterns(
            '_build', '__pycache__'))
        csrc = os.path.join(pkg, 'csrc')
        for f in os.listdir(csrc):
            if f.endswith('.cu') and f != 'cem_sample_rollout.cu':
                os.unlink(os.path.join(csrc, f))
        if patch is not None:
            patch(csrc, shape)
        dirs[name] = root
    builds = [subprocess.Popen([
        sys.executable, '-c', 'import sys; sys.path.insert(0, sys.argv[1]); '
        'from mujoco_mbrl_tpu_torch.ops import _build; _build.build_all()',
        root]) for root in dirs.values()]
    if any(p.wait() != 0 for p in builds):
        return 1
    subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                    '--format=csv,noheader'], check=False)
    for _ in range(2):
        for name, root in dirs.items():
            subprocess.run([sys.executable, '-c', _RUN, root, name,
                            str(sd), str(ad)], check=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
