"""CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these skip on a machine without an NVIDIA card. On the
card run ``python -m pytest tests/test_torch_kernels.py -m cuda``; the
full-size checks are in chip_smoke.py.
"""

import pytest
import torch

from mujoco_mbrl_tpu_torch import ops
from mujoco_mbrl_tpu_torch.models import MLPDynamics
from mujoco_mbrl_tpu_torch.ops import apgd_solve, cem_rollout

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _problem(dev, B, nr, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn((B, nr + 4, nr), generator=g, device=dev)
    A = torch.einsum('bij,bik->bjk', G, G) / (nr + 4) + 0.05 * torch.eye(
        nr, device=dev)
    s = torch.diagonal(A, dim1=1, dim2=2).rsqrt()
    Ad = (A * s[:, :, None] * s[:, None, :]).contiguous()
    vec = lambda: torch.randn((B, nr), generator=g, device=dev)
    act = (torch.rand((B, nr), generator=g, device=dev) > 0.15).float()
    mu = torch.zeros(nr, device=dev)
    mu[[5, 8, 11, 14]] = torch.tensor([0.6, 0.8, 1.0, 0.5], device=dev)
    bounds = torch.zeros(nr, device=dev)
    bounds[3] = 0.7
    return Ad, vec(), 0.3 * vec(), vec(), act, mu, bounds


@pytest.mark.parametrize('cold', [True, False])
@pytest.mark.parametrize('eq_rows', [(), (4,)])
def test_apgd_kernel_matches_plain(dev, cold, eq_rows):
    args = _problem(dev, 37, 17, seed=int(cold))
    kw = dict(nonneg=(0, 1, 2), box_rows=(3,), con0=(5, 8, 11, 14),
              iterations=40, cold=cold, eq_rows=eq_rows)
    before = ops.launch_counts['apgd_solve']
    f, v = apgd_solve.apgd_iterate_batched(*args, **kw)
    assert ops.launch_counts['apgd_solve'] == before + 1
    f_p, v_p = apgd_solve.apgd_iterate_plain(*args, **kw)
    torch.testing.assert_close(f, f_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(v, v_p, rtol=2e-4, atol=2e-4)


def test_apgd_kernel_rejects_float64(dev):
    args = [a.double() for a in _problem(dev, 4, 17, seed=0)]
    with pytest.raises(ValueError):
        apgd_solve.apgd_iterate_batched(
            *args, nonneg=(0,), box_rows=(), con0=(), iterations=5,
            cold=True)


@pytest.mark.parametrize('sampler', ['triangular', 'normal'])
def test_sampler_kernel_matches_plain_cost(dev, sampler):
    B, K, H, sd, ad = 8, 101, 7, 24, 6
    params = MLPDynamics(sd, ad).init(torch.Generator().manual_seed(0),
                                      device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    s0 = torch.randn((B, sd), generator=g, device=dev)
    mean = 0.3 * torch.randn((B, H, ad), generator=g, device=dev)
    std = 0.2 + torch.rand((B, H, ad), generator=g, device=dev)
    goal, w = torch.zeros(sd, device=dev), torch.ones(sd, device=dev)
    costs, acts = cem_rollout.mlp_sample_rollout_costs(
        params, 3, s0, mean, std, goal, w, K, sampler=sampler)
    assert costs.shape == (B, K) and acts.shape == (B, H, ad, K)
    ref = cem_rollout.rollout_costs_of_actions(params, s0, acts, goal, w)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    assert float(acts.abs().max()) <= 1.0
