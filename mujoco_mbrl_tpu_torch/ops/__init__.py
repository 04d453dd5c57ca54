"""Hand-written Hopper kernels with their plain PyTorch versions.

``launch_counts`` holds one integer per kernel (the CEM kernels' bf16
instantiations under their own ``*_bf16`` keys); each wrapper adds one
where it launches its kernel and nowhere else.
"""

launch_counts = {'apgd_solve': 0, 'apgd_factored': 0,
                 'apgd_dense_factors': 0,
                 'cem_sample_rollout': 0, 'cem_sample_rollout_ens': 0,
                 'cem_rollout_costs': 0, 'cem_sample_rollout_bf16': 0,
                 'cem_sample_rollout_ens_bf16': 0,
                 'cem_rollout_costs_bf16': 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# after launch_counts, which cem_rollout reads at import
from .cem_rollout import (mlp_rollout_costs,  # noqa: E402
                          mlp_rollout_costs_reference, mlp_rollout_costs_t,
                          mlp_sample_rollout_costs,
                          mlp_sample_rollout_costs_ensemble)

__all__ = ['launch_counts', 'reset_launch_counts', 'mlp_rollout_costs',
           'mlp_rollout_costs_reference', 'mlp_rollout_costs_t',
           'mlp_sample_rollout_costs', 'mlp_sample_rollout_costs_ensemble']
