"""Rollout storage on the device: ring buffer, stats and samplers."""

from .replay import (ReplayBuffer, Rollouts, Stats, add_rollouts,
                     compute_stats, epoch_batches, gather_windows,
                     init_replay, normalize, num_transitions,
                     sample_transitions, unnormalize)

__all__ = ['ReplayBuffer', 'Rollouts', 'Stats', 'add_rollouts',
           'compute_stats', 'epoch_batches', 'gather_windows', 'init_replay',
           'normalize', 'num_transitions', 'sample_transitions',
           'unnormalize']
