"""Control suite environments explorer (port of
mujoco_mbrl_tpu/suite/explore.py, the reference's ``suite/explore.py:
30-84``): list every registered ``domain.task``, prompt for one, and
drive it under a random policy with the ``--timeout``, ``--action_noise``
and ``--visualize_reward`` flags, either

  * through the offline renderer (default): one episode rendered to a
    GIF and an interactive HTML player (``viewer.launch``), or
  * through the live policy-in-the-loop HTTP viewer (``--serve``).

It runs on ``cuda`` unless ``--device cpu`` is given. Run::

    python -m mujoco_mbrl_tpu_torch.suite.explore            # list + prompt
    python -m mujoco_mbrl_tpu_torch.suite.explore cartpole.swingup \\
        --visualize_reward --action_noise 0.3 --out /tmp/ep
    python -m mujoco_mbrl_tpu_torch.suite.explore walker.walk --serve
"""

from __future__ import annotations

import argparse


def _all_names():
    from . import all_tasks
    return ['.'.join(dt) for dt in all_tasks()]


def prompt_environment_name(prompt, values):
    """Interactive task picker (reference explore.py:47-54)."""
    environment_name = None
    while not environment_name:
        environment_name = input(prompt)
        if environment_name not in values:
            print(f'"{environment_name}" is not a valid environment name.')
            environment_name = None
    return environment_name


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('environment_name', nargs='?', default=None,
                        help="'domain.task' pair; prompted if omitted")
    parser.add_argument('--timeout', action=argparse.BooleanOptionalAction,
                        default=True,
                        help='whether episodes have a time limit')
    parser.add_argument('--visualize_reward', action='store_true',
                        help='tint geom colors by the current reward')
    parser.add_argument('--action_noise', type=float, default=0.0,
                        help='Gaussian action noise as a fraction of the '
                             'action range')
    parser.add_argument('--steps', type=int, default=200)
    parser.add_argument('--out', default='explore_episode',
                        help='output path stem for the GIF/HTML episode')
    parser.add_argument('--serve', action='store_true',
                        help='launch the live HTTP viewer instead of '
                             'rendering an offline episode')
    parser.add_argument('--port', type=int, default=8000)
    parser.add_argument('--device', default=None,
                        help="torch device (default cuda; 'cpu' for the "
                             'plain versions)')
    args = parser.parse_args(argv)

    names = _all_names()
    environment_name = args.environment_name
    if environment_name is None:
        print('\n  '.join(['Available environments:'] + names))
        environment_name = prompt_environment_name(
            'Please select an environment name: ', names)
    if environment_name not in names:
        parser.error(f'unknown environment {environment_name!r}; '
                     f'run with no argument to list them')
    domain_name, task_name = environment_name.split('.')

    from . import load
    task_kwargs = {}
    if not args.timeout:
        task_kwargs['time_limit'] = float('inf')
    env = load(domain_name, task_name, task_kwargs=task_kwargs,
               device=args.device)
    env.task.visualize_reward = bool(args.visualize_reward)
    if args.action_noise > 0:
        from .wrappers import ActionNoiseWrapper
        env = ActionNoiseWrapper(env, scale=args.action_noise)

    from .. import viewer
    if args.serve:
        viewer.serve(env, port=args.port, device=args.device)
        return None
    return viewer.launch(env, steps=args.steps, path=args.out + '.gif',
                         html=True, device=args.device)


if __name__ == '__main__':
    main()
