#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and torch version,
   builds every kernel in mujoco_mbrl_tpu_torch/csrc (nvcc, in parallel);
2. holds the dense APGD kernel against its plain PyTorch version on
   synthetic problems (non-negative, box, cone and equality rows; cold and
   warm; 17, 62 and 96 rows, one case per instantiation of the kernel) and
   on inputs captured from the port's own walker_walk solves at 1024 envs,
   at reset and in contact (rtol = atol = 2e-4 on f and v; see hold_apgd
   for the envs whose step size rounding decides); times it (device time,
   from a CUDA graph of the calls; the wrapper call's time beside it) with
   the largest iteration count among the envs and the time per dependent
   step (kernel time / (power steps + that count)), and the latency of one
   APGD iteration from two iteration caps;
3. holds the CEM sampler kernel against the plain rollout cost of the
   kernel's own actions at 1024 envs x 1000 candidates x horizon 30
   (rtol 1e-4) for the triangular, normal and spline4 samplers, and checks
   the action range, the antithetic identity, the moments of the sampled
   noise and, for spline4, the lerp-and-renormalise identity between knots
   and the knots' moments; the sampler kernels (3xTF32 on the tensor
   cores) are timed beside two bounds: the tensor-core bound they are held
   to (3 x FLOP at 494.7 TFLOP/s) and the FP32 bound (FLOP at 66.9
   TFLOP/s);
4. holds the ensemble TS-infinity sampler kernel against the plain cost of
   its own actions by member k % n at walker_ens shapes (1024 envs x 1000
   candidates x horizon 30, 5 members; rtol 1e-4), with the same action
   checks, a small case whose antithetic pairs straddle members, and the
   one-member case against the single-MLP kernel;
5. drives each walker path with every launch count set to 0 just before
   and read just after (exact counts of every kernel):
   a. slice 1's control step, ``bench.build_bench('walker_walk', 1024,
      1000, 30, 3, steps)``, checks the physics of a control step against
      the plain (CPU) step and profiles the device time by kernel;
   b. the walker_ens control step, the same with ``model_kind='ensemble'``;
   c. the agent loop at full width: GoalStateAgent on walker_walk with a
      5-member ensemble, CEM 1000 x 30 x 3, 1024 seed and 1024 policy
      rollouts (cut to 10 steps), one fit of 5 epochs;
   d. the experiment CLI on the single MLP with the spline4 sampler and 5
      policy rollouts;
6. cheetah_run, each path with exact launch counts:
   a. the control step, ``build_bench('cheetah_run', 1024, 1000, 30, 3,
      steps)`` (3 sampler + 1 factored APGD launch per control step), its
      physics against the CPU step, a profile;
   b. the factored APGD kernel against its plain version on solves
      captured from cheetah at 1024 envs (at reset and after 20 control
      steps of random actions, cold and warm; one env per warp), on a
      synthetic batch for the warp path's guarded instantiation (120
      rows, nv 16) and on a humanoid-shaped synthetic batch (303 rows, nv
      27, 512 envs; one block per env), with the same tolerance and
      rounding allowance as the dense kernel; prints the path of each
      case, times each as the dense kernel and the latency of one APGD
      iteration from two iteration caps;
   c. the rollout-cost kernel (given actions, the samplers' tensor-core
      body) against its plain version (rtol 1e-4) at 1024 x 1000
      candidates, H 30, sd 17; at the walker widths (sd 24) with N not a
      multiple of 16; and at a shape only the guarded instantiation takes;
      timed beside both bounds with its gate margin; and the sampler at
      the cheetah shapes;
   d. the control step through cem_batched's non-fused branch (3
      rollout-cost launches, no sampler launch, per control step);
   e. ``bench.full_loop_bench`` at CONFIGS['cheetah1024'] (seed
      collection, then collect -> replay add -> fit 50 epochs), then the
      rollout-cost kernel on the fitted MLP with the replay's normalizers
      folded in (candidates decided by rounding left out, at most 0.1%);
   f. the experiment CLI on cheetah_run (single MLP, 5 policy rollouts);
7. the contact-free domains, each path with exact launch counts:
   a. the dense APGD kernel's one-row-a-lane instantiation (31 or 30
      lanes of a warp without a row) on solves captured from reacher_easy
      (its wrist-limit row, the wrist at +-2.75..2.80 rad moving outward)
      and point_mass_easy (two slide-limit rows pushing out), cold and
      warm, and on an all-inactive reacher batch, held and timed as in 2;
   b. the ``reacher256`` control step (``bench.config('reacher256')``:
      256 envs, CEM 500 x 20 x 3 through cem_batched's model / cost scan,
      the route the JAX bench takes below obs_dim + act_dim = 16; one
      physics substep, so 1 APGD and 0 sampler launches a step), its
      device-busy share, and the sampler (#2) at that shape through the
      exact (1, 7, 1) instantiation, held to its plain version and timed;
      and #2 at a layout only the guarded (16, 16, 16) instantiation takes
      (sd 40 + ad 6, hidden 64);
   c. ``GoalStateAgent.train()`` on reacher_easy with the single MLP
      (hidden 50), 1024 seed + 1024 policy rollouts of 10 control steps
      (the Reacher wrapper's 0.04 s control step: 2 substeps, 2 APGD
      launches a step), CEM 1000 x 30 x 3 (3 sampler launches a step),
      then #2 on the fitted params (as for the walker agent);
   d. the experiment CLI on reacher_easy and on point_mass_easy (single
      MLP, default sampler, 5 policy rollouts; 5 sampler launches a
      control step, 2 or 1 APGD launches a step), then the sampler (#3's
      route) on each CLI's fitted params at its B = 5 shape, as for the
      walker CLI;
   e. pendulum_swingup: the card's step against the CPU's (no constraint
      row, so no launch);
8. the humanoid (free root, sphere contacts, condim-1 rows; 303
   constraint rows over nv 27), each path with exact launch counts:
   a. the ``humanoid`` preset's control step (``bench.config('humanoid')``:
      humanoid_walk, 512 envs, CEM 1000 x 30 x 3 through the sampler's
      (11, 7, 9) instantiation; 5 physics substeps, so 3 sampler +
      5 factored APGD launches a step, each on #7's block path), its
      physics against the CPU step, a profile (device-busy share), plan
      and physics ms;
   b. #7's block path on solves captured from humanoid_walk at 512 envs
      (at the reset states and after 20 control steps of random actions,
      landed; cold and warm), held and timed as in 6b, with the latency of
      one APGD iteration; the synthetic humanoid-shaped batch of 6b stays;
   c. #2 at the preset's shape (sd 67, ad 21), held to the plain cost of
      its actions (rtol 1e-4) and timed beside both bounds, with the
      instantiation dispatch took (run-time loop bounds over the sized
      (11, 7, 9) tiles, weights in shared memory), as each sampler case
      of 7 and 8 prints and checks its own;
   d. the experiment CLI on humanoid_walk (single MLP over the 60-dim
      featured state, 5 policy rollouts of 10 steps; 5 sampler + 5
      factored APGD launches a control step), then the sampler on its
      fitted params at B = 5 (the (11, 7, 8) instantiation);
   ptxas registers and spills of the two humanoid instantiations and of
   the guarded one go into the kernel line;
9. cartpole, hopper, swimmer and acrobot (RK4, box geoms, sites, touch,
   the fluid force), each path with exact launch counts:
   a. the ``cartpole`` preset's control step (``bench.config('cartpole')``:
      cartpole_swingup, 128 envs, CEM 1000 x 30 x 3 through the model /
      cost scan, no sampler launch; one RK4 step a control step, so 4
      one-row #1 launches), its physics against the CPU step, a profile;
   b. the experiment CLI on cartpole_swingup (5 + 1 observation dims: the
      (1, 7, 1) sampler, held on its fitted params at B = 5);
   c. #1's one-row-a-lane instantiation on solves captured from cartpole
      (1 row, eight cold RK4 stage solves) and swimmer6 (5 joint-limit
      rows, cold and warm) at 1024 envs, held and timed as in 2;
   d. hopper_hop's control step at the JAX bench's defaults
      (``build_bench('hopper_hop', 1024, 1000, 30, 3, steps)``: #2 at the
      15-dim observation and 4 actions, the sized (3, 7, 2) tiles; 4
      substeps and the observation's forward, each an 88-row solve on
      #1's block path), its physics against the CPU step, a profile;
   e. #1's block path (apgd_block_kernel) on solves captured from
      hopper_hop at 1024 envs (at the reset states and after 20 control
      steps of random actions, fallen and in contact; cold and warm) under
      the one APGD rule, timed as in 2 with the latency of one APGD
      iteration; and #2 at the hopper bench's shape;
   f. the experiment CLI on hopper_hop (17-dim featured state) and on
      swimmer_swimmer6 (18-dim; 15 substeps a control step), each with #3
      on its fitted params at B = 5 (the (3, 7, 3) tiles);
   g. acrobot_swingup: the card's step against the CPU's (no constraint
      row, so no launch);
   ptxas registers and spills of the (3, 7, 2) instantiation and of #1's
   block kernel go into the kernel line;
10. the per-env planners, the other models and RewardAgent (slice 11),
   each path with exact launch counts, none of #2-#7 on them:
   a. (23) the JAX CLI's defaults on walker_walk (GoalStateAgent, random
      shooting, MLP; 1000 candidates, horizon 20, 5 rollouts planned per
      env in lockstep), its phases timed and each control step split into
      plan and physics; 10 #1 launches a control step;
   b. (24) per-env CEM through CEMPlanner.plan at the walker's width
      (1000 x 5 iterations, H 20, B 5) on (a)'s fitted model, after
      checking that get_action fails on the walker as JAX's does;
   c. (25) reacher_easy's CLI with --planner grad, and with --planner
      ilqr, which fails where JAX's does; the iterations each env ran and
      iLQR's accepted step sizes on the grad CLI's fitted model;
   d. (26) point_mass_easy's CLI with --agent rw --model rw --planner
      cem (RewardAgent) and its get_action;
   e. (27) walker_walk's CLI with --planner cem over --model lin and over
      --model ens with 998 candidates: the model / cost scan, no sampler;
   f. (28) each per-env planner on the card against the CPU on the same
      fed inputs at B = 5 (random shooting, CEM, gradient descent, iLQR;
      the decisions rounding decides named and counted, at most 1%), and
      an RNNDynamics fit and rollout on the card against the CPU;
11. the bf16 mode of the tensor-core CEM kernels (slice 12):
   a. (29) each bf16 instantiation against its plain bf16 version
      (``compute_dtype=torch.bfloat16``) on the same actions: #2 at
      northstar (triangular, normal) and at the humanoid preset's shape,
      #3 spline4 at northstar, #5 at walker_ens, #6 at the CLI's ensemble
      layout, #4 at the cheetah's, and #2 at a shape only the guarded bf16
      instantiation takes; every candidate within rtol = atol = 1e-3 and
      all but at most 1% within 1e-5 (the rest, decided by accumulation
      order, named), JAX's bf16 selfcheck tolerance against the plain
      float32 rollout, bf16 actions in range with the antithetic identity;
      each timed beside its bf16 bound (FLOP at 989.4 TFLOP/s) and the
      float32 kernel on the same inputs;
   b. (30) ``bench.main`` in-process: ``--config northstar`` at JAX's
      defaults, with ``--dtype bf16`` (and bf16 spline4), every other
      preset cut to 3 steps and 1 repeat (walker_ens also in bf16;
      cheetah1024 at 5 epochs), ``--phases`` and ``--agent-loop`` on the
      walker at the northstar width; each with exact launch counts, its
      JSON line printed and checked (value finite and positive, every
      mfu_* share in (0, 100]);
12. finger, ball_in_cup and lqr (slice 13: elliptic cones, friction-loss
   rows, a spatial-tendon limit row, early termination, autoreset), each
   path through ``suite.load`` at 1024 envs with exact launch counts:
   a. (31) finger spin and turn_hard from a card reset, random actions:
      2 substeps and the observation's forward (the touch sensors read
      its solve), so 3 #1 launches a control step, each checked to carry
      39 rows (a box row with per-env bounds, two hinge limits, 12 cone
      triples) and the 400-iteration cap; the card's step against the
      CPU's; then #1 on finger solves captured at the reset states and in
      contact (fingertip pressed into the spinner, a tenth past a hinge
      limit), cold and warm, and on the contact ones with each env's
      bound scaled by its own factor, held and timed as in 9e;
   b. (32) ball_in_cup catch the same way: 10 substeps, 10 21-row
      launches a control step (the string's limit row, 5 sphere-capsule
      points of 4 facets), card vs CPU, and #1 on solves captured at the
      reset states and with the ball in the cup or the string taut;
   c. (33) lqr_6_2 (seed 0): card vs CPU, then the analytic gain of
      ``suite.lqr_solver`` drives states of norm sqrt(2) 1e-6 until the
      envs terminate (LAST, discount 0) and ``autoreset_step`` restarts
      them (FIRST); no launch;
13. manipulator, stacker and fish (slice 14: tendon-equality rows, box
   contacts, per-env body poses, #1's global path), each path through
   ``suite.load`` or ``envs.load`` at 1024 envs with exact launch counts:
   a. (34) manipulator bring_ball from a card reset, random actions: 10
      substeps and the observation's forward (touch reads its solve), so
      11 #1 launches a control step, each checked to take the global path
      (Ad in device memory) with 452 rows (the equality row, 7 limits,
      148 cone triples) and the 60 cap; the card's step against the CPU's
      on the first 100 envs; then the global path on solves captured at
      the reset states and at drawn poses in contact, cold and warm, held
      under the one APGD rule and timed beside the bound of the active
      submatrices it reads (and of every row of Ad), with the ns of one
      APGD iteration;
   b. (35) GoalStateAgent on the Manipulator wrapper: an MLP over the
      29-dim featured state, CEM 1000 x 30 x 3 through #2's (5, 7, 4)
      instantiation (run-time loop bounds), 1024 + 1024 rollouts of 5
      control steps, one fit (exact #1 and #2 counts); #2 at the loop's
      shapes on a random MLP, held at rtol 1e-4 and timed, and on the
      fitted params with the replay's normalizers folded in, reported
      (the near-constant touch dims make those costs ill-conditioned in
      float32);
   c. (36) stacker stack_4 (977 rows) and manipulator insert_peg (833),
      as in (a), with the box pair kernels on the card against the CPU
      on the reset's 8 x 1024 draws, and the global path on captured
      stack_4 solves;
   d. (37) fish swim: control steps and the card's step against the
      CPU's (no constraint row, no launch);
   e. the other four tasks (manipulator bring_peg and insert_ball,
      stacker stack_2, fish upright): a card reset and a control step
      each, with exact launch counts;
   ptxas of ``apgd_global_kernel`` and the (5, 7, 4) instantiation go
   into the kernel line;
14. quadruped (slice 15: filtered actuators, ellipsoid and heightfield
   contacts, condim-6 pyramids, the IMU and force-torque sensors), each
   path through ``suite.load`` at 1024 envs from a card reset with exact
   launch counts:
   a. (38) walk, random actions: 4 substeps and the observation's
      forward (the sensors read its solve), so 5 #1 launches a control
      step, each checked to take the global path with 240 rows (4
      equality rows, then non-negative rows only) and the 60 cap; the
      activations seen to move; force_torque nonzero wherever a toe's
      contact carries force; the card's step against the CPU's on the
      first 128 envs in qpos, qvel, act and reward; then the global path
      on solves captured at the reset states and once the robots have
      landed, held under the one APGD rule (a converged env that differs
      along a pyramid's flat facet direction counts as decided by
      rounding: ``hold_apgd(..., energy_valley=True)``) and timed as in
      13a;
   b. (39) escape, as (a) at 356 rows on each env's own terrain, with the
      rangefinder in [-1, 1] and the 1024 terrains against the law of
      the bowl times the resized uniform bumps;
   c. (40) fetch, as (a) at 914 rows (the ball's condim-6 pyramids of 10
      facets; Ad 3.4 GB at 1024 envs), its landed states with the ball
      resting on the floor;
   d. (41) run: one control step from a card reset (5 launches);
15. humanoid_cmu (slice 16: contact excludes, 4,352 rows over 62 dofs,
   #1's dense iterate on factors), each path through ``suite.load`` at
   1024 envs from a card reset (the first of 10 draws without
   penetration, else the last) with exact launch counts:
   a. (42) stand, random actions: 10 substeps, so 10 launches of
      ``apgd_dense_factors_kernel`` a control step, each checked to take
      J~ (1024, 4,352, 62), every row non-negative, the 60 cap; the peak
      device memory of a control step; the card's step of states dropped
      onto the floor against the CPU's on their first 8 envs (qpos, qvel,
      reward); then the kernel against its plain version on solves
      captured at the reset states, landed, and fallen (the landed
      states after 20 control steps of random actions), cold and
      warm, held under the one APGD rule with ``energy_valley`` (Ad
      formed only for the envs that differ) and timed beside the bound of
      what the run's data needs (the active rows of J~ and of rhs, Rs and
      f0, M^-1, `active` and a warm v0 read, f and v written; 4 k nv + 2
      nv^2 FLOP a matvec and the row sums of the stale envs), with the
      active-row counts and the ns of one APGD iteration;
   b. (43) run: one control step from a card reset (10 launches);
16. the tools around the engine (slice 17), each with exact launch
   counts:
   a. (44) the builder: walker's XML through ``builder.RootElement.
      from_xml_string(...).compile(device='cuda')`` equals the
      ``mjcf.parse`` Model field by field, and one control step of 1024
      envs from the same state on each is bitwise equal in qpos, qvel and
      reward (10 #1 launches on the built model's); ``named`` and
      ``schema.bind`` read the batched card state as index arithmetic
      does; two pendulums attached as ``a/`` and ``b/`` run 1024 envs
      for 200 steps (one #1 launch a step: their masses can touch),
      finite, b's gear twice a's;
   b. (45) IK: ``qpos_from_site_pose`` places swimmer6's head site at
      targets drawn from random poses, 100 steps x 1024 envs, every env
      within 2e-3, card vs CPU within 1e-4 in qpos on 8 envs (no launch);
   c. (46) pixels: ``PixelWrapper`` at 64 x 64 through camera 0 on
      walker walk (trackcom) and cartpole swingup (fixed), reset and one
      control step of 1024 envs (10 / 4 #1 launches), the render time of
      the batch and its share of the step, the step's peak device
      memory, the camera's segmentation, depth and RGB card vs CPU on 8
      envs (at most 0.5% of pixels decided by rounding, on an edge of the
      image; the rest within 1e-4); a ``MovableCamera`` the same way;
      ``record_rollout`` of one walker env for 10 steps into a temp dir,
      a GIF of 10 frames (200 #1 launches: the rollout and its replay);
   d. (47) distributed on one card: ``distributed_init`` with NCCL at
      world size 1 (no fallback to gloo); inside ``profiling.trace``,
      ``sharded_collect`` of cartpole swingup (1024 x 5, 20 #1 launches)
      equal to the unsharded collect, and ``dp_train_step`` of an
      MLPDynamics within 1e-6 of the one-process step; the trace file
      written;
17. the model-building stack and the viewer (slice 18), each with exact
   launch counts:
   a. (48) composer + observation: ``RunThroughCorridor(PlanarWalker)``
      with a median pipeline (delay 2, buffer 4) and an Additive(Normal)
      corruptor at 1024 envs, reset and 6 control steps (234 rows over nv
      9: the factored regime, 5 #7 block-path launches a step), card vs
      CPU on 256 envs, the median card vs CPU bit for bit on the card's
      raw sequence, the noise by its mean and std;
   b. (49) props: 3 Primitive spheres dropped onto a Floor of 1024 envs
      into a PositionDetector zone, 25 control steps (24 rows, #1's warp
      path, 4 a step), detections card vs CPU on 256 envs;
   c. (50) ``GoToTarget(CMUHumanoid)`` on the floor, 1024 envs, one
      control step (4,352 rows, 5 launches of #1's dense iterate on
      factors), its peak device memory, card vs CPU on 8 envs;
   d. (51) ``soccer.load(team_size=2)`` on a ``RandomizedPitch``, 1024
      envs, reset and 3 control steps (716 rows, #1's global path, 5 a
      step), card vs CPU on 256 envs; a goal in every env, LAST with
      discount 0 and rewards [+1, +1, -1, -1], then ``autoreset_step``
      FIRST with (B, 4) zero rewards;
   e. (52) ``viewer.launch`` on walker walk (50 steps, GIF and HTML, its
      frames rendered as one batch, 8 of them card vs CPU under the pixel
      rule), 5 ``LiveSession`` steps and a perturbation, one ``serve``
      round trip on 127.0.0.1, ``explore.main`` on cartpole swingup with
      the reward tint;
18. the last physics branches (slice 19), each with exact launch counts
   and card vs CPU:
   a. (53) walker walk with ``opt.solver = 'pgs'`` at 1024 envs, reset
      and 2 control steps (10 PGS solves a step in plain PyTorch, #1
      launched 0 times), the ms of one PGS solve, and at states settled
      on the floor the total normal force of PGS within 2% of APGD's; a
      ``LinearDynamics`` ensemble's ``forward_ts`` at 1024 x 1000 rows;
   b. (54) ``BALL_CHAIN_XML``: ball joints and a velocity servo (its
      sensor and contact pair dropped), 1024 envs randomized, 25 steps
      (one #1 launch each, 28 rows on the warp path), the quaternions'
      norms;
   c. (55) cheetah run with ``frictionloss='.1'`` in its joint class,
      1024 envs, 3 control steps (6 + 146 rows over nv 9, #7's warp path
      with per-env bounds, 1 a step), #7 against its plain twin on
      captured solves and on a humanoid solve with the same default at
      512 envs (21 + 303 rows, the block path), per-env bounds timed
      beside shared ones;
   d. (56) quadruped fetch with ``cone='elliptic'``, 1024 envs, 3 control
      steps (830 rows: 3 a contact, the ball's condim-6 pairs too; #1's
      global path, 5 a step), #1 against its plain twin on captured
      solves;
19. prints one ``{"kernels": [...]}`` line (one entry per TPU kernel, one
   per bf16 mode of #2-#6, and entries for #1's global path, with the
   quadruped's cases, #1's dense iterate on factors and #2's (5, 7, 4)
   instantiation; #7's per-env bounds under its own entry), a
   ``{"paths": ...}`` line with the cheetah, contact-free, humanoid,
   slice-10, slice-11, bench, slice-13, slice-14, slice-15, slice-16,
   slice-17, slice-18 and slice-19 paths' times, the card line, and last
   ``{"ok": true, "device": {...}}``.

Every card-vs-CPU step runs the card at the path's whole batch and the
CPU on its first CPU_CHECK_ENVS = 256 envs at most (the plain CPU step
is the slow side), which are compared; ``[clock]`` lines give the
elapsed time at each slice's start.

The H100 peaks of the bounds come from the port's bench.py, whose mfu_*
shares use the same ones.

Any failed check raises, so the process exits non-zero. It also exits
non-zero without a result when no CUDA card is present or when the
package is missing. Imports nothing of JAX.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

B, K, H, ITERS, STEPS = 1024, 1000, 30, 3, 3
# the H100 SXM data-sheet peaks, set by main() from the port's bench.py
# (PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES), which
# its mfu_* shares use too
PEAK_BF16_FLOPS = PEAK_TF32_FLOPS = PEAK_FP32_FLOPS = PEAK_BYTES = None


T_START = time.perf_counter()


def clock(label) -> None:
    """The script's elapsed time at the start of a slice's paths."""
    print(f'[clock] {label}: {time.perf_counter() - T_START:.1f} s since '
          'the start', flush=True)


def check(ok: bool, detail) -> None:
    """Raise when a check fails (also under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(f'chip_smoke check failed: {detail}')


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float):
    t_b, t_o = n_bytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS
    return max(t_b, t_o) * 1e3, ('bytes' if t_b >= t_o else 'operations')


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph
    and the graph replayed between CUDA events, so the host's work per
    call (the wrapper's checks, its allocations, the ctypes launch) is
    left out; for kernels whose device time is below that host work."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def rhs_act_of(args):
    """The rhs and active rows of a case's args: the factored iterate's
    (J~, M^-1, Rs, diag_s, rhs, f0, v0, active, mu, bounds) or the dense
    one's (Ad, rhs, f0, v0, active, mu, bounds)."""
    return (args[4], args[7]) if len(args) == 10 else (args[1], args[4])


def hold_apgd(torch, label, run_k, run_p, dense_Ad, cases,
              joint_force=None, energy_valley=False, rhs_act=rhs_act_of):
    """Each case's kernel (run_k) against its plain version (run_p) at
    rtol = atol = 2e-4 on f and v; returns (largest difference, envs
    decided by rounding). ``dense_Ad(args)`` gives the cases' Ad for the
    report of the envs that differ. A kernel that also returns its
    iteration counts has an env at the cap where either version is.
    ``joint_force(args, f)`` (the factored regime's J~' f) admits, as
    decided by rounding, a converged env whose f differs while its dual
    objective (to 1e-6 relative) and its joint-space constraint force
    (rtol = atol = 2e-4 of its largest entry) agree. ``energy_valley``
    does the same for a dense solve, whose J is not at hand, in Ad's
    energy norm: the objectives agree to 1e-6 and (f_k - f_p)' Ad (f_k -
    f_p) <= (2e-4)^2 (1 + f_p' Ad f_p), i.e. the two differ along a
    direction J' nearly annihilates (a pyramid's four facets span three
    directions, so their rows leave a flat valley held up by R alone).
    ``rhs_act(args)`` gives a case's rhs and active rows."""
    worst, rounding_envs = 0.0, 0
    for tag, args, kw in cases:
        Bs = args[4].shape[0]
        out = run_k(*args, **kw)
        f_k, v_k = out[:2]
        f_p, v_p, its = run_p(*args, **kw, return_iterations=True)
        torch.cuda.synchronize()
        # Every env that both versions converged in must agree. An env that
        # runs to the iteration cap ends wherever its step size L took it,
        # and L can be decided by rounding: with unit-diagonal (Jacobi)
        # scaling the flat start is an exact eigenvector of a 2-row active
        # block, so the direction the power iteration leaves it in, or a
        # borderline staleness test, depends on summation order (plain
        # float32 vs float64 differ in the same way on the CPU). Such envs
        # may differ, in at most 1% of the batch.
        close = lambda a, b: torch.isclose(a, b, rtol=2e-4,
                                           atol=2e-4).all(1)
        f_bad, v_bad = ~close(f_k, f_p), ~close(v_k, v_p)
        at_cap = its == kw['iterations']
        its_k = out[2] if len(out) == 3 else its
        excused = at_cap | (its_k == kw['iterations'])
        odd = f_bad | v_bad
        n_odd = int(odd.sum())
        if n_odd:
            Ad = dense_Ad(args)[odd].double()
            ev = torch.linalg.eigvalsh(Ad)[:, -2:].flip(1)
            quad = lambda v: (v[odd].double() * (Ad @ v[odd].double()[
                ..., None])[..., 0]).sum(1)
            # the dual objective 1/2 f'Ad f - f'rhs of each answer
            rhs = rhs_act(args)[0][odd].double()
            phi = lambda f: 0.5 * quad(f) - (f[odd].double() * rhs).sum(1)
            phi_k, phi_p = phi(f_k), phi(f_p)
            flat = torch.zeros_like(odd)
            if energy_valley:
                dfk = (f_k - f_p)[odd].double()
                quad_d = (dfk * (Ad @ dfk[..., None])[..., 0]).sum(1)
                flat[odd] = (((phi_k - phi_p).abs() <= 1e-6 * phi_p.abs())
                             & (quad_d <= 4e-8 * (1.0 + quad(f_p))))
            if joint_force is not None:
                # A dual with far more rows than dofs (cheetah: 146 over 9)
                # is strictly convex only through the small Rs, so its
                # optimum lies in a flat valley: rounding moves f along it
                # without moving the objective or the force in joint space
                jf_k = joint_force(args, f_k)[odd]
                jf_p = joint_force(args, f_p)[odd]
                scale = jf_p.abs().amax(1, keepdim=True)
                flat[odd] = (((phi_k - phi_p).abs()
                              <= 1e-6 * phi_p.abs())
                             & ((jf_k - jf_p).abs()
                                <= 2e-4 * (1.0 + scale)).all(1))
            act = rhs_act(args)[1]
            for i, e in enumerate(odd.nonzero()[:, 0].tolist()[:12]):
                why = (f'kernel {int(its_k[e])}, '
                       + ('at the cap' if bool(excused[e]) else
                          'converged in a flat valley' if bool(flat[e])
                          else 'converged'))
                extra = ''
                if joint_force is not None:
                    extra = (f', |J~\'(f_k - f_p)| '
                             f'{float((jf_k[i] - jf_p[i]).abs().max()):.3e}'
                             f' of |J~\'f_p| {float(scale[i]):.3e}')
                df = float((f_k[e] - f_p[e]).abs().max())
                print(f'  {label} {tag} env {e}: f differs {bool(f_bad[e])} '
                      f'(by {df:.3e}), v differs {bool(v_bad[e])}, '
                      f'{int(its[e])} iterations ({why}), '
                      f'{int(act[e].sum())} active rows, top eigenvalues '
                      f'{ev[i].tolist()}, Rayleigh kernel '
                      f'{float(quad(v_k)[i]):.6f} plain '
                      f'{float(quad(v_p)[i]):.6f}, objective kernel '
                      f'{float(phi_k[i]):.9e} plain {float(phi_p[i]):.9e}'
                      f'{extra}')
            excused = excused | flat
        check(not bool((f_bad & ~excused).any()), (
            label, tag, (f_bad & ~excused).nonzero()[:, 0].tolist()))
        check(n_odd <= Bs // 100, (label, tag, n_odd))
        rounding_envs += n_odd
        err = max(float((f_k - f_p)[~odd].abs().max()),
                  float((v_k - v_p)[~odd].abs().max()))
        worst = max(worst, err)
        print(f'{label} {tag} cold={kw["cold"]} eq={kw.get("eq_rows", ())}: '
              f'max|kernel - plain| = {err:.3e} over {Bs - n_odd} of {Bs} '
              f'envs; {int(at_cap.sum())} envs at the iteration cap; max|f| '
              f'{float(f_p.abs().max()):.3e}')
    return worst, rounding_envs


def time_apgd(torch, label, run_k, run_p, cases, matvec_flops, n_bytes,
              trace_bound, stale_flops=None):
    """Kernel and plain times of each case, beside the bound: the bytes
    ``n_bytes(args)`` once at the HBM rate, or the matvecs that this
    case's envs run, (25 cold | 10 warm + APGD iterations) x
    ``matvec_flops(args)`` per env, at the FP32 peak (warm solves add the
    staleness bound's pass, ``trace_bound`` or the row sums, or
    ``stale_flops(args)`` where the pass runs only in stale envs). The kernel
    time is its device time (``device_ms``); the wrapper call's time, host
    work included, stands beside it (``call_ms``). Also the largest APGD
    iteration count among the kernel's envs (the slowest env sets the
    launch's time) and the time per dependent step, kernel time / (power
    steps, 24 cold or 8 warm, + that count)."""
    times = {}
    for tag, args, kw in cases:
        tag = tag + ('-cold' if kw['cold'] else '-warm')
        Bs, nr = args[4].shape
        _, _, its = run_p(*args, **kw, return_iterations=True)
        max_its = int(run_k(*args, **kw, return_iterations=True)[2].max())
        steps = (24 if kw['cold'] else 8) + max_its
        n_mv = (25 if kw['cold'] else 10) + its.double()
        flops = float((matvec_flops(args) * n_mv).sum())
        if not kw['cold']:
            flops += (stale_flops(args) if stale_flops is not None else
                      Bs * (nr if trace_bound else 2.0 * nr * nr))
        bms, by = bound_ms(n_bytes(args), flops)
        k_ms = device_ms(lambda: run_k(*args, **kw), 20)
        c_ms = time_ms(lambda: run_k(*args, **kw), 20)
        p_ms = time_ms(lambda: run_p(*args, **kw), 3)
        times[tag] = dict(ms=k_ms, call_ms=c_ms, plain_ms=p_ms, bound_ms=bms,
                          bound_by=by,
                          mean_iterations=float(its.double().mean()),
                          max_iterations=max_its,
                          us_per_dependent_step=1e3 * k_ms / steps)
        print(f'{label} {tag} B={Bs} nr={nr}: kernel {k_ms:.4f} ms '
              f'(device; the wrapper call {c_ms:.4f} ms), '
              f'plain {p_ms:.3f} ms (reference only), bound {bms:.5f} ms '
              f'({by}), mean APGD iterations '
              f'{times[tag]["mean_iterations"]:.1f}, largest {max_its} '
              f'(kernel); {1e3 * k_ms / steps:.3f} us per dependent step '
              f'({steps} = {steps - max_its} power steps + {max_its})')
    return times


def apgd_phase(dev, torch, walker_cases):
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    g = torch.Generator(device=dev).manual_seed(0)
    nonneg, box, con0, nr = (0, 1, 2), (3,), (5, 8, 11, 14), 17

    def synthetic(Bs, nr=nr, con0=con0):
        G = torch.randn((Bs, nr + 4, nr), generator=g, device=dev)
        Am = torch.einsum('bij,bik->bjk', G, G) / (nr + 4) + 0.05 * torch.eye(
            nr, device=dev)
        s = 1.0 / torch.sqrt(torch.diagonal(Am, dim1=1, dim2=2))
        Ad = (Am * s[:, :, None] * s[:, None, :]).contiguous()
        rhs = torch.randn((Bs, nr), generator=g, device=dev)
        f0 = 0.3 * torch.randn((Bs, nr), generator=g, device=dev)
        v0 = torch.randn((Bs, nr), generator=g, device=dev)
        act = (torch.rand((Bs, nr), generator=g, device=dev) > 0.15).float()
        mu = torch.zeros(nr, device=dev)
        mu[list(con0)] = torch.tensor([0.6, 0.8, 1.0, 0.5],
                                      device=dev).repeat(len(con0))[
                                          :len(con0)]
        bnd = torch.zeros(nr, device=dev)
        bnd[list(box)] = 0.7
        return Ad, rhs, f0, v0, act, mu, bnd

    cases = []
    for cold in (True, False):
        for eq in ((), (4,)):
            cases.append(('synthetic', synthetic(B), dict(
                nonneg=nonneg, box_rows=box, con0=con0, iterations=40,
                cold=cold, eq_rows=eq)))
    # one warp per env with two rows a lane (62, the walker's size) and
    # the block per env (96, the dense regime's ceiling); cones to the
    # last rows, the last wrapping to row 0
    for n_rows, cold in ((62, True), (96, False)):
        cones = tuple(range(n_rows - 29, n_rows, 3))
        cases.append((f'synthetic-nr{n_rows}', synthetic(B, n_rows, cones),
                      dict(nonneg=nonneg, box_rows=box, con0=cones,
                           iterations=40, cold=cold, eq_rows=(4,))))
    worst, rounding_envs = hold_apgd(
        torch, 'apgd', A.apgd_iterate_batched, A.apgd_iterate_plain,
        lambda args: args[0], cases + walker_cases)
    # times on the walker-captured inputs (cold and warm)
    times = time_apgd(
        torch, 'apgd', A.apgd_iterate_batched, A.apgd_iterate_plain,
        walker_cases, lambda a: 2.0 * a[1].shape[1] ** 2,
        lambda a: 4.0 * (a[0].numel() + 6 * a[1].numel() + 2 * a[1].shape[1]),
        trace_bound=False)
    # the latency of one APGD iteration: the walker's warm solve in
    # contact, with no exit on convergence (tol2 = 0; the slowest env runs
    # to the cap), at caps of 1 and 41 iterations
    tag, args, kw = walker_cases[-1]
    check(tag == 'contact' and not kw['cold'], tag)
    cap = lambda n: device_ms(lambda: A.apgd_iterate_batched(
        *args, **dict(kw, iterations=n, tol2=0.0)), 20)
    t1, t41 = cap(1), cap(41)
    iteration_ns = 1e6 * (t41 - t1) / 40
    print(f'apgd {tag}-warm, tol2 = 0: {t1:.4f} ms at 1 iteration, '
          f'{t41:.4f} ms at 41: '
          f'{iteration_ns:.0f} ns per APGD iteration')
    return worst, rounding_envs, times, iteration_ns


def factored_problem(dev, torch, Bs, nr, nv, n_nonneg, cold, seed):
    """A synthetic factored dual QP batch, as
    tests/test_apgd_kernel.py _factored_problem builds one: limit rows,
    then friction-cone triples; scaled and active-masked J~, dense PSD
    M^-1, a quarter of the rows active."""
    g = torch.Generator(device=dev).manual_seed(seed)
    J = torch.randn((Bs, nr, nv), generator=g, device=dev)
    G = torch.randn((Bs, nv + 2, nv), generator=g, device=dev)
    Minv = (torch.einsum('bij,bik->bjk', G, G) / nv
            + 0.1 * torch.eye(nv, device=dev)).contiguous()
    R = 0.05 + 0.25 * torch.rand((Bs, nr), generator=g, device=dev)
    act = (torch.rand((Bs, nr), generator=g, device=dev) > 0.75).float()
    d = torch.einsum('brv,bvw,brw->br', J, Minv, J) + R
    s = d.rsqrt()
    vec = lambda: torch.randn((Bs, nr), generator=g, device=dev)
    con0 = tuple(range(n_nonneg, nr, 3))
    mu = torch.zeros(nr, device=dev)
    mu[list(con0)] = 0.7
    args = ((J * (s * act)[:, :, None]).contiguous(), Minv, s * s * R * act,
            s * s * d * act, vec() * act, 0.3 * vec(), vec(), act, mu,
            torch.zeros(nr, device=dev))
    return args, dict(nonneg=tuple(range(n_nonneg)), box_rows=(), con0=con0,
                      iterations=40, cold=cold)


def factored_phase(dev, torch, cheetah_cases):
    """TPU kernel #7 against its plain version: the cheetah solves
    captured from the main path (146 rows, nv 9; the warp path's exact
    instantiation), a synthetic batch for the warp path's guarded
    instantiation (120 rows: 24 limits, 32 cone triples; nv 16; B = 1024)
    and a humanoid-shaped synthetic batch (303 rows: 36 limits, 89 cone
    triples; nv 27; B = 512; the block path), cold and warm; the path each
    case took; and the latency of one APGD iteration on the warp path."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    synthetic = []
    for cold in (True, False):
        args, kw = factored_problem(dev, torch, B, 120, 16, 24, cold,
                                    seed=2 + int(cold))
        synthetic.append(('guarded-synthetic', args, kw))
    for cold in (True, False):
        args, kw = factored_problem(dev, torch, 512, 303, 27, 36, cold,
                                    seed=int(cold))
        synthetic.append(('humanoid-synthetic', args, kw))
    worst, rounding_envs, times = hold_time_factored(
        torch, cheetah_cases + synthetic)
    tag, args, kw = cheetah_cases[-1]
    check(tag == 'moving' and not kw['cold'], tag)
    return worst, rounding_envs, times, factored_iteration_ns(
        torch, tag, args, kw)


def hold_time_factored(torch, cases):
    """#7 on each case against its plain version (hold_apgd, with the
    flat-valley test on J~' f) and timed (time_apgd), with the path each
    case takes."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    routes = {}
    for tag, args, kw in cases:
        nr, nv = args[0].shape[1:]
        routes[tag + ('-cold' if kw['cold'] else '-warm')] = route = \
            A.factored_route(nr, nv)
        print(f'apgd factored {tag} cold={kw["cold"]}: nr {nr}, nv {nv}, '
              f'B {args[0].shape[0]}, {int(args[7].sum())} rows active: '
              f'the {route} path')
    dense = lambda a: (a[0] @ a[1]) @ a[0].transpose(1, 2) + torch.diag_embed(
        a[2])
    worst, rounding_envs = hold_apgd(
        torch, 'apgd factored',
        lambda *a, **k: A.apgd_iterate_factored(*a, **k,
                                                return_iterations=True),
        A.apgd_iterate_factored_plain, dense, cases,
        joint_force=lambda a, f: torch.einsum('brv,br->bv', a[0], f))
    times = time_apgd(
        torch, 'apgd factored', A.apgd_iterate_factored,
        A.apgd_iterate_factored_plain, cases,
        lambda a: 4.0 * a[0].shape[1] * a[0].shape[2] + 2.0 * a[0].shape[2]
        ** 2,
        lambda a: 4.0 * (a[0].numel() + a[1].numel() + 8 * a[4].numel()
                         + 2 * a[4].shape[1]),
        trace_bound=True)
    for tag, route in routes.items():
        times[tag]['path'] = route
    return worst, rounding_envs, times


def factored_iteration_ns(torch, tag, args, kw):
    """The latency of one APGD iteration of #7 on a warm solve in motion,
    with no exit on convergence (tol2 = 0; every env runs to the cap), from
    caps of 1 and 41 iterations."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    cap = lambda n: device_ms(lambda: A.apgd_iterate_factored(
        *args, **dict(kw, iterations=n, tol2=0.0)), 20)
    t1, t41 = cap(1), cap(41)
    iteration_ns = 1e6 * (t41 - t1) / 40
    print(f'apgd factored {tag}-warm, tol2 = 0: {t1:.4f} ms at 1 iteration, '
          f'{t41:.4f} ms at 41: {iteration_ns:.0f} ns per APGD iteration')
    return iteration_ns


def capture_solves(dev, torch, env, state, label, kernel):
    """Inputs of the port's own solves at B envs from `state`, zero
    actions: a cold physics step, then a warm one from its row forces and
    power vector (what the walker's 10-substep control step runs first;
    cheetah's 1-substep control step solves cold only, so its warm case
    comes from this warm step; an RK4 model's two steps are eight cold
    stage solves). `kernel` names the wrapper to capture:
    apgd_iterate_batched (walker, 62 rows; hopper, 88) or
    apgd_iterate_factored (cheetah, 146 rows; humanoid, 303)."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A
    from mujoco_mbrl_tpu_torch.physics import engine
    from mujoco_mbrl_tpu_torch.physics.model import RK4

    captured = []
    real = getattr(A, kernel)

    def capture(*args, **kw):
        captured.append((label, tuple(a.clone() for a in args), dict(kw)))
        return real(*args, **kw)

    # the episodes' per-env params (escape's terrain) applied, as a step
    params = getattr(state, 'params', ())
    m = (env._model_with(params) if hasattr(env, '_model_with')
         and isinstance(params, torch.Tensor) else env.model)
    zero = torch.zeros((state.physics.qpos.shape[0], m.nu), device=dev)
    setattr(A, kernel, capture)
    try:
        s1, f, v = engine.step_warm(m, state.physics, zero)
        engine.step_warm(m, s1, zero, warm_f=f, warm_v=v)
    finally:
        setattr(A, kernel, real)
    torch.cuda.synchronize()
    check([c[2]['cold'] for c in captured] == (
        [True] * 8 if m.opt.integrator == RK4 else [True, False]), label)
    return captured


def proposal(dev, torch, ad=6):
    """Goal, cost weights and a CEM proposal (mean, std) for B envs."""
    goal = torch.zeros(24, device=dev)
    goal[1] = 1.0
    weights = torch.ones(24, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    mean = (0.3 * torch.randn((B, H, ad), generator=g, device=dev)).clamp(
        -0.9, 0.9)
    std = 0.2 + torch.rand((B, H, ad), generator=g, device=dev)
    return goal, weights, mean, std


def check_actions(torch, label, costs, ref, acts, mean, Kc, skip=None):
    """Costs against the plain cost of the kernel's own actions (rtol
    1e-4; candidates where ``skip`` is set are left out), the action range
    and the antithetic identity; returns the largest cost difference."""
    check(costs.shape == (mean.shape[0], Kc)
          and acts.shape == mean.shape + (Kc,), (costs.shape, acts.shape))
    check(bool(torch.isfinite(costs).all()), f'{label}: non-finite costs')
    if skip is not None:
        costs, ref = costs[~skip], ref[~skip]
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
    check(float(acts.abs().max()) <= 1.0, f'{label}: action out of [-1, 1]')
    a1, a2 = acts[..., :Kc // 2], acts[..., Kc // 2:]
    free = (a1.abs() < 1.0) & (a2.abs() < 1.0)
    pair = (a1 + a2 - 2.0 * mean[..., None]).abs()[free]
    check(float(pair.max()) < 1e-5, (label, float(pair.max())))
    return float((costs - ref).abs().max()), float(pair.max())


def noise_moments(torch, label, acts):
    """Moments of z = a / 0.1 from an unclipped proposal (std 0.1 around
    0): mean 0, variance 1."""
    z = acts[..., :acts.shape[-1] // 2] / 0.1
    zm, zv = float(z.mean()), float(z.var())
    check(abs(zm) < 1e-2 and abs(zv - 1.0) < 2e-2, (label, zm, zv))
    return zm, zv


def spline4_identity(torch, acts, mean, std):
    """Where actions are unclipped, z = (a - mean) / std at t = 4i + r
    (r > 0) is ((1 - w) z_4i + w z_4i+4) / sqrt((1 - w)^2 + w^2), w = r/4;
    returns the largest deviation."""
    z = (acts - mean[..., None]) / std[..., None]
    z = torch.where(acts.abs() < 1.0, z, torch.nan)
    worst, horizon = 0.0, acts.shape[1]
    for t in range(horizon):
        i, r = divmod(t, 4)
        if r == 0 or 4 * i + 4 >= horizon:
            continue
        w = r / 4
        lerp = ((1 - w) * z[:, 4 * i] + w * z[:, 4 * i + 4]) / (
            (1 - w) ** 2 + w ** 2) ** 0.5
        worst = max(worst, float((z[:, t] - lerp).abs().nan_to_num(
            0.0).max()))
    check(worst < 1e-4, ('spline4 lerp identity', worst))
    return worst


def sampler_bound(B_, K_, H_, sd, ad, hid, n=1):
    """FLOP of the rollout (unpadded) and the sampler kernels' two bounds,
    each the larger of its operation time and the bytes at the HBM rate:
    the tensor-core bound they are held to (3 x FLOP at the TF32 tensor
    rate: the 3xTF32 split) and the FP32 bound (FLOP at the non-tensor
    FP32 rate, what the earlier FFMA kernels were held to)."""
    in_dim = sd + ad
    flops = 2.0 * B_ * K_ * H_ * (in_dim * hid + hid * hid + hid * sd)
    n_bytes = 4.0 * (B_ * H_ * ad * K_ + B_ * K_ + B_ * sd + 2 * B_ * H_ * ad
                     + n * (in_dim * hid + hid * hid + hid * sd + 2 * hid
                            + sd) + 2 * sd)
    t_b, t_o = n_bytes / PEAK_BYTES, 3.0 * flops / PEAK_TF32_FLOPS
    tensor = (max(t_b, t_o) * 1e3, 'bytes' if t_b >= t_o else 'operations')
    return flops, tensor, bound_ms(n_bytes, flops)


def sampler_case(label, flops, bounds, k_ms, p_ms, **extra):
    """Print a sampler kernel's time beside both bounds, with its share of
    each, and return its entry: ``bound_ms`` is the tensor-core bound it is
    held to (a share of at most 100%, checked); ``bound_fp32_ms`` the FP32
    bound, which a tensor-core kernel may beat (no share is then given)."""
    (tc_ms, tc_by), (fp_ms, fp_by) = bounds
    check(tc_ms <= k_ms, (label, 'faster than its bound', k_ms, tc_ms))
    fp = (f'{100 * fp_ms / k_ms:.1f}% of it' if fp_ms <= k_ms else
          f'beaten {fp_ms / k_ms:.2f}x, so no share')
    print(f'{label}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms (reference '
          f'only); held to the 3xTF32 tensor-core bound {tc_ms:.4f} ms '
          f'({tc_by}): {100 * tc_ms / k_ms:.1f}% of it; FP32 bound '
          f'{fp_ms:.4f} ms ({fp_by}): {fp}; '
          f'{flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s of model FLOP')
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=tc_ms, bound_by=tc_by,
                bound_fp32_ms=fp_ms, bound_fp32_by=fp_by,
                held_to='3xTF32 tensor cores: 3 x FLOP at 494.7 TFLOP/s',
                **extra)


def sampler_phase(dev, torch, params, obs):
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    sd, ad = obs.shape[1], 6
    goal, weights, mean, std = proposal(dev, torch)
    worst = 0.0
    for sampler in ('triangular', 'normal', 'spline4'):
        costs, acts = C.mlp_sample_rollout_costs(
            params, 1234, obs, mean, std, goal, weights, K, sampler=sampler)
        ref = C.rollout_costs_of_actions(params, obs, acts, goal, weights)
        torch.cuda.synchronize()
        err, pair = check_actions(torch, sampler, costs, ref, acts, mean, K)
        worst = max(worst, err)
        _, a_m = C.mlp_sample_rollout_costs(
            params, 99, obs, torch.zeros_like(mean),
            torch.full_like(std, 0.1), goal, weights, K, sampler=sampler)
        zm, zv = noise_moments(torch, sampler, a_m)
        extra = ''
        if sampler == 'spline4':
            dev_lerp = spline4_identity(torch, acts, mean, std)
            km, kv = noise_moments(torch, 'spline4 knots', a_m[:, 0::4])
            extra = (f'; lerp identity max dev {dev_lerp:.2e}; knots mean '
                     f'{km:+.2e} var {kv:.4f}')
        print(f'sampler {sampler}: max|cost - plain(actions)| = {err:.3e} '
              f'(max |cost| {float(costs.abs().max()):.3f}); '
              f'antithetic max dev {pair:.2e}; '
              f'z mean {zm:+.2e} var {zv:.4f}{extra}')

    hid = params['l2']['w'].shape[0]
    flops, *bounds = sampler_bound(B, K, H, sd, ad, hid)
    cases = {}
    for sampler in ('triangular', 'spline4'):
        run_k = lambda: C.mlp_sample_rollout_costs(
            params, 7, obs, mean, std, goal, weights, K, sampler=sampler)
        run_p = lambda: C.mlp_sample_rollout_costs_plain(
            params, 7, obs, mean, std, goal, weights, K, sampler=sampler)
        k_ms = time_ms(run_k, 5)
        p_ms = time_ms(run_p, 2)
        cases[sampler] = sampler_case(
            f'sampler {sampler} B={B} K={K} H={H} sd={sd}', flops, bounds,
            k_ms, p_ms)
    return worst, dict(cases['triangular'], cases=cases)


def ensemble_phase(dev, torch, obs, n=5):
    from mujoco_mbrl_tpu_torch import models
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    sd, ad, hid = obs.shape[1], 6, 50
    ens = lambda m: models.EnsembleDynamics(
        models.MLPDynamics(sd, ad, hidden_units=hid), m).init(
            torch.Generator().manual_seed(1), device=dev)
    params = ens(n)
    goal, weights, mean, std = proposal(dev, torch)
    worst = 0.0
    for sampler in ('normal', 'triangular'):
        costs, acts = C.mlp_sample_rollout_costs_ensemble(
            params, 1234, obs, mean, std, goal, weights, K, n,
            sampler=sampler)
        ref = C.rollout_costs_of_actions_ensemble(params, obs, acts, goal,
                                                  weights)
        torch.cuda.synchronize()
        err, pair = check_actions(torch, f'ensemble {sampler}', costs, ref,
                                  acts, mean, K)
        worst = max(worst, err)
        _, a_m = C.mlp_sample_rollout_costs_ensemble(
            params, 99, obs, torch.zeros_like(mean),
            torch.full_like(std, 0.1), goal, weights, K, n, sampler=sampler)
        zm, zv = noise_moments(torch, f'ensemble {sampler}', a_m)
        print(f'ensemble {sampler} n={n}: max|cost - plain(actions, member '
              f'k % n)| = {err:.3e} (max |cost| '
              f'{float(costs.abs().max()):.3f}); antithetic max dev '
              f'{pair:.2e}; z mean {zm:+.2e} var {zv:.4f}')

    # K = 60, n = 4: candidate k's antithetic partner k + 30 belongs to
    # member (k + 2) % 4, so pairs straddle members
    p4, Bs = ens(4), 64
    costs, acts = C.mlp_sample_rollout_costs_ensemble(
        p4, 77, obs[:Bs], mean[:Bs], std[:Bs], goal, weights, 60, 4)
    ref = C.rollout_costs_of_actions_ensemble(p4, obs[:Bs], acts, goal,
                                              weights)
    err, pair = check_actions(torch, 'ensemble straddling pairs', costs, ref,
                              acts, mean[:Bs], 60)
    worst = max(worst, err)
    # one member: the single-MLP kernel's actions and costs
    one = {l: {k: v[:1] for k, v in p.items()} for l, p in params.items()}
    mlp = {l: {k: v[0] for k, v in p.items()} for l, p in params.items()}
    c1, a1 = C.mlp_sample_rollout_costs(mlp, 5, obs, mean, std, goal,
                                        weights, K, sampler='normal')
    c2, a2 = C.mlp_sample_rollout_costs_ensemble(one, 5, obs, mean, std,
                                                 goal, weights, K, 1)
    da, dc = float((a1 - a2).abs().max()), float((c1 - c2).abs().max())
    check(da <= 1e-6, ('one-member actions', da))
    torch.testing.assert_close(c2, c1, rtol=1e-5, atol=1e-5)
    print(f'ensemble straddling pairs (B={Bs}, K=60, n=4): max|cost - plain| '
          f'{err:.3e}, antithetic max dev {pair:.2e}; one member vs the MLP '
          f'kernel: max|da| {da:.2e}, max|dcost| {dc:.2e}')

    # walker_ens at 1024 envs (sd 24), and the CLI's --model ens layout:
    # 5 envs, horizon 20, the 20-dim featured state
    p20 = models.EnsembleDynamics(models.MLPDynamics(
        20, ad, hidden_units=hid), n).init(torch.Generator().manual_seed(2),
                                           device=dev)
    cases = {}
    for tag, p, s0, Hc, Bs in (('b1024_h30_sd24', params, obs, H, B),
                               ('b5_h20_sd20', p20, obs[:5, :20], 20, 5)):
        args = (p, 7, s0.contiguous(), mean[:Bs, :Hc].contiguous(),
                std[:Bs, :Hc].contiguous(), goal[:s0.shape[1]],
                weights[:s0.shape[1]], K, n)
        costs, acts = C.mlp_sample_rollout_costs_ensemble(*args)
        ref = C.rollout_costs_of_actions_ensemble(p, args[2], acts, args[5],
                                                  args[6])
        err, _ = check_actions(torch, f'ensemble {tag}', costs, ref, acts,
                               args[3], K)
        worst = max(worst, err)
        flops, *bounds = sampler_bound(Bs, K, Hc, s0.shape[1], ad, hid, n)
        k_ms = time_ms(lambda: C.mlp_sample_rollout_costs_ensemble(*args), 5)
        p_ms = time_ms(
            lambda: C.mlp_sample_rollout_costs_ensemble_plain(*args), 2)
        cases[tag] = sampler_case(
            f'ensemble sampler {tag} (B={Bs} K={K} H={Hc} n={n})', flops,
            bounds, k_ms, p_ms, max_abs_err=err)
    main_case = {k: v for k, v in cases['b1024_h30_sd24'].items()
                 if k != 'max_abs_err'}
    return worst, dict(main_case, cases=cases)


def folded_costs64(torch, C, params, norms, fold_dtype, s0, acts, goal,
                   weights, alpha_action):
    """Float64 plain costs of ``acts`` with the normalizers folded into the
    weights in ``fold_dtype`` (float32 is what the kernel and the float32
    plain version are given)."""
    import dataclasses
    p = {l: {k: v.detach().to(fold_dtype) for k, v in d.items()}
         for l, d in params.items()}
    nm = type(norms)(**{f.name: getattr(norms, f.name).to(fold_dtype)
                        for f in dataclasses.fields(norms)})
    w = [t.double() for t in C._fold_normalizers(p, nm)]
    tree = {l: {'w': w[2 * i], 'b': w[2 * i + 1]}
            for i, l in enumerate(('l1', 'l2', 'l3'))}
    f = (C.rollout_costs_of_actions_ensemble if w[0].ndim == 3
         else C.rollout_costs_of_actions)
    return f(tree, s0.double(), acts.double(), goal.double(),
             weights.double(), alpha_action=alpha_action)


def decided_by_rounding(torch, label, costs, ref, r64, r64_w32):
    """Candidates whose float64 cost moves by more than 1e-5 relative
    when only the folded weights are rounded to float32 (r64_w32 vs r64):
    printed, with every candidate beyond rtol 1e-4 of the float32 plain
    ``ref``; at most 0.1% may be. Also printed: the errors of the kernel and
    of the float32 plain against float64 arithmetic on the same float32
    weights (r64_w32), and the gate's margin, the tolerance over the
    largest |cost - plain| among the candidates not decided by rounding
    (the check fails below 1). Returns (mask, count, margin)."""
    torch.cuda.synchronize()
    sens = (r64_w32 - r64).abs() / (r64.abs() + 1e-4)
    decided = sens > 1e-5
    off = ~torch.isclose(costs, ref, rtol=1e-4, atol=1e-4)
    n_dec, n_off = int(decided.sum()), int(off.sum())
    rel = lambda x: (x.double() - r64_w32).abs() / (r64_w32.abs() + 1e-4)
    rk, rp = rel(costs), rel(ref)
    used = ((costs - ref).abs() / (1e-4 + 1e-4 * ref.abs()))[~decided]
    margin = 1.0 / max(float(used.max()), 1e-30)
    print(f'{label}: {n_dec} of {costs.numel()} candidates decided by '
          f'rounding (max sensitivity {float(sens.max()):.2e}); {n_off} '
          f'beyond rtol 1e-4 of the float32 plain; rel. error vs float64 '
          f'on the float32 weights: kernel mean {float(rk.mean()):.3e} max '
          f'{float(rk.max()):.3e} ({float(rk[~decided].max()):.3e} not '
          f'decided), float32 plain mean {float(rp.mean()):.3e} max '
          f'{float(rp.max()):.3e} ({float(rp[~decided].max()):.3e}); gate '
          f'margin {margin:.2f}x')
    for b, k in off.nonzero()[:8].tolist():
        print(f'  env {b} candidate {k}: kernel {float(costs[b, k]):.6f} '
              f'plain {float(ref[b, k]):.6f} float64 '
              f'{float(r64[b, k]):.6f} sensitivity '
              f'{float(sens[b, k]):.2e}')
    check(n_dec <= costs.numel() // 1000, (label, n_dec))
    return decided, n_dec, margin


def fitted_sampler_check(dev, torch, label, agent, s0, horizon, sampler,
                         rounding_note=''):
    """The agent's own sampler kernel on its fitted params, with the
    replay's normalizers folded into W1 / W3, at the shapes its loop gives
    it (s0 the 20-dim featured states, padded to 24 lanes in the kernel):
    costs against the plain cost of the kernel's own actions (rtol 1e-4),
    the action checks, and times next to the bound.

    A fitted model rolled past the rollout length it was fitted on can
    amplify float32 rounding, so a few candidates' costs are decided by
    rounding: rounding the folded weights to float32 alone (the fold of
    1 / (std + 1e-6) into W1 cancels in b1) moves their float64 cost by
    more than 1e-5 relative. Those candidates (at most 0.1%) are printed
    and left out of the rtol 1e-4 comparison; every other one must agree.
    """
    from mujoco_mbrl_tpu_torch import models
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    Bs, sd = s0.shape
    ad, hid = agent.environment.action_dim, agent.params['l2']['w'].shape[-1]
    g = torch.Generator(device=dev).manual_seed(11)
    mean = (0.3 * torch.randn((Bs, horizon, ad), generator=g,
                              device=dev)).clamp(-0.9, 0.9)
    std = 0.2 + torch.rand((Bs, horizon, ad), generator=g, device=dev)
    kw = dict(normalizers=agent._normalizers(),
              alpha_action=agent.action_cost_alpha)
    goal, weights = agent.training_goal_state, agent.state_cost_weights
    p = agent.params
    if isinstance(agent.model, models.EnsembleDynamics):
        n = agent.model.n
        run = lambda: C.mlp_sample_rollout_costs_ensemble(
            p, 21, s0, mean, std, goal, weights, K, n, sampler=sampler, **kw)
        run_p = lambda: C.mlp_sample_rollout_costs_ensemble_plain(
            p, 21, s0, mean, std, goal, weights, K, n, sampler=sampler, **kw)
        plain = lambda a: C.rollout_costs_of_actions_ensemble(
            p, s0, a, goal, weights, **kw)
    else:
        n = 1
        run = lambda: C.mlp_sample_rollout_costs(
            p, 21, s0, mean, std, goal, weights, K, sampler=sampler, **kw)
        run_p = lambda: C.mlp_sample_rollout_costs_plain(
            p, 21, s0, mean, std, goal, weights, K, sampler=sampler, **kw)
        plain = lambda a: C.rollout_costs_of_actions(p, s0, a, goal,
                                                     weights, **kw)
    with torch.no_grad():
        costs, acts = run()
        ref = plain(acts)
        c64 = lambda fold_dtype: folded_costs64(
            torch, C, p, kw['normalizers'], fold_dtype, s0, acts, goal,
            weights, kw['alpha_action'])
        decided, n_dec, margin = decided_by_rounding(
            torch, label, costs, ref, c64(torch.float64), c64(torch.float32))
        err, pair = check_actions(torch, label, costs, ref, acts, mean, K,
                                  skip=decided)
        extra = ''
        if sampler == 'spline4':
            extra = (f'; lerp identity max dev '
                     f'{spline4_identity(torch, acts, mean, std):.2e}')
        k_ms = time_ms(run, 5)
        p_ms = time_ms(run_p, 1)
        # the wrapper's host-side share: the centred fold and the packing
        prep_ms = time_ms(lambda: C._kernel_inputs(
            label, p, kw['normalizers'], s0, mean, std, goal, weights,
            n_members=None if n == 1 else n), 5)
    flops, *bounds = sampler_bound(Bs, K, horizon, sd, ad, hid, n)
    w1 = C._fold_normalizers(p, kw['normalizers'])[0].detach()
    print(f'{label} (fitted params, folded normalizers, max|W1\'| '
          f'{float(w1.abs().max()):.3e}; B={Bs} K={K} H={horizon} sd={sd} '
          f'{sampler}): max|cost - plain(actions)| = {err:.3e} (max |cost| '
          f'{float(costs.abs().max()):.3f}); antithetic max dev {pair:.2e}'
          f'{extra}; {n_dec} of {costs.numel()} candidates decided by '
          f'rounding{rounding_note}; the wrapper call {k_ms:.4f} ms, of '
          f'which fold + pack {prep_ms:.4f} ms')
    return sampler_case(f'{label} (B={Bs} K={K} H={horizon})', flops,
                        bounds, k_ms, p_ms, max_abs_err=err,
                        rounding_decided_candidates=n_dec,
                        gate_margin=margin, fold_pack_ms=prep_ms)


def profile_phase(torch, run, params, state, gen, wall_plain):
    """Device time by kernel over the main path's control steps
    (torch.profiler), and the device-busy share of the unprofiled run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(params, state, gen)
        torch.cuda.synchronize()
    dev_time = lambda e: getattr(e, 'self_device_time_total',
                                 getattr(e, 'self_cuda_time_total', 0.0))
    events = [e for e in prof.key_averages() if dev_time(e) > 0]
    total_ms = sum(dev_time(e) for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    print(f'profile: {STEPS} control steps, device busy {total_ms:.2f} ms in '
          f'{n_kernels} device ops = '
          f'{100 * total_ms / (1e3 * wall_plain):.1f}% '
          f'of the unprofiled {1e3 * wall_plain:.1f} ms wall')
    for e in sorted(events, key=dev_time, reverse=True)[:12]:
        print(f'  {dev_time(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}')
    return dict(device_busy_ms=total_ms, device_ops=n_kernels,
                device_busy_share=total_ms / (1e3 * wall_plain))


def ens_control_step_phase(dev, torch):
    """The walker_ens control step: build_bench with the 5-member
    ensemble; 3 ensemble sampler + 10 APGD launches per control step."""
    from mujoco_mbrl_tpu_torch.bench import build_bench

    run, (params, state0, gen) = build_bench(
        'walker_walk', B, K, H, ITERS, STEPS, device=dev,
        model_kind='ensemble')
    counts, out, _, _ = control_step(dev, torch, run, params, state0, gen,
                                     'walker_ens control step')
    exact_counts('walker_ens control step', counts,
                 cem_sample_rollout_ens=ITERS * STEPS, apgd_solve=10 * STEPS)
    return counts, out


AGENT_T, AGENT_EPOCHS, AGENT_BATCH = 10, 5, 512


def agent_phase(dev, torch, tmp):
    """GoalStateAgent.train() on walker_walk at full width: 5-member
    ensemble (hidden 50) over the 20-dim featured state, CEM 1000 x 30 x 3,
    1024 seed + 1024 policy rollouts cut to AGENT_T steps, one fit of
    AGENT_EPOCHS epochs at batch 512, replay capacity 2048 rollouts."""
    from mujoco_mbrl_tpu_torch import agents, data, envs, models, ops
    from mujoco_mbrl_tpu_torch import planners
    from mujoco_mbrl_tpu_torch.models import train as Mt
    from mujoco_mbrl_tpu_torch.utils import MetricsWriter

    env = envs.load('walker', 'walk', device=dev)
    model = models.EnsembleDynamics(models.MLPDynamics(
        env.state_dim, env.action_dim, hidden_units=50), 5)
    dataset = data.init_replay(2 * B, AGENT_T, env.state_dim,
                               env.observation_dim, env.action_dim,
                               device=dev)
    writer = MetricsWriter(tmp)
    agent = agents.GoalStateAgent(
        environment=env, planner=planners.CEMPlanner, model=model,
        horizon=H, optimizer=Mt.adam(0.01), rollout_length=AGENT_T,
        num_rollouts_per_iteration=B, num_train_iterations=1, writer=writer,
        base_path=tmp, dataset=dataset,
        planner_kwargs=dict(num_candidates=K, num_elites=K // 10,
                            num_iterations=ITERS),
        train_epochs=AGENT_EPOCHS, train_batch_size=AGENT_BATCH,
        num_initial_rollouts=B, seed=0)
    phases = []

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            phases.append((name, time.perf_counter() - t0, out))
            return out
        return run

    agent.add_rollouts = timed('collect', agent.add_rollouts)
    agent.fit_model = timed('fit', agent.fit_model)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    agent.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    writer.close()
    check([p[0] for p in phases] == ['collect', 'fit', 'collect'],
          [p[0] for p in phases])
    # 3 CEM iterations per policy step; 10 physics substeps per control
    # step of both collections (the featured-state forward of reset and
    # step stops at the velocity stage: no solve)
    exact_counts('agent loop', counts,
                 cem_sample_rollout_ens=ITERS * AGENT_T,
                 apgd_solve=2 * 10 * AGENT_T)
    check(agent.dataset.filled == 2 * B, agent.dataset.filled)
    buf = agent.dataset
    for name in ('states', 'observations', 'actions', 'rewards'):
        check(bool(torch.isfinite(getattr(buf, name)).all()), name)
    losses = phases[1][2].losses
    n_up = losses.shape[0]
    check(n_up == AGENT_EPOCHS * (2 * B * AGENT_T // AGENT_BATCH), n_up)
    check(bool(torch.isfinite(losses).all()), 'non-finite training loss')
    first, last = float(losses[:n_up // 10].mean()), float(
        losses[-(n_up // 10):].mean())
    check(last < first, ('training loss did not decrease', first, last))
    rewards = {}
    with open(os.path.join(tmp, 'metrics.jsonl')) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec['tag'].startswith('AvgRolloutRewards/'):
                rewards[rec['tag'].split('/')[1]] = rec['value']
    times = {'seed_collect_s': phases[0][1], 'fit_s': phases[1][1],
             'policy_collect_s': phases[2][1], 'train_s': wall}
    print(f'agent loop (walker_walk, ensemble n=5, {B} + {B} rollouts of '
          f'{AGENT_T} steps, fit {AGENT_EPOCHS} epochs = {n_up} updates): '
          + ', '.join(f'{k} {v:.3f}' for k, v in times.items())
          + f'; loss {first:.4f} -> {last:.4f}; mean rollout reward '
          f'{rewards}; launches {counts}')
    states = phases[2][2].states[:, -1].contiguous()
    check(states.shape == (B, 20), states.shape)
    fitted = fitted_sampler_check(
        dev, torch, 'agent ensemble sampler', agent, states, H, 'normal',
        rounding_note=' (the earlier FP32 FFMA kernel: 6 of 1,024,000)')
    return counts, times, fitted


def cli_phase(dev, torch, tmp):
    """The port's experiment CLI: single MLP, spline4 sampler, 5 policy
    rollouts of 10 steps (CEM 1000 candidates x 5 iterations)."""
    from mujoco_mbrl_tpu_torch import experiment, ops

    args = experiment.parse_args([
        '--exp_dir', tmp, '--environment', 'walker_walk', '--planner', 'cem',
        '--model', 'nn', '--kernel_kwargs', '{"sampler": "spline4"}',
        '--num_rollouts_per_iteration', '5', '--rollout_length', '10',
        '--num_train_iterations', '1', '--train_epochs', '2'])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    agent = experiment.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    # 5 CEM iterations per policy step of the 5 rollouts (plain walker
    # physics and the dense solve: 10 substeps, 3 x 10 control steps, the
    # observation-spec reset solves nothing)
    exact_counts('CLI', counts, cem_sample_rollout=5 * 10,
                 apgd_solve=10 * (2 * 10))
    check(os.path.exists(os.path.join(tmp, 'agent_final.pt')),
          'agent_final not written')
    print(f'experiment CLI (nn, spline4, 5 rollouts of 10 steps): {wall:.3f} '
          f's; launches {counts}')
    # the 5 policy rollouts follow the 20 seed rollouts in the ring
    buf = agent.dataset
    check(buf.filled == 25 and buf.cursor == 25, (buf.filled, buf.cursor))
    states = buf.states[20:25, -1].contiguous()
    check(states.shape == (5, 20) and agent.horizon == 20,
          (states.shape, agent.horizon))
    fitted = fitted_sampler_check(dev, torch, 'CLI MLP sampler', agent,
                                  states, agent.horizon, 'spline4')
    return counts, fitted


def rollout_costs_bound(N, H_, sd, ad, hid):
    """FLOP of the rollout (sampler_bound's) and the given-action kernel's
    two bounds, as sampler_bound gives them, over the bytes of the given
    actions, the states, the costs and the weights, read or written once:
    the 3xTF32 tensor-core bound it is held to and the FP32 bound."""
    in_dim = sd + ad
    flops = 2.0 * N * H_ * (in_dim * hid + hid * hid + hid * sd)
    n_bytes = 4.0 * (N * H_ * ad + N * sd + N + in_dim * hid + hid * hid
                     + hid * sd + 2 * hid + 3 * sd)
    t_b, t_o = n_bytes / PEAK_BYTES, 3.0 * flops / PEAK_TF32_FLOPS
    tensor = (max(t_b, t_o) * 1e3, 'bytes' if t_b >= t_o else 'operations')
    return flops, tensor, bound_ms(n_bytes, flops)


def candidates(dev, torch, Bs, Hh, ad, seed):
    """Sampler-layout candidates (B, H, ad, K) as cem_batched's non-fused
    branch draws them, a clipped normal around a proposal; and the same
    actions in the rollout-cost kernel's layout (H, ad, B K)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mean = (0.3 * torch.randn((Bs, Hh, ad, 1), generator=g,
                              device=dev)).clamp(-0.9, 0.9)
    std = 0.2 + torch.rand((Bs, Hh, ad, 1), generator=g, device=dev)
    acts = torch.clamp(mean + std * torch.randn(
        (Bs, Hh, ad, K), generator=g, device=dev), -1.0, 1.0)
    return acts, acts.permute(1, 2, 0, 3).reshape(Hh, ad, Bs * K)


def states_t(s0):
    """(sd, B K): each env's state repeated for its K candidates."""
    sd, Bs = s0.shape[1], s0.shape[0]
    return s0.T[:, :, None].expand(sd, Bs, K).reshape(sd, Bs * K).contiguous()


def hold_given(torch, label, params, s0T, aT, goal, weights):
    """Kernel #4 against its plain version on given actions (rtol = atol =
    1e-4, every candidate), timed beside both bounds with its gate margin
    (the tolerance over the largest |cost - plain|)."""
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    (sd, N), (Hh, ad) = s0T.shape, aT.shape[:2]
    hid = params['l2']['w'].shape[0]
    run_k = lambda: C.mlp_rollout_costs_t(params, s0T, aT, goal, weights)
    run_p = lambda: C.mlp_rollout_costs_reference(
        params, s0T.T, aT.transpose(1, 2), goal, weights)
    with torch.no_grad():
        costs, ref = run_k(), run_p()
        torch.cuda.synchronize()
        check(costs.shape == (N,) and bool(torch.isfinite(costs).all()),
              (label, costs.shape))
        torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-4)
        err = float((costs - ref).abs().max())
        margin = 1.0 / max(float(((costs - ref).abs() / (
            1e-4 + 1e-4 * ref.abs())).max()), 1e-30)
        k_ms, p_ms = time_ms(run_k, 5), time_ms(run_p, 2)
    flops, *bounds = rollout_costs_bound(N, Hh, sd, ad, hid)
    print(f'{label}: max|kernel - plain| = {err:.3e} (max |cost| '
          f'{float(costs.abs().max()):.3f}); gate margin {margin:.2f}x')
    return sampler_case(f'{label} N={N} H={Hh} sd={sd} ad={ad} hid={hid}',
                        flops, bounds, k_ms, p_ms, max_abs_err=err,
                        gate_margin=margin)


def rollout_costs_phase(dev, torch, params, obs, goal, weights, walker):
    """TPU kernel #4 against its plain version on given actions (rtol
    1e-4): at the cheetah control step's shapes (B=1024 x K=1000
    candidates, H=30, sd 17: the exact (3, 7, 3) instantiation; the
    bench's random MLP), at the walker widths (``walker`` = (params, obs),
    sd 24: the exact (4, 7, 3) instantiation) with N = B K - 9, not a
    multiple of 16, and at a shape only the guarded instantiation takes
    (sd 40, hidden 64). Also times the fused sampler (#2) at the cheetah
    shapes."""
    from mujoco_mbrl_tpu_torch import models
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    sd, ad, hid = obs.shape[1], 6, params['l2']['w'].shape[0]
    acts, aT = candidates(dev, torch, B, H, ad, 13)
    main_case = hold_given(torch, 'rollout costs (given actions)', params,
                           states_t(obs), aT, goal, weights)
    del acts, aT
    cases = {'cheetah_sd17': main_case}
    w_params, w_obs = walker
    w_goal, w_weights = proposal(dev, torch)[:2]
    N = B * K - 9
    _, aT = candidates(dev, torch, B, H, ad, 16)
    cases['walker_sd24_ragged'] = hold_given(
        torch, 'rollout costs, walker widths, ragged N', w_params,
        states_t(w_obs)[:, :N].contiguous(), aT[..., :N].contiguous(),
        w_goal, w_weights)
    del aT
    gsd, ghid, gN, gH = 40, 64, 100003, 10
    g_params = models.MLPDynamics(gsd, ad, hidden_units=ghid).init(
        torch.Generator().manual_seed(4), device=dev)
    g = torch.Generator(device=dev).manual_seed(17)
    cases['guarded_sd40_hid64'] = hold_given(
        torch, 'rollout costs, guarded instantiation', g_params,
        torch.randn((gsd, gN), generator=g, device=dev),
        torch.rand((gH, ad, gN), generator=g, device=dev) * 2 - 1,
        torch.randn(gsd, generator=g, device=dev),
        torch.rand(gsd, generator=g, device=dev))
    main_case = dict(main_case, cases=cases)

    # the fused sampler (#2) at the same shapes, as the control step runs it
    g = torch.Generator(device=dev).manual_seed(14)
    mean = (0.3 * torch.randn((B, H, ad), generator=g, device=dev)).clamp(
        -0.9, 0.9)
    std = 0.2 + torch.rand((B, H, ad), generator=g, device=dev)
    with torch.no_grad():
        c_s, a_s = C.mlp_sample_rollout_costs(params, 7, obs, mean, std, goal,
                                              weights, K)
        ref_s = C.rollout_costs_of_actions(params, obs, a_s, goal, weights)
        s_err, _ = check_actions(torch, 'sampler sd 17', c_s, ref_s, a_s,
                                 mean, K)
        s_ms = time_ms(lambda: C.mlp_sample_rollout_costs(
            params, 7, obs, mean, std, goal, weights, K,
            sampler='triangular'), 5)
        sp_ms = time_ms(lambda: C.mlp_sample_rollout_costs_plain(
            params, 7, obs, mean, std, goal, weights, K,
            sampler='triangular'), 2)
    s_flops, *s_bounds = sampler_bound(B, K, H, sd, ad, hid)
    print(f'sampler triangular at the cheetah shapes (sd={sd}): max|cost - '
          f'plain(actions)| = {s_err:.3e}')
    return main_case, sampler_case(
        f'sampler triangular B={B} K={K} H={H} sd={sd}', s_flops, s_bounds,
        s_ms, sp_ms, max_abs_err=s_err)


def fitted_rollout_costs_check(dev, torch, loop, goal, weights):
    """Kernel #4 on the full loop's fitted MLP with the replay's
    normalizers folded in, from the policy rollouts' last states, against
    its plain version (rtol 1e-4), leaving out the candidates decided by
    rounding (see decided_by_rounding; at most 0.1%)."""
    from mujoco_mbrl_tpu_torch.models import train as Mt
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    p, buf = loop['params'], loop['replay']
    norms = Mt.make_normalizers(buf)
    Bc = buf.filled // 2            # the seed rollouts, then the policy's
    s0 = buf.observations[Bc:2 * Bc, -1].contiguous()
    acts, aT = candidates(dev, torch, Bc, H, 6, 15)
    s0T = states_t(s0)
    run_k = lambda: C.mlp_rollout_costs_t(p, s0T, aT, goal, weights,
                                          normalizers=norms)
    with torch.no_grad():
        costs = run_k().reshape(Bc, K)
        ref = C.rollout_costs_of_actions(p, s0, acts, goal, weights,
                                         normalizers=norms)
        c64 = lambda fold_dtype: folded_costs64(
            torch, C, p, norms, fold_dtype, s0, acts, goal, weights, 0.25)
        decided, n_dec, margin = decided_by_rounding(
            torch, 'fitted rollout costs', costs, ref, c64(torch.float64),
            c64(torch.float32))
        torch.testing.assert_close(costs[~decided], ref[~decided],
                                   rtol=1e-4, atol=1e-4)
        err = float((costs - ref)[~decided].abs().max())
        k_ms = time_ms(run_k, 5)
    print(f'fitted rollout costs (B={Bc} K={K} H={H}, folded normalizers): '
          f'max|kernel - plain| = {err:.3e} over the rest (max |cost| '
          f'{float(costs.abs().max()):.3f}); kernel {k_ms:.3f} ms')
    return dict(ms=k_ms, max_abs_err=err, rounding_decided_candidates=n_dec,
                gate_margin=margin)


def exact_counts(label, counts, **expected):
    """Every kernel's launch count: `expected` where named, else 0."""
    want = {k: expected.get(k, 0) for k in counts}
    check(counts == want, (label, counts, want))


def control_step(dev, torch, run, params, state0, gen, label, envs=B):
    """One warm-up run, then the timed run with a synchronize around each
    phase; returns (launch counts, times, final state, warm-up state)."""
    from mujoco_mbrl_tpu_torch import ops

    warm_state, _ = run(params, state0, gen)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    profile = {}
    t0 = time.perf_counter()
    state, rewards = run(params, warm_state, gen, profile=profile)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    for name, x in (('qpos', state.physics.qpos),
                    ('qvel', state.physics.qvel), ('reward', rewards)):
        check(bool(torch.isfinite(x).all()), (label, name))
    out = dict(ms_per_step=1e3 * wall / STEPS, wall_s=wall,
               plan_ms=1e3 * profile['plan'] / STEPS,
               physics_ms=1e3 * profile['physics'] / STEPS)
    print(f'{label}: {STEPS} control steps x {envs} envs in {wall:.3f} s = '
          f'{envs * STEPS / wall:.1f} env-steps/s, {out["ms_per_step"]:.2f} ms '
          f'per control step (plan {out["plan_ms"]:.2f} ms, physics '
          f'{out["physics_ms"]:.2f} ms); launches {counts}; mean reward per '
          f'step {rewards.tolist()}')
    return counts, out, state, warm_state


CPU_CHECK_ENVS = 256         # envs a card-vs-CPU step compares at most


def card_vs_cpu_step(dev, torch, domain, task, start, by_rounding=False,
                     task_kwargs=None, fields=('qpos',),
                     cpu_envs=CPU_CHECK_ENVS, envs=None):
    """One env.step of random actions from `start`: on the card at the
    path's whole batch, and with the plain versions on the CPU from the
    first `cpu_envs` of its envs, which are compared: the state's
    `fields` (qpos; the quadruped's qvel and act too) and the reward
    within 1e-3. With
    ``by_rounding`` (the hopper, whose contact solves run to the iteration
    cap in some envs), an env beyond that is admitted when rounding
    decides it: the CPU's float32 step itself moves by more than 1e-3
    from the same step in float64 there; at most 1% of the envs may be
    such, and every other env must agree. ``envs`` = (card env, CPU env)
    takes a composed environment's pair instead of suite.load's (a
    reward vector compares element by element)."""
    import dataclasses

    from mujoco_mbrl_tpu_torch import suite

    t0 = time.perf_counter()
    if envs is None:
        env = suite.load(domain, task, task_kwargs=task_kwargs, device=dev)
        env_cpu = suite.load(domain, task, task_kwargs=task_kwargs,
                             device='cpu')
    else:
        env, env_cpu = envs
    n_all = start.physics.qpos.shape[0]
    n = min(n_all, cpu_envs)
    acts_all = 2 * torch.rand((n_all, env.model.nu),
                              generator=torch.Generator().manual_seed(5)) - 1
    acts = acts_all[:n]
    cast = lambda x, dt=None: None if x is None else x.cpu().to(
        dt or x.dtype)
    to_cpu = lambda s, dt=None: type(s)(physics=type(s.physics)(
        qpos=cast(s.physics.qpos, dt), qvel=cast(s.physics.qvel, dt),
        time=cast(s.physics.time, dt), act=cast(s.physics.act, dt)),
        params=tree_map(torch, lambda x: x.cpu(), s.params),
        step_count=s.step_count.cpu(), last=s.last.cpu())
    s_gpu, ts_gpu = env.step(start, acts_all.to(dev))
    s_gpu = head_state(torch, s_gpu, n)
    ts_gpu = dataclasses.replace(ts_gpu, reward=ts_gpu.reward[:n])
    start = head_state(torch, start, n)
    s_cpu, ts_cpu = env_cpu.step(to_cpu(start), acts)
    diff = lambda s, ts, s_ref, ts_ref, f: (
        (ts.reward.cpu().double() - ts_ref.reward).abs().reshape(
            ts_ref.reward.shape[0], -1).amax(1) if f == 'reward'
        else (getattr(s.physics, f).cpu().double()
              - getattr(s_ref.physics, f)).abs().amax(1))
    keys = tuple(fields) + ('reward',)
    apart = lambda s, ts, s_ref, ts_ref: torch.stack(
        [diff(s, ts, s_ref, ts_ref, f) for f in keys]).amax(0)
    off = apart(s_gpu, ts_gpu, s_cpu, ts_cpu) >= 1e-3
    decided = torch.zeros_like(off)
    if by_rounding and bool(off.any()):
        m = env_cpu.model
        f64 = lambda o: dataclasses.replace(o, **{
            f.name: getattr(o, f.name).double() for f in dataclasses.fields(o)
            if isinstance(getattr(o, f.name), torch.Tensor)})
        env_cpu._model = f64(m).replace(opt=f64(m.opt))
        start64 = to_cpu(start, torch.float64)
        start64 = dataclasses.replace(start64, params=tree_map(
            torch, lambda x: x.double() if x.is_floating_point() else x,
            start64.params))
        s64, ts64 = env_cpu.step(start64, acts.double())
        decided = apart(s_cpu, ts_cpu, s64, ts64) >= 1e-3
    keep, n_dec = ~decided, int(decided.sum())
    out = {f'max_d{f}': float(diff(s_gpu, ts_gpu, s_cpu, ts_cpu, f)[keep]
                              .max()) for f in keys}
    shown = ', '.join(f'max|d{f}| {v:.2e}' for f, v in zip(keys,
                                                            out.values()))
    print(f'{domain}_{task} physics step, card at {n_all} envs vs plain CPU '
          f'at its first {n}: {shown} over {n - n_dec} envs; {n_dec} '
          f'decided by rounding (the '
          f'float32 CPU step beyond 1e-3 of the float64 one there); '
          f'{time.perf_counter() - t0:.1f} s')
    check(max(out.values()) < 1e-3, (domain, out))
    check(n_dec <= n // 100, (domain, n_dec))
    return dict(out, rounding_decided_envs=n_dec)


FULL_T, FULL_EPOCHS, FULL_BATCH = 10, 50, 512


def full_loop_phase(dev, torch):
    """bench.full_loop_bench at CONFIGS['cheetah1024']: B=1024, CEM 1000 x
    30 x 3, rollouts of 10 steps, the fit's 50 epochs at batch 512: the
    seed collection, then one timed iteration (collect -> add -> fit)."""
    from mujoco_mbrl_tpu_torch import bench, ops

    cfg = bench.config('cheetah1024')
    Bc, Kc, Hc = cfg['envs'], cfg['candidates'], cfg['horizon']
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loop = bench.full_loop_bench(cfg['task'], Bc, Kc, Hc, ITERS, FULL_T,
                                 repeats=1, device=dev,
                                 train_epochs=FULL_EPOCHS,
                                 train_batch=FULL_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    # 200 settling solves in the reset, one solve per control step of the
    # seed and the policy collection (1 substep), 3 CEM iterations per
    # policy step
    exact_counts('full loop', counts, apgd_factored=200 + 2 * FULL_T,
                 cem_sample_rollout=ITERS * FULL_T)
    losses = loop['losses']
    n_up = losses.shape[0]
    check(n_up == FULL_EPOCHS * (2 * Bc * FULL_T // FULL_BATCH), n_up)
    check(bool(torch.isfinite(losses).all()), 'non-finite training loss')
    first, last = float(losses[:n_up // 10].mean()), float(
        losses[-(n_up // 10):].mean())
    check(last < first, ('training loss did not decrease', first, last))
    phys = loop['env_state'].physics
    check(bool(torch.isfinite(phys.qpos).all()
               and torch.isfinite(phys.qvel).all()), 'non-finite state')
    check(loop['replay'].filled == 2 * Bc, loop['replay'].filled)
    times = {k: loop[k] for k in ('reset_s', 'seed_collect_s', 'collect_s',
                                  'add_s', 'fit_s', 'iteration_s',
                                  'env_steps_per_s')}
    print(f'full loop (cheetah1024: {Bc} envs, CEM {Kc}x{Hc}x{ITERS}, '
          f'{FULL_T}-step rollouts, fit {FULL_EPOCHS} epochs = {n_up} '
          f'updates at batch {FULL_BATCH}): '
          + ', '.join(f'{k} {v:.3f}' for k, v in times.items())
          + f'; loss {first:.4f} -> {last:.4f} (final '
          f'{loop["final_loss"]:.4f}); {wall:.1f} s in all; launches '
          f'{counts}')
    return counts, dict(times, final_loss=loop['final_loss']), loop


def cheetah_cli_phase(dev, torch, tmp):
    """The experiment CLI on cheetah_run: GoalStateAgent, single MLP over
    the 19-dim featured state, CEM 1000 candidates x 5 iterations
    (planner defaults), 20 seed and 5 policy rollouts of 10 steps."""
    from mujoco_mbrl_tpu_torch import experiment, ops

    args = experiment.parse_args([
        '--exp_dir', tmp, '--environment', 'cheetah_run', '--planner', 'cem',
        '--model', 'nn', '--num_rollouts_per_iteration', '5',
        '--rollout_length', '10', '--num_train_iterations', '1',
        '--train_epochs', '2'])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    agent = experiment.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    # three resets of 200 settling solves (the wrapper's observation spec
    # resets one env, then the seed and the policy collections), one solve
    # per control step of both collections; 5 CEM iterations per policy
    # step
    exact_counts('cheetah CLI', counts, apgd_factored=3 * 200 + 2 * 10,
                 cem_sample_rollout=5 * 10)
    check(os.path.exists(os.path.join(tmp, 'agent_final.pt')),
          'agent_final not written')
    buf = agent.dataset
    check(buf.filled == 25 and not agent.obs_only and agent.plan_dim == 19,
          (buf.filled, agent.obs_only, agent.plan_dim))
    check(bool(torch.isfinite(buf.states).all()), 'non-finite states')
    print(f'experiment CLI (cheetah_run, nn, 5 rollouts of 10 steps): '
          f'{wall:.3f} s; launches {counts}')
    return counts


def ptxas_info(name, marker):
    """Registers and spill bytes of the kernel instantiation of library
    ``name`` whose mangled name contains ``marker``, from nvcc's -Xptxas -v
    report (``_build.build_log``)."""
    import re
    from mujoco_mbrl_tpu_torch.ops import _build

    lines = _build.build_log(name).splitlines()
    for i, line in enumerate(lines):
        if 'Compiling entry' in line and marker in line:
            info = {'entry': line.split("'")[1]}
            for nxt in lines[i + 1:i + 6]:
                m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                              r'loads', nxt)
                if m:
                    info['spill_stores'] = int(m.group(1))
                    info['spill_loads'] = int(m.group(2))
                m = re.search(r'Used (\d+) registers', nxt)
                if m:
                    info['registers'] = int(m.group(1))
                    break
            return info
    raise RuntimeError(f'no ptxas report for {marker} in lib{name}')


def limit_cases(dev, torch):
    """The dense APGD kernel's one-row-a-lane instantiation on the solves
    of the contact-free domains, captured from the port at B envs (a cold
    step, then a warm one): the reacher's one wrist-limit row with the
    wrist at +-2.75..2.80 rad moving outward (the limit at 2.7925, so the
    row turns active on the way), the point_mass's two slide-limit rows at
    +-0.285..0.30 pushing out, and an all-inactive batch (the wrist at
    rest mid-range)."""
    from types import SimpleNamespace

    from mujoco_mbrl_tpu_torch import suite
    from mujoco_mbrl_tpu_torch.physics.model import State

    g = torch.Generator(device=dev).manual_seed(21)
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)
    sign = torch.where(u(B) < 0.5, -1.0, 1.0)
    start = lambda qpos, qvel: SimpleNamespace(physics=State(
        qpos=qpos, qvel=qvel, time=torch.zeros(B, device=dev)))
    shoulder = lambda: torch.stack([(2 * u(B) - 1) * 3.14159,
                                    torch.randn(B, generator=g, device=dev)])
    env = suite.load('reacher', 'easy', device=dev)
    cases = []
    for tag, wrist, wvel in (
            ('reacher-nr1', sign * (2.75 + 0.05 * u(B)),
             sign * (1.0 + 2.0 * u(B))),
            ('reacher-nr1-inactive', 2.0 * u(B) - 1.0,
             torch.zeros(B, device=dev))):
        q0, v0 = shoulder()
        cases += capture_solves(
            dev, torch, env, start(torch.stack([q0, wrist], 1),
                                   torch.stack([v0, wvel], 1)),
            tag, 'apgd_iterate_batched')
    env = suite.load('point_mass', 'easy', device=dev)
    cases += capture_solves(
        dev, torch, env, start(sign[:, None] * (0.285 + 0.015 * u(B, 2)),
                               sign[:, None] * (0.5 + 1.5 * u(B, 2))),
        'point_mass-nr2', 'apgd_iterate_batched')
    for tag, args, kw in cases:
        n_act = int(args[4].sum())
        print(f'apgd {tag} cold={kw["cold"]}: nr {args[0].shape[1]}, '
              f'{n_act} of {args[4].numel()} limit rows active')
        check((n_act == 0) == tag.endswith('inactive'), (tag, n_act))
    return cases


def limit_apgd_phase(dev, torch):
    """TPU kernel #1 at 1 and 2 rows (apgd_warp_kernel<1>, 31 or 30 empty
    lanes) against its plain version, with the dense kernel's tolerance and
    rounding allowance; device time, APGD iterations and time per
    dependent step of each case."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    cases = limit_cases(dev, torch)
    worst, rounding_envs = hold_apgd(
        torch, 'apgd', A.apgd_iterate_batched, A.apgd_iterate_plain,
        lambda args: args[0], cases)
    times = time_apgd(
        torch, 'apgd', A.apgd_iterate_batched, A.apgd_iterate_plain, cases,
        lambda a: 2.0 * a[1].shape[1] ** 2,
        lambda a: 4.0 * (a[0].numel() + 6 * a[1].numel() + 2 * a[1].shape[1]),
        trace_bound=False)
    return worst, rounding_envs, times


def reacher256_phase(dev, torch):
    """CONFIGS['reacher256'] (reacher_easy, 256 envs, CEM 500 x 20 x 3):
    build_bench's route rule sends the 6 + 2 dims to cem_batched's model /
    cost scan (no sampler launch); the suite env steps once per control
    step (timestep 0.02 = control timestep), one dense APGD launch for the
    wrist-limit row. Then #2 at that shape (the bench's random MLP, the
    exact (1, 7, 1) instantiation) against its plain version, timed."""
    from mujoco_mbrl_tpu_torch import bench, suite

    cfg = bench.config('reacher256')
    Br, Kr, Hr = cfg['envs'], cfg['candidates'], cfg['horizon']
    run, (params, state0, gen) = bench.build_bench(
        cfg['task'], Br, Kr, Hr, ITERS, STEPS, device=dev)
    counts, out, state, warm = control_step(
        dev, torch, run, params, state0, gen, 'reacher256 control step',
        envs=Br)
    exact_counts('reacher256 control step', counts, apgd_solve=STEPS)
    check(state.physics.qpos.shape == (Br, 2), state.physics.qpos.shape)
    out.update(profile_phase(torch, run, params, state, gen, out['wall_s']))

    env = suite.load('reacher', 'easy', device=dev)
    obs = suite.flatten_observation(env._observe(
        env._model_with(warm.params), warm.physics, warm.params))
    goal = torch.zeros(obs.shape[1], device=dev)
    goal[1] = 1.0
    case = sampler_shape_case(
        dev, torch, 'sampler reacher256', params, obs, goal,
        torch.ones(obs.shape[1], device=dev), Kr, Hr,
        torch.Generator(device=dev).manual_seed(22), 7, (1, 7, 1, True, True),
        reps=20)
    return counts, out, case


def sampler_shape_case(dev, torch, label, params, s0, goal, weights, Kc,
                       Hc, g, seed, instantiation, reps=5):
    """#2 at one shape: start states s0 (B, sd), a random CEM proposal
    (B, Hc, ad) drawn from the generator ``g``, the sampler's noise from
    ``seed``; the instantiation dispatch takes checked against
    ``instantiation`` (C.sampler_instantiation); the costs held to the
    plain cost of the kernel's own actions (rtol 1e-4) with the action
    checks, and the kernel timed beside both bounds."""
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    (Bs, sd), hid = s0.shape, params['l2']['w'].shape[0]
    ad = params['l1']['w'].shape[0] - sd
    taken = C.sampler_instantiation(Kc, Hc, sd, ad, hid)
    check(taken == instantiation, (label, taken, instantiation))
    mean = (0.3 * torch.randn((Bs, Hc, ad), generator=g, device=dev)).clamp(
        -0.9, 0.9)
    std = 0.2 + torch.rand((Bs, Hc, ad), generator=g, device=dev)
    args = (params, seed, s0, mean, std, goal, weights, Kc)
    with torch.no_grad():
        costs, acts = C.mlp_sample_rollout_costs(*args)
        ref = C.rollout_costs_of_actions(params, s0, acts, goal, weights)
        err, pair = check_actions(torch, label, costs, ref, acts, mean, Kc)
        k_ms = time_ms(lambda: C.mlp_sample_rollout_costs(*args), reps)
        p_ms = time_ms(lambda: C.mlp_sample_rollout_costs_plain(*args), 2)
    flops, *bounds = sampler_bound(Bs, Kc, Hc, sd, ad, hid)
    print(f'{label} (B={Bs} K={Kc} H={Hc} sd={sd} ad={ad} hidden={hid}; '
          f'instantiation {taken}): max|cost - plain(actions)| = '
          f'{err:.3e}; antithetic max dev {pair:.2e}')
    return sampler_case(f'{label} B={Bs} K={Kc} H={Hc} sd={sd}', flops,
                        bounds, k_ms, p_ms, max_abs_err=err,
                        instantiation=list(taken))


def guarded_sampler_case(dev, torch):
    """#2 at a layout no exact instantiation takes (sd 40 + ad 6, hidden
    64: 8 hidden tiles), so dispatch sends it to the guarded (16, 16, 16)
    instantiation with the weights read from global memory; a random MLP,
    256 envs x 500 candidates x horizon 20."""
    from mujoco_mbrl_tpu_torch.models import MLPDynamics

    Bg, sd, ad = 256, 40, 6
    params = MLPDynamics(sd, ad, hidden_units=64).init(
        torch.Generator().manual_seed(24), device=dev)
    g = torch.Generator(device=dev).manual_seed(24)
    s0 = torch.randn((Bg, sd), generator=g, device=dev)
    goal = torch.randn(sd, generator=g, device=dev)
    weights = torch.rand(sd, generator=g, device=dev)
    return sampler_shape_case(dev, torch, 'sampler guarded (16, 16, 16)',
                              params, s0, goal, weights, 500, 20, g, 9,
                              (16, 16, 16, False, False), reps=20)


def reacher_agent_phase(dev, torch, tmp):
    """GoalStateAgent.train() on reacher_easy at full width: the single MLP
    (hidden 50) over the 6-dim observation, CEM 1000 x 30 x 3, 1024 seed +
    1024 policy rollouts cut to AGENT_T steps, one fit of AGENT_EPOCHS
    epochs at batch 512. The Reacher wrapper's 0.04 s control step is 2
    physics substeps (two dense APGD launches a control step); the
    sampler's exact (1, 7, 1) instantiation plans. Then #2 on the fitted
    params at the loop's shapes."""
    from mujoco_mbrl_tpu_torch import agents, data, envs, models, ops
    from mujoco_mbrl_tpu_torch import planners
    from mujoco_mbrl_tpu_torch.models import train as Mt
    from mujoco_mbrl_tpu_torch.utils import MetricsWriter

    env = envs.load('reacher', 'easy', device=dev)
    check(env.env._n_sub_steps == 2, env.env._n_sub_steps)
    model = models.MLPDynamics(env.observation_dim, env.action_dim,
                               hidden_units=50)
    dataset = data.init_replay(2 * B, AGENT_T, env.state_dim,
                               env.observation_dim, env.action_dim,
                               device=dev)
    writer = MetricsWriter(tmp)
    agent = agents.GoalStateAgent(
        environment=env, planner=planners.CEMPlanner, model=model,
        horizon=H, optimizer=Mt.adam(0.01), rollout_length=AGENT_T,
        num_rollouts_per_iteration=B, num_train_iterations=1, writer=writer,
        base_path=tmp, dataset=dataset,
        planner_kwargs=dict(num_candidates=K, num_elites=K // 10,
                            num_iterations=ITERS),
        train_epochs=AGENT_EPOCHS, train_batch_size=AGENT_BATCH,
        num_initial_rollouts=B, seed=0)
    check(agent.obs_only and agent.plan_dim == 6,
          (agent.obs_only, agent.plan_dim))
    phases = []

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            phases.append((name, time.perf_counter() - t0, out))
            return out
        return run

    agent.add_rollouts = timed('collect', agent.add_rollouts)
    agent.fit_model = timed('fit', agent.fit_model)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    agent.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    writer.close()
    check([p[0] for p in phases] == ['collect', 'fit', 'collect'],
          [p[0] for p in phases])
    # 3 CEM iterations per policy step; 2 physics substeps per control
    # step of both collections, one solve each (the observation forwards
    # stop at the velocity stage)
    exact_counts('reacher agent loop', counts,
                 cem_sample_rollout=ITERS * AGENT_T,
                 apgd_solve=2 * 2 * AGENT_T)
    buf = agent.dataset
    check(buf.filled == 2 * B, buf.filled)
    for name in ('states', 'observations', 'actions', 'rewards'):
        check(bool(torch.isfinite(getattr(buf, name)).all()), name)
    losses = phases[1][2].losses
    n_up = losses.shape[0]
    check(n_up == AGENT_EPOCHS * (2 * B * AGENT_T // AGENT_BATCH), n_up)
    check(bool(torch.isfinite(losses).all()), 'non-finite training loss')
    first, last = float(losses[:n_up // 10].mean()), float(
        losses[-(n_up // 10):].mean())
    check(last < first, ('training loss did not decrease', first, last))
    times = {'seed_collect_s': phases[0][1], 'fit_s': phases[1][1],
             'policy_collect_s': phases[2][1], 'train_s': wall}
    print(f'reacher agent loop (reacher_easy, MLP, {B} + {B} rollouts of '
          f'{AGENT_T} control steps, fit {AGENT_EPOCHS} epochs = {n_up} '
          f'updates): ' + ', '.join(f'{k} {v:.3f}' for k, v in times.items())
          + f'; loss {first:.4f} -> {last:.4f}; launches {counts}')
    obs = phases[2][2].observations[:, -1].contiguous()
    check(obs.shape == (B, 6), obs.shape)
    fitted = fitted_sampler_check(dev, torch, 'reacher agent MLP sampler',
                                  agent, obs, H, 'normal')
    return counts, times, fitted


def cli_fitted_phase(dev, torch, tmp, environment, obs_only, instantiation,
                     **solves):
    """The experiment CLI on `environment` (the contact-free domains, the
    humanoid, cartpole, hopper, swimmer): GoalStateAgent, single MLP, the
    default sampler, CEM 1000
    candidates x 5 iterations, 20 seed and 5 policy rollouts of 10 control
    steps, 1 iteration of 2 epochs; `obs_only` whether the agent must plan
    in the observation (else in the featured state), `instantiation` the
    sampler instantiation its plan takes (as sampler_shape_case checks it),
    `solves` the APGD launches expected of the two collections. At 5 envs the JAX agent's grouped kernel runs one
    env per program (_sample_kernel); here it is the same sampler kernel.
    Then that kernel on the fitted params at the CLI's shapes (the 5
    policy rollouts' last states in the plan space: the observation, or
    the featured state where the agent plans in it), as the walker CLI
    phase holds it."""
    from mujoco_mbrl_tpu_torch import experiment, ops
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    args = experiment.parse_args([
        '--exp_dir', tmp, '--environment', environment, '--planner', 'cem',
        '--model', 'nn', '--num_rollouts_per_iteration', '5',
        '--rollout_length', '10', '--num_train_iterations', '1',
        '--train_epochs', '2'])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    agent = experiment.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    # one APGD solve per physics substep of the seed and the policy
    # collections (10 control steps each); 5 CEM iterations per policy step
    exact_counts(f'{environment} CLI', counts, cem_sample_rollout=5 * 10,
                 **solves)
    check(os.path.exists(os.path.join(tmp, 'agent_final.pt')),
          'agent_final not written')
    buf = agent.dataset
    check(buf.filled == 25 and buf.cursor == 25
          and agent.obs_only == obs_only,
          (buf.filled, buf.cursor, agent.obs_only))
    plan = buf.observations if obs_only else buf.states
    check(bool(torch.isfinite(plan).all()), 'non-finite plan-space states')
    print(f'experiment CLI ({environment}, nn, 5 rollouts of 10 steps): '
          f'{wall:.3f} s; launches {counts}')
    # the 5 policy rollouts follow the 20 seed rollouts in the ring
    obs = plan[20:25, -1].contiguous()
    check(obs.shape == (5, agent.plan_dim) and agent.horizon == 20,
          (obs.shape, agent.horizon))
    taken = C.sampler_instantiation(
        K, agent.horizon, agent.plan_dim, agent.environment.action_dim,
        agent.params['l2']['w'].shape[-1])
    check(taken == instantiation, (environment, taken, instantiation))
    print(f'{environment} CLI sampler: instantiation {taken}')
    fitted = fitted_sampler_check(dev, torch, f'{environment} CLI sampler',
                                  agent, obs, agent.horizon, 'normal')
    fitted['instantiation'] = list(taken)
    return counts, wall, fitted


def pendulum_phase(dev, torch):
    """pendulum_swingup, one step of random actions on the card against
    the CPU's from the same reset states: no constraint row (contacts off,
    no limit), so the solver returns before any kernel."""
    from mujoco_mbrl_tpu_torch import ops, suite

    env = suite.load('pendulum', 'swingup', device=dev)
    start, _ = env.reset(B, torch.Generator().manual_seed(4))
    ops.reset_launch_counts()
    card_vs_cpu_step(dev, torch, 'pendulum', 'swingup', start)
    counts = dict(ops.launch_counts)
    exact_counts('pendulum step', counts)
    return counts


HUMANOID_SUBSTEPS = 5        # 0.025 s control step over 0.005 s physics


def humanoid_control_step_phase(dev, torch):
    """(a) CONFIGS['humanoid']: humanoid_walk, 512 envs, CEM 1000 x 30 x 3
    through the fused sampler (67 + 21 dims: the (11, 7, 9)
    instantiation), 5 physics substeps a control step, each one factored
    APGD launch on the block path (303 rows, nv 27); the physics of a
    control step against the CPU's; a profile (device-busy share)."""
    from mujoco_mbrl_tpu_torch import bench

    cfg = bench.config('humanoid')
    Bh, Kh, Hh = cfg['envs'], cfg['candidates'], cfg['horizon']
    run, (params, state0, gen) = bench.build_bench(
        cfg['task'], Bh, Kh, Hh, ITERS, STEPS, device=dev)
    counts, out, state, warm = control_step(
        dev, torch, run, params, state0, gen, 'humanoid control step',
        envs=Bh)
    exact_counts('humanoid control step', counts,
                 cem_sample_rollout=ITERS * STEPS,
                 apgd_factored=HUMANOID_SUBSTEPS * STEPS)
    check(state.physics.qpos.shape == (Bh, 28), state.physics.qpos.shape)
    out['card_vs_cpu'] = card_vs_cpu_step(dev, torch, 'humanoid', 'walk',
                                          warm)
    out.update(profile_phase(torch, run, params, state, gen, out['wall_s']))
    return counts, out, params, state0, warm


def humanoid_factored_phase(dev, torch, state0):
    """(b) #7's block path against its plain version on solves captured
    from humanoid_walk at the preset's 512 envs: at the reset states
    (rejection-sampled, in the air) and after 20 control steps of random
    actions (landed, limbs in floor contact), cold and warm, with the
    dense kernel's tolerance and rounding allowance; timed, with its
    largest iteration count, time per dependent step and the latency of
    one APGD iteration."""
    from mujoco_mbrl_tpu_torch import suite

    env = suite.load('humanoid', 'walk', device=dev)
    n = state0.physics.qpos.shape[0]
    moving, g_act = state0, torch.Generator(device=dev).manual_seed(8)
    for _ in range(20):
        moving, _ = env.step(moving, 2 * torch.rand(
            (n, env.model.nu), generator=g_act, device=dev) - 1)
    cases = (capture_solves(dev, torch, env, state0, 'humanoid-reset',
                            'apgd_iterate_factored')
             + capture_solves(dev, torch, env, moving, 'humanoid-moving',
                              'apgd_iterate_factored'))
    worst, rounding_envs, times = hold_time_factored(torch, cases)
    tag, args, kw = cases[-1]
    check(tag == 'humanoid-moving' and not kw['cold'], tag)
    return worst, rounding_envs, times, factored_iteration_ns(
        torch, tag, args, kw)


def humanoid_sampler_case(dev, torch, params, warm):
    """(c) #2 at the preset's shape: the bench's random MLP (67-50-50-67)
    over the observations of the control step's warm-up states, 512 envs
    x 1000 candidates x horizon 30, ad 21 (the (11, 7, 9) instantiation,
    run-time loop bounds, weights in shared memory)."""
    from mujoco_mbrl_tpu_torch import suite

    env = suite.load('humanoid', 'walk', device=dev)
    obs = suite.flatten_observation(env._observe(env.model, warm.physics,
                                                 ()))
    check((obs.shape[1], env.model.nu) == (67, 21), obs.shape)
    goal = torch.zeros(obs.shape[1], device=dev)
    goal[1] = 1.0
    return sampler_shape_case(
        dev, torch, 'sampler humanoid', params, obs, goal,
        torch.ones(obs.shape[1], device=dev), K, H,
        torch.Generator(device=dev).manual_seed(25), 7,
        (11, 7, 9, False, True))


HOPPER_SOLVES = 5            # 4 substeps + the observation's forward
RK4_SOLVES = 4               # cartpole: one RK4 step a control step


def cartpole_control_step_phase(dev, torch):
    """(16) CONFIGS['cartpole']: cartpole_swingup, 128 envs, CEM 1000 x 30
    x 3 through cem_batched's model / cost scan (5 + 1 dims: no sampler
    launch); one RK4 step a control step, four cold one-row solves (#1's
    apgd_warp_kernel<1>); the physics against the CPU's; a profile."""
    from mujoco_mbrl_tpu_torch import bench

    cfg = bench.config('cartpole')
    Bc, Kc, Hc = cfg['envs'], cfg['candidates'], cfg['horizon']
    run, (params, state0, gen) = bench.build_bench(
        cfg['task'], Bc, Kc, Hc, ITERS, STEPS, device=dev)
    counts, out, state, warm = control_step(
        dev, torch, run, params, state0, gen, 'cartpole control step',
        envs=Bc)
    exact_counts('cartpole control step', counts,
                 apgd_solve=RK4_SOLVES * STEPS)
    check(state.physics.qpos.shape == (Bc, 2), state.physics.qpos.shape)
    out['card_vs_cpu'] = card_vs_cpu_step(dev, torch, 'cartpole', 'swingup',
                                          warm)
    out.update(profile_phase(torch, run, params, state, gen, out['wall_s']))
    return counts, out


def small_row_cases(dev, torch):
    """#1's one-row-a-lane instantiation on solves captured from the
    port at B envs: cartpole's slider-limit row (the cart at +-1.79..1.83
    moving outward, the limit at 1.8: eight cold RK4 stage solves, one
    kept for timing), and swimmer6's five joint-limit rows (the joints at
    +-1.03..1.08 rad moving outward, the limit at 60 degrees; a cold
    substep, then a warm one)."""
    from types import SimpleNamespace

    from mujoco_mbrl_tpu_torch import suite
    from mujoco_mbrl_tpu_torch.physics.model import State

    g = torch.Generator(device=dev).manual_seed(23)
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)
    sign = lambda *shape: torch.where(u(*shape) < 0.5, -1.0, 1.0)
    start = lambda qpos, qvel: SimpleNamespace(physics=State(
        qpos=qpos, qvel=qvel, time=torch.zeros(B, device=dev)))
    sc = sign(B)
    cart = capture_solves(dev, torch, suite.load('cartpole', 'swingup',
                                                 device=dev),
                          start(torch.stack([sc * (1.79 + 0.04 * u(B)),
                                             6.3 * u(B) - 3.15], 1),
                                torch.stack([sc * (0.5 + 1.5 * u(B)),
                                             torch.randn(B, generator=g,
                                                         device=dev)], 1)),
                          'cartpole-nr1', 'apgd_iterate_batched')
    ss = sign(B, 5)
    qpos = torch.zeros((B, 8), device=dev)
    qvel = torch.zeros((B, 8), device=dev)
    qpos[:, 3:] = ss * (1.03 + 0.05 * u(B, 5))
    qvel[:, 3:] = ss * (0.5 + 1.5 * u(B, 5))
    swim = capture_solves(dev, torch, suite.load('swimmer', 'swimmer6',
                                                 device=dev),
                          start(qpos, qvel), 'swimmer6-nr5',
                          'apgd_iterate_batched')
    for tag, args, kw in cart + swim:
        n_act = int(args[4].sum())
        check(n_act > 0, (tag, n_act))
    print(f'apgd cartpole-nr1: {len(cart)} cold RK4 stage solves, '
          f'{int(cart[0][1][4].sum())} of {B} rows active in the first; '
          f'swimmer6-nr5: {int(swim[0][1][4].sum())} of {5 * B} rows '
          f'active (cold)')
    return cart, swim


def small_row_apgd_phase(dev, torch):
    """#1 at cartpole's 1 row and swimmer6's 5 (apgd_warp_kernel<1>)
    against its plain version under the one APGD rule, and timed as the
    dense kernel (cartpole: its first stage solve)."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    cart, swim = small_row_cases(dev, torch)
    worst, rounding_envs = hold_apgd(
        torch, 'apgd', A.apgd_iterate_batched, A.apgd_iterate_plain,
        lambda args: args[0], cart + swim)
    times = time_apgd(
        torch, 'apgd', A.apgd_iterate_batched, A.apgd_iterate_plain,
        cart[:1] + swim, lambda a: 2.0 * a[1].shape[1] ** 2,
        lambda a: 4.0 * (a[0].numel() + 6 * a[1].numel() + 2 * a[1].shape[1]),
        trace_bound=False)
    return worst, rounding_envs, times


def hopper_control_step_phase(dev, torch):
    """(18) the JAX bench's --task hopper_hop at its defaults: 1024 envs,
    CEM 1000 x 30 x 3 through the fused sampler at the 15-dim observation
    and 4 actions (the (3, 7, 2) tiles); a control step is 4 substeps and
    the observation's forward (the touch sensors read its contact
    forces), each one 88-row dense solve on #1's block path; the first
    observation of a run solves once more. The physics against the CPU's;
    a profile."""
    from mujoco_mbrl_tpu_torch import bench

    run, (params, state0, gen) = bench.build_bench(
        'hopper_hop', B, K, H, ITERS, STEPS, device=dev)
    counts, out, state, warm = control_step(
        dev, torch, run, params, state0, gen, 'hopper control step')
    exact_counts('hopper control step', counts,
                 cem_sample_rollout=ITERS * STEPS,
                 apgd_solve=1 + HOPPER_SOLVES * STEPS)
    check(state.physics.qpos.shape == (B, 7), state.physics.qpos.shape)
    out['card_vs_cpu'] = card_vs_cpu_step(dev, torch, 'hopper', 'hop', warm,
                                          by_rounding=True)
    out.update(profile_phase(torch, run, params, state, gen, out['wall_s']))
    return counts, out, params, state0, warm


def hopper_block_phase(dev, torch, state0):
    """(19) #1's block path (apgd_block_kernel, 88 rows) against its plain
    version on solves captured from hopper_hop at 1024 envs: at the reset
    states (random pitch, falling) and after 20 control steps of random
    actions (fallen, in floor contact), cold and warm, under the one APGD
    rule (rtol = atol = 2e-4, at most 1% of envs decided by rounding);
    device time from a CUDA graph, the largest iteration count, us per
    dependent step and ns per APGD iteration beside the FP32 bound."""
    from mujoco_mbrl_tpu_torch import suite
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    env = suite.load('hopper', 'hop', device=dev)
    moving, g_act = state0, torch.Generator(device=dev).manual_seed(9)
    for _ in range(20):
        moving, _ = env.step(moving, 2 * torch.rand(
            (B, env.model.nu), generator=g_act, device=dev) - 1)
    cases = (capture_solves(dev, torch, env, state0, 'hopper-reset',
                            'apgd_iterate_batched')
             + capture_solves(dev, torch, env, moving, 'hopper-contact',
                              'apgd_iterate_batched'))
    for tag, args, kw in cases:
        check(args[0].shape[1:] == (88, 88), (tag, args[0].shape))
        print(f'apgd {tag} cold={kw["cold"]}: nr 88, '
              f'{int(args[4].sum())} of {args[4].numel()} rows active, '
              f'{int((args[4][:, 4:].sum(1) > 0).sum())} of {B} envs in '
              f'contact')
    worst, rounding_envs = hold_apgd(
        torch, 'apgd block', A.apgd_iterate_batched, A.apgd_iterate_plain,
        lambda args: args[0], cases)
    times = time_apgd(
        torch, 'apgd block', A.apgd_iterate_batched, A.apgd_iterate_plain,
        cases, lambda a: 2.0 * a[1].shape[1] ** 2,
        lambda a: 4.0 * (a[0].numel() + 6 * a[1].numel() + 2 * a[1].shape[1]),
        trace_bound=False)
    tag, args, kw = cases[-1]
    check(tag == 'hopper-contact' and not kw['cold'], tag)
    cap = lambda n: device_ms(lambda: A.apgd_iterate_batched(
        *args, **dict(kw, iterations=n, tol2=0.0)), 20)
    t1, t41 = cap(1), cap(41)
    iteration_ns = 1e6 * (t41 - t1) / 40
    print(f'apgd block {tag}-warm, tol2 = 0: {t1:.4f} ms at 1 iteration, '
          f'{t41:.4f} ms at 41: {iteration_ns:.0f} ns per APGD iteration')
    return worst, rounding_envs, times, iteration_ns


def hopper_sampler_case(dev, torch, params, warm):
    """#2 at the hopper bench's shape: its random MLP (15-50-50-15) over
    the observations of the control step's warm-up states, 1024 envs x
    1000 candidates x horizon 30, ad 4: the sized (3, 7, 2) instantiation,
    held to one block an SM (no spill)."""
    from mujoco_mbrl_tpu_torch import suite

    env = suite.load('hopper', 'hop', device=dev)
    obs = suite.flatten_observation(env._observe(env.model, warm.physics,
                                                 ()))
    check((obs.shape[1], env.model.nu) == (15, 4), obs.shape)
    goal = torch.zeros(obs.shape[1], device=dev)
    goal[1] = 1.0
    return sampler_shape_case(
        dev, torch, 'sampler hopper', params, obs, goal,
        torch.ones(obs.shape[1], device=dev), K, H,
        torch.Generator(device=dev).manual_seed(26), 7,
        (3, 7, 2, True, True))


def acrobot_phase(dev, torch):
    """(22) acrobot_swingup, one step of random actions on the card
    against the CPU's from the same reset states: RK4, contacts and limits
    off, so no constraint row and no launch."""
    from mujoco_mbrl_tpu_torch import ops, suite

    env = suite.load('acrobot', 'swingup', device=dev)
    start, _ = env.reset(B, torch.Generator().manual_seed(6))
    ops.reset_launch_counts()
    out = card_vs_cpu_step(dev, torch, 'acrobot', 'swingup', start)
    counts = dict(ops.launch_counts)
    exact_counts('acrobot step', counts)
    return counts, out


# ---- slice 11: the per-env planners, the other models, RewardAgent -----

PER_ENV_T = 10               # control steps of each collection, paths 23-27
PER_ENV_B = 5                # the CLI's policy rollouts (planned per env)


@contextlib.contextmanager
def timed_calls(torch, log, targets):
    """Times every call of the (owner, method name, label) ``targets``
    between two synchronizes into ``log`` as (label, start, seconds); the
    methods are put back on exit."""
    saved = [(owner, name, owner.__dict__[name]) for owner, name, _ in targets]

    def wrap(fn, label):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            log.append((label, t0, time.perf_counter() - t0))
            return out
        return run
    try:
        for (owner, name, fn), (_, _, label) in zip(saved, targets):
            setattr(owner, name, wrap(fn, label))
        yield log
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def run_cli(torch, label, argv, **solves):
    """The experiment CLI on ``argv`` with every launch count zeroed just
    before and read just after: (agent, counts, seconds). ``solves`` are
    the APGD launches expected; no other kernel may launch."""
    from mujoco_mbrl_tpu_torch import experiment, ops

    args = experiment.parse_args(argv)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    agent = experiment.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    exact_counts(label, counts, **solves)
    buf = agent.dataset
    check(buf.filled == 20 + PER_ENV_B, (label, buf.filled))
    for name in ('states', 'observations', 'actions', 'rewards'):
        check(bool(torch.isfinite(getattr(buf, name)).all()), (label, name))
    return agent, counts, wall


def cli_argv(tmp, environment, *extra):
    return ['--exp_dir', tmp, '--environment', environment,
            '--rollout_length', str(PER_ENV_T), '--num_train_iterations', '1',
            '--train_epochs', '2', *extra]


def walker_rs_cli_phase(dev, torch, tmp):
    """(23) the JAX CLI's defaults on walker_walk: GoalStateAgent, random
    shooting (1000 candidates, horizon 20) per env over the MLP (hidden 50)
    of the 20-dim featured state, 5 rollouts planned in lockstep; 20 seed
    and 5 policy rollouts of 10 control steps, one fit of 2 epochs. Each
    control step's 10 substeps are 10 #1 launches; random shooting
    launches no kernel (JAX rolls it through XLA). Times the phases and,
    per control step of the policy collection, the plan (the per-env
    policy's call) and the physics (the env step)."""
    from mujoco_mbrl_tpu_torch import agents, experiment, models, planners
    from mujoco_mbrl_tpu_torch.suite.control import Environment

    argv = cli_argv(tmp, 'walker_walk')
    args = experiment.parse_args(argv)
    check((str(args.agent), str(args.planner), str(args.model), args.horizon,
           args.num_rollouts_per_iteration) == ('gs', 'rs', 'nn', 20,
                                                PER_ENV_B), args)
    log = []
    with timed_calls(torch, log, [
            (agents.MPCAgent, 'add_rollouts', 'collect'),
            (agents.MPCAgent, 'fit_model', 'fit'),
            (agents.MPCPolicy, '__call__', 'plan'),
            (Environment, 'step_with_data', 'physics')]):
        agent, counts, wall = run_cli(torch, 'walker rs CLI', argv,
                                      apgd_solve=10 * 2 * PER_ENV_T)
    check(agent.planner is planners.RandomShootingPlanner
          and type(agent.model) is models.MLPDynamics
          and agent.obs_only is False, (agent.planner, agent.model))
    check(float(agent.dataset.actions.abs().max()) <= 1.0, 'action range')
    collect = [e for e in log if e[0] == 'collect']
    fit = [e for e in log if e[0] == 'fit']
    plans = [e for e in log if e[0] == 'plan']
    check(len(collect) == 2 and len(fit) == 1 and len(plans) == PER_ENV_T,
          [e[0] for e in log if e[0] != 'physics'])
    start, span = collect[1][1], collect[1][2]
    physics = [e[2] for e in log if e[0] == 'physics'
               and start <= e[1] <= start + span]
    check(len(physics) == PER_ENV_T, len(physics))
    times = dict(cli_s=wall, seed_collect_s=collect[0][2], fit_s=fit[0][2],
                 policy_collect_s=span,
                 plan_ms=1e3 * sum(e[2] for e in plans) / PER_ENV_T,
                 physics_ms=1e3 * sum(physics) / PER_ENV_T)
    print('walker rs CLI (gs / rs / nn, K 1000, H 20, B 5): '
          + ', '.join(f'{k} {v:.3f}' for k, v in times.items())
          + f' (plan and physics ms per control step); launches {counts}')
    return counts, times, agent


def walker_cem_policy_phase(dev, torch, rs_agent):
    """(24) per-env CEM through CEMPlanner.plan at the walker's width:
    1000 candidates, 100 elites, 5 iterations, horizon 20, on path 23's
    fitted MLP and goal, from the 5 policy rollouts' last featured states;
    two control steps (t = 0 from zeros, t = 1 warm-started). This is the
    policy GoalStateAgent.get_action builds; get_action itself fails on
    the walker as JAX's does (it passes the policy no state, and the
    walker plans on states), which is checked first. No kernel launches."""
    from mujoco_mbrl_tpu_torch import agents, ops, planners
    from mujoco_mbrl_tpu_torch.models import train as Mt

    agent = agents.GoalStateAgent(
        environment=rs_agent.environment, planner=planners.CEMPlanner,
        model=rs_agent.model, horizon=20, optimizer=Mt.adam(0.01),
        rollout_length=PER_ENV_T, num_rollouts_per_iteration=PER_ENV_B,
        num_train_iterations=1, writer=None, base_path='',
        dataset=rs_agent.dataset, seed=1)
    agent.params = rs_agent.params
    agent.training_goal_state = rs_agent.training_goal_state
    buf = agent.dataset
    try:
        agent.get_action(torch.Generator(), buf.observations[20, -1])
        check(False, 'walker get_action ran; JAX fails there')
    except AttributeError as e:
        check("'NoneType'" in str(e), str(e))
    states = buf.states[20:20 + PER_ENV_B, -1].contiguous()
    policy = agent._make_policy(agent.params, agent._normalizers(),
                                agent.training_goal_state)
    gen, carry, times = torch.Generator().manual_seed(2), policy.init_carry(), []
    ops.reset_launch_counts()
    for t in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acts, carry = policy(gen, t, states, None, carry)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    counts = dict(ops.launch_counts)
    exact_counts('walker per-env CEM', counts)
    traj = carry[1]
    check(acts.shape == (PER_ENV_B, 6) and traj.states.shape == (
        PER_ENV_B, 21, 20) and bool(torch.isfinite(traj.states).all())
        and float(traj.actions.abs().max()) <= 1.0, 'per-env CEM plan')
    out = dict(plan_ms_t0=times[0], plan_ms_t1=times[1])
    print(f'walker per-env CEM (K 1000 x 5 iterations, H 20, B 5): plan '
          f'{times[0]:.2f} ms at t = 0, {times[1]:.2f} ms warm; get_action '
          f'fails as in JAX; launches {counts}')
    return counts, out


def reacher_grad_ilqr_phase(dev, torch, tmp, tmp2):
    """(25) reacher_easy's CLI with --planner grad (Adam on each env's
    sequence, up to 40 iterations, each env stopping on its own) runs: 2
    #1 launches a control step of both collections. With --planner ilqr it
    fails where JAX's does, in ILQRPlanner.plan at the first policy step,
    after the seed collection and the fit. Then, on the grad CLI's fitted
    MLP from its 5 policy rollouts' last observations, the iterations each
    env ran (gradient_descent) and the step size each env accepted in each
    of iLQR's 10 iterations (the ilqr function)."""
    from mujoco_mbrl_tpu_torch import ops, planners

    agent, g_counts, g_wall = run_cli(
        torch, 'reacher grad CLI',
        cli_argv(tmp, 'reacher_easy', '--planner', 'grad'),
        apgd_solve=2 * 2 * PER_ENV_T)
    from mujoco_mbrl_tpu_torch import experiment
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        experiment.main(experiment.parse_args(
            cli_argv(tmp2, 'reacher_easy', '--planner', 'ilqr')))
        check(False, 'the ilqr CLI ran; JAX fails there')
    except AttributeError as e:
        check("no attribute 'ilqr'" in str(e), str(e))
    torch.cuda.synchronize()
    i_wall = time.perf_counter() - t0
    i_counts = dict(ops.launch_counts)
    exact_counts('reacher ilqr CLI (fails as in JAX)', i_counts,
                 apgd_solve=2 * PER_ENV_T)
    obs = agent.dataset.observations[20:20 + PER_ENV_B, -1].contiguous()
    policy = agent._make_policy(agent.params, agent._normalizers(),
                                agent.training_goal_state)
    env = agent.environment
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    ops.reset_launch_counts()
    for name, fn in (('gradient_descent', planners.gradient_descent),
                     ('ilqr', planners.ilqr)):
        info = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj = fn(g, obs, policy.model, policy.cost, env.sample_action,
                  agent.horizon, info=info)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(traj.states).all()), name)
        out[name] = dict(ms=1e3 * (time.perf_counter() - t0), **{
            k: info[k].tolist() for k in ('iterations', 'alphas')
            if k in info})
    exact_counts('reacher planners', dict(ops.launch_counts))
    out.update(grad_cli_s=g_wall, ilqr_cli_s=i_wall)
    print(f'reacher grad CLI {g_wall:.3f} s, launches {g_counts}; ilqr CLI '
          f'fails as in JAX after {i_wall:.3f} s, launches {i_counts}; '
          f'gradient_descent iterations per env '
          f'{out["gradient_descent"]["iterations"]} '
          f'({out["gradient_descent"]["ms"]:.1f} ms); ilqr accepted step '
          f'sizes (iteration x env) {out["ilqr"]["alphas"]} '
          f'({out["ilqr"]["ms"]:.1f} ms)')
    return g_counts, i_counts, out, agent


def reward_agent_cli_phase(dev, torch, tmp):
    """(26) point_mass_easy's CLI with --agent rw --model rw --planner cem:
    RewardAgent, whose cost is minus the reward the model predicts for
    (s_t, a_t), plans per env through MPCPolicy with CEM (1000 x 5, H 20):
    no sampler launch, 1 #1 launch a control step of both collections.
    Then get_action on one observation."""
    from mujoco_mbrl_tpu_torch import agents, models

    agent, counts, wall = run_cli(
        torch, 'point_mass rw CLI',
        cli_argv(tmp, 'point_mass_easy', '--agent', 'rw', '--model', 'rw',
                 '--planner', 'cem'), apgd_solve=1 * 2 * PER_ENV_T)
    check(type(agent) is agents.RewardAgent
          and type(agent.model) is models.RewardDynamics, type(agent))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    act, carry = agent.get_action(torch.Generator().manual_seed(4),
                                  agent.dataset.observations[20, -1])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    check(act.shape == (2,) and bool(torch.isfinite(act).all())
          and float(act.abs().max()) <= 1.0 and carry[0], act)
    print(f'point_mass rw CLI (RewardAgent, reward model, per-env CEM): '
          f'{wall:.3f} s; get_action {ms:.2f} ms; launches {counts}')
    return counts, dict(cli_s=wall, get_action_ms=ms)


def walker_scan_cli_phase(dev, torch, tmp, tmp2):
    """(27) walker_walk's CLI with --planner cem over --model lin, and over
    --model ens with 998 candidates (998 % 5 != 0): both plan through
    cem_batched's model / cost scan, as JAX routes them (the samplers take
    a plain MLP and an ensemble whose size divides the candidates), so no
    sampler launches; 10 #1 launches a control step."""
    import warnings

    from mujoco_mbrl_tpu_torch import models

    out, counts = {}, {}
    for key, model, extra, d in (
            ('lin', 'lin', (), tmp),
            ('ens998', 'ens', ('--planner_kwargs',
                               '{"num_candidates": 998}'), tmp2)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            agent, c, wall = run_cli(
                torch, f'walker {key} CLI',
                cli_argv(d, 'walker_walk', '--planner', 'cem', '--model',
                         model, *extra), apgd_solve=10 * 2 * PER_ENV_T)
        warned = any('not divisible' in str(w.message) for w in caught)
        check(warned == (key == 'ens998'), (key, warned))
        check(isinstance(agent.model, (models.LinearDynamics,
                                       models.EnsembleDynamics)), key)
        out[f'{key}_cli_s'], counts[key] = wall, c
        print(f'walker {key} CLI (cem through the model / cost scan): '
              f'{wall:.3f} s; launches {c}')
    return counts['lin'], counts['ens998'], out


def plan_fns(agent, device):
    """The agent's plan model and goal cost with every tensor on
    ``device``."""
    import dataclasses

    from mujoco_mbrl_tpu_torch import models as Mo

    to = lambda t: t.detach().to(device)
    params = {k: {kk: to(v) for kk, v in d.items()}
              for k, d in agent.params.items()}
    n = agent._normalizers()
    norms = type(n)(**{f.name: None if getattr(n, f.name) is None
                       else to(getattr(n, f.name))
                       for f in dataclasses.fields(n)})
    goal, weights = to(agent.training_goal_state), to(agent.state_cost_weights)
    alpha = agent.action_cost_alpha
    return (agent._plan_model_fn(params, norms),
            lambda s, a: (Mo.smooth_abs_loss(s, goal, weights)
                          + Mo.cosh_loss(a, alpha)))


def ilqr_ties(torch, info):
    """(iterations, B): the iLQR decisions rounding decides on the CPU's
    costs: its two cheapest step sizes, or its cheapest and the cost it
    would keep, within 1e-5 relative of each other."""
    costs = info['costs']                                 # (I, A, B)
    low2 = costs.topk(2, 1, largest=False).values         # (I, 2, B)
    prev, kept = info['initial_cost'], []
    for best in low2[:, 0]:
        kept.append(prev)
        prev = torch.minimum(best, prev)
    kept = torch.stack(kept)
    near = lambda a, b: (a - b).abs() <= 1e-5 * b.abs()
    return near(low2[:, 1], low2[:, 0]) | near(low2[:, 0], kept)


def per_env_card_vs_cpu_phase(dev, torch, walker, reacher):
    """(28) each per-env planner on the card against the CPU on the same
    fed inputs at B = 5: random shooting and CEM (1000 candidates, H 20;
    CEM 100 elites x 5 iterations) on path 23's fitted walker MLP from its
    policy rollouts' last states, on the same candidates and normals;
    gradient descent and iLQR on path 25's fitted reacher MLP from the same
    initial sequences. Every candidate cost agrees to rtol = atol = 1e-4.
    A decision is decided by rounding when the CPU's costs tie within 1e-5
    relative: random shooting's two lowest, an elite swapped across CEM's
    boundary, gradient descent's count one apart. At most 1% of the
    decisions may be such: of 5 envs none for random shooting and
    gradient descent (iterations run), which must agree in every env; of
    the 2,500 elite memberships of CEM, 25, whose envs then leave the
    final comparison. iLQR's step sizes must agree wherever the CPU's
    choice is not such a tie (``ilqr_ties``; near convergence most are,
    and there every step size gives nearly the same plan). The plans agree
    to rtol = atol = 1e-4 in every other env. Then an
    RNNDynamics (hidden 64) fit on path 23's replay, 2 epochs of windows of
    3 on the same batches (per-minibatch loss rtol 1e-3: Adam steps on
    near-zero gradients round apart), and an open-loop rollout of the
    card-fitted weights on both (rtol = atol = 1e-4)."""
    from mujoco_mbrl_tpu_torch import models, ops, planners
    from mujoco_mbrl_tpu_torch.data import replay as R
    from mujoco_mbrl_tpu_torch.models import train as Mt

    cpu, nb, out = torch.device('cpu'), PER_ENV_B, {}
    close = lambda a, b, tol: bool(torch.allclose(a.cpu(), b.cpu(), rtol=tol,
                                                  atol=tol))
    ops.reset_launch_counts()
    # -- random shooting and CEM on the walker
    states = walker.dataset.states[20:20 + nb, -1].cpu()
    cand = 2 * torch.rand((nb, 20, K, 6), generator=torch.Generator()
                          .manual_seed(11)) - 1
    normals = torch.randn((5, nb, 20, K, 6), generator=torch.Generator()
                          .manual_seed(12))
    res = {}
    for where, d in (('cpu', cpu), ('card', dev)):
        model, cost = plan_fns(walker, d)
        rs_info, cem_info = {}, {}
        rs = planners.random_shooting(
            None, states.to(d), model, cost, lambda g, shape: cand.to(d), 20,
            K, info=rs_info)
        ce = planners.cem(None, states.to(d), model, cost, 20, 6,
                          normals=normals.to(d), info=cem_info)
        res[where] = (rs, rs_info['costs'].cpu(), ce,
                      cem_info['costs'].cpu())
    (rs_c, c_cpu, ce_c, cc_cpu), (rs_g, c_gpu, ce_g, cc_gpu) = (
        res['cpu'], res['card'])
    check(close(c_gpu, c_cpu, 1e-4), ('rs costs', float(
        (c_gpu - c_cpu).abs().max())))
    best_c, best_g = c_cpu.argmin(1), c_gpu.argmin(1)
    low2 = c_cpu.topk(2, 1, largest=False).values
    gap = ((low2[:, 1] - low2[:, 0]) / low2[:, 0].abs()).tolist()
    check(torch.equal(best_c, best_g), ('rs chosen candidates',
                                        best_c.tolist(), best_g.tolist(),
                                        'relative gap of the two lowest',
                                        gap))
    check(torch.equal(rs_g.actions.cpu(), rs_c.actions)
          and close(rs_g.states, rs_c.states, 1e-4), 'rs plan')
    out['random_shooting'] = dict(
        chosen=best_c.tolist(), min_relative_gap=min(gap),
        max_abs_cost_err=float((c_gpu - c_cpu).abs().max()))
    swaps, flipped, compared = 0, set(), 0
    for b in range(nb):
        for i in range(5):
            check(close(cc_gpu[i, b], cc_cpu[i, b], 1e-4),
                  ('cem costs', i, b))
            e_c = set(cc_cpu[i, b].topk(100, largest=False).indices.tolist())
            e_g = set(cc_gpu[i, b].topk(100, largest=False).indices.tolist())
            compared += 100
            if e_c != e_g:
                srt = cc_cpu[i, b].sort().values
                edge = float(srt[99])
                moved = [float(cc_cpu[i, b, k]) for k in e_c ^ e_g]
                check(all(abs(v - edge) <= 1e-5 * abs(edge) for v in moved),
                      ('cem elites apart beyond rounding', i, b, edge,
                       moved))
                swaps += len(e_c - e_g)
                flipped.add(b)
                break
    check(swaps <= compared // 100, ('cem swaps', swaps, compared))
    keep = [b for b in range(nb) if b not in flipped]
    check(close(ce_g.actions[keep], ce_c.actions[keep], 1e-4)
          and close(ce_g.states[keep], ce_c.states[keep], 1e-4), 'cem plan')
    out['cem'] = dict(elite_swaps_by_rounding=swaps,
                      envs_decided_by_rounding=sorted(flipped),
                      max_abs_action_err=float((ce_g.actions.cpu()[keep]
                                                - ce_c.actions[keep]).abs()
                                               .max()))
    # -- gradient descent and iLQR on the reacher
    obs = reacher.dataset.observations[20:20 + nb, -1].cpu()
    init = 2 * torch.rand((nb, 20, 2), generator=torch.Generator()
                          .manual_seed(13)) - 1
    for name, fn in (('gradient_descent', planners.gradient_descent),
                     ('ilqr', planners.ilqr)):
        got = {}
        for where, d in (('cpu', cpu), ('card', dev)):
            model, cost = plan_fns(reacher, d)
            info = {}
            traj = fn(None, obs.to(d), model, cost, None, 20,
                      initial_trajectory=planners.Trajectory(
                          states=None, actions=init.to(d)), info=info)
            got[where] = (traj, {k: v.cpu() for k, v in info.items()})
        (tc, ic), (tg, ig) = got['cpu'], got['card']
        err = float((tg.actions.cpu() - tc.actions).abs().max())
        check(close(tg.actions, tc.actions, 1e-4)
              and close(tg.states, tc.states, 1e-4), (name, err))
        out[name] = dict(max_abs_action_err=err)
        if name == 'gradient_descent':
            check(torch.equal(ic['iterations'], ig['iterations']),
                  (name, ic['iterations'].tolist(),
                   ig['iterations'].tolist()))
            out[name]['iterations'] = ic['iterations'].tolist()
            continue
        tied = ilqr_ties(torch, ic)
        apart = (ic['alphas'] != ig['alphas']) & ~tied
        check(not bool(apart.any()), (name, 'step sizes apart beyond '
                                      'rounding', ic['alphas'].tolist(),
                                      ig['alphas'].tolist()))
        out[name].update(alphas=ic['alphas'].tolist(),
                         tied_decisions=int(tied.sum()),
                         tied_decisions_apart=int(
                             ((ic['alphas'] != ig['alphas']) & tied).sum()))
    # -- an RNN fit and rollout
    rnn = models.RNNDynamics(20, 6)
    p0 = rnn.init(torch.Generator().manual_seed(14), device='cpu')
    buf_c = R.from_tree(R.as_tree(walker.dataset), cpu)
    fitted = {}
    for where, d, buf in (('cpu', cpu, buf_c), ('card', dev, walker.dataset)):
        p = {k: {kk: v.clone().to(d) for kk, v in dd.items()}
             for k, dd in p0.items()}
        _, _, log = Mt.train_model(
            rnn, p, buf, torch.Generator().manual_seed(15), batch_size=512,
            num_epochs=2, horizon=3, obs_only=False,
            normalizers=Mt.make_normalizers(buf, use_observations=False))
        fitted[where] = (p, log.losses.cpu())
    lc, lg = fitted['cpu'][1], fitted['card'][1]
    check(lc.shape == lg.shape and bool(torch.isfinite(lg).all())
          and bool(torch.allclose(lg, lc, rtol=1e-3, atol=0)),
          ('rnn fit losses', float(((lg - lc) / lc).abs().max())))
    acts = 2 * torch.rand((20, nb, 6), generator=torch.Generator()
                          .manual_seed(16)) - 1
    p_g = fitted['card'][0]
    roll = {}
    for where, d, buf in (('cpu', cpu, buf_c), ('card', dev, walker.dataset)):
        p = {k: {kk: v.detach().to(d) for kk, v in dd.items()}
             for k, dd in p_g.items()}
        with torch.no_grad():
            roll[where] = rnn.rollout(
                p, states.to(d), acts.to(d),
                Mt.make_normalizers(buf, use_observations=False)).cpu()
    check(close(roll['card'], roll['cpu'], 1e-4) and bool(
        torch.isfinite(roll['card']).all()), ('rnn rollout', float(
            (roll['card'] - roll['cpu']).abs().max())))
    out['rnn'] = dict(max_rel_loss_err=float(((lg - lc) / lc).abs().max()),
                      max_abs_rollout_err=float(
                          (roll['card'] - roll['cpu']).abs().max()),
                      updates=int(lg.shape[0]))
    counts = dict(ops.launch_counts)
    exact_counts('per-env planners card vs CPU', counts)
    print(f'per-env planners and the RNN, card vs CPU on fed inputs: '
          f'{json.dumps(out)}')
    return counts, out


# ---- slice 12: the bf16 kernels (29) and the bench CLI (30) ----

BF16_TIGHT = 1e-5            # rtol = atol against the plain bf16 version
BF16_FLIP = 1e-3             # rtol = atol every candidate holds there
BF16_SELF = (5e-2, 5e-1)     # JAX's bf16 selfcheck against float32
BF16_NAMED = 0.01            # share admitted beyond BF16_TIGHT, named


def params64(params):
    return {l: {k: v.double() for k, v in d.items()}
            for l, d in params.items()}


def bf16_bound(flops, n_bytes):
    """The bf16 kernels' bound: FLOP at the bf16 tensor rate, or the bytes
    at the HBM rate, the larger."""
    t_b, t_o = n_bytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_b, t_o) * 1e3, ('bytes' if t_b >= t_o else 'operations')


def hold_bf16(torch, label, costs, ref16, ref16_64, ref32, acts=None,
              mean=None):
    """A bf16 kernel's costs against the plain bf16 version of the same
    actions (float32 products): every candidate within BF16_FLIP, all but
    the named ones within BF16_TIGHT. The named ones are decided by
    accumulation order (some activation's bf16 rounding turned on the order
    of a float32 sum, and the trajectory moved with it): at most
    BF16_NAMED of them, printed with how many of them the plain version
    with float64 products also moves by more than BF16_TIGHT. Then against
    the plain float32 rollout at JAX's bf16 selfcheck tolerance; and, for
    a sampler, bf16 actions in [-1, 1] with the antithetic identity to
    bf16 rounding (half an ulp, at most 2^-9, on each side)."""
    c, r = costs.reshape(-1), ref16.reshape(-1)
    check(bool(torch.isfinite(c).all()), (label, 'non-finite costs'))
    gap = (c - r).abs()
    scale = 1.0 + r.abs()
    check(bool((gap <= BF16_FLIP * scale).all()),
          (label, 'beyond the flip bound', float((gap / scale).max())))
    named = gap > BF16_TIGHT * scale
    n_named = int(named.sum())
    check(n_named <= BF16_NAMED * c.numel(), (label, 'named', n_named))
    by_order = (r - ref16_64.reshape(-1)).abs() > BF16_TIGHT * scale
    also = int((named & by_order).sum())
    torch.testing.assert_close(costs, ref32, rtol=BF16_SELF[0],
                               atol=BF16_SELF[1])
    rec = dict(max_abs_err=float(gap.max()),
               max_abs_err_vs_f32=float((costs - ref32).abs().max()),
               named=n_named, named_share=n_named / c.numel(),
               named_also_by_float64_order=also,
               plain_orders_apart=int(by_order.sum()),
               max_abs_err_unnamed=float(gap[~named].max()))
    if acts is not None:
        check(acts.dtype == torch.bfloat16, (label, acts.dtype))
        a = acts.float()
        check(float(a.abs().max()) <= 1.0, (label, 'action out of [-1, 1]'))
        Kc = a.shape[-1]
        a1, a2 = a[..., :Kc // 2], a[..., Kc // 2:]
        free = (a1.abs() < 1.0) & (a2.abs() < 1.0)
        pair = float((a1 + a2 - 2.0 * mean[..., None]).abs()[free].max())
        check(pair <= 2.0 ** -8 + 1e-6, (label, 'antithetic', pair))
        rec['antithetic_max_dev'] = pair
    first = [int(i) for i in named.nonzero()[:5, 0].tolist()]
    print(f'{label}: bf16 kernel vs plain bf16 max|d| {rec["max_abs_err"]:.3e}'
          f' ({rec["max_abs_err_unnamed"]:.3e} unnamed); decided by '
          f'accumulation order (beyond rtol = atol {BF16_TIGHT:g}): '
          f'{n_named} of {c.numel()} ({100 * rec["named_share"]:.4f}%), '
          f'first flat indices {first}, {also} of them also between the '
          f'plain float32- and float64-product orders '
          f'({rec["plain_orders_apart"]} apart in all); vs float32 max|d| '
          f'{rec["max_abs_err_vs_f32"]:.3e}')
    return rec


def bf16_timed(label, flops, n_bytes, k_ms, f32_ms, p_ms, rec, **extra):
    b_ms, b_by = bf16_bound(flops, n_bytes)
    check(b_ms <= k_ms, (label, 'faster than its bound', k_ms, b_ms))
    print(f'{label}: bf16 kernel {k_ms:.4f} ms, float32 kernel {f32_ms:.4f} '
          f'ms on the same inputs ({f32_ms / k_ms:.2f}x), plain bf16 '
          f'{p_ms:.3f} ms; bf16 bound {b_ms:.4f} ms ({b_by}): '
          f'{100 * b_ms / k_ms:.1f}% of it; '
          f'{flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s of model FLOP')
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                f32_ms=f32_ms, held_to='bf16 tensor cores: FLOP at 989.4 '
                'TFLOP/s', **rec, **extra)


def bf16_sampler_case(dev, torch, label, params, s0, goal, weights, mean,
                      std, Kc, sampler, instantiation=None, n=None):
    """#2 / #3 (n None) or #5 / #6 (an n-member ensemble) in bf16 against
    the plain bf16 cost of the kernel's own actions (hold_bf16), timed
    beside the bf16 bound and the float32 kernel on the same inputs."""
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    bf = torch.bfloat16
    (Bs, sd), (Hc, ad) = s0.shape, mean.shape[1:]
    hid = params['l2']['w'].shape[-1]
    if n is None:
        kern = lambda **kw: C.mlp_sample_rollout_costs(
            params, 7, s0, mean, std, goal, weights, Kc, sampler=sampler,
            **kw)
        plain = lambda: C.mlp_sample_rollout_costs_plain(
            params, 7, s0, mean, std, goal, weights, Kc, sampler=sampler,
            compute_dtype=bf)
        of = C.rollout_costs_of_actions
    else:
        kern = lambda **kw: C.mlp_sample_rollout_costs_ensemble(
            params, 7, s0, mean, std, goal, weights, Kc, n, sampler=sampler,
            **kw)
        plain = lambda: C.mlp_sample_rollout_costs_ensemble_plain(
            params, 7, s0, mean, std, goal, weights, Kc, n, sampler=sampler,
            compute_dtype=bf)
        of = C.rollout_costs_of_actions_ensemble
    if instantiation is not None:
        taken = C.sampler_instantiation(Kc, Hc, sd, ad, hid,
                                        compute_dtype=bf)
        check(taken == instantiation, (label, taken, instantiation))
    with torch.no_grad():
        costs, acts = kern(compute_dtype=bf)
        ref16 = of(params, s0, acts, goal, weights, compute_dtype=bf)
        ref16_64 = of(params64(params), s0.double(), acts.double(),
                      goal.double(), weights.double(), compute_dtype=bf)
        ref32 = of(params, s0, acts, goal, weights)
        torch.cuda.synchronize()
        rec = hold_bf16(torch, label, costs, ref16, ref16_64, ref32, acts,
                        mean)
        del ref16_64
        k_ms = time_ms(lambda: kern(compute_dtype=bf), 5)
        f32_ms = time_ms(kern, 5)
        p_ms = time_ms(plain, 2)
    flops = 2.0 * Bs * Kc * Hc * ((sd + ad) * hid + hid * hid + hid * sd)
    n_bytes = (2.0 * Bs * Hc * ad * Kc + 4.0 * (
        Bs * Kc + Bs * sd + 2 * Bs * Hc * ad + 2 * sd)
        + 2.0 * (n or 1) * ((sd + ad) * hid + hid * hid + hid * sd
                            + 2 * hid + sd))
    return bf16_timed(f'{label} B={Bs} K={Kc} H={Hc} sd={sd} ad={ad}',
                      flops, n_bytes, k_ms, f32_ms, p_ms, rec,
                      instantiation=instantiation)


def bf16_given_case(dev, torch, label, params, s0, goal, weights, seed):
    """#4 in bf16 on given actions (cem_batched's non-fused candidates) at
    B x K candidates, H 30, against its plain bf16 version (hold_bf16),
    timed beside the bf16 bound and the float32 kernel."""
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    bf = torch.bfloat16
    s0T = states_t(s0)
    _, aT = candidates(dev, torch, s0.shape[0], H, 6, seed)
    (sd, N), (Hc, ad) = s0T.shape, aT.shape[:2]
    hid = params['l2']['w'].shape[0]
    kern = lambda **kw: C.mlp_rollout_costs_t(params, s0T, aT, goal, weights,
                                              **kw)
    plain = lambda p, s, a, g, w, **kw: C.mlp_rollout_costs_reference(
        p, s.T, a.transpose(1, 2), g, w, **kw)
    with torch.no_grad():
        costs = kern(compute_dtype=bf)
        ref16 = plain(params, s0T, aT, goal, weights, compute_dtype=bf)
        ref16_64 = plain(params64(params), s0T.double(), aT.double(),
                         goal.double(), weights.double(), compute_dtype=bf)
        ref32 = plain(params, s0T, aT, goal, weights)
        torch.cuda.synchronize()
        rec = hold_bf16(torch, label, costs, ref16, ref16_64, ref32)
        del ref16_64
        k_ms = time_ms(lambda: kern(compute_dtype=bf), 5)
        f32_ms = time_ms(kern, 5)
        p_ms = time_ms(lambda: plain(params, s0T, aT, goal, weights,
                                     compute_dtype=bf), 2)
    flops = 2.0 * N * Hc * ((sd + ad) * hid + hid * hid + hid * sd)
    n_bytes = 4.0 * (N * Hc * ad + N * sd + N + 3 * sd) + 2.0 * (
        (sd + ad) * hid + hid * hid + hid * sd + 2 * hid + sd)
    return bf16_timed(f'{label} N={N} H={Hc} sd={sd}', flops, n_bytes, k_ms,
                      f32_ms, p_ms, rec)


def bf16_phase(dev, torch, walker, cheetah, humanoid):
    """(29) The bf16 instantiations against their plain bf16 versions at
    the shapes of the paths that reach them: #2 at northstar (walker obs
    sd 24, 1024 x 1000 x 30; triangular and normal) and at the humanoid
    preset's (sd 67, ad 21, 512 envs; run-time loop bounds), #3 spline4 at
    northstar, #5 at walker_ens (n 5), #6 at the CLI's ensemble layout (B
    5, H 20, sd 20), #4 at the cheetah's (sd 17, B K = 1,024,000, H 30),
    and #2 at a shape only the guarded bf16 instantiation takes (sd 40 +
    6, hidden 64)."""
    from mujoco_mbrl_tpu_torch import models

    (w_params, w_obs), (c_params, c_obs), (h_params, h_obs) = (
        walker, cheetah, humanoid)
    goal, weights, mean, std = proposal(dev, torch)
    cases = {}
    for sampler in ('triangular', 'normal', 'spline4'):
        cases[f'northstar_{sampler}'] = bf16_sampler_case(
            dev, torch, f'bf16 sampler {sampler}', w_params, w_obs, goal,
            weights, mean, std, K, sampler, (2, 4, 3, True, True))
    ens = models.EnsembleDynamics(models.MLPDynamics(
        24, 6, hidden_units=50), 5).init(torch.Generator().manual_seed(1),
                                         device=dev)
    cases['walker_ens'] = bf16_sampler_case(
        dev, torch, 'bf16 ensemble sampler', ens, w_obs, goal, weights, mean,
        std, K, 'normal', n=5)
    p20 = models.EnsembleDynamics(models.MLPDynamics(
        20, 6, hidden_units=50), 5).init(torch.Generator().manual_seed(2),
                                         device=dev)
    cases['ensemble_b5_h20_sd20'] = bf16_sampler_case(
        dev, torch, 'bf16 ensemble sampler, CLI layout', p20,
        w_obs[:5, :20].contiguous(), goal[:20], weights[:20],
        mean[:5, :20].contiguous(), std[:5, :20].contiguous(), K, 'normal',
        n=5)
    c_goal = torch.zeros(c_obs.shape[1], device=dev)
    c_goal[1] = 1.0
    cases['given_cheetah'] = bf16_given_case(
        dev, torch, 'bf16 rollout costs (given actions)', c_params, c_obs,
        c_goal, torch.ones_like(c_goal), 29)
    g = torch.Generator(device=dev).manual_seed(29)
    hm = (0.3 * torch.randn((h_obs.shape[0], H, 21), generator=g,
                            device=dev)).clamp(-0.9, 0.9)
    h_goal = torch.zeros(67, device=dev)
    h_goal[1] = 1.0
    cases['humanoid'] = bf16_sampler_case(
        dev, torch, 'bf16 sampler humanoid', h_params, h_obs, h_goal,
        torch.ones_like(h_goal), hm, 0.2 + torch.rand(
            hm.shape, generator=g, device=dev), K, 'triangular',
        (6, 4, 9, False, True))
    Bg, gsd = 256, 40
    gp = models.MLPDynamics(gsd, 6, hidden_units=64).init(
        torch.Generator().manual_seed(24), device=dev)
    gm = (0.3 * torch.randn((Bg, 20, 6), generator=g, device=dev)).clamp(
        -0.9, 0.9)
    cases['guarded_sd40_hid64'] = bf16_sampler_case(
        dev, torch, 'bf16 sampler guarded', gp,
        torch.randn((Bg, gsd), generator=g, device=dev),
        torch.randn(gsd, generator=g, device=dev),
        torch.rand(gsd, generator=g, device=dev), gm,
        0.2 + torch.rand(gm.shape, generator=g, device=dev), 500,
        'triangular', (8, 8, 16, False, False))
    return cases


# (argv, expected launches) of path 30: every preset through the CLI as a
# user runs it, the JAX defaults on northstar (10 steps, 3 repeats), the
# others (and the agent loop) cut to 3 steps and 1 repeat, which keeps the
# script within half its time limit. Launches: the selfcheck's 1, then
# (1 + repeats) runs of steps control steps, 3 CEM iterations each
BENCH_CALLS = (
    (['--config', 'northstar'],
     dict(cem_sample_rollout=1 + 3 * 10 * 4, apgd_solve=10 * 10 * 4)),
    (['--config', 'northstar', '--dtype', 'bf16'],
     dict(cem_sample_rollout_bf16=1 + 3 * 10 * 4, apgd_solve=10 * 10 * 4)),
    (['--config', 'northstar', '--dtype', 'bf16', '--sampler', 'spline4',
      '--steps', '3', '--repeats', '1'],
     dict(cem_sample_rollout_bf16=1 + 3 * 3 * 2, apgd_solve=10 * 3 * 2)),
    (['--config', 'walker_ens', '--steps', '3', '--repeats', '1'],
     dict(cem_sample_rollout_ens=1 + 3 * 3 * 2, apgd_solve=10 * 3 * 2)),
    (['--config', 'walker_ens', '--dtype', 'bf16', '--steps', '3',
      '--repeats', '1'],
     dict(cem_sample_rollout_ens_bf16=1 + 3 * 3 * 2,
          apgd_solve=10 * 3 * 2)),
    # the scan route (obs_dim + act_dim < 16): the selfcheck's launch only
    (['--config', 'cartpole', '--steps', '3', '--repeats', '1'],
     dict(cem_sample_rollout=1, apgd_solve=RK4_SOLVES * 3 * 2)),
    (['--config', 'reacher256', '--steps', '3', '--repeats', '1'],
     dict(cem_sample_rollout=1, apgd_solve=3 * 2)),
    (['--config', 'humanoid', '--steps', '3', '--repeats', '1'],
     dict(cem_sample_rollout=1 + 3 * 3 * 2,
          apgd_factored=HUMANOID_SUBSTEPS * 3 * 2)),
    # the full loop: the reset's 200 settling solves, the seed collection's
    # 3 steps, one timed iteration of 3 (1 factored solve a step)
    (['--config', 'cheetah1024', '--steps', '3', '--repeats', '1',
      '--train_epochs', '5'],
     dict(cem_sample_rollout=1 + 3 * 3, apgd_factored=200 + 3 + 3)),
    # chain 10, a warm-up and 5 repeats of each phase; no selfcheck
    (['--task', 'walker_walk', '--phases'],
     dict(cem_sample_rollout=3 * 10 * 6, apgd_solve=10 * 10 * 6)),
    (['--task', 'walker_walk', '--agent-loop', '--steps', '3',
      '--repeats', '1'],
     dict(cem_sample_rollout=1 + 3 * 3 * 2, apgd_solve=10 * 3 * 2)),
)


def bench_cli_phase(dev, torch):
    """(30) ``bench.main`` in-process for each of BENCH_CALLS, every launch
    count zeroed just before and read just after (exact); each call's last
    line is the JAX bench's JSON line less vs_baseline, its value finite
    and positive, every mfu_* share in (0, 100]. Returns {argv: (record,
    counts, seconds)}; prints each line."""
    import io
    from mujoco_mbrl_tpu_torch import bench, ops

    out = {}
    for argv, expected in BENCH_CALLS:
        label = ' '.join(argv)
        buf = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.launch_counts)
        check(rc == 0, (label, rc))
        exact_counts(f'bench {label}', counts, **expected)
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        check('vs_baseline' not in rec and rec.get('unit', 'env-steps/s')
              == 'env-steps/s', (label, rec))
        value = rec.get('value', rec.get('implied_env_steps_per_s'))
        check(math.isfinite(value) and value > 0, (label, rec))
        shares = {k: v for k, v in rec.items() if 'mfu' in k and k !=
                  'mfu_note'}
        check('--full-loop' in argv or '--agent-loop' in argv
              or 'cheetah1024' in argv or bool(shares), (label, rec))
        check(all(0 < v <= 100 for v in shares.values()), (label, shares))
        print(f'bench {label} ({wall:.1f} s, launches '
              f'{ {k: v for k, v in counts.items() if v} }): '
              f'{json.dumps(rec)}')
        out[label] = dict(record=rec, launches=counts, seconds=wall)
    return out


# ---- slice 13: finger, ball_in_cup, lqr ---------------------------------

FINGER_SOLVES = 3            # 2 substeps + the observation's forward
CUP_SOLVES = 10              # 10 substeps; the observation needs no solve
FINGER_CONE_ROWS = tuple(range(3, 39, 3))
LQR_DRIVE_CAP = 1500         # control steps to drive lqr_6_2 toward 0


@contextlib.contextmanager
def watching(kernel, rows=None):
    """Every launch count zeroed on entry, and each call of the
    ops.apgd_solve wrapper `kernel` checked by `rows(args, kw)` as it
    happens: keeping the calls' inputs would keep every Ad of the steps
    alive (3.6 GB each at stack_4's 977 rows)."""
    from mujoco_mbrl_tpu_torch import ops
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    real = getattr(A, kernel)

    def watch(*args, **kw):
        if rows is not None:
            rows(args, kw)
        return real(*args, **kw)

    ops.reset_launch_counts()
    setattr(A, kernel, watch)
    try:
        yield
    finally:
        setattr(A, kernel, real)


def suite_control_steps(dev, torch, env, state0, label, rows=None,
                        kernel='apgd_iterate_batched', steps=STEPS):
    """A warm-up control step of random actions from `state0`, then
    `steps` timed ones with every launch count zeroed just before and read
    just after; `rows(args, kw)` checks each call of the wrapper `kernel`
    (#1's) in the timed steps. Returns (counts, times, the state after the
    warm-up)."""
    from mujoco_mbrl_tpu_torch import ops

    g = torch.Generator(device=dev).manual_seed(31)
    act = lambda: 2 * torch.rand((state0.physics.qpos.shape[0],
                                  env.model.nu), generator=g, device=dev) - 1
    warm, _ = env.step(state0, act())
    torch.cuda.synchronize()
    with watching(kernel, rows):
        t0 = time.perf_counter()
        state = warm
        for _ in range(steps):
            state, ts = env.step(state, act())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    for name, x in (('qpos', state.physics.qpos),
                    ('qvel', state.physics.qvel), ('reward', ts.reward)):
        check(bool(torch.isfinite(x).all()), (label, name))
    out = dict(ms_per_step=1e3 * wall / steps, wall_s=wall)
    print(f'{label}: {steps} control steps x {state0.physics.qpos.shape[0]} '
          f'envs in {wall:.3f} s = {out["ms_per_step"]:.2f} ms per control '
          f'step; launches {counts}; mean reward '
          f'{float(ts.reward.mean()):.4f}')
    return counts, out, warm


def finger_rows(B_):
    """The check of each #1 call on finger: 39 rows (a box row with
    per-env bounds, two hinge limits, 12 cone triples), the 400 cap."""
    def rows(args, kw):
        check(args[0].shape == (B_, 39, 39) and args[6].shape == (B_, 39),
              (args[0].shape, args[6].shape))
        check((kw['box_rows'], kw['nonneg'], kw['con0'], kw['iterations'])
              == ((0,), (1, 2), FINGER_CONE_ROWS, 400), kw)
    return rows


def finger_control_step_phase(dev, torch, task):
    """(31) finger's spin and turn_hard through suite.load at 1024 envs
    from a card reset, random actions: 2 substeps and the observation's
    forward a control step (the touch sensors read its solve), each one
    39-row #1 launch with per-env box bounds; the card's step against the
    CPU's."""
    from mujoco_mbrl_tpu_torch import suite

    env = suite.load('finger', task, device=dev)
    state0, _ = env.reset(B, torch.Generator(device=dev).manual_seed(30))
    counts, out, warm = suite_control_steps(
        dev, torch, env, state0, f'finger {task} control step',
        rows=finger_rows(B))
    exact_counts(f'finger {task} control step', counts,
                 apgd_solve=FINGER_SOLVES * STEPS)
    out['card_vs_cpu'] = card_vs_cpu_step(dev, torch, 'finger', task, warm,
                                          by_rounding=True)
    return counts, out, state0


def finger_contact_state(dev, torch, n):
    """n finger poses with the fingertip pressed into the spinner (a pool
    of random poses, the penetrating ones kept), a tenth of them with the
    proximal hinge past its limit and moving on into it; small finger
    velocities, the spinner fast (its friction-loss row saturates)."""
    from types import SimpleNamespace

    from mujoco_mbrl_tpu_torch import suite
    from mujoco_mbrl_tpu_torch.physics import collision, smooth
    from mujoco_mbrl_tpu_torch.physics.model import State

    m = suite.load('finger', 'turn_hard', device=dev).model
    g = torch.Generator(device=dev).manual_seed(32)
    N = 64 * n                      # ~3% penetrate by under 1 cm
    q = torch.stack([3.84 * torch.rand(N, generator=g, device=dev) - 1.92,
                     3.84 * torch.rand(N, generator=g, device=dev) - 1.92,
                     6.2832 * torch.rand(N, generator=g, device=dev)
                     - 3.1416], 1)
    kin = smooth.kinematics(m, q, smooth.tree_meta(m))
    dist = collision.detect(m, kin[3], kin[4],
                            collision.candidate_pairs(m)).dist
    keep = ((dist < 0) & (dist > -0.01)).any(1).nonzero()[:, 0]
    check(len(keep) >= n, ('finger contact pool', len(keep)))
    qpos = q[keep[:n]].clone()
    qvel = 0.2 * torch.randn((n, 3), generator=g, device=dev)
    qvel[:, 2] = 2.0 * torch.randn(n, generator=g, device=dev)
    lim = torch.arange(n, device=dev) % 10 == 0
    side = torch.where(qpos[:, 0] > 0, 1.0, -1.0)
    qpos[lim, 0] = side[lim] * 1.95
    qvel[lim, 0] = side[lim] * 0.5
    return SimpleNamespace(physics=State(qpos=qpos, qvel=qvel,
                                         time=torch.zeros(n, device=dev)))


def cup_contact_state(dev, torch, n):
    """n ball_in_cup states: the ball resting in the cup's bottom (half),
    against a side wall (a quarter), or hanging below with the string past
    its 0.3 length (a quarter); random velocities."""
    from types import SimpleNamespace

    from mujoco_mbrl_tpu_torch.physics.model import State

    g = torch.Generator(device=dev).manual_seed(33)
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)
    qpos = torch.zeros((n, 4), device=dev)
    qpos[:, :2] = 0.04 * u(n, 2) - 0.02
    kind = torch.arange(n, device=dev) % 4
    side = torch.where(u(n) < 0.5, -1.0, 1.0)
    qpos[:, 2] = qpos[:, 0] + torch.where(
        kind == 2, side * (0.018 + 0.004 * u(n)), 0.01 * u(n) - 0.005)
    qpos[:, 3] = qpos[:, 1] + torch.where(
        kind == 3, -0.05 - 0.1 * u(n), 0.322 + 0.004 * u(n))
    qvel = 0.3 * torch.randn((n, 4), generator=g, device=dev)
    return SimpleNamespace(physics=State(qpos=qpos, qvel=qvel,
                                         time=torch.zeros(n, device=dev)))


def varied_bounds(torch, cases):
    """The captured finger cases with each env's box bound scaled by its
    own factor in [0.5, 2): finger's spinner inertia does not change with
    the pose, so its envs share one scaled bound; this case makes the
    kernel read each env's own."""
    out = []
    for tag, args, kw in cases:
        Bs = args[6].shape[0]
        scale = 0.5 + 1.5 * torch.arange(Bs, device=args[6].device) / Bs
        out.append((tag + '-varied-bounds',
                    args[:6] + ((args[6] * scale[:, None]).contiguous(),),
                    kw))
    return out


def slice13_apgd_phase(dev, torch, label, env, reset_state, contact_state,
                       per_env_bounds):
    """(31, 32) #1 against its plain version on solves captured from the
    port at 1024 envs, at the reset states and in contact, cold and warm
    (and, for finger, with per-env varied bounds), under the one APGD rule
    (rtol = atol = 2e-4, at most 1% of envs decided by rounding); device
    time, the largest iteration count of the cap, us per dependent step,
    ns per APGD iteration, beside the FP32 bound."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    cases = (capture_solves(dev, torch, env, reset_state, f'{label}-reset',
                            'apgd_iterate_batched')
             + capture_solves(dev, torch, env, contact_state,
                              f'{label}-contact', 'apgd_iterate_batched'))
    for tag, args, kw in cases:
        act = args[4]
        n_con = int((act[:, 3:].sum(1) > 0).sum()) if per_env_bounds else \
            int((act[:, 1:].sum(1) > 0).sum())
        print(f'apgd {tag} cold={kw["cold"]}: nr {args[0].shape[1]}, '
              f'{int(act.sum())} of {act.numel()} rows active, {n_con} of '
              f'{act.shape[0]} envs in contact; bounds {tuple(args[6].shape)}'
              f'; cap {kw["iterations"]}')
        if tag.endswith('contact'):
            check(n_con >= act.shape[0] // 2, (tag, n_con))
    held = cases + (varied_bounds(torch, cases[2:]) if per_env_bounds
                    else [])
    worst, rounding_envs = hold_apgd(
        torch, f'apgd {label}', A.apgd_iterate_batched, A.apgd_iterate_plain,
        lambda args: args[0], held)
    times = time_apgd(
        torch, f'apgd {label}', A.apgd_iterate_batched, A.apgd_iterate_plain,
        cases, lambda a: 2.0 * a[1].shape[1] ** 2,
        lambda a: 4.0 * (a[0].numel() + 6 * a[1].numel() + a[5].numel()
                         + a[6].numel()),
        trace_bound=False)
    tag, args, kw = cases[-1]
    check(tag.endswith('contact') and not kw['cold'], tag)
    cap = lambda n: device_ms(lambda: A.apgd_iterate_batched(
        *args, **dict(kw, iterations=n, tol2=0.0)), 20)
    t1, t41 = cap(1), cap(41)
    iteration_ns = 1e6 * (t41 - t1) / 40
    print(f'apgd {label} {tag}-warm, tol2 = 0: {t1:.4f} ms at 1 iteration, '
          f'{t41:.4f} ms at 41: {iteration_ns:.0f} ns per APGD iteration')
    return worst, rounding_envs, times, iteration_ns


def cup_control_step_phase(dev, torch):
    """(32) ball_in_cup catch through suite.load at 1024 envs from a card
    reset, random actions: 10 substeps a control step, each one 21-row #1
    launch (the string's limit row, 5 sphere-capsule points of 4 facets);
    the observation needs no solve. The card's step against the CPU's."""
    from mujoco_mbrl_tpu_torch import suite

    def rows(args, kw):
        check(args[0].shape == (B, 21, 21) and not kw['box_rows']
              and not kw['con0'] and kw['nonneg'] == tuple(range(21))
              and kw['iterations'] == 60, (args[0].shape, kw))

    env = suite.load('ball_in_cup', 'catch', device=dev)
    state0, _ = env.reset(B, torch.Generator(device=dev).manual_seed(34))
    counts, out, warm = suite_control_steps(
        dev, torch, env, state0, 'ball_in_cup catch control step', rows=rows)
    exact_counts('ball_in_cup control step', counts,
                 apgd_solve=CUP_SOLVES * STEPS)
    out['card_vs_cpu'] = card_vs_cpu_step(dev, torch, 'ball_in_cup',
                                          'catch', warm, by_rounding=True)
    return counts, out, env, state0


def lqr_phase(dev, torch):
    """(33) lqr_6_2 (seed 0) at 1024 envs: the card's step against the
    CPU's; then the analytic gain of the port's lqr_solver drives states
    of norm sqrt(2) 1e-6 below the task's 1e-6 termination bound (at most
    LQR_DRIVE_CAP control steps): a terminated env reports LAST with
    discount 0, the others MID with discount 1, and autoreset_step starts
    the terminated envs afresh (FIRST, step count 0, norm sqrt(2)) while
    the others step on. Contacts and limits are off: no launch."""
    from mujoco_mbrl_tpu_torch import ops, suite
    from mujoco_mbrl_tpu_torch.suite import control, lqr_solver

    kw = {'seed': 0}
    env = suite.load('lqr', 'lqr_6_2', task_kwargs=kw, device=dev)
    start, _ = env.reset(B, torch.Generator().manual_seed(35))
    ops.reset_launch_counts()
    out = dict(card_vs_cpu=card_vs_cpu_step(dev, torch, 'lqr', 'lqr_6_2',
                                            start, task_kwargs=kw))
    _, k, beta = lqr_solver.solve(env)
    K = torch.tensor(k, dtype=torch.float32, device=dev)
    state, _ = env.start(start.physics.replace(
        qpos=start.physics.qpos * 1e-6))
    first = torch.full((B,), -1, dtype=torch.long, device=dev)
    t0 = time.perf_counter()
    for i in range(LQR_DRIVE_CAP):
        x = torch.cat([state.physics.qpos, state.physics.qvel], 1)
        state, ts = env.step(state, x @ K.T)
        last = ts.step_type == control.LAST
        first = torch.where((first < 0) & last, i, first)
        if i % 50 == 49 and bool((first >= 0).all()):
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = i + 1
    ended = int((first >= 0).sum())
    check(ended >= B * 9 // 10, ('lqr terminated envs', ended))
    check(bool((ts.discount[last] == 0).all())
          and bool((ts.discount[~last] == 1).all()), 'lqr discount')
    q, v = state.physics.qpos, state.physics.qvel
    norm = torch.sqrt((q * q).sum(1) + (v * v).sum(1))
    check(bool((last == (norm < 1e-6)).all()), 'lqr LAST is the bound')
    new, ts2 = env.autoreset_step(state, torch.zeros((B, env.model.nu),
                                                     device=dev),
                                  torch.Generator(device=dev).manual_seed(36))
    check(bool((ts2.step_type[last] == control.FIRST).all())
          and bool((new.step_count[last] == 0).all()), 'lqr autoreset')
    check(bool((ts2.step_type[~last] != control.FIRST).all())
          and bool((new.step_count[~last]
                    == state.step_count[~last] + 1).all()), 'lqr stepped')
    check(bool(torch.isclose(torch.linalg.vector_norm(
        new.physics.qpos[last], dim=1), torch.tensor(
            2.0 ** 0.5, device=dev)).all()), 'lqr reset norm')
    counts = dict(ops.launch_counts)
    exact_counts('lqr_6_2 drive', counts)
    out.update(drive_steps=steps, drive_s=wall,
               ms_per_step=1e3 * wall / steps, beta=float(beta),
               terminated=ended, last_at_end=int(last.sum()),
               first_termination=int(first[first >= 0].min()),
               median_termination=int(first[first >= 0].median()))
    print(f'lqr_6_2 drive at {B} envs: {steps} control steps in {wall:.2f} s'
          f' ({out["ms_per_step"]:.3f} ms a step), beta {beta:.6f}; '
          f'{ended} envs terminated (first at step '
          f'{out["first_termination"]}, median '
          f'{out["median_termination"]}), {int(last.sum())} LAST at the '
          f'end and restarted by autoreset_step; launches {counts}')
    return counts, out


# ---- slice 14: manipulator, stacker, fish (34-37) -----------------------

MANIP_SOLVES = 11            # 10 substeps + the observation's forward
MANIP_T = 5                  # control steps of each agent-loop collection
CPU_ENVS = 100               # envs of the card-vs-CPU steps past 452 rows
MANIP_ROWS = {('manipulator', 'bring_ball'): 452,
              ('manipulator', 'insert_peg'): 833,
              ('stacker', 'stack_4'): 977}


def tree_map(torch, fn, x):
    """fn on every tensor of a nested tuple / list / dict (task params)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(torch, fn, y) for y in x)
    if isinstance(x, dict):
        return {k: tree_map(torch, fn, y) for k, y in x.items()}
    return x


def head_state(torch, s, n):
    """The first n envs of an EnvState."""
    import dataclasses
    cut = lambda x: x[:n] if isinstance(x, torch.Tensor) else x
    return dataclasses.replace(s, physics=dataclasses.replace(
        s.physics, qpos=s.physics.qpos[:n], qvel=s.physics.qvel[:n],
        time=s.physics.time[:n], act=cut(s.physics.act)),
        params=tree_map(torch, cut, s.params),
        step_count=s.step_count[:n], last=s.last[:n])


def global_rows(B_, nr):
    """The check of each #1 call on the manipulator and the stacker: nr
    rows (the equality row, 7 arm limits, cone triples) on #1's global
    path, the 60 cap."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    def rows(args, kw):
        check(args[0].shape == (B_, nr, nr) and A.dense_route(nr) ==
              'global', (args[0].shape, A.dense_route(nr)))
        check((kw['eq_rows'], kw['nonneg'], kw['box_rows'], kw['con0'],
               kw['iterations']) == ((0,), tuple(range(1, 8)), (),
                                     tuple(range(8, nr, 3)), 60), kw)
    return rows


def dense_control_step_phase(dev, torch, domain, task, seed):
    """(34, 36) domain/task through suite.load at 1024 envs from a card
    reset (8 attempts an env, the first without penetration), random
    actions: 10 substeps and the observation's forward (the touch sensors
    read its solve), so 11 #1 launches a control step, each checked to
    take the global path with the task's rows; the card's step against
    the CPU's on the first CPU_ENVS envs."""
    from mujoco_mbrl_tpu_torch import suite

    nr = MANIP_ROWS[domain, task]
    env = suite.load(domain, task, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state0, _ = env.reset(B, torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    label = f'{domain} {task} control step'
    counts, out, warm = suite_control_steps(dev, torch, env, state0, label,
                                            rows=global_rows(B, nr))
    exact_counts(label, counts, apgd_solve=MANIP_SOLVES * STEPS)
    out.update(reset_s=reset_s, rows=nr, card_vs_cpu_envs=CPU_ENVS,
               card_vs_cpu=card_vs_cpu_step(
                   dev, torch, domain, task, warm, by_rounding=True,
                   cpu_envs=CPU_ENVS))
    return counts, out, env, state0


def penetrating_state(dev, torch, env, n, seed):
    """n states of the task's reset draws that penetrate by under 1 cm
    (the draws the reset rejects: arm, fingers, props, floor and walls in
    contact), small random velocities, with their params."""
    from types import SimpleNamespace

    from mujoco_mbrl_tpu_torch.physics import collision, smooth
    from mujoco_mbrl_tpu_torch.physics.model import State

    m = env.model
    g = torch.Generator(device=dev).manual_seed(seed)
    qposes, params = env.task.attempts(m, 4 * n, g)
    q, p = qposes.reshape(-1, m.nq), params.reshape(-1, params.shape[-1])
    kin = smooth.kinematics(m, q, smooth.tree_meta(m))
    dist = collision.detect(m, kin[3], kin[4],
                            collision.candidate_pairs(m)).dist
    keep = ((dist < 0).any(1) & (dist > -0.01).all(1)).nonzero()[:, 0]
    check(len(keep) >= n, ('penetrating pool', len(keep)))
    qvel = 0.2 * torch.randn((n, m.nv), generator=g, device=dev)
    return SimpleNamespace(physics=State(
        qpos=q[keep[:n]].contiguous(), qvel=qvel,
        time=torch.zeros(n, device=dev)), params=p[keep[:n]])


def global_apgd_phase(dev, torch, label, env, reset_state, contact_state,
                      first_contact=8, energy_valley=False):
    """(34, 36, 38-40) #1's global path against its plain version on
    solves captured from the port at 1024 envs, at the reset states and in
    contact, cold and warm, under the one APGD rule (rtol = atol = 2e-4,
    at most 1% of envs decided by rounding); device time beside the bound
    of what this run's data needs (each env's active submatrix read once,
    or its matvecs at the FP32 peak) and the bytes of every row of Ad,
    the largest iteration count, us per dependent step, ns per APGD
    iteration. Contact rows start at `first_contact` (8 on the
    manipulator and the stacker, 20 on the quadruped); ``energy_valley``
    goes to ``hold_apgd`` (the quadruped's pyramid facets, four or ten
    rows over three or six directions, leave flat valleys)."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    cases = (capture_solves(dev, torch, env, reset_state, f'{label}-reset',
                            'apgd_iterate_batched')
             + capture_solves(dev, torch, env, contact_state,
                              f'{label}-contact', 'apgd_iterate_batched'))
    for tag, args, kw in cases:
        act = args[4]
        na = act.sum(1)
        n_con = int((act[:, first_contact:].sum(1) > 0).sum())
        check(A.dense_route(args[0].shape[1]) == 'global', tag)
        print(f'apgd {tag} cold={kw["cold"]}: nr {args[0].shape[1]}, active '
              f'rows a env mean {float(na.mean()):.1f} max '
              f'{int(na.max())}, {n_con} of {act.shape[0]} envs in contact; '
              f'cap {kw["iterations"]}')
        if tag.endswith('contact'):
            check(n_con >= act.shape[0] // 2, (tag, n_con))
    worst, rounding_envs = hold_apgd(
        torch, f'apgd {label}', A.apgd_iterate_batched, A.apgd_iterate_plain,
        lambda args: args[0], cases,
        energy_valley=energy_valley)
    # what the run's data needs: each env's active submatrix once and its
    # vectors; a matvec is 2 na^2 of its FLOP
    times = time_apgd(
        torch, f'apgd {label}', A.apgd_iterate_batched, A.apgd_iterate_plain,
        cases, lambda a: 2.0 * a[4].sum(1).double() ** 2,
        lambda a: 4.0 * (float((a[4].sum(1).double() ** 2).sum())
                         + 7 * a[1].numel() + a[5].numel()),
        trace_bound=False)
    for tag, args, kw in cases:
        t = times[tag + ('-cold' if kw['cold'] else '-warm')]
        t['bound_every_row_ms'] = 1e3 * 4.0 * args[0].numel() / PEAK_BYTES
        t['mean_active_rows'] = float(args[4].sum(1).mean())
    tag, args, kw = cases[-1]
    check(tag.endswith('contact') and not kw['cold'], tag)
    cap = lambda n: device_ms(lambda: A.apgd_iterate_batched(
        *args, **dict(kw, iterations=n, tol2=0.0)), 20)
    t1, t41 = cap(1), cap(41)
    iteration_ns = 1e6 * (t41 - t1) / 40
    print(f'apgd {label} {tag}-warm, tol2 = 0: {t1:.4f} ms at 1 iteration, '
          f'{t41:.4f} ms at 41: {iteration_ns:.0f} ns per APGD iteration; '
          f'bound with every row of Ad read '
          f'{times[tag + "-warm"]["bound_every_row_ms"]:.4f} ms (bytes)')
    return worst, rounding_envs, times, iteration_ns


def box_pairs_card_vs_cpu(dev, torch, env, label):
    """(36) The box pair kernels on the card against the CPU on the
    reset's 8 x 1024 draws: every contact distance within 1e-5 and, but
    where two of a pair's points tie within 1e-5 (their order is then
    rounding's), every point and frame within 1e-4."""
    from mujoco_mbrl_tpu_torch import suite
    from mujoco_mbrl_tpu_torch.physics import collision, smooth
    from mujoco_mbrl_tpu_torch.physics import model as M

    m = env.model
    m_cpu = suite.load(*label.split(), device='cpu').model
    qposes, _ = env.task.attempts(m, B, torch.Generator(
        device=dev).manual_seed(41))
    q = qposes.reshape(-1, m.nq)
    out = []
    for mm, qq in ((m, q), (m_cpu, q.cpu())):
        kin = smooth.kinematics(mm, qq, smooth.tree_meta(mm))
        out.append(collision.detect(mm, kin[3], kin[4],
                                    collision.candidate_pairs(mm)))
    card, cpu = out
    pairs = collision.candidate_pairs(m_cpu)
    box = [i for i, (g1, g2) in enumerate(pairs)
           if M.BOX in (m.geom_type[g1], m.geom_type[g2])]
    npts = [collision._PAIR_POINTS[(m.geom_type[g1], m.geom_type[g2])]
            for g1, g2 in pairs]
    off = [sum(npts[:i]) for i in range(len(pairs))]
    rows = [off[i] + k for i in box for k in range(npts[i])]
    d_card, d_cpu = card.dist.cpu()[:, rows], cpu.dist[:, rows]
    tie = torch.zeros_like(d_cpu, dtype=torch.bool)
    col = 0
    for i in box:
        k = npts[i]
        d = d_cpu[:, col:col + k]
        near = (d[:, :, None] - d[:, None, :]).abs() < 1e-5
        tie[:, col:col + k] = near.sum(2) > 1
        col += k
    dd = float((d_card - d_cpu).abs().max())
    dp = float((card.pos.cpu()[:, rows] - cpu.pos[:, rows]).abs()
               .amax(-1)[~tie].max())
    df = float((card.frame.cpu()[:, rows] - cpu.frame[:, rows]).abs()
               .amax((-2, -1))[~tie].max())
    kinds = sorted({(m.geom_type[pairs[i][0]], m.geom_type[pairs[i][1]])
                    for i in box})
    print(f'{label} box pairs {kinds} ({len(box)} pairs, {len(rows)} points)'
          f' card vs CPU on {q.shape[0]} poses: max|ddist| {dd:.2e}, '
          f'max|dpos| {dp:.2e}, max|dframe| {df:.2e}; '
          f'{int(tie.sum())} tied points; '
          f'{int((d_cpu < 0).sum())} penetrating')
    check(dd < 1e-5 and dp < 1e-4 and df < 1e-4, (label, dd, dp, df))
    return dict(max_ddist=dd, max_dpos=dp, max_dframe=df,
                points=len(rows), poses=q.shape[0])


def manipulator_agent_phase(dev, torch, tmp):
    """(35) GoalStateAgent.train() on the Manipulator wrapper (bring_ball)
    at full width: the single MLP (hidden 50) over the 29-dim featured
    state and 5 actions, CEM 1000 x 30 x 3 through #2's (5, 7, 4)
    instantiation (run-time loop bounds), 1024 seed + 1024 policy rollouts of MANIP_T control
    steps, one fit of AGENT_EPOCHS epochs at batch 512; then #2 at the
    loop's shapes (``manipulator_sampler_cases``)."""
    from mujoco_mbrl_tpu_torch import agents, data, envs, models, ops
    from mujoco_mbrl_tpu_torch import planners
    from mujoco_mbrl_tpu_torch.models import train as Mt
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C
    from mujoco_mbrl_tpu_torch.utils import MetricsWriter

    env = envs.load('manipulator', 'bring_ball', device=dev)
    check((env.state_dim, env.action_dim) == (29, 5),
          (env.state_dim, env.action_dim))
    taken = C.sampler_instantiation(K, H, 29, 5, 50)
    print(f'manipulator sampler instantiation at sd 29, ad 5, hidden 50: '
          f'{taken}')
    check(taken == (5, 7, 4, False, True), taken)
    model = models.MLPDynamics(env.state_dim, env.action_dim,
                               hidden_units=50)
    dataset = data.init_replay(2 * B, MANIP_T, env.state_dim,
                               env.observation_dim, env.action_dim,
                               device=dev)
    writer = MetricsWriter(tmp)
    agent = agents.GoalStateAgent(
        environment=env, planner=planners.CEMPlanner, model=model,
        horizon=H, optimizer=Mt.adam(0.01), rollout_length=MANIP_T,
        num_rollouts_per_iteration=B, num_train_iterations=1, writer=writer,
        base_path=tmp, dataset=dataset,
        planner_kwargs=dict(num_candidates=K, num_elites=K // 10,
                            num_iterations=ITERS),
        train_epochs=AGENT_EPOCHS, train_batch_size=AGENT_BATCH,
        num_initial_rollouts=B, seed=0)
    check(not agent.obs_only and agent.plan_dim == 29,
          (agent.obs_only, agent.plan_dim))
    phases = []

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            phases.append((name, time.perf_counter() - t0, out))
            return out
        return run

    agent.add_rollouts = timed('collect', agent.add_rollouts)
    agent.fit_model = timed('fit', agent.fit_model)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    agent.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    writer.close()
    check([p[0] for p in phases] == ['collect', 'fit', 'collect'],
          [p[0] for p in phases])
    # per collection: the reset's and the first featured state's
    # forwards, then 10 substeps and the observation's forward a control
    # step, one 452-row solve each; 3 CEM iterations per policy step
    exact_counts('manipulator agent loop', counts,
                 cem_sample_rollout=ITERS * MANIP_T,
                 apgd_solve=2 * (2 + MANIP_SOLVES * MANIP_T))
    buf = agent.dataset
    check(buf.filled == 2 * B, buf.filled)
    for name in ('states', 'observations', 'actions', 'rewards'):
        check(bool(torch.isfinite(getattr(buf, name)).all()), name)
    losses = phases[1][2].losses
    n_up = losses.shape[0]
    check(n_up == AGENT_EPOCHS * (2 * B * MANIP_T // AGENT_BATCH), n_up)
    check(bool(torch.isfinite(losses).all()), 'non-finite training loss')
    first, last = float(losses[:n_up // 10].mean()), float(
        losses[-(n_up // 10):].mean())
    check(last < first, ('training loss did not decrease', first, last))
    times = {'seed_collect_s': phases[0][1], 'fit_s': phases[1][1],
             'policy_collect_s': phases[2][1], 'train_s': wall,
             'policy_collect_ms_per_control_step':
                 1e3 * phases[2][1] / MANIP_T}
    print(f'manipulator agent loop (bring_ball, MLP over the 29-dim '
          f'featured state, {B} + {B} rollouts of {MANIP_T} control steps, '
          f'fit {AGENT_EPOCHS} epochs = {n_up} updates): '
          + ', '.join(f'{k} {v:.3f}' for k, v in times.items())
          + f'; loss {first:.4f} -> {last:.4f}; launches {counts}')
    states = phases[2][2].states[:, -1].contiguous()
    check(states.shape == (B, 29), states.shape)
    held = manipulator_sampler_cases(dev, torch, agent, states)
    return counts, times, held


def manipulator_sampler_cases(dev, torch, agent, states):
    """#2's (5, 7, 4) instantiation at the agent loop's shapes (B 1024 x K
    1000 x H 30, the policy collection's last featured states, the
    agent's goal and cost weights): held on a random MLP, every candidate
    within rtol 1e-4 of the plain cost of its own actions, and timed; then
    on the fitted params with the replay's normalizers folded in,
    reported and not held: the 5-step replay leaves the touch dims near
    constant, so their folded W1 columns reach ~1 / (std + 1e-6) and the
    costs are ill-conditioned in float32 (the kernel's 3xTF32 and the
    float32 plain against float64 arithmetic are printed, and the action
    range and antithetic identity checked)."""
    from mujoco_mbrl_tpu_torch import models
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C

    params = models.MLPDynamics(29, 5, hidden_units=50).init(
        torch.Generator().manual_seed(48), device=dev)
    g = torch.Generator(device=dev).manual_seed(48)
    out = sampler_shape_case(
        dev, torch, 'manipulator sampler (5, 7, 4), random MLP', params,
        states, agent.training_goal_state, agent.state_cost_weights, K, H,
        g, 49, (5, 7, 4, False, True))
    p, kw = agent.params, dict(normalizers=agent._normalizers(),
                               alpha_action=agent.action_cost_alpha)
    goal, weights = agent.training_goal_state, agent.state_cost_weights
    mean = (0.3 * torch.randn((B, H, 5), generator=g, device=dev)).clamp(
        -0.9, 0.9)
    std = 0.2 + torch.rand((B, H, 5), generator=g, device=dev)
    with torch.no_grad():
        costs, acts = C.mlp_sample_rollout_costs(
            p, 21, states, mean, std, goal, weights, K, **kw)
        ref = C.rollout_costs_of_actions(p, states, acts, goal, weights,
                                         **kw)
        r64 = folded_costs64(torch, C, p, kw['normalizers'], torch.float64,
                             states, acts, goal, weights,
                             kw['alpha_action'])
        r64_w32 = folded_costs64(torch, C, p, kw['normalizers'],
                                 torch.float32, states, acts, goal, weights,
                                 kw['alpha_action'])
        check(bool(torch.isfinite(costs).all())
              and float(acts.abs().max()) <= 1.0, 'manipulator fitted')
        a1, a2 = acts[..., :K // 2], acts[..., K // 2:]
        free = (a1.abs() < 1.0) & (a2.abs() < 1.0)
        check(float((a1 + a2 - 2.0 * mean[..., None]).abs()[free].max())
              < 1e-5, 'manipulator fitted antithetic')
    rel = lambda x: (x.double() - r64_w32).abs() / (r64_w32.abs() + 1e-4)
    sens = (r64_w32 - r64).abs() / (r64.abs() + 1e-4)
    w1 = C._fold_normalizers(p, kw['normalizers'])[0].detach()
    fitted = dict(
        max_w1=float(w1.abs().max()),
        weight_rounding_decided=int((sens > 1e-5).sum()),
        beyond_rtol_1e4_of_plain=int((~torch.isclose(
            costs, ref, rtol=1e-4, atol=1e-4)).sum()),
        kernel_rel_err_vs_float64_mean=float(rel(costs).mean()),
        kernel_rel_err_vs_float64_max=float(rel(costs).max()),
        plain_rel_err_vs_float64_mean=float(rel(ref).mean()),
        plain_rel_err_vs_float64_max=float(rel(ref).max()))
    print(f'manipulator fitted sampler (reported, not held; B={B} K={K} '
          f'H={H}): {fitted}')
    out['fitted_reported'] = fitted
    return out


def other_tasks_phase(dev, torch):
    """(36, 37) The slice's other four tasks through suite.load at 1024
    envs: a card reset and one control step of random actions each, with
    exact launch counts (11 #1 launches on the global path for
    manipulator bring_peg / insert_ball and stacker stack_2, none for fish
    upright) and finite states and rewards."""
    from mujoco_mbrl_tpu_torch import ops, suite

    out = {}
    for domain, task, solves in (('manipulator', 'bring_peg', MANIP_SOLVES),
                                 ('manipulator', 'insert_ball', MANIP_SOLVES),
                                 ('stacker', 'stack_2', MANIP_SOLVES),
                                 ('fish', 'upright', 0)):
        env = suite.load(domain, task, device=dev)
        gen = torch.Generator(device=dev).manual_seed(50)
        state, _ = env.reset(B, gen)
        act = 2 * torch.rand((B, env.model.nu), generator=gen,
                             device=dev) - 1
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, ts = env.step(state, act)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        label = f'{domain} {task} control step'
        exact_counts(label, dict(ops.launch_counts), apgd_solve=solves)
        for name, x in (('qpos', state.physics.qpos), ('reward', ts.reward)):
            check(bool(torch.isfinite(x).all()), (label, name))
        out[f'{domain}_{task}'] = dict(ms_per_step=1e3 * wall,
                                       apgd_solve=solves)
        print(f'{label}: one control step x {B} envs from a card reset in '
              f'{1e3 * wall:.2f} ms; {solves} #1 launches; mean reward '
              f'{float(ts.reward.mean()):.4f}')
    return out


def fish_phase(dev, torch):
    """(37) fish swim through suite.load at 1024 envs: control steps of
    random actions (10 substeps; contacts and limits off, so no constraint
    row and no launch), the card's step against the CPU's."""
    from mujoco_mbrl_tpu_torch import ops, suite

    env = suite.load('fish', 'swim', device=dev)
    state0, _ = env.reset(B, torch.Generator(device=dev).manual_seed(42))
    counts, out, warm = suite_control_steps(dev, torch, env, state0,
                                            'fish swim control step')
    exact_counts('fish swim control step', counts)
    ops.reset_launch_counts()
    out['card_vs_cpu'] = card_vs_cpu_step(dev, torch, 'fish', 'swim', warm)
    exact_counts('fish card vs CPU', dict(ops.launch_counts))
    return counts, out


# ---- slice 15: quadruped walk, escape, fetch, run (38-41) ---------------

QUAD_SOLVES = 5              # 4 substeps + the observation's forward
QUAD_CPU_ENVS = 128          # envs of the quadruped's card-vs-CPU steps
QUAD_ROWS = {'walk': 240, 'run': 240, 'escape': 356, 'fetch': 914}


def quad_rows(B_, nr):
    """The check of each #1 call on the quadruped: nr rows on #1's global
    path (the 4 tendon-equality rows, then non-negative rows only: joint
    limits, frictionless leg contacts, pyramid facets), the 60 cap."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    def rows(args, kw):
        check(args[0].shape == (B_, nr, nr) and A.dense_route(nr) ==
              'global', (args[0].shape, A.dense_route(nr)))
        check((kw['eq_rows'], kw['nonneg'], kw['box_rows'], kw['con0'],
               kw['iterations']) == ((0, 1, 2, 3), tuple(range(4, nr)), (),
                                     (), 60), kw)
    return rows


def quad_contact_state(dev, torch, env, state0, seed, steps=10):
    """The reset states after `steps` control steps of random actions: the
    robot, dropped from 1 cm above the floor, lands (toes, legs or torso
    in contact); on fetch the ball is first set resting 1 mm into the
    floor where it was drawn, so its condim-6 rows are active."""
    import dataclasses

    m = env.model
    g = torch.Generator(device=dev).manual_seed(seed)
    state = state0
    if 'ball_root' in m.names['joint']:
        qa = m.jnt_qposadr[m.name2id('joint', 'ball_root')]
        qpos = state0.physics.qpos.clone()
        qpos[:, qa + 2] = 0.149
        state = dataclasses.replace(state0, physics=state0.physics.replace(
            qpos=qpos, qvel=torch.zeros_like(state0.physics.qvel)))
    for _ in range(steps):
        act = 2 * torch.rand((state.physics.qpos.shape[0], m.nu),
                             generator=g, device=dev) - 1
        state, _ = env.step(state, act)
    return state


def quad_observation_checks(dev, torch, env, state, label):
    """One more control step (not counted) from `state`: imu, force_torque
    and torso_velocity finite; force_torque nonzero in every env where a
    toe's contact carries a normal force (the count of envs with a toe
    pressed in by over 1 mm beside it); escape's rangefinder finite in
    [-1, 1]."""
    from mujoco_mbrl_tpu_torch.suite import sensors

    m = env.model
    n = state.physics.qpos.shape[0]
    g = torch.Generator(device=dev).manual_seed(39)
    act = 2 * torch.rand((n, m.nu), generator=g, device=dev) - 1
    _, ts, data = env.step_with_data(state, act)
    obs = ts.observation
    for key in ('imu', 'force_torque', 'torso_velocity'):
        check(bool(torch.isfinite(obs[key]).all()), (label, key))
    toes = {m.name2id('geom', f'toe_{leg}') for leg in
            ('front_left', 'front_right', 'back_right', 'back_left')}
    rows = [c for c, pair in enumerate(sensors.contact_layout(m))
            if toes & set(pair)]
    # a toe's solved normal force reaches the sensor in every env (a toe
    # pressed in but leaving the ground, as after escape's drop onto its
    # terrain, carries none)
    pushed = (data.contact_force[:, rows, 0] > 0).any(1)
    pressed = (data.contact_dist[:, rows] < -1e-3).any(1)
    ft_on = obs['force_torque'].abs().amax(1) > 0
    check(int(pushed.sum()) > 0 and bool(ft_on[pushed].all()),
          (label, 'force_torque zero in envs', int(pushed.sum()),
           (pushed & ~ft_on).nonzero()[:, 0].tolist()[:20]))
    out = dict(toe_pressed_envs=int(pressed.sum()),
               toe_pushed_envs=int(pushed.sum()),
               pressed_with_force_torque_envs=int((pressed & ft_on).sum()),
               force_torque_nonzero_envs=int(ft_on.sum()))
    if 'rangefinder' in obs:
        rf = obs['rangefinder']
        check(bool((torch.isfinite(rf) & (rf >= -1) & (rf <= 1)).all()),
              (label, 'rangefinder'))
        out['rangefinder_hit_share'] = float((rf < 1).double().mean())
    print(f'{label}: observation checks on {n} envs: {out}')
    return out


def terrain_law_check(torch, terrain, label):
    """Escape's per-env terrains (B, 201, 201) against the bowl times
    uniform bumps on [0.15, 1) resized by the Keys cubic: the grid-mean of
    the envs' mean against 0.575 bowl, and of their variance against
    0.85^2 / 12 bowl^2 times the squared weights' sums."""
    from mujoco_mbrl_tpu_torch.suite import quadruped

    t = terrain.double()
    bowl = quadruped.terrain_bowl(torch.float64, t.device)
    W = torch.as_tensor(quadruped.keys_cubic_weights(30, 201),
                        device=t.device)
    s2 = (W ** 2).sum(0)
    var = 0.85 ** 2 / 12 * bowl ** 2 * s2[:, None] * s2[None, :]
    mean_ratio = float(t.mean(0).mean() / (0.575 * bowl.mean()))
    var_ratio = float(t.var(0).mean() / var.mean())
    print(f'{label}: {t.shape[0]} terrains, mean / law {mean_ratio:.5f}, '
          f'variance / law {var_ratio:.5f}')
    check(abs(mean_ratio - 1) < 5e-3 and abs(var_ratio - 1) < 0.03,
          (label, mean_ratio, var_ratio))
    return dict(mean_over_law=mean_ratio, variance_over_law=var_ratio)


def quadruped_phase(dev, torch, task, seed):
    """(38-40) quadruped `task` through suite.load at 1024 envs from a card
    reset, random actions: 4 substeps and the observation's forward (the
    IMU and the toes' force-torque sensors read its solve), so 5 #1
    launches a control step, each checked to take the global path with
    the task's rows; the activations seen to move; the observation
    checks; the card's step against the CPU's on the first QUAD_CPU_ENVS
    envs (qpos, qvel, act, reward); then #1 against its plain version on
    solves captured at the reset states and once the robots have landed
    (``quad_contact_state``)."""
    from mujoco_mbrl_tpu_torch import suite

    nr = QUAD_ROWS[task]
    env = suite.load('quadruped', task, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state0, _ = env.reset(B, torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    label = f'quadruped {task} control step'
    counts, out, warm = suite_control_steps(dev, torch, env, state0, label,
                                            rows=quad_rows(B, nr))
    exact_counts(label, counts, apgd_solve=QUAD_SOLVES * STEPS)
    moved = (warm.physics.act - state0.physics.act).abs().amax(1)
    check(bool((moved > 0).all()), (label, 'act still in',
                                    int((moved == 0).sum()), 'envs'))
    out.update(reset_s=reset_s, rows=nr, act_moved_envs=int(
        (moved > 0).sum()), observation=quad_observation_checks(
            dev, torch, env, warm, label))
    if task == 'escape':
        out['terrain'] = terrain_law_check(torch, state0.params, label)
    out.update(card_vs_cpu_envs=QUAD_CPU_ENVS, card_vs_cpu=card_vs_cpu_step(
        dev, torch, 'quadruped', task, warm, by_rounding=True,
        fields=('qpos', 'qvel', 'act'), cpu_envs=QUAD_CPU_ENVS))
    held = global_apgd_phase(
        dev, torch, task, env, state0,
        quad_contact_state(dev, torch, env, state0, seed + 1),
        first_contact=20, energy_valley=True)
    return (counts, out) + held


def quadruped_run_phase(dev, torch):
    """(41) quadruped run (walk's model, a faster target) through
    suite.load at 1024 envs: a card reset and one control step of random
    actions, 5 #1 launches on the global path at 240 rows."""
    from mujoco_mbrl_tpu_torch import ops, suite

    env = suite.load('quadruped', 'run', device=dev)
    gen = torch.Generator(device=dev).manual_seed(55)
    state, _ = env.reset(B, gen)
    act = 2 * torch.rand((B, env.model.nu), generator=gen, device=dev) - 1
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, ts = env.step(state, act)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    label = 'quadruped run control step'
    exact_counts(label, dict(ops.launch_counts), apgd_solve=QUAD_SOLVES)
    for name, x in (('qpos', state.physics.qpos), ('act', state.physics.act),
                    ('reward', ts.reward)):
        check(bool(torch.isfinite(x).all()), (label, name))
    print(f'{label}: one control step x {B} envs from a card reset in '
          f'{1e3 * wall:.2f} ms; {QUAD_SOLVES} #1 launches; mean reward '
          f'{float(ts.reward.mean()):.4f}')
    return {'quadruped_run': dict(ms_per_step=1e3 * wall,
                                  apgd_solve=QUAD_SOLVES)}


CMU_SOLVES = 10              # 10 substeps; the observation needs no solve
CMU_ROWS = 4352              # 56 joint limits, 1,074 contact points x 4
CMU_NV = 62
CMU_CPU_ENVS = 8             # envs of the card-vs-CPU step (the plain CPU
                             # step takes seconds an env at 4,352 rows)
CMU_LAND_STEPS = 1           # control steps after the drop onto the floor
                             # (~70% of the envs still in contact; they
                             # bounce off by the third)
CMU_FALL_STEPS = 20          # control steps (0.4 s) of random actions from
                             # the landed states to falling or lying ones


def cmu_rows(B_):
    """The check of each call of #1's dense iterate on factors on
    humanoid_cmu: J~ (B, 4,352, 62), past the 1024 rows of #1's dense
    paths, every row non-negative, the 60 cap."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    def rows(args, kw):
        check(args[0].shape == (B_, CMU_ROWS, CMU_NV)
              and CMU_ROWS > A.DENSE_MAX_NR, args[0].shape)
        check(kw['nonneg'] == tuple(range(CMU_ROWS))
              and kw['iterations'] == 60, kw['iterations'])
    return rows


def cmu_landed_state(dev, torch, env, state0, seed):
    """The reset states dropped onto the floor: each env lowered until its
    lowest geom is 2 mm into it, then CMU_LAND_STEPS control step of
    random actions (feet, hands, knees or the torso in contact)."""
    import dataclasses

    from mujoco_mbrl_tpu_torch.physics import collision, smooth

    m = env.model
    kin = smooth.kinematics(m, state0.physics.qpos, smooth.tree_meta(m))
    con = collision.detect(m, kin[3], kin[4], collision.candidate_pairs(m))
    floor = m.name2id('geom', 'floor')
    cols = [c for c, pair in enumerate(zip(con.geom1, con.geom2))
            if floor in pair]
    qpos = state0.physics.qpos.clone()
    qpos[:, 2] -= con.dist[:, cols].amin(1) + 0.002
    state = dataclasses.replace(state0, physics=state0.physics.replace(
        qpos=qpos))
    g = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(CMU_LAND_STEPS):
        act = 2 * torch.rand((qpos.shape[0], m.nu), generator=g,
                             device=dev) - 1
        state, _ = env.step(state, act)
    return state


class FactorAd:
    """Ad = J~ M^-1 J~' + diag(Rs) of a dense-on-factors case, formed in
    float64 only for the envs a mask selects (76 MB an env in float32 at
    4,352 rows: the batch's would not fit on the card)."""

    def __init__(self, args):
        self.args = args

    def __getitem__(self, sel):
        J, Minv, Rs = (a[sel].double() for a in self.args[:3])
        Ad = J @ Minv @ J.transpose(1, 2)
        Ad.diagonal(dim1=1, dim2=2).add_(Rs)
        return Ad


def cmu_fallen_state(dev, torch, env, landed, seed):
    """The landed states after CMU_FALL_STEPS control steps of random
    actions, falling or lying on the floor: what an episode that has lost
    its balance solves."""
    state = landed
    g = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(CMU_FALL_STEPS):
        act = 2 * torch.rand((state.physics.qpos.shape[0], env.model.nu),
                             generator=g, device=dev) - 1
        state, _ = env.step(state, act)
    return state


def cmu_stale_flops(torch, args):
    """FLOP of the row-sum bound in the envs whose warm start the Rayleigh
    guard finds stale (ops.apgd_solve.dense_factors_warm_stale): P_i =
    J~_i M^-1 and its products with every active row, 2 k nv^2 + 2 k^2
    nv. Returns (FLOP, stale envs)."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    J, Minv, Rs, _, _, v0, act = args
    stale = A.dense_factors_warm_stale(J, Minv, Rs, v0)
    k = act.sum(1).double()[stale]
    return float((2 * k * CMU_NV ** 2 + 2 * k * k * CMU_NV).sum()), int(
        stale.sum())


def dense_factors_apgd_phase(dev, torch, env, states):
    """(42) #1's dense iterate on factors against its plain version on
    solves captured from humanoid_cmu at 1024 envs from each of `states`
    (tag -> state: the reset states, landed, fallen), cold and warm, under
    the one APGD rule (rtol = atol = 2e-4, at most 1% of envs decided by
    rounding; a converged env that differs along a pyramid's flat facet
    direction counts as decided by rounding); device time beside the bound
    of what this run's data needs (each env's active rows of J~ and of
    rhs, Rs and f0, M^-1, `active` and, warm, v0 read once, f and v
    written; or 4 k nv + 2 nv^2 FLOP a matvec and, where the warm start is
    stale, the row sums at the FP32 peak), the largest iteration count, us
    per dependent step, ns per APGD iteration."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    kern = 'apgd_iterate_dense_factors'
    cases = [c for tag, state in states.items()
             for c in capture_solves(dev, torch, env, state, 'cmu-' + tag,
                                     kern)]
    stale = {}
    for tag, args, kw in cases:
        act = args[6]
        k = act.sum(1)
        n_con = int((act[:, 56:].sum(1) > 0).sum())
        past = sum(int(x) > A.dense_factors_stage_rows(int(x), CMU_NV)
                   for x in k.tolist())
        if not kw['cold']:
            stale[tag] = cmu_stale_flops(torch, args)
        print(f'apgd dense factors {tag} cold={kw["cold"]}: nr '
              f'{args[0].shape[1]}, nv {args[0].shape[2]}, active rows a '
              f'env mean {float(k.mean()):.1f} max {int(k.max())}, {n_con} '
              f'of {act.shape[0]} envs in contact, {past} envs past the '
              f'rows staged in shared memory'
              + (f', {stale[tag][1]} envs with a stale warm start'
                 if tag in stale else ''))
        if tag.endswith(('landed', 'fallen')):
            check(n_con >= act.shape[0] // 2, (tag, n_con))
    worst, rounding_envs = hold_apgd(
        torch, 'apgd dense factors humanoid_cmu',
        A.apgd_iterate_dense_factors, A.apgd_iterate_dense_factors_plain,
        FactorAd, cases, energy_valley=True,
        rhs_act=lambda a: (a[3], a[6]))
    ks = lambda a: a[6].sum(1).double()
    times = {}
    for cold in (True, False):
        # floats an env: J~'s active rows and rhs, Rs, f0 there; M^-1;
        # `active` and f, v out over all nr rows, and v0 on a warm start
        n_bytes = lambda a, nr_vecs=3 + (not cold): 4.0 * (
            float(ks(a).sum()) * (CMU_NV + 3) + a[1].numel()
            + nr_vecs * a[3].numel())
        times.update(time_apgd(
            torch, 'apgd dense factors humanoid_cmu',
            A.apgd_iterate_dense_factors, A.apgd_iterate_dense_factors_plain,
            [c for c in cases if c[2]['cold'] == cold],
            lambda a: 4.0 * ks(a) * CMU_NV + 2.0 * CMU_NV ** 2, n_bytes,
            trace_bound=False,
            stale_flops=lambda a: cmu_stale_flops(torch, a)[0]))
    for tag, args, kw in cases:
        t = times[tag + ('-cold' if kw['cold'] else '-warm')]
        t['mean_active_rows'] = float(ks(args).mean())
        t['max_active_rows'] = int(ks(args).max())
        if tag in stale and not kw['cold']:
            t['stale_envs'] = stale[tag][1]
    tag, args, kw = cases[-1]
    check(not kw['cold'], tag)
    cap = lambda n: device_ms(lambda: A.apgd_iterate_dense_factors(
        *args, **dict(kw, iterations=n, tol2=0.0)), 20)
    t1, t41 = cap(1), cap(41)
    iteration_ns = 1e6 * (t41 - t1) / 40
    print(f'apgd dense factors {tag}-warm, tol2 = 0: {t1:.4f} ms at 1 '
          f'iteration, {t41:.4f} ms at 41: {iteration_ns:.0f} ns per APGD '
          f'iteration')
    return worst, rounding_envs, times, iteration_ns


def humanoid_cmu_phase(dev, torch):
    """(42) humanoid_cmu stand through suite.load at 1024 envs from a card
    reset (10 draws an env, the first without penetration, else the
    last), random actions: 10 substeps, so 10 launches of #1's dense
    iterate on factors a control step, each checked to take 4,352 rows
    over nv 62; the peak device memory of a control step; the card's step
    against the CPU's on the first CMU_CPU_ENVS envs of the landed states
    (qpos, qvel, reward); then the kernel against its plain version on
    solves captured at the reset states and landed."""
    from mujoco_mbrl_tpu_torch import suite

    env = suite.load('humanoid_cmu', 'stand', device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state0, _ = env.reset(B, torch.Generator(device=dev).manual_seed(70))
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    label = 'humanoid_cmu stand control step'
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts, out, _ = suite_control_steps(
        dev, torch, env, state0, label, rows=cmu_rows(B),
        kernel='apgd_iterate_dense_factors')
    peak = torch.cuda.max_memory_allocated()
    exact_counts(label, counts, apgd_dense_factors=CMU_SOLVES * STEPS)
    print(f'{label}: peak device memory {peak / 1e9:.3f} GB, '
          f'{(peak - base) / 1e9:.3f} GB of it the control step\'s')
    landed = cmu_landed_state(dev, torch, env, state0, 71)
    out.update(reset_s=reset_s, rows=CMU_ROWS, peak_memory_gb=peak / 1e9,
               step_memory_gb=(peak - base) / 1e9,
               card_vs_cpu_envs=CMU_CPU_ENVS, card_vs_cpu=card_vs_cpu_step(
                   dev, torch, 'humanoid_cmu', 'stand', landed,
                   by_rounding=True, fields=('qpos', 'qvel'),
                   cpu_envs=CMU_CPU_ENVS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fallen = cmu_fallen_state(dev, torch, env, landed, 72)
    torch.cuda.synchronize()
    out['fall_s'] = time.perf_counter() - t0
    print(f'humanoid_cmu: {CMU_FALL_STEPS} control steps x {B} envs to the '
          f'fallen states in {out["fall_s"]:.1f} s; root height mean '
          f'{float(fallen.physics.qpos[:, 2].mean()):.3f} m, largest '
          f'{float(fallen.physics.qpos[:, 2].max()):.3f} m')
    held = dense_factors_apgd_phase(dev, torch, env, {
        'reset': state0, 'landed': landed, 'fallen': fallen})
    return (counts, out) + held


def humanoid_cmu_run_phase(dev, torch):
    """(43) humanoid_cmu run through suite.load at 1024 envs: a card reset
    and one control step of random actions, 10 launches of #1's dense
    iterate on factors, each checked to take 4,352 rows."""
    from mujoco_mbrl_tpu_torch import ops, suite

    env = suite.load('humanoid_cmu', 'run', device=dev)
    gen = torch.Generator(device=dev).manual_seed(75)
    state, _ = env.reset(B, gen)
    act = 2 * torch.rand((B, env.model.nu), generator=gen, device=dev) - 1
    torch.cuda.synchronize()
    with watching('apgd_iterate_dense_factors', cmu_rows(B)):
        t0 = time.perf_counter()
        state, ts = env.step(state, act)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    label = 'humanoid_cmu run control step'
    exact_counts(label, dict(ops.launch_counts),
                 apgd_dense_factors=CMU_SOLVES)
    for name, x in (('qpos', state.physics.qpos),
                    ('qvel', state.physics.qvel), ('reward', ts.reward)):
        check(bool(torch.isfinite(x).all()), (label, name))
    print(f'{label}: one control step x {B} envs from a card reset in '
          f'{1e3 * wall:.2f} ms; {CMU_SOLVES} launches; mean reward '
          f'{float(ts.reward.mean()):.4f}')
    return dict(ms_per_step=1e3 * wall, apgd_dense_factors=CMU_SOLVES)


# ---- slice 17: the tools around the engine (paths 44-47) ----------------

WALKER_SOLVES = 10           # walker: 10 substeps; its observation needs none
PAIR_STEPS = 200             # steps of the attached pendulum pair
IK_STEPS = 100               # damped least-squares steps of path 45
IK_REACH, IK_CPU_TOL = 2e-3, 1e-4
PIX = 64                     # pixel observations, PIX x PIX
PIX_CPU_ENVS = 8             # envs whose pixels the CPU renders too
PIX_SHARE, PIX_TOL, PIX_DEPTH_RTOL = 0.005, 1e-4, 1e-5
RECORD_T = 10                # record_rollout's steps (and frames)
DP_TOL = 1e-6                # dp_train_step against the one-process step


def same_model(torch, a, b, path='model'):
    """Every field of two Models (or Options) equal: tensors exactly."""
    import dataclasses
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        where = f'{path}.{f.name}'
        if isinstance(x, torch.Tensor):
            check(x.shape == y.shape and x.dtype == y.dtype
                  and x.device == y.device and bool(torch.equal(x, y)), where)
        elif dataclasses.is_dataclass(x):
            same_model(torch, x, y, where)
        else:
            check(x == y, where)


def named_reads(torch, m, state, data, ctrl, label):
    """``named`` and ``schema.bind`` on the batched card state against
    index arithmetic on the same tensors, exactly; returns the reads."""
    from mujoco_mbrl_tpu_torch.physics import named, schema

    view = named.NamedView(m)
    d = named.indexer(m).bind(state=state, data=data, ctrl=ctrl)
    n = 0
    for jname, j in m.names['joint'].items():
        q, v = m.jnt_qposadr[j], m.jnt_dofadr[j]
        check(torch.equal(view.qpos(state, jname), state.qpos[:, q]),
              (label, jname))
        check(torch.equal(d.qvel[jname], state.qvel[:, v]), (label, jname))
        check(torch.equal(schema.bind(m, 'joint', jname).qpos(state),
                          state.qpos[:, q:q + 1]), (label, jname))
        n += 3
    for bname, b in m.names['body'].items():
        check(torch.equal(d.xpos[bname, 'z'], data.xpos[:, b, 2]),
              (label, bname))
        check(torch.equal(schema.bind(m, 'body', bname).xpos(data),
                          data.xpos[:, b]), (label, bname))
        check(torch.equal(d.xmat[bname, 'zx'], data.ximat[:, b, 2, 0]),
              (label, bname))
        n += 3
    for gname, g in m.names['geom'].items():
        check(torch.equal(view.geom_xpos(data, gname), data.geom_xpos[:, g]),
              (label, gname))
        n += 1
    for aname, a in m.names['actuator'].items():
        check(torch.equal(d.ctrl[aname], ctrl[:, a]), (label, aname))
        check(torch.equal(schema.bind(m, 'actuator', aname).force(data),
                          data.actuator_force[:, a]), (label, aname))
        n += 2
    check(state.qpos.device == m.device, label)
    return n


def builder_phase(dev, torch):
    """(44) The builder on the card: walker's XML through
    ``RootElement.from_xml_string(...).compile(device='cuda')`` gives the
    Model ``mjcf.parse`` gives; one control step of 1024 envs from the
    same state on both is bitwise equal in qpos, qvel and reward, with 10
    launches of #1 on the built model's; ``named`` and ``schema.bind``
    read the batched card state as index arithmetic does. Then two
    pendulums attached as ``a/`` and ``b/`` run 1024 envs for 200 steps:
    finite, and b's gear twice a's."""
    from mujoco_mbrl_tpu_torch import ops, suite
    from mujoco_mbrl_tpu_torch.physics import builder, engine, mjcf
    from mujoco_mbrl_tpu_torch.physics import model as M
    from mujoco_mbrl_tpu_torch.suite import control, walker

    t0 = time.perf_counter()
    root = builder.RootElement.from_xml_string(walker._XML)
    check(root.schema_warnings == [], root.schema_warnings)
    built = root.compile(device=dev)
    direct = mjcf.parse(walker._XML).to(dev)
    same_model(torch, built, direct)
    check(built.ncam == 2, built.ncam)
    env_d = suite.load('walker', 'walk', device=dev)
    env_d._model = direct
    env_b = control.Environment(built, env_d.task,
                                control_timestep=env_d._control_timestep)
    gen = torch.Generator(device=dev).manual_seed(80)
    state0, _ = env_d.reset(B, gen)
    act = 2 * torch.rand((B, 6), generator=gen, device=dev) - 1
    s_d, ts_d = env_d.step(state0, act)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    s_b, ts_b, data_b = env_b.step_with_data(state0, act)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t1)
    counts = dict(ops.launch_counts)
    exact_counts('builder walker control step', counts,
                 apgd_solve=WALKER_SOLVES)
    for name, x, y in (('qpos', s_b.physics.qpos, s_d.physics.qpos),
                       ('qvel', s_b.physics.qvel, s_d.physics.qvel),
                       ('reward', ts_b.reward, ts_d.reward)):
        check(bool(torch.equal(x, y)), ('builder vs parse', name))
        check(bool(torch.isfinite(x).all()), ('builder walker', name))
    ctrl = env_b.task.before_step(act, built)
    reads = named_reads(torch, built, s_b.physics, data_b, ctrl,
                        'builder walker')
    print(f'builder walker: compiled Model equal to mjcf.parse\'s field by '
          f'field; one control step x {B} envs bitwise equal in qpos, qvel '
          f'and reward ({step_ms:.2f} ms; launches {counts}); {reads} named '
          'and schema.bind reads equal to index arithmetic')

    pair = builder.RootElement(model='pair')
    pair.option(timestep=0.002)
    pair.worldbody.add('body', name='mount_a', pos=[0, 0, 1]).attach(
        _pendulum_root(builder, 1.0), 'a/')
    pair.worldbody.add('body', name='mount_b', pos=[1, 0, 1]).attach(
        _pendulum_root(builder, 2.0), 'b/')
    pm = pair.compile(device=dev)
    ua, ub = pm.names['actuator']['a/torque'], pm.names['actuator']['b/torque']
    check(float(pm.actuator_gear[ub]) == 2 * float(pm.actuator_gear[ua]),
          'b/ gear')
    state = M.make_state(pm, batch=B)
    u = torch.ones((B, pm.nu), device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    for _ in range(PAIR_STEPS):
        state = engine.step(pm, state, u)
    torch.cuda.synchronize()
    pair_s = time.perf_counter() - t1
    pair_counts = dict(ops.launch_counts)
    exact_counts('attached pendulum pair', pair_counts,
                 apgd_solve=PAIR_STEPS)
    for name, x in (('qpos', state.qpos), ('qvel', state.qvel)):
        check(bool(torch.isfinite(x).all()), ('pendulum pair', name))
    a, b = (float(state.qpos[0, pm.jnt_qposadr[pm.names['joint'][j]]])
            for j in ('a/hinge', 'b/hinge'))
    check(abs(a) > 1e-3 and abs(b) > 1e-3, ('the pair swung', a, b))
    data = engine.forward(pm, state, u, acc_stage=False)
    reads += named_reads(torch, pm, state, data, u, 'pendulum pair')
    print(f'builder pendulum pair (a/, b/, gear 1 and 2): {PAIR_STEPS} steps '
          f'x {B} envs in {pair_s:.2f} s, finite; hinges at {a:.4f} / '
          f'{b:.4f} rad; launches {pair_counts}; '
          f'{time.perf_counter() - t0:.1f} s in all')
    return counts, pair_counts, dict(step_ms=step_ms, pair_s=pair_s,
                                     named_reads=reads)


def _pendulum_root(builder, gear):
    root = builder.RootElement(model='pendulum')
    root.option(timestep=0.002)
    body = root.worldbody.add('body', name='pole', pos=[0, 0, 1])
    body.add('joint', name='hinge', type='hinge', axis=[0, 1, 0],
             damping=0.05)
    body.add('geom', name='mass', type='sphere', size=[0.05], mass=1,
             pos=[0.5, 0, 0])
    root.actuator.add('motor', name='torque', joint='hinge', gear=gear)
    return root


def ik_phase(dev, torch):
    """(45) IK on the card: swimmer6's head site placed by
    ``qpos_from_site_pose`` (100 steps) at the head positions of poses
    the script draws (root within 0.2 m, hinges N(0, 0.3)), one pose an
    env for 1024 envs: every env within 2e-3 of its target, and the
    card's qpos within 1e-4 of the CPU's on the first 8 envs."""
    import numpy as np

    from mujoco_mbrl_tpu_torch import ops
    from mujoco_mbrl_tpu_torch.physics import ik, mjcf, smooth
    from mujoco_mbrl_tpu_torch.suite import swimmer

    m_cpu = mjcf.parse(swimmer._make_model_xml(6))
    m = m_cpu.to(dev)
    rng = np.random.default_rng(90)
    pose = np.tile(m_cpu.qpos0.numpy(), (B, 1))
    pose[:, :2] += rng.uniform(-0.2, 0.2, (B, 2))
    pose[:, 3:] += rng.normal(0, 0.3, (B, m.nq - 3))
    pose = torch.tensor(pose, dtype=torch.float32, device=dev)
    sid = m.name2id('site', 'head')
    head = lambda mm, q: smooth.kinematics(mm, q, smooth.tree_meta(mm))[5][
        :, sid]
    target = head(m, pose)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    q, err = ik.qpos_from_site_pose(m, 'head', target, max_steps=IK_STEPS)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    exact_counts('ik', counts)
    reach = (head(m, q) - target).norm(dim=-1)
    check(bool(torch.isfinite(q).all()), 'ik qpos')
    n_far = int((reach > IK_REACH).sum())
    check(n_far == 0, ('ik: envs not within 2e-3', n_far,
                       float(reach.max())))
    n = PIX_CPU_ENVS
    q_cpu, _ = ik.qpos_from_site_pose(m_cpu, 'head', target[:n].cpu(),
                                      max_steps=IK_STEPS)
    dq = float((q[:n].cpu() - q_cpu).abs().max())
    check(dq < IK_CPU_TOL, ('ik card vs CPU', dq))
    print(f'ik: swimmer6 head, {IK_STEPS} steps x {B} envs in '
          f'{1e3 * solve_s:.1f} ms; every env within {IK_REACH} (largest '
          f'{float(reach.max()):.2e} m, last-step error norm '
          f'{float(err.max()):.2e}); card vs CPU on {n} envs max|dqpos| '
          f'{dq:.2e}; launches {counts}')
    return counts, dict(solve_ms=1e3 * solve_s, max_reach_m=float(
        reach.max()), max_dqpos_cpu=dq)


def pixel_edges(np, seg, rgb):
    """Pixels with a 4-neighbour of another segmentation id or shade."""
    out = np.zeros(seg.shape, bool)
    for axis in (-1, -2):
        step = ((np.diff(seg, axis=axis) != 0)
                | (np.abs(np.diff(rgb, axis=axis - 1)).max(-1) > 1e-2))
        lo = [slice(None)] * seg.ndim
        hi = [slice(None)] * seg.ndim
        lo[axis], hi[axis] = slice(None, -1), slice(1, None)
        out[tuple(lo)] |= step
        out[tuple(hi)] |= step
    return out


def hold_pixels(label, ours, ref):
    """Card (seg, depth, rgb) against the CPU's: a pixel whose id
    differs, or whose depth or shade differs while it lies on an edge of
    the CPU's image (a silhouette grazed, a box edge's tied normals), is
    decided by rounding, at most 0.5% of them; every other pixel within
    1e-4 in depth (1e-5 relative past 10 m) and RGB. Returns the share
    decided."""
    import numpy as np
    seg, depth, rgb = (np.asarray(x) for x in ours)
    cseg, cdepth, crgb = (np.asarray(x) for x in ref)
    same = seg == cseg
    with np.errstate(invalid='ignore'):
        close_d = (np.isinf(depth) & np.isinf(cdepth)) | (
            np.abs(depth - cdepth) <= PIX_TOL + PIX_DEPTH_RTOL
            * np.abs(cdepth))
    close_c = np.abs(rgb - crgb).max(-1) <= PIX_TOL
    off = ~(same & close_d & close_c)
    inner = off & same & ~pixel_edges(np, cseg, crgb)
    check(not inner.any(), (label, 'off an edge', np.argwhere(inner)[:5]))
    check(off.sum() <= PIX_SHARE * seg.size, (label, int(off.sum())))
    fin = ~off & np.isfinite(cdepth)
    return dict(decided_share=float(off.sum() / seg.size),
                seg_differs=int((~same).sum()),
                max_ddepth=float(np.abs(depth[fin] - cdepth[fin]).max(
                    initial=0.0)),
                max_drgb=float(np.abs(rgb[~off] - crgb[~off]).max(
                    initial=0.0)))


def camera_card_vs_cpu(torch, cam, cam_cpu, m_cpu, qpos, label):
    """The camera's seg, depth and RGB of the first PIX_CPU_ENVS envs,
    card against CPU (the CPU's forward of the same qpos)."""
    from mujoco_mbrl_tpu_torch.physics import engine
    from mujoco_mbrl_tpu_torch.physics import model as M

    n = PIX_CPU_ENVS
    q = qpos[:n]
    out = []
    for mm, cc, qq in ((cam._m, cam, q), (m_cpu, cam_cpu, q.cpu())):
        data = engine.forward(mm, M.make_state(mm, qpos=qq), torch.zeros(
            (n, mm.nu), device=qq.device), acc_stage=False)
        out.append(tuple(x.cpu().numpy() for x in (
            cc.render(data, segmentation=True), cc.render(data, depth=True),
            cc.render(data))))
    return hold_pixels(label, out[0], out[1])


def pixel_step_phase(dev, torch, domain, task, seed, solves):
    """(46) PixelWrapper on suite.load(domain, task) at 64 x 64 through
    camera 0: reset and one control step of 1024 envs (launches of #1
    counted), the render time of the batch, its share of the control
    step, the step's peak device memory, and card vs CPU on 8 envs."""
    from mujoco_mbrl_tpu_torch import ops, suite
    from mujoco_mbrl_tpu_torch.suite import wrappers
    from mujoco_mbrl_tpu_torch.utils.raycast import Camera

    env = suite.load(domain, task, device=dev)
    px = wrappers.PixelWrapper(env, height=PIX, width=PIX)
    check(px._camera is not None, (domain, 'camera 0'))
    gen = torch.Generator(device=dev).manual_seed(seed)
    act = 2 * torch.rand((B, env.model.nu), generator=gen, device=dev) - 1
    px.reset(B, gen)                              # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, ts = px.reset(B, gen)
    torch.cuda.synchronize()
    reset_ms = 1e3 * (time.perf_counter() - t0)
    reset_counts = dict(ops.launch_counts)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, ts = px.step(state, act)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    counts = dict(ops.launch_counts)
    label = f'{domain} {task} pixels'
    exact_counts(label + ' reset', reset_counts)
    exact_counts(label + ' control step', counts, apgd_solve=solves)
    pix = ts.observation['pixels']
    check(tuple(pix.shape) == (B, PIX, PIX, 3), (label, tuple(pix.shape)))
    check(bool(torch.isfinite(pix).all()) and float(pix.min()) >= 0
          and float(pix.max()) <= 1, (label, 'range'))
    render_ms = time_ms(lambda: px.render(state), 3)
    env_cpu = suite.load(domain, task, device='cpu')
    cam_cpu = Camera(env_cpu.model, PIX, PIX, 0)
    held = camera_card_vs_cpu(torch, px._camera, cam_cpu, env_cpu.model,
                              state.physics.qpos, label)
    out = dict(reset_ms=reset_ms, step_ms=step_ms, render_ms=render_ms,
               render_share=render_ms / step_ms, peak_memory_gb=peak / 1e9,
               step_memory_gb=(peak - base) / 1e9, **held)
    print(f'{label}: {PIX} x {PIX} through camera 0 ({env.model.cam_mode[0]})'
          f' x {B} envs; reset {reset_ms:.2f} ms (launches {reset_counts}), '
          f'control step with pixels {step_ms:.2f} ms (launches {counts}); '
          f'render of the batch {render_ms:.2f} ms = '
          f'{100 * out["render_share"]:.1f}% of the step; peak device '
          f'memory {peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB the '
          f'step\'s); card vs CPU on {PIX_CPU_ENVS} envs: {held}')
    return counts, out, env, state


def movable_camera_phase(dev, torch, env, state):
    """(46) A MovableCamera over the walker batch, card vs CPU on 8."""
    from mujoco_mbrl_tpu_torch import suite
    from mujoco_mbrl_tpu_torch.utils.raycast import MovableCamera

    pose = dict(lookat=(0.0, 0.0, 1.0), distance=3.0, azimuth=60.0,
                elevation=-20.0)
    cam = MovableCamera(env.model, PIX, PIX, **pose)
    m_cpu = suite.load('walker', 'walk', device='cpu').model
    held = camera_card_vs_cpu(torch, cam, MovableCamera(m_cpu, PIX, PIX,
                                                        **pose),
                              m_cpu, state.physics.qpos, 'movable camera')
    print(f'walker movable camera {pose}: card vs CPU on {PIX_CPU_ENVS} '
          f'envs: {held}')
    return held


def record_phase(dev, torch, tmp):
    """(46) ``record_rollout`` of one walker env for 10 steps into a temp
    dir: the GIF exists and holds 10 frames (one a replayed step)."""
    from mujoco_mbrl_tpu_torch import envs, ops
    from mujoco_mbrl_tpu_torch.utils import recorder

    w = envs.load('walker', 'walk', device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rolls = w.record_rollout(torch.Generator(device=dev).manual_seed(95),
                             RECORD_T, mp4path=os.path.join(tmp, 'walker'))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    # the rollout's 10 steps and their replay, 10 solves each
    exact_counts('record_rollout', counts,
                 apgd_solve=2 * RECORD_T * WALKER_SOLVES)
    path = os.path.join(tmp, 'walker.gif')
    frames = recorder.gif_frame_count(path)
    check(frames == RECORD_T, ('record_rollout frames', frames))
    check(tuple(rolls.actions.shape) == (1, RECORD_T, 6),
          tuple(rolls.actions.shape))
    print(f'record_rollout: walker, {RECORD_T} steps, {frames} frames '
          f'({os.path.getsize(path)} bytes of GIF) in {wall:.2f} s; '
          f'launches {counts}')
    return counts, dict(seconds=wall, frames=frames)


def distributed_phase(dev, torch, tmp):
    """(47) Distributed on one card: ``distributed_init`` with NCCL,
    world size 1 (a group that does not form fails the phase); inside
    ``profiling.trace``: ``sharded_collect`` of cartpole swingup, 1024
    rollouts x 5 steps, equal to the unsharded collect from the same
    seed, and ``dp_train_step`` of an MLPDynamics within 1e-6 of the
    one-process step; the trace file written."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from mujoco_mbrl_tpu_torch import envs, ops, parallel
    from mujoco_mbrl_tpu_torch.models import MLPDynamics, train
    from mujoco_mbrl_tpu_torch.utils import profiling

    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    parallel.distributed_init(f'localhost:{port}', 1, 0, device=dev)
    backend = dist.get_backend()
    check(backend == ('nccl' if dev.type == 'cuda' else 'gloo'), backend)
    try:
        mesh = parallel.make_mesh(('env',))
        check(mesh.device_type == dev.type, mesh.device_type)
        logdir = os.path.join(tmp, 'trace')
        w = envs.load('cartpole', 'swingup', device=dev)
        timer = profiling.PhaseTimer()
        with profiling.trace(logdir):
            ops.reset_launch_counts()
            with timer.phase('sharded_collect', sync=True):
                rolls = parallel.sharded_collect(mesh, w, B, 5)(
                    torch.Generator(device=dev).manual_seed(97))
            counts = dict(ops.launch_counts)
            with timer.phase('collect', sync=True):
                ref = w.get_rollouts(torch.Generator(device=dev)
                                     .manual_seed(97), B, 5)
            for f in ('states', 'observations', 'actions', 'rewards'):
                x = getattr(rolls, f)
                check(isinstance(x, DTensor)
                      and list(x.placements) == [Shard(0)], f)
                check(bool(torch.equal(x.full_tensor(), getattr(ref, f))),
                      ('sharded collect', f))
            model = MLPDynamics(rolls.states.shape[-1],
                                rolls.actions.shape[-1])
            batch = dict(states=rolls.states.to_local()[:, :-1],
                         actions=rolls.actions.to_local(),
                         rewards=rolls.rewards.to_local(),
                         next_states=rolls.states.to_local()[:, 1:])
            steps = {}
            for name in ('dp', 'one'):
                params = model.init(torch.Generator().manual_seed(7),
                                    device=dev)
                with timer.phase(f'{name}_train_step', sync=True):
                    if name == 'dp':
                        step = parallel.dp_train_step(mesh, model,
                                                      train.adam(1e-3))
                        params, _, loss = step(params, None, batch)
                    else:
                        leaves = train.param_leaves(params)
                        for leaf in leaves:
                            leaf.requires_grad_(True)
                        opt = train.adam(1e-3)(leaves)
                        loss = model.loss(params, batch)
                        loss.backward()
                        opt.step()
                steps[name] = (float(loss.detach()),
                               train.param_leaves(params))
            dp_err = max(float((a - b).detach().abs().max())
                         for a, b in zip(steps['dp'][1], steps['one'][1]))
            check(abs(steps['dp'][0] - steps['one'][0]) <= DP_TOL
                  and dp_err <= DP_TOL, ('dp_train_step', steps['dp'][0],
                                         steps['one'][0], dp_err))
        traces = [f for f in os.listdir(logdir) if f.endswith('.json')]
        check(len(traces) == 1 and os.path.getsize(
            os.path.join(logdir, traces[0])) > 0, ('trace', traces))
    finally:
        dist.destroy_process_group()
    phases = {k: v['total_s'] for k, v in timer.summary().items()}
    print(f'distributed ({backend}, world size 1): sharded_collect of '
          f'cartpole '
          f'swingup, {B} x 5, equal to the unsharded collect (launches '
          f'{counts}); dp_train_step within {dp_err:.1e} of the one-process '
          f'step (loss {steps["dp"][0]:.6f}); trace {traces[0]} '
          f'({os.path.getsize(os.path.join(logdir, traces[0]))} bytes); '
          f'phases {phases}; {time.perf_counter() - t0:.1f} s')
    return counts, dict(phases_s=phases, dp_max_abs_err=dp_err)


# ---- slice 18: the model-building stack and the viewer (paths 48-52) -----

COMPOSED_SOLVES = 5          # 0.025 s control steps over 0.005 s physics
CORRIDOR_ROWS, CORRIDOR_NV = 234, 9   # capsules against three planes
PROP_SOLVES = 4              # 0.02 s control steps over 0.005 s physics
PROP_BALLS, PROP_STEPS = 3, 25
PROP_ROWS = 4 * (PROP_BALLS + PROP_BALLS * (PROP_BALLS - 1) // 2)
SOCCER_ROWS, SOCCER_NV = 716, 18      # 2v2: boxes, spheres, box-box pairs
BUFFER_DELAY, BUFFER_SIZE = 2, 4      # path 48's median pipeline
CORRIDOR_STEPS = 6                    # its control steps: the ring turns
NOISE_STD = 0.05                      # path 48's Additive(Normal) corruptor
VIEWER_STEPS, VIEWER_STRIDE = 50, 2   # path 52's walker episode
LIVE_STEPS = 5
EXPLORE_STEPS = 20


def factored_rows(B_, nr, nv):
    """Each #7 call on the corridor: J~ (B, nr, nv), the factored regime's
    block path."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    def rows(args, kw):
        check(args[0].shape == (B_, nr, nv)
              and A.factored_route(nr, nv) == 'block',
              (args[0].shape, A.factored_route(nr, nv)))
    return rows


def dense_rows(B_, nr, route):
    """Each #1 call: Ad (B, nr, nr) on `route` of dense_route."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    def rows(args, kw):
        check(args[0].shape == (B_, nr, nr) and A.dense_route(nr) == route,
              (args[0].shape, A.dense_route(nr)))
    return rows


def corridor_task(composer, locomotion, variation):
    """Path 48's task: RunThroughCorridor(PlanarWalker) with two pipeline
    observables, the walker's root velocity through a median of 4 delayed
    2 steps, and its torso height with Additive(Normal(0, 0.05)) noise."""
    class Corridor(locomotion.RunThroughCorridor):
        @composer.observable(delay=BUFFER_DELAY, buffer_size=BUFFER_SIZE,
                             aggregator='median')
        def median_velocity(self, model, phys, data):
            return self.walker.velocity(model, phys, data)

        @composer.observable(corruptor=variation.Additive(
            variation.Normal(0.0, NOISE_STD)))
        def noisy_height(self, model, phys, data):
            return self.walker.torso_height(model, phys, data)

    return Corridor(target_velocity=3.0)


def composed_steps(dev, torch, env, state, label, kernel, rows, nu,
                   seed, steps=STEPS):
    """`steps` control steps of random actions from `state` with every
    launch count zeroed just before and read just after; each call of
    the ops.apgd_solve wrapper `kernel` checked by `rows`. Returns
    (counts, ms per control step, the states and TimeSteps, actions)."""
    from mujoco_mbrl_tpu_torch import ops

    g = torch.Generator(device=dev).manual_seed(seed)
    B_ = (state['inner'] if isinstance(state, dict) else state
          ).physics.qpos.shape[0]
    acts = [2 * torch.rand((B_, nu), generator=g, device=dev) - 1
            for _ in range(steps)]
    torch.cuda.synchronize()
    out = []
    with watching(kernel, rows):
        t0 = time.perf_counter()
        for a in acts:
            state, ts = env.step(state, a)
            out.append((state, ts))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    inner = state['inner'] if isinstance(state, dict) else state
    for name, x in (('qpos', inner.physics.qpos),
                    ('qvel', inner.physics.qvel), ('reward', ts.reward)):
        check(bool(torch.isfinite(x).all()), (label, name))
    ms = 1e3 * wall / steps
    print(f'{label}: {steps} control steps x {B_} envs in {wall:.3f} s = '
          f'{ms:.2f} ms per control step; launches {counts}')
    return counts, ms, out, acts


def composer_phase(dev, torch):
    """(48) composer + observation: RunThroughCorridor(PlanarWalker) with
    a median pipeline and a corruptor, at 1024 envs: a card reset and 3
    control steps (5 #7 launches a step on its block path, 234 rows over
    nv 9: the factored regime), the card's step against the CPU's on the
    first CPU_CHECK_ENVS envs; the pipeline's median card against CPU
    bit for bit on the card's raw velocity sequence; the corruptor's
    noise by its mean and std."""
    from mujoco_mbrl_tpu_torch import (composer, locomotion, observation,
                                       variation)

    label = 'corridor control step'
    task = corridor_task(composer, locomotion, variation)
    env = composer.make_env(task, time_limit=5.0, device=dev)
    check(isinstance(env, observation.BufferedEnvironment), type(env))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state0, ts0 = env.reset(B, torch.Generator(device=dev).manual_seed(80))
    torch.cuda.synchronize()
    reset_ms = 1e3 * (time.perf_counter() - t0)
    counts, ms, out, _ = composed_steps(
        dev, torch, env, state0, label, 'apgd_iterate_factored',
        factored_rows(B, CORRIDOR_ROWS, CORRIDOR_NV), env.model.nu, 81,
        steps=CORRIDOR_STEPS)
    exact_counts(label, counts, apgd_factored=COMPOSED_SOLVES * CORRIDOR_STEPS)
    # the pipeline: the card's raw velocity sequence through the CPU's
    # buffers gives the card's median, bit for bit
    spec = observation.ObservableSpec(delay=BUFFER_DELAY,
                                      buffer_size=BUFFER_SIZE,
                                      aggregator='median')
    raw = [ts0.observation['walker/velocity']] + [
        ts.observation['walker/velocity'] for _, ts in out]
    st = observation.init_buffer(spec, raw[0].cpu())
    check(torch.equal(observation.read_buffer(spec, st),
                      ts0.observation['median_velocity'].cpu()), 'reset')
    for k, (_, ts) in enumerate(out):
        st = observation.update_buffer(spec, st, raw[k + 1].cpu())
        check(torch.equal(observation.read_buffer(spec, st),
                          ts.observation['median_velocity'].cpu()),
              ('median pipeline, step', k))
    # the corruptor: noisy height - height, over B envs and 3 steps
    noise = torch.cat([ts.observation['noisy_height']
                       - ts.observation['walker/torso_height']
                       for _, ts in out])
    n = noise.numel()
    mean, std = float(noise.mean()), float(noise.std())
    check(abs(mean) < 5 * NOISE_STD / math.sqrt(n)
          and abs(std - NOISE_STD) < 5 * NOISE_STD / math.sqrt(2 * n),
          ('corruptor', mean, std))
    warm = out[0][0]['inner']
    held = card_vs_cpu_step(
        dev, torch, 'corridor', 'walker', warm, by_rounding=True,
        fields=('qpos', 'qvel'), envs=(env._env, composer.make_env(
            corridor_task(composer, locomotion, variation), time_limit=5.0,
            device='cpu')._env))
    res = dict(ms_per_step=ms, reset_ms=reset_ms, rows=CORRIDOR_ROWS,
               nv=CORRIDOR_NV, route='factored block (#7)',
               launches_per_control_step=COMPOSED_SOLVES,
               noise_mean=mean, noise_std=std, card_vs_cpu=held)
    print(f'{label}: reset {reset_ms:.2f} ms; {CORRIDOR_ROWS} rows over nv '
          f'{CORRIDOR_NV}, #7 block path, {COMPOSED_SOLVES} launches a '
          f'control step; median pipeline card = CPU bit for bit over '
          f'{len(out) + 1} observations; corruptor noise mean {mean:.2e} std '
          f'{std:.5f} over {n} draws')
    return counts, res


def props_task(torch, composer, props, arenas):
    """Path 49's task: PROP_BALLS Primitive spheres dropped from per-env
    random spots onto a Floor, a PositionDetector zone over part of it
    registering them all; the reward counts the balls detected."""
    class Drop(composer.Task):
        control_timestep = 0.02
        OBSERVES_ACC = False

        def __init__(self):
            super().__init__(arenas.Floor(size=(4.0, 4.0)))
            self.balls = [self.attach(props.Primitive(
                geom_type='sphere', size=[0.1], pos=(0.3 * i, 0.0, 0.5)),
                f'ball{i}/') for i in range(PROP_BALLS)]
            self.detector = self.attach(props.PositionDetector(
                pos=[0.5, 0.0, 0.1], size=[0.5, 0.4, 0.15]), 'zone/')
            self.detector.register_entities(*self.balls)

        def initialize_episode(self, model, batch, generator):
            state, params = super().initialize_episode(model, batch,
                                                       generator)
            qpos = state.qpos
            for i, ball in enumerate(self.balls):
                xy = 2.0 * torch.rand((batch, 2), generator=generator,
                                      device=generator.device) - 0.5
                pos = torch.cat([xy, torch.full_like(xy[:, :1],
                                                     0.3 + 0.3 * i)], 1)
                qpos = ball.set_pose(model, qpos, pos=pos.to(qpos.device))
            return state.replace(qpos=qpos), params

        def get_reward(self, model, phys, data, ctrl):
            return self.detector.detections(model, data).sum(-1).to(
                phys.qpos.dtype)

    return Drop()


def props_phase(dev, torch):
    """(49) props: PROP_BALLS spheres dropped from per-env spots onto the
    floor of 1024 envs, a detector zone over part of it: a card reset and
    PROP_STEPS control steps (4 #1 launches a step on its warp path,
    PROP_ROWS rows); the card's step against the CPU's, and the card's
    detections against the CPU's on the first CPU_CHECK_ENVS envs of the
    landed states (a flag may differ only where a ball lies within 1e-4
    of a zone face)."""
    from mujoco_mbrl_tpu_torch import composer, props
    from mujoco_mbrl_tpu_torch.locomotion import arenas
    from mujoco_mbrl_tpu_torch.physics import engine
    from mujoco_mbrl_tpu_torch.physics import model as M

    label = 'props control step'
    task = props_task(torch, composer, props, arenas)
    env = composer.make_env(task, device=dev)
    state0, _ = env.reset(B, torch.Generator(device=dev).manual_seed(85))
    counts, ms, out, _ = composed_steps(
        dev, torch, env, state0, label, 'apgd_iterate_batched',
        dense_rows(B, PROP_ROWS, 'warp'), 0, 86, steps=PROP_STEPS)
    exact_counts(label, counts, apgd_solve=PROP_SOLVES * PROP_STEPS)
    state, ts = out[-1]
    z = state.physics.qpos[:, [env.model.jnt_qposadr[env.model.names[
        'joint'][f'ball{i}/prop_root']] + 2 for i in range(PROP_BALLS)]]
    landed = float((z < 0.15).float().mean())
    check(landed > 0.9, ('balls landed', landed))
    task_cpu = props_task(torch, composer, props, arenas)
    env_cpu = composer.make_env(task_cpu, device='cpu')
    n = CPU_CHECK_ENVS
    m, m_cpu = env.model, env_cpu.model
    det = task.detector.detections(m, engine.forward(
        m, state.physics, torch.zeros((B, 0), device=dev),
        acc_stage=False))[:n].cpu()
    phys_cpu = M.make_state(m_cpu, qpos=state.physics.qpos[:n].cpu())
    data_cpu = engine.forward(m_cpu, phys_cpu, torch.zeros((n, 0)),
                              acc_stage=False)
    det_cpu = task_cpu.detector.detections(m_cpu, data_cpu)
    lo, hi = task_cpu.detector.zone(m_cpu, data_cpu)
    ids = [b.body_id(m_cpu) for b in task_cpu.balls]
    p = data_cpu.xpos[:, ids]
    margin = torch.minimum((p - lo[:, None]).abs(),
                           (p - hi[:, None]).abs()).amin(-1)
    differ = det != det_cpu
    check(not bool((differ & (margin > 1e-4)).any()), (label, 'detections'))
    detected = int(det_cpu.sum())
    check(0 < detected < det_cpu.numel(), ('both kinds of flags', detected))
    held = card_vs_cpu_step(dev, torch, 'props', 'drop', out[0][0],
                            fields=('qpos', 'qvel'),
                            envs=(env, composer.make_env(props_task(
                                torch, composer, props, arenas), device='cpu')))
    res = dict(ms_per_step=ms, rows=PROP_ROWS, route='warp (#1)',
               launches_per_control_step=PROP_SOLVES, landed_share=landed,
               detected=detected,
               flags=int(det_cpu.numel()),
               detections_differ=int(differ.sum()), card_vs_cpu=held)
    print(f'{label}: {PROP_BALLS} balls x {B} envs, {100 * landed:.1f}% '
          f'on the floor after {PROP_STEPS} steps; {PROP_ROWS} '
          f'rows on #1\'s warp path; detections card vs CPU on {n} envs: '
          f'{detected} of {det_cpu.numel()} flags set, '
          f'{int(differ.sum())} differ (each within 1e-4 of a zone face)')
    return counts, res


def cmu_walker_phase(dev, torch):
    """(50) GoToTarget(CMUHumanoid) on the floor at 1024 envs: a card reset
    and one control step (5 launches of #1's dense iterate on factors,
    each checked to take J~ (1024, 4,352, 62)); the step's peak device
    memory; the card's step against the CPU's on its first CMU_CPU_ENVS
    envs."""
    from mujoco_mbrl_tpu_torch import composer, locomotion, ops
    from mujoco_mbrl_tpu_torch.locomotion import walkers

    label = 'CMU walker go-to-target control step'
    make = lambda d: composer.make_env(locomotion.GoToTarget(
        walker=walkers.CMUHumanoid()), time_limit=5.0, device=d)
    env = make(dev)
    check(env.model.nu == 56 and env.model.nv == CMU_NV, env.model.nv)
    gen = torch.Generator(device=dev).manual_seed(87)
    state, _ = env.reset(B, gen)
    act = 2 * torch.rand((B, 56), generator=gen, device=dev) - 1
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with watching('apgd_iterate_dense_factors', cmu_rows(B)):
        t0 = time.perf_counter()
        new, ts = env.step(state, act)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = dict(ops.launch_counts)
    exact_counts(label, counts, apgd_dense_factors=COMPOSED_SOLVES)
    for name, x in (('qpos', new.physics.qpos), ('qvel', new.physics.qvel),
                    ('reward', ts.reward)):
        check(bool(torch.isfinite(x).all()), (label, name))
    held = card_vs_cpu_step(dev, torch, 'cmu_walker', 'go_to_target', state,
                            by_rounding=True, fields=('qpos', 'qvel'),
                            cpu_envs=CMU_CPU_ENVS, envs=(env, make('cpu')))
    res = dict(ms_per_step=1e3 * wall, rows=CMU_ROWS, nv=CMU_NV,
               route='dense iterate on factors (#1)',
               launches_per_control_step=COMPOSED_SOLVES,
               peak_memory_gb=peak / 1e9, step_memory_gb=(peak - base) / 1e9,
               card_vs_cpu_envs=CMU_CPU_ENVS, card_vs_cpu=held)
    print(f'{label}: one control step x {B} envs from a card reset in '
          f'{1e3 * wall:.2f} ms; {CMU_ROWS} rows over nv {CMU_NV} on #1\'s '
          f'dense iterate on factors, {COMPOSED_SOLVES} launches; peak '
          f'device memory {peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB '
          f'the step\'s); mean reward {float(ts.reward.mean()):.4f}')
    return counts, res


def soccer_phase(dev, torch):
    """(51) soccer.load(team_size=2) on a RandomizedPitch at 1024 envs: a
    card reset and 3 control steps (5 #1 launches a step on its global
    path, SOCCER_ROWS rows over nv 18; walls and posts moved per env);
    the card's step against the CPU's on the first CPU_CHECK_ENVS envs; a
    ball placed in each env's away goal gives rewards [+1, +1, -1, -1],
    LAST and discount 0, then autoreset_step returns FIRST with (B, 4)
    zero rewards."""
    from mujoco_mbrl_tpu_torch.locomotion import soccer
    from mujoco_mbrl_tpu_torch.suite import control

    label = 'soccer 2v2 control step'
    make = lambda d: soccer.load(team_size=2, time_limit=45.0, device=d,
                                 pitch=soccer.RandomizedPitch())
    env = make(dev)
    check(env.model.nu == 12 and env.model.nv == SOCCER_NV, env.model.nv)
    gen = torch.Generator(device=dev).manual_seed(88)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state0, _ = env.reset(B, gen)
    torch.cuda.synchronize()
    reset_ms = 1e3 * (time.perf_counter() - t0)
    m0 = env._model_with(state0.params)
    check(m0.geom_pos.shape == (B, env.model.ngeom, 3)
          and float(m0.geom_pos[:, env.model.names['geom']['wall_px'], 0]
                    .std()) > 0, 'per-env walls')
    counts, ms, out, _ = composed_steps(
        dev, torch, env, state0, label, 'apgd_iterate_batched',
        dense_rows(B, SOCCER_ROWS, 'global'), 12, 89)
    exact_counts(label, counts, apgd_solve=COMPOSED_SOLVES * STEPS)
    check(tuple(out[-1][1].reward.shape) == (B, 4), out[-1][1].reward.shape)
    held = card_vs_cpu_step(dev, torch, 'soccer', '2v2', out[0][0],
                            by_rounding=True, fields=('qpos', 'qvel'),
                            envs=(env, make('cpu')))
    # a goal: the ball 0.25 past each env's sampled away goal line
    state = out[-1][0]
    length, _ = env.task._task.pitch.episode_size(state.params[0])
    m = env._model_with(state.params)
    a = m.jnt_qposadr[m.names['joint']['ball/root']]
    qpos = state.physics.qpos.clone()
    qpos[:, a] = length / 2 + 0.25
    qpos[:, a + 1] = 0.0
    state = control.EnvState(physics=state.physics.replace(qpos=qpos),
                             params=state.params,
                             step_count=state.step_count, last=state.last)
    zeros = torch.zeros((B, 12), device=dev)
    state, ts = env.step(state, zeros)
    want = torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev)
    check(bool(ts.last().all()) and float(ts.discount.abs().max()) == 0
          and bool((ts.reward == want).all()), ('goal', ts.reward[:2]))
    _, ts = env.autoreset_step(state, zeros, gen)
    check(bool(ts.first().all()) and tuple(ts.reward.shape) == (B, 4)
          and float(ts.reward.abs().max()) == 0, ('autoreset after a goal',
                                                   ts.reward.shape))
    res = dict(ms_per_step=ms, reset_ms=reset_ms, rows=SOCCER_ROWS,
               nv=SOCCER_NV, route='global (#1)',
               launches_per_control_step=COMPOSED_SOLVES, card_vs_cpu=held,
               solve=soccer_solve_times(dev, torch, env, out[0][0]))
    print(f'{label}: reset {reset_ms:.2f} ms; {SOCCER_ROWS} rows over nv '
          f'{SOCCER_NV} on #1\'s global path, {COMPOSED_SOLVES} launches a '
          f'control step; a goal in every env: rewards [+1, +1, -1, -1], '
          f'LAST, discount 0; autoreset: FIRST, (B, 4) zero rewards')
    return counts, res


def soccer_solve_times(dev, torch, env, state):
    """#1 on the 716-row solves of one soccer step (cold, then warm from
    its forces) captured at `state` with its per-env walls and posts:
    held against the plain twin and timed beside the bound of each env's
    active submatrix (as global_apgd_phase does)."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A
    from mujoco_mbrl_tpu_torch.physics import engine

    m = env._model_with(state.params)
    zero = torch.zeros((B, m.nu), device=dev)
    cases, real = [], A.apgd_iterate_batched

    def capture(*args, **kw):
        cases.append(('soccer', tuple(a.clone() for a in args), dict(kw)))
        return real(*args, **kw)

    A.apgd_iterate_batched = capture
    try:
        s1, f, v = engine.step_warm(m, state.physics, zero)
        engine.step_warm(m, s1, zero, warm_f=f, warm_v=v)
    finally:
        A.apgd_iterate_batched = real
    check([c[2]['cold'] for c in cases] == [True, False], 'soccer solves')
    worst, rounding_envs = hold_apgd(
        torch, 'apgd soccer', A.apgd_iterate_batched, A.apgd_iterate_plain,
        lambda args: args[0], cases, energy_valley=True)
    times = time_apgd(
        torch, 'apgd soccer', A.apgd_iterate_batched, A.apgd_iterate_plain,
        cases, lambda a: 2.0 * a[4].sum(1).double() ** 2,
        lambda a: 4.0 * (float((a[4].sum(1).double() ** 2).sum())
                         + 7 * a[1].numel() + a[5].numel()),
        trace_bound=False)
    del cases
    return dict(times, max_abs_err=worst, rounding_decided_envs=rounding_envs)


def viewer_phase(dev, torch, tmp):
    """(52) the viewer: ``launch`` on walker walk for VIEWER_STEPS steps
    (10 #1 launches a step) with the GIF and HTML written, its frames held
    against the card's render of the recorded states bit for bit and 8 of
    them against a CPU render under the pixel rule (hold_pixels); 5
    ``LiveSession`` steps and a perturbation; one ``serve`` round trip on
    127.0.0.1 at an ephemeral port; ``explore.main`` on cartpole swingup
    with the reward tint (4 #1 launches a step)."""
    import json as _json
    import threading
    import urllib.request

    import numpy as np

    from mujoco_mbrl_tpu_torch import ops, suite, viewer
    from mujoco_mbrl_tpu_torch.physics import model as M
    from mujoco_mbrl_tpu_torch.suite import explore
    from mujoco_mbrl_tpu_torch.utils import recorder
    from mujoco_mbrl_tpu_torch.utils.raycast import Camera

    env = suite.load('walker', 'walk', device=dev)
    qpos, real_step = [], env.step

    def recording_step(state, action):
        state, ts = real_step(state, action)
        if len(qpos) % VIEWER_STRIDE == 0:
            qpos.append(state.physics.qpos.clone())
        else:
            qpos.append(None)
        return state, ts

    env.step = recording_step
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = viewer.launch(env, steps=VIEWER_STEPS,
                        path=os.path.join(tmp, 'walker'), html=True,
                        verbose=False, device=dev)
    torch.cuda.synchronize()
    launch_s = time.perf_counter() - t0
    env.step = real_step
    launch_counts = dict(ops.launch_counts)
    exact_counts('viewer.launch', launch_counts,
                 apgd_solve=WALKER_SOLVES * VIEWER_STEPS)
    F = len(range(0, VIEWER_STEPS, VIEWER_STRIDE))
    frames = out['frames']
    check(frames.shape == (F, 120, 160, 3) and frames.dtype == np.uint8,
          frames.shape)
    check(recorder.gif_frame_count(out['gif']) == F, 'gif frames')
    with open(out['html']) as fh:
        check(fh.read().count('data:image/png;base64,') == F, 'html frames')
    traj = torch.cat([q for q in qpos if q is not None])
    cam = Camera(env.model, 120, 160, 0)
    states = M.make_state(env.model, qpos=traj)
    again = viewer.render_states(env, states, (), cam)
    check(np.array_equal(again, frames), 'launch frames = the render')
    render_ms = time_ms(lambda: viewer.render_states(env, states, (), cam),
                        3)
    env_cpu = suite.load('walker', 'walk', device='cpu')
    held = camera_card_vs_cpu(torch, cam, Camera(env_cpu.model, 120, 160, 0),
                              env_cpu.model, traj[::F // PIX_CPU_ENVS],
                              'viewer frames')
    # the live session: 5 steps and a perturbation
    ops.reset_launch_counts()
    s = viewer.LiveSession(env, height=64, width=64, device=dev)
    for _ in range(LIVE_STEPS):
        snap = s.step()
    before = float(s.state.physics.qvel[0, 3])
    s.perturb(dof=3, dv=2.0)
    check(abs(float(s.state.physics.qvel[0, 3]) - before - 2.0) < 1e-5,
          'perturb')
    live_counts = dict(ops.launch_counts)
    exact_counts('LiveSession', live_counts,
                 apgd_solve=WALKER_SOLVES * LIVE_STEPS)
    check(snap['t'] == LIVE_STEPS and 'frame' in snap, snap['t'])
    # one serve round trip over a loopback socket
    httpd = viewer.make_server(env, host='127.0.0.1', port=0, height=32,
                               width=32, device=dev)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        page = urllib.request.urlopen(f'http://127.0.0.1:{port}/',
                                      timeout=60).read().decode()
        req = urllib.request.Request(
            f'http://127.0.0.1:{port}/step', data=b'{"policy": "zero"}',
            headers={'Content-Type': 'application/json'})
        reply = _json.loads(urllib.request.urlopen(req, timeout=60).read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    check('live viewer' in page and reply['t'] == 1 and 'frame' in reply,
          'serve round trip')
    # the explorer on cartpole swingup with the reward tint
    ops.reset_launch_counts()
    ex = explore.main(['cartpole.swingup', '--steps', str(EXPLORE_STEPS),
                       '--visualize_reward', '--out',
                       os.path.join(tmp, 'explore'), '--device', dev.type])
    explore_counts = dict(ops.launch_counts)
    exact_counts('explore', explore_counts,
                 apgd_solve=RK4_SOLVES * EXPLORE_STEPS)
    check(ex['rewards'].shape == (EXPLORE_STEPS,)
          and os.path.exists(ex['gif']) and os.path.exists(ex['html']),
          'explore outputs')
    res = dict(launch_s=launch_s, frames=F, render_ms=render_ms,
               render_ms_per_frame=render_ms / F, gif_bytes=os.path.getsize(
                   out['gif']), html_bytes=os.path.getsize(out['html']),
               live_steps=LIVE_STEPS, explore_steps=EXPLORE_STEPS, **held)
    print(f'viewer: launch of walker walk, {VIEWER_STEPS} steps in '
          f'{launch_s:.2f} s (launches {launch_counts}), {F} frames of '
          f'120 x 160 rendered as one batch in {render_ms:.2f} ms; GIF '
          f'{res["gif_bytes"]} bytes, HTML {res["html_bytes"]} bytes; '
          f'frames card vs CPU on {PIX_CPU_ENVS}: {held}; LiveSession '
          f'{LIVE_STEPS} steps + a perturbation (launches {live_counts}); '
          f'serve round trip on port {port}; explore cartpole.swingup '
          f'{EXPLORE_STEPS} steps with the tint (launches {explore_counts})')
    return launch_counts, live_counts, explore_counts, res


# ---- slice 19: the last physics branches (paths 53-56) ------------------
# path 54's model, held identical in tests/test_torch_ball_joints.py: a
# base on a limited ball joint, a capsule on a hinge driven by a velocity
# servo, a capsule on a second ball joint, a floor the chain reaches, and
# a <sensor> and a <contact><pair> that the compiler drops, as JAX's does
BALL_CHAIN_XML = """
<mujoco model='ball_chain'>
  <option timestep='0.005'/>
  <default><geom friction='0.8 0.01 0.001'/></default>
  <worldbody>
    <geom name='floor' type='plane' size='3 3 .1'/>
    <body name='base' pos='0 0 0.65'>
      <joint name='hang' type='ball' limited='true' range='0 60'
             damping='0.5'/>
      <geom name='base' type='capsule' fromto='0 0 0 0 0 -0.3'
            size='0.05'/>
      <body name='arm' pos='0 0 -0.3'>
        <joint name='elbow' type='hinge' axis='0 1 0' damping='0.1'/>
        <geom name='arm' type='capsule' fromto='0 0 0 0.3 0 -0.2'
              size='0.04'/>
        <body name='tip' pos='0.3 0 -0.2'>
          <joint name='wrist' type='ball' damping='0.05'/>
          <geom name='tip' type='capsule' fromto='0 0 0 0 0 -0.35'
                size='0.04'/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <velocity name='spin' joint='elbow' kv='3' ctrllimited='true'
              ctrlrange='-2 2'/>
  </actuator>
  <contact><pair geom1='floor' geom2='tip'/></contact>
  <sensor><jointvel name='elbow_vel' joint='elbow'/></sensor>
</mujoco>
"""


PGS_STEPS = 2                # path 53's timed control steps
PGS_SETTLE_STEPS = 40        # zero-action control steps before the force check
PGS_FORCE_RTOL = 0.02        # PGS against APGD on the total normal force
BALL_STEPS = 25              # path 54's physics steps
ENS_K = 1000                 # candidates a env of the ensemble's forward_ts
FL_ROWS, FL_NV = 152, 9      # cheetah: 6 friction-loss + 146 rows over nv 9
FL_H_ROWS, FL_H_NV, FL_H_B = 324, 27, 512   # humanoid: 21 + 303 over nv 27
ELLIPTIC_ROWS = 830          # quadruped fetch, elliptic: 4 + 16 + 270 x 3


def with_model(env, model):
    """`env` stepping `model` (an option or a default class changed) in
    place of the one its suite loader compiled."""
    env._model = model
    return env


def with_option(env, **opt):
    import dataclasses
    return with_model(env, env.model.replace(
        opt=dataclasses.replace(env.model.opt, **opt)))


def frictionloss_xml(xml, joint_default):
    """`xml` with frictionloss='.1' added to the joint default that starts
    with `joint_default`."""
    check(xml.count(joint_default) == 1, joint_default)
    return xml.replace(joint_default, joint_default + "frictionloss='.1' ")


CHEETAH_JOINT_CLASS = "<default class='cheetah'>\n      <joint "
HUMANOID_JOINT_CLASS = "<joint type='hinge' damping='.2' "


def physics_card_vs_cpu(dev, torch, m_dev, m_cpu, state, ctrl, label,
                        cpu_envs=CPU_CHECK_ENVS):
    """One physics step of `state` under `ctrl`: on the card at the whole
    batch and on the CPU from its first `cpu_envs` envs, compared in qpos
    and qvel within 1e-3."""
    from mujoco_mbrl_tpu_torch.physics import engine
    from mujoco_mbrl_tpu_torch.physics.model import State

    n = min(cpu_envs, state.qpos.shape[0])
    out = engine.step(m_dev, state, ctrl)
    cut = lambda x: None if x is None else x[:n].cpu()
    ref = engine.step(m_cpu, State(qpos=cut(state.qpos),
                                   qvel=cut(state.qvel),
                                   time=cut(state.time), act=cut(state.act)),
                      cut(ctrl))
    d = {f: float((getattr(out, f)[:n].cpu() - getattr(ref, f)).abs().max())
         for f in ('qpos', 'qvel')}
    print(f'{label} physics step, card at {state.qpos.shape[0]} envs vs '
          f'plain CPU at its first {n}: max|dqpos| {d["qpos"]:.2e}, '
          f'max|dqvel| {d["qvel"]:.2e}')
    check(max(d.values()) < 1e-3, (label, d))
    return {f'max_d{k}': v for k, v in d.items()}


def linear_ensemble_check(dev, torch):
    """A LinearDynamics ensemble (5 members, the walker's 24 + 6 dims) over
    B x ENS_K candidate rows: forward_ts on the card (row k -> member k %
    5, each member's base forward on its rows) against the same call on
    the CPU, within 1e-5 of the largest output; its time."""
    from mujoco_mbrl_tpu_torch.models import dynamics as D

    ens = D.EnsembleDynamics(D.LinearDynamics(24, 6), 5)
    params = ens.init(torch.Generator().manual_seed(53), device=dev)
    g = torch.Generator(device=dev).manual_seed(54)
    s = torch.randn((B * ENS_K, 24), generator=g, device=dev)
    a = torch.rand((B * ENS_K, 6), generator=g, device=dev) * 2 - 1
    norms = D.Normalizers(state_mean=torch.randn(24, generator=g,
                                                 device=dev),
                          state_std=torch.rand(24, generator=g,
                                               device=dev) + 0.5)
    out = ens.forward_ts(params, s, a, norms)
    ms = time_ms(lambda: ens.forward_ts(params, s, a, norms), 5)
    cpu = lambda x: tree_map(torch, lambda t: t.cpu(), x)
    ref = ens.forward_ts(cpu(params), s.cpu(), a.cpu(), D.Normalizers(
        state_mean=norms.state_mean.cpu(), state_std=norms.state_std.cpu()))
    err = float((out.cpu() - ref).abs().max())
    scale = float(ref.abs().max())
    print(f'LinearDynamics ensemble forward_ts, {B} x {ENS_K} rows x 5 '
          f'members: {ms:.3f} ms on the card; max|card - CPU| {err:.3e} '
          f'(largest output {scale:.3e})')
    check(tuple(out.shape) == (B * ENS_K, 24) and err <= 1e-5 * (1 + scale),
          ('linear ensemble', err))
    return dict(ms=ms, rows=B * ENS_K, max_abs_err=err)


def pgs_walker_phase(dev, torch):
    """(53) walker walk with opt.solver = 'pgs' through suite.load at 1024
    envs: a card reset and PGS_STEPS timed control steps of random actions
    (10 substeps, each a PGS solve in plain PyTorch, so #1 launches 0
    times); the card's step against the CPU's; the ms of one PGS solve
    captured from a substep; at states settled on the floor by
    PGS_SETTLE_STEPS zero-action control steps (APGD, not counted), the
    total normal force of the PGS forward within 2% of the APGD forward's
    (JAX's tests/test_solver_contact.py:126-127); a LinearDynamics
    ensemble's forward_ts card vs CPU."""
    from mujoco_mbrl_tpu_torch import suite
    from mujoco_mbrl_tpu_torch.physics import engine
    from mujoco_mbrl_tpu_torch.physics import solver as S

    label = 'walker walk (PGS) control step'
    make = lambda d: with_option(suite.load('walker', 'walk', device=d),
                                 solver='pgs')
    env = make(dev)
    gen = torch.Generator(device=dev).manual_seed(53)
    state0, _ = env.reset(B, gen)
    counts, out, warm = suite_control_steps(dev, torch, env, state0, label,
                                            steps=PGS_STEPS)
    exact_counts(label, counts)
    out['card_vs_cpu'] = card_vs_cpu_step(dev, torch, 'walker', 'walk', warm,
                                          envs=(env, make('cpu')))
    # one PGS solve: a control step's second substep, warm started
    captured, real = [], S.solve

    def capture(*args, **kw):
        captured.append((args, kw))
        return real(*args, **kw)

    S.solve = capture
    try:
        env.step(warm, torch.zeros((B, env.model.nu), device=dev))
    finally:
        S.solve = real
    args, kw = captured[1]
    nr = args[1].J.shape[1]
    solve_ms = time_ms(lambda: S.solve(*args, **kw), 3)
    # resting on the floor: PGS against APGD on the same states
    apgd = suite.load('walker', 'walk', device=dev)
    settled, zeros = state0, torch.zeros((B, env.model.nu), device=dev)
    for _ in range(PGS_SETTLE_STEPS):
        settled, _ = apgd.step(settled, zeros)
    f_n = lambda m: engine.forward(m, settled.physics, zeros).contact_force[
        ..., 0].sum(1)
    f_pgs, f_apgd = f_n(env.model), f_n(apgd.model)
    torch.cuda.synchronize()
    total = (float(f_pgs.sum()), float(f_apgd.sum()))
    rel = (f_pgs - f_apgd).abs() / f_apgd.clamp(min=1e-6)
    weight = float(env.model.body_mass.sum()) * 9.81
    within = float((rel <= PGS_FORCE_RTOL).double().mean())
    print(f'{label}: {nr} rows a solve; one PGS solve (30 sweeps over the '
          f'blocks, plain PyTorch) {solve_ms:.2f} ms at {B} envs; at rest '
          f'after {PGS_SETTLE_STEPS} control steps: total normal force PGS '
          f'{total[0]:.1f} N, APGD {total[1]:.1f} N over {B} envs (the '
          f'walker\'s weight {weight:.2f} N a env); {100 * within:.1f}% of '
          f'envs within {100 * PGS_FORCE_RTOL:.0f}% of APGD, median '
          f'{float(rel.median()):.2e}')
    check(abs(total[0] - total[1]) <= PGS_FORCE_RTOL * total[1],
          ('PGS vs APGD normal force', total))
    check(float(rel.median()) <= PGS_FORCE_RTOL, ('median', rel.median()))
    out.update(rows=nr, pgs_solve_ms=solve_ms, solves_per_control_step=10,
               normal_force_pgs=total[0], normal_force_apgd=total[1],
               envs_within_2pct=within,
               linear_ensemble=linear_ensemble_check(dev, torch))
    return counts, out


def ball_chain_phase(dev, torch):
    """(54) BALL_CHAIN_XML (ball joints, a velocity servo; its <sensor> and
    <contact><pair> dropped) at 1024 envs: joints drawn by the randomizer
    (the limited ball joint within 60 degrees, the free one uniform on
    S^3), then BALL_STEPS physics steps of random controls, one #1 launch
    each on the path its rows take; the ball quaternions' norms; a step
    card vs CPU."""
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A
    from mujoco_mbrl_tpu_torch.physics import engine, mjcf
    from mujoco_mbrl_tpu_torch.physics.model import make_state
    from mujoco_mbrl_tpu_torch.suite import randomizers

    label = 'ball chain'
    m_cpu = mjcf.parse(BALL_CHAIN_XML)
    check((m_cpu.nq, m_cpu.nv, m_cpu.nu, m_cpu.contact_excludes)
          == (9, 7, 1, ()), (m_cpu.nq, m_cpu.nv))
    m = m_cpu.to(dev)
    gen = torch.Generator(device=dev).manual_seed(54)
    qpos = randomizers.randomize_limited_and_rotational_joints(
        m, m.qpos0.expand(B, m.nq).clone(), gen)
    angle = 2 * torch.acos(qpos[:, 0].clamp(-1, 1))
    check(float(angle.max()) <= float(m.jnt_range[0, 1]) + 1e-5,
          ('ball limit', float(angle.max())))
    state = make_state(m, qpos=qpos)
    ctrls = [4 * torch.rand((B, 1), generator=gen, device=dev) - 2
             for _ in range(BALL_STEPS)]
    seen, in_contact = set(), torch.zeros(B, dtype=torch.bool, device=dev)

    def rows(args, kw):
        seen.add(args[0].shape[1])
        check(args[0].shape[0] == B, args[0].shape)

    torch.cuda.synchronize()
    with watching('apgd_iterate_batched', rows):
        t0 = time.perf_counter()
        for c in ctrls:
            state = engine.step(m, state, c)
            in_contact |= (engine.forward(m, state, c, acc_stage=False)
                           .contact_dist < 0).any(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from mujoco_mbrl_tpu_torch import ops
    counts = dict(ops.launch_counts)
    exact_counts(label, counts, apgd_solve=BALL_STEPS)
    (nr,) = seen
    norm_dev = max(float((torch.linalg.vector_norm(
        state.qpos[:, a:a + 4], dim=1) - 1).abs().max()) for a in (0, 5))
    check(bool(torch.isfinite(state.qpos).all()) and norm_dev < 1e-5,
          (label, norm_dev))
    n_con = int(in_contact.sum())
    check(n_con > 0, (label, 'no contact'))
    held = physics_card_vs_cpu(dev, torch, m, m_cpu, state, ctrls[-1], label)
    route = A.dense_route(nr)
    ms = 1e3 * wall / BALL_STEPS
    print(f'{label}: {BALL_STEPS} steps x {B} envs in {wall:.3f} s = '
          f'{ms:.2f} ms a step; #1 launched {counts["apgd_solve"]} times on '
          f'its {route} path at {nr} rows; {n_con} envs touched the floor; '
          f'largest | |q| - 1 | of a ball quaternion {norm_dev:.2e}')
    return counts, dict(ms_per_step=ms, rows=nr, route=route,
                        envs_in_contact=n_con, quat_norm_dev=norm_dev,
                        card_vs_cpu=held)


def fl_rows(B_, nr, nv, n_box):
    """Each #7 call with friction loss: J~ (B, nr, nv) on the path its
    shape takes, the box rows first, the bounds per env (B, nr)."""
    def rows(args, kw):
        check(args[0].shape == (B_, nr, nv) and args[9].shape == (B_, nr)
              and kw['box_rows'] == tuple(range(n_box)),
              (args[0].shape, args[9].shape, kw['box_rows']))
    return rows


def frictionloss_phase(dev, torch):
    """(55) cheetah run with frictionloss='.1' in its cheetah joint class
    at 1024 envs: a card reset (200 settling solves, not counted), then
    STEPS control steps of random actions, one #7 launch each on its warp
    path with the 6 + 146 rows and per-env bounds (B, 152); the card's
    step against the CPU's; #7 against its plain twin on solves captured
    from the port (cold and warm), and on one humanoid solve with the same
    default at B 512 (21 + 303 rows, the block path), with their device
    times beside the bound; #7's time with the bounds shared (nr,) on the
    cheetah's solves beside its per-env time."""
    from mujoco_mbrl_tpu_torch import suite
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A
    from mujoco_mbrl_tpu_torch.physics import mjcf
    from mujoco_mbrl_tpu_torch.suite import cheetah, humanoid

    label = 'cheetah run (friction loss) control step'
    xml = frictionloss_xml(cheetah._XML, CHEETAH_JOINT_CLASS)
    make = lambda d: with_model(suite.load('cheetah', 'run', device=d),
                                mjcf.parse(xml).to(d))
    env = make(dev)
    gen = torch.Generator(device=dev).manual_seed(55)
    state0, _ = env.reset(B, gen)
    counts, out, warm = suite_control_steps(
        dev, torch, env, state0, label, rows=fl_rows(B, FL_ROWS, FL_NV, 6),
        kernel='apgd_iterate_factored')
    exact_counts(label, counts, apgd_factored=STEPS)
    out['card_vs_cpu'] = card_vs_cpu_step(dev, torch, 'cheetah', 'run', warm,
                                          by_rounding=True,
                                          envs=(env, make('cpu')))
    cases = capture_solves(dev, torch, env, warm, 'cheetah-frictionloss',
                           'apgd_iterate_factored')
    h_env = with_model(
        suite.load('humanoid', 'walk', device=dev),
        mjcf.parse(frictionloss_xml(humanoid._XML, HUMANOID_JOINT_CLASS)
                   ).to(dev))
    h_state, _ = h_env.reset(FL_H_B, gen)
    h_cases = capture_solves(dev, torch, h_env, h_state,
                             'humanoid-frictionloss', 'apgd_iterate_factored')
    for tag, args, kw in cases + h_cases:
        check(args[9].dim() == 2 and len(kw['box_rows']) in (6, 21), tag)
    check(A.factored_route(FL_ROWS, FL_NV) == 'warp'
          and tuple(h_cases[0][1][0].shape) == (FL_H_B, FL_H_ROWS, FL_H_NV)
          and A.factored_route(FL_H_ROWS, FL_H_NV) == 'block', 'routes')
    worst, rounding_envs, times = hold_time_factored(torch, cases + h_cases)
    shared = {}
    for tag, args, kw in cases:
        one = args[:9] + (args[9][0].contiguous(),)
        key = tag + ('-cold' if kw['cold'] else '-warm')
        shared[key] = device_ms(lambda: A.apgd_iterate_factored(*one, **kw),
                                20)
        print(f'apgd factored {key}: per-env bounds (B, {FL_ROWS}) '
              f'{times[key]["ms"]:.4f} ms, the same solves with env 0\'s '
              f'bounds shared ({FL_ROWS},) {shared[key]:.4f} ms (device)')
    out.update(rows=FL_ROWS, nv=FL_NV, route='warp (#7)',
               humanoid_rows=FL_H_ROWS, humanoid_route='block (#7)')
    return counts, out, worst, rounding_envs, times, shared


def elliptic_quadruped_phase(dev, torch):
    """(56) quadruped fetch with cone='elliptic' at 1024 envs: a card reset
    and STEPS control steps of random actions, 5 #1 launches a step (4
    substeps and the observation's forward) at ELLIPTIC_ROWS rows: the 4
    equality rows, the joint limits, then a (normal, t1, t2) triple a
    contact, the ball's condim-6 pairs too; the card's step against the
    CPU's on QUAD_CPU_ENVS envs; #1 against its plain twin on solves
    captured at the reset states and landed."""
    from mujoco_mbrl_tpu_torch import suite
    from mujoco_mbrl_tpu_torch.ops import apgd_solve as A

    label = 'quadruped fetch (elliptic) control step'
    make = lambda d: with_option(suite.load('quadruped', 'fetch', device=d),
                                 cone='elliptic')
    env = make(dev)
    gen = torch.Generator(device=dev).manual_seed(56)
    state0, _ = env.reset(B, gen)
    nr = ELLIPTIC_ROWS

    def rows(args, kw):
        n_con = (nr - 20) // 3
        check(args[0].shape == (B, nr, nr)
              and kw['eq_rows'] == (0, 1, 2, 3)
              and kw['con0'] == tuple(range(20, nr, 3))
              and len(kw['nonneg']) == 16 and not kw['box_rows'],
              (args[0].shape, len(kw['con0']), n_con))
        check(bool((args[5][20::3] >= 0).all()), 'cone friction')

    counts, out, warm = suite_control_steps(dev, torch, env, state0, label,
                                            rows=rows)
    exact_counts(label, counts, apgd_solve=QUAD_SOLVES * STEPS)
    out['card_vs_cpu'] = card_vs_cpu_step(
        dev, torch, 'quadruped', 'fetch', warm, by_rounding=True,
        fields=('qpos', 'qvel', 'act'), cpu_envs=QUAD_CPU_ENVS,
        envs=(env, make('cpu')))
    cases = (capture_solves(dev, torch, env, state0, 'elliptic-reset',
                            'apgd_iterate_batched')
             + capture_solves(dev, torch, env, quad_contact_state(
                 dev, torch, env, state0, 57), 'elliptic-contact',
                 'apgd_iterate_batched'))
    worst, rounding_envs = hold_apgd(
        torch, 'apgd quadruped elliptic', A.apgd_iterate_batched,
        A.apgd_iterate_plain, lambda args: args[0], cases,
        energy_valley=True)
    times = time_apgd(
        torch, 'apgd quadruped elliptic', A.apgd_iterate_batched,
        A.apgd_iterate_plain, cases,
        lambda a: 2.0 * a[4].sum(1).double() ** 2,
        lambda a: 4.0 * (float((a[4].sum(1).double() ** 2).sum())
                         + 7 * a[1].numel() + a[5].numel()),
        trace_bound=False)
    route = A.dense_route(nr)
    print(f'{label}: {nr} rows ({(nr - 20) // 3} contact triples) on #1\'s '
          f'{route} path, {QUAD_SOLVES} launches a control step')
    out.update(rows=nr, route=f'{route} (#1)',
               launches_per_control_step=QUAD_SOLVES)
    return counts, out, worst, rounding_envs, times


# ---- slice 20: the last API pieces (path 57) ------------------------------
# the flaky-init model of JAX's tests/test_reset_retry.py (and of
# tests/test_torch_reset_retry.py): a free-swinging sphere whose reset
# draws a NaN qpos where an env's uniform draw falls under the fail rate
FLAKY_XML = """
<mujoco model='m'>
  <option timestep='0.01'/>
  <worldbody>
    <body name='b' pos='0 0 1'>
      <joint name='j' type='hinge' axis='0 1 0' limited='false'/>
      <geom name='g' type='sphere' size='.1'/>
    </body>
  </worldbody>
</mujoco>"""
FLAKY_FAIL, FLAKY_ATTEMPTS = 0.5, 6
FLAKY_MAX_BAD = 0.03         # 0.5 ** 6 = 1.6% of envs expected non-finite
ROLLOUT_STEPS = 10           # get_rollout's walker control steps
ROLLOUT_ATOL = 1e-3          # its card against the CPU


def flaky_task(torch):
    from mujoco_mbrl_tpu_torch.physics import make_state
    from mujoco_mbrl_tpu_torch.suite import base

    class Flaky(base.Task):
        OBSERVES_ACC = False

        def initialize_episode(self, model, batch, generator):
            u = torch.rand((batch,), generator=generator,
                           device=generator.device)
            st = make_state(model, batch=batch)
            return st.replace(qpos=torch.where(
                (u < FLAKY_FAIL)[:, None],
                torch.full_like(st.qpos, float('nan')), st.qpos)), ()

        def get_observation(self, model, phys, data):
            return {'pos': phys.qpos}

        def get_reward(self, model, phys, data, ctrl):
            return torch.zeros_like(phys.time)

    return Flaky()


def api_pieces_phase(dev, torch):
    """(57) The last API pieces, through the entry points a user calls:
    walker walk at B envs reset through suite.load's environment_kwargs
    with max_reset_attempts 1 and 6, each bitwise the plain reset (the
    task's initialize_episode and Environment.start from the same seed,
    as the environment reset before retries were ported; no walker draw
    diverges); the flaky-init task at B envs, about half its envs NaN
    with one draw and at most FLAKY_MAX_BAD of them with FLAKY_ATTEMPTS;
    the walker wrapper's get_rollout of ROLLOUT_STEPS control steps under
    a deterministic policy, card against CPU from one initial_state
    within ROLLOUT_ATOL, #1 launched 10 times a control step;
    check_divergence raising on a NaN env and passing on a finite batch.
    Every launch count is zeroed before each piece and read after it."""
    from mujoco_mbrl_tpu_torch import envs, ops, suite
    from mujoco_mbrl_tpu_torch.physics import engine, mjcf
    from mujoco_mbrl_tpu_torch.suite import control

    out = {}
    plain = suite.load('walker', 'walk', device=dev)
    ref, ref_ts = plain.start(*plain.task.initialize_episode(
        plain.model, B, torch.Generator(device=dev).manual_seed(57)))
    reset_counts = {}
    for attempts in (1, 6):
        env = suite.load('walker', 'walk', device=dev,
                         environment_kwargs={'max_reset_attempts': attempts})
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, ts = env.reset(B, torch.Generator(device=dev).manual_seed(57))
        torch.cuda.synchronize()
        out[f'walker_reset_ms_attempts_{attempts}'] = 1e3 * (
            time.perf_counter() - t0)
        reset_counts[attempts] = dict(ops.launch_counts)
        exact_counts(f'walker reset, max_reset_attempts={attempts}',
                     reset_counts[attempts])
        same = (torch.equal(state.physics.qpos, ref.physics.qpos)
                and torch.equal(state.physics.qvel, ref.physics.qvel)
                and all(torch.equal(ts.observation[k], v)
                        for k, v in ref_ts.observation.items()))
        check(same, ('walker reset not bitwise the plain reset', attempts))
    engine.check_divergence(state.physics)
    nan_qpos = state.physics.qpos.clone()
    nan_qpos[B // 2, 3] = float('nan')
    try:
        engine.check_divergence(state.physics.replace(qpos=nan_qpos))
        raised = False
    except engine.PhysicsError:
        raised = True
    check(raised, 'check_divergence passed a NaN env')

    flaky_m = mjcf.parse(FLAKY_XML).to(dev)
    bad = {}
    for attempts in (1, FLAKY_ATTEMPTS):
        env = control.Environment(flaky_m, flaky_task(torch),
                                  max_reset_attempts=attempts)
        ops.reset_launch_counts()
        state, _ = env.reset(B, torch.Generator(device=dev).manual_seed(58))
        exact_counts(f'flaky reset, max_reset_attempts={attempts}',
                     dict(ops.launch_counts))
        bad[attempts] = int((~torch.isfinite(state.physics.qpos)).any(1)
                            .sum())
    check(bad[1] >= B // 4, ('flaky reset, one draw', bad))
    check(bad[FLAKY_ATTEMPTS] <= FLAKY_MAX_BAD * B,
          ('flaky reset, retries', bad))

    w = torch.randn((24, 6), generator=torch.Generator().manual_seed(59))
    s0 = envs.load('walker', 'walk', device='cpu').sample_state(
        torch.Generator().manual_seed(59))

    def rollout(where):
        wrap, wd = envs.load('walker', 'walk', device=where), w.to(where)
        return wrap.get_rollout(
            torch.Generator(device=where).manual_seed(60), ROLLOUT_STEPS,
            lambda g, t, s, o, c: (torch.tanh(o @ wd), c),
            initial_state=s0.to(where))

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card = rollout(dev)
    torch.cuda.synchronize()
    walls = {'cuda': time.perf_counter() - t0}
    roll_counts = dict(ops.launch_counts)
    t0 = time.perf_counter()
    cpu = rollout(torch.device('cpu'))
    walls['cpu'] = time.perf_counter() - t0
    exact_counts('walker get_rollout', roll_counts,
                 apgd_solve=10 * ROLLOUT_STEPS)
    shapes = {f: tuple(getattr(card, f).shape) for f in (
        'states', 'observations', 'actions', 'rewards')}
    check(shapes == {'states': (1, ROLLOUT_STEPS + 1, 20),
                     'observations': (1, ROLLOUT_STEPS + 1, 24),
                     'actions': (1, ROLLOUT_STEPS, 6),
                     'rewards': (1, ROLLOUT_STEPS)}, shapes)
    err = max(float((getattr(card, f).cpu() - getattr(cpu, f)).abs().max())
              for f in shapes)
    check(err <= ROLLOUT_ATOL, ('walker get_rollout card vs CPU', err))
    out.update(flaky_nonfinite_envs={str(k): v for k, v in bad.items()},
               rollout_card_s=walls['cuda'], rollout_cpu_s=walls['cpu'],
               rollout_max_abs_err=err, check_divergence_raised=raised)
    print(f'api pieces: walker reset at {B} envs '
          f'{out["walker_reset_ms_attempts_1"]:.2f} ms with one attempt, '
          f'{out["walker_reset_ms_attempts_6"]:.2f} ms with 6, both bitwise '
          f'the plain reset; flaky init non-finite envs {bad[1]} of {B} '
          f'with one draw, {bad[FLAKY_ATTEMPTS]} with {FLAKY_ATTEMPTS}; '
          f'get_rollout of {ROLLOUT_STEPS} walker steps {walls["cuda"]:.3f} '
          f's on the card, {walls["cpu"]:.3f} s on the CPU, max abs err '
          f'{err:.2e}, shapes {shapes}, launches {roll_counts}; '
          f'check_divergence raised on a NaN env: {raised}')
    return roll_counts, out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False',
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import mujoco_mbrl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the port package is missing ({e})',
              file=sys.stderr)
        return 1
    from mujoco_mbrl_tpu_torch import ops, suite
    from mujoco_mbrl_tpu_torch.bench import build_bench
    from mujoco_mbrl_tpu_torch.ops import _build
    global PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES
    from mujoco_mbrl_tpu_torch.bench import (PEAK_BF16_FLOPS, PEAK_BYTES,
                                             PEAK_FP32_FLOPS,
                                             PEAK_TF32_FLOPS)

    card = card_line()
    print(card)
    print(f'torch {torch.__version__} cuda {torch.version.cuda}')
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    _build.build_all()
    print(f'kernels built in {time.perf_counter() - t0:.1f} s '
          f'(per source: {_build.BUILD_SECONDS})')
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if ('registers' in line or 'spill' in line
                    or 'Compiling entry' in line):
                print(f'[{name}] {line.strip()}')
    from mujoco_mbrl_tpu_torch.ops import cem_rollout as C
    smem = (_build.library('cem_sample_rollout', C._SIGNATURES)
            .cem_sample_smem_bytes(K, H, 24, 6, 50, 1, 0),
            _build.library('cem_sample_rollout_ens', C._ENS_SIGNATURES)
            .cem_ens_smem_bytes(K, 5, H, 24, 6, 50, 1, 0))
    print(f'sampler kernels, dynamic shared memory per block of '
          f'{8 * 32} threads at the walker shapes: MLP {smem[0]} bytes, '
          f'ensemble {smem[1]} bytes')

    run, (params, state0, gen) = build_bench('walker_walk', B, K, H, ITERS,
                                             STEPS, device=dev)
    env = suite.load('walker', 'walk', device=dev)
    # solves at the bench's reset states (what the short main path below
    # sees) and after 20 zero-action control steps, fallen and in contact
    # with the floor (what a long episode sees)
    fallen = state0
    for _ in range(20):
        fallen, _ = env.step(fallen, torch.zeros((B, 6), device=dev))
    walker_cases = (capture_solves(dev, torch, env, state0, 'reset',
                                   'apgd_iterate_batched')
                    + capture_solves(dev, torch, env, fallen, 'contact',
                                     'apgd_iterate_batched'))
    apgd_err, rounding_envs, apgd_t, apgd_iter_ns = apgd_phase(
        dev, torch, walker_cases)
    obs0 = suite.flatten_observation(env._observe(
        env.model, state0.physics, ()))
    samp_err, samp_t = sampler_phase(dev, torch, params, obs0)
    ens_err, ens_t = ensemble_phase(dev, torch, obs0)

    # ---- slice 1's main path: the walker MPC control step over the MLP --
    clock('slice 1')
    counts, w_out, state, warm_state = control_step(
        dev, torch, run, params, state0, gen, 'walker control step')
    exact_counts('walker control step', counts,
                 cem_sample_rollout=ITERS * STEPS, apgd_solve=10 * STEPS)
    check(state.physics.qpos.shape == (B, 9), state.physics.qpos.shape)
    card_vs_cpu_step(dev, torch, 'walker', 'walk', warm_state)
    profile_phase(torch, run, params, state, gen, w_out['wall_s'])

    # ---- slice 3: walker_ens control step, agent loop, CLI -------------
    clock('slice 3')
    ens_counts, _ = ens_control_step_phase(dev, torch)
    with tempfile.TemporaryDirectory() as tmp:
        agent_counts, _, agent_fit = agent_phase(dev, torch, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        cli_counts, cli_fit = cli_phase(dev, torch, tmp)
    samp_t['cases']['cli_b5_h20_spline4_fitted'] = cli_fit
    ens_t['cases']['agent_b1024_sd20_fitted'] = agent_fit
    ens_err = max(ens_err, agent_fit['max_abs_err'])

    # ---- slice 4: cheetah_run (factored APGD, given-action costs) ------
    clock('slice 4')
    c_run, (c_params, c_state0, c_gen) = build_bench(
        'cheetah_run', B, K, H, ITERS, STEPS, device=dev)
    c_counts, c_out, c_state, c_warm = control_step(
        dev, torch, c_run, c_params, c_state0, c_gen, 'cheetah control step')
    exact_counts('cheetah control step', c_counts,
                 cem_sample_rollout=ITERS * STEPS, apgd_factored=STEPS)
    card_vs_cpu_step(dev, torch, 'cheetah', 'run', c_warm)
    profile_phase(torch, c_run, c_params, c_state, c_gen, c_out['wall_s'])
    c_env = suite.load('cheetah', 'run', device=dev)
    # solves at the reset states (resting on the floor) and after 20
    # control steps of random actions (running, legs in contact)
    moving, g_act = c_state0, torch.Generator(device=dev).manual_seed(8)
    for _ in range(20):
        moving, _ = c_env.step(moving, 2 * torch.rand(
            (B, 6), generator=g_act, device=dev) - 1)
    cheetah_cases = (capture_solves(dev, torch, c_env, c_state0, 'reset',
                                    'apgd_iterate_factored')
                     + capture_solves(dev, torch, c_env, moving, 'moving',
                                      'apgd_iterate_factored'))
    fact_err, fact_rounding, fact_t, fact_iter_ns = factored_phase(
        dev, torch, cheetah_cases)
    c_obs = suite.flatten_observation(c_env._observe(
        c_env.model, c_warm.physics, ()))
    goal = torch.zeros(c_obs.shape[1], device=dev)
    goal[1] = 1.0
    weights = torch.ones(c_obs.shape[1], device=dev)
    costs_t, samp_cheetah = rollout_costs_phase(dev, torch, c_params, c_obs,
                                                goal, weights,
                                                walker=(params, obs0))

    # the non-fused CEM route on the same envs: candidates drawn by
    # cem_batched, costed by kernel #4 (one launch per CEM iteration)
    nf_run = build_bench('cheetah_run', B, K, H, ITERS, STEPS, device=dev,
                         fused=False)[0]
    nf_counts, nf_out, _, _ = control_step(
        dev, torch, nf_run, c_params, c_state0, c_gen,
        'cheetah control step, non-fused CEM')
    exact_counts('non-fused control step', nf_counts,
                 cem_rollout_costs=ITERS * STEPS, apgd_factored=STEPS)
    loop_counts, loop_t, loop = full_loop_phase(dev, torch)
    fitted_costs = fitted_rollout_costs_check(dev, torch, loop, goal,
                                              weights)
    with tempfile.TemporaryDirectory() as tmp:
        c_cli_counts = cheetah_cli_phase(dev, torch, tmp)

    # ---- slice 8: the contact-free domains -----------------------------
    clock('slice 8')
    lim_err, lim_rounding, lim_t = limit_apgd_phase(dev, torch)
    r_counts, r_out, samp_r256 = reacher256_phase(dev, torch)
    samp_guarded = guarded_sampler_case(dev, torch)
    with tempfile.TemporaryDirectory() as tmp:
        ra_counts, ra_times, ra_fit = reacher_agent_phase(dev, torch, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        rc_counts, rc_wall, rc_fit = cli_fitted_phase(
            dev, torch, tmp, 'reacher_easy', True, (1, 7, 1, True, True),
            apgd_solve=2 * 2 * 10)
    with tempfile.TemporaryDirectory() as tmp:
        pc_counts, pc_wall, pc_fit = cli_fitted_phase(
            dev, torch, tmp, 'point_mass_easy', True, (1, 7, 1, True, True),
            apgd_solve=1 * 2 * 10)
    pend_counts = pendulum_phase(dev, torch)

    # ---- slice 9: the humanoid ------------------------------------------
    clock('slice 9')
    h_counts, h_out, h_params, h_state0, h_warm = humanoid_control_step_phase(
        dev, torch)
    h_err, h_rounding, h_fact_t, h_iter_ns = humanoid_factored_phase(
        dev, torch, h_state0)
    samp_h = humanoid_sampler_case(dev, torch, h_params, h_warm)
    with tempfile.TemporaryDirectory() as tmp:
        hc_counts, hc_wall, hc_fit = cli_fitted_phase(
            dev, torch, tmp, 'humanoid_walk', False,
            (11, 7, 8, False, True),
            apgd_factored=HUMANOID_SUBSTEPS * 2 * 10)

    # ---- slice 10: cartpole, hopper, swimmer, acrobot --------------------
    clock('slice 10')
    cp_counts, cp_out = cartpole_control_step_phase(dev, torch)
    with tempfile.TemporaryDirectory() as tmp:
        cpc_counts, cpc_wall, cpc_fit = cli_fitted_phase(
            dev, torch, tmp, 'cartpole_swingup', True, (1, 7, 1, True, True),
            apgd_solve=RK4_SOLVES * 2 * 10)
    sr_err, sr_rounding, sr_t = small_row_apgd_phase(dev, torch)
    hp_counts, hp_out, hp_params, hp_state0, hp_warm = (
        hopper_control_step_phase(dev, torch))
    hb_err, hb_rounding, hb_t, hb_iter_ns = hopper_block_phase(
        dev, torch, hp_state0)
    samp_hp = hopper_sampler_case(dev, torch, hp_params, hp_warm)
    # the hopper's solves: the observation spec's forward (one env), then
    # per collection the reset's and the first featured state's forwards
    # and 10 control steps of 4 substeps and an observation forward
    with tempfile.TemporaryDirectory() as tmp:
        hpc_counts, hpc_wall, hpc_fit = cli_fitted_phase(
            dev, torch, tmp, 'hopper_hop', False, (3, 7, 3, True, True),
            apgd_solve=1 + 2 * (2 + HOPPER_SOLVES * 10))
    # swimmer6: a 0.03 s control step over 0.002 s physics, 15 substeps
    with tempfile.TemporaryDirectory() as tmp:
        swc_counts, swc_wall, swc_fit = cli_fitted_phase(
            dev, torch, tmp, 'swimmer_swimmer6', False, (3, 7, 3, True, True),
            apgd_solve=15 * 2 * 10)
    ac_counts, ac_out = acrobot_phase(dev, torch)

    # ---- slice 11: per-env planners, the other models, RewardAgent -----
    clock('slice 11')
    with tempfile.TemporaryDirectory() as tmp:
        rs_counts, rs_out, rs_agent = walker_rs_cli_phase(dev, torch, tmp)
    pc_cem_counts, pc_cem_out = walker_cem_policy_phase(dev, torch, rs_agent)
    with tempfile.TemporaryDirectory() as tmp, \
            tempfile.TemporaryDirectory() as tmp2:
        gr_counts, il_counts, gi_out, r_agent = reacher_grad_ilqr_phase(
            dev, torch, tmp, tmp2)
    with tempfile.TemporaryDirectory() as tmp:
        rw_counts, rw_out = reward_agent_cli_phase(dev, torch, tmp)
    with tempfile.TemporaryDirectory() as tmp, \
            tempfile.TemporaryDirectory() as tmp2:
        lin_counts, e998_counts, scan_out = walker_scan_cli_phase(
            dev, torch, tmp, tmp2)
    cv_counts, cv_out = per_env_card_vs_cpu_phase(dev, torch, rs_agent,
                                                  r_agent)

    # ---- slice 12: the bf16 kernels (29), the bench CLI (30) -----------
    clock('slice 12')
    h_env = suite.load('humanoid', 'walk', device=dev)
    h_obs = suite.flatten_observation(h_env._observe(
        h_env.model, h_warm.physics, ()))
    bf16_cases = bf16_phase(dev, torch, (params, obs0), (c_params, c_obs),
                            (h_params, h_obs))
    bench_out = bench_cli_phase(dev, torch)
    bench_counts = lambda key: {a: r['launches'][key]
                                for a, r in bench_out.items()
                                if r['launches'][key]}
    bf16_launches = lambda key: sum(bench_counts(key).values())

    # ---- slice 13: finger, ball_in_cup, lqr (31-33) ---------------------
    clock('slice 13')
    fs_counts, fs_out, f_state0 = finger_control_step_phase(dev, torch,
                                                            'spin')
    ft_counts, ft_out, _ = finger_control_step_phase(dev, torch,
                                                     'turn_hard')
    f_err, f_rounding, f_t, f_iter_ns = slice13_apgd_phase(
        dev, torch, 'finger', suite.load('finger', 'spin', device=dev),
        f_state0, finger_contact_state(dev, torch, B), per_env_bounds=True)
    cu_counts, cu_out, cu_env, cu_state0 = cup_control_step_phase(dev, torch)
    cu_err, cu_rounding, cu_t, cu_iter_ns = slice13_apgd_phase(
        dev, torch, 'ball_in_cup', cu_env, cu_state0,
        cup_contact_state(dev, torch, B), per_env_bounds=False)
    lq_counts, lq_out = lqr_phase(dev, torch)

    # ---- slice 14: manipulator, stacker, fish (34-37) --------------------
    clock('slice 14')
    mp_counts, mp_out, mp_env, mp_state0 = dense_control_step_phase(
        dev, torch, 'manipulator', 'bring_ball', 43)
    mp_err, mp_rounding, mp_t, mp_iter_ns = global_apgd_phase(
        dev, torch, 'bring_ball', mp_env, mp_state0,
        penetrating_state(dev, torch, mp_env, B, 44))
    with tempfile.TemporaryDirectory() as tmp:
        ma_counts, ma_times, ma_fit = manipulator_agent_phase(dev, torch,
                                                              tmp)
    st_counts, st_out, st_env, st_state0 = dense_control_step_phase(
        dev, torch, 'stacker', 'stack_4', 45)
    st_out['box_pairs'] = box_pairs_card_vs_cpu(dev, torch, st_env,
                                                'stacker stack_4')
    st_err, st_rounding, st_t, st_iter_ns = global_apgd_phase(
        dev, torch, 'stack_4', st_env, st_state0,
        penetrating_state(dev, torch, st_env, B, 46))
    del st_env, st_state0
    ip_counts, ip_out, ip_env, _ = dense_control_step_phase(
        dev, torch, 'manipulator', 'insert_peg', 47)
    ip_out['box_pairs'] = box_pairs_card_vs_cpu(dev, torch, ip_env,
                                                'manipulator insert_peg')
    fi_counts, fi_out = fish_phase(dev, torch)
    ot_out = other_tasks_phase(dev, torch)

    # ---- slice 15: quadruped walk, escape, fetch, run (38-41) -----------
    clock('slice 15')
    quad = {task: quadruped_phase(dev, torch, task, seed)
            for task, seed in (('walk', 60), ('escape', 62), ('fetch', 64))}
    qr_out = quadruped_run_phase(dev, torch)

    # ---- slice 16: humanoid_cmu stand, run (42-43) ----------------------
    clock('slice 16')
    (cmu_counts, cmu_out, cmu_err, cmu_rounding, cmu_t,
     cmu_iter_ns) = humanoid_cmu_phase(dev, torch)
    cmu_run_out = humanoid_cmu_run_phase(dev, torch)

    # ---- slice 17: builder, IK, pixels, distributed (44-47) -------------
    clock('slice 17, path 44')
    bw_counts, pair_counts, b_out = builder_phase(dev, torch)
    clock('path 45')
    ik_counts, ik_out = ik_phase(dev, torch)
    clock('path 46')
    wpx_counts, wpx_out, wpx_env, wpx_state = pixel_step_phase(
        dev, torch, 'walker', 'walk', 91, WALKER_SOLVES)
    cpx_counts, cpx_out, _, _ = pixel_step_phase(
        dev, torch, 'cartpole', 'swingup', 92, RK4_SOLVES)
    mv_out = movable_camera_phase(dev, torch, wpx_env, wpx_state)
    del wpx_env, wpx_state
    with tempfile.TemporaryDirectory() as tmp:
        rec_counts, rec_out = record_phase(dev, torch, tmp)
    clock('path 47')
    with tempfile.TemporaryDirectory() as tmp:
        dist_counts, dist_out = distributed_phase(dev, torch, tmp)

    # ---- slice 18: the model-building stack and the viewer (48-52) ------
    clock('slice 18, path 48')
    cor_counts, cor_out = composer_phase(dev, torch)
    clock('path 49')
    prop_counts, prop_out = props_phase(dev, torch)
    clock('path 50')
    cmuw_counts, cmuw_out = cmu_walker_phase(dev, torch)
    clock('path 51')
    soc_counts, soc_out = soccer_phase(dev, torch)
    clock('path 52')
    with tempfile.TemporaryDirectory() as tmp:
        view_counts, live_counts, expl_counts, view_out = viewer_phase(
            dev, torch, tmp)

    # ---- slice 19: the last physics branches (53-56) ---------------------
    clock('slice 19, path 53')
    pgs_counts, pgs_out = pgs_walker_phase(dev, torch)
    clock('path 54')
    ball_counts, ball_out = ball_chain_phase(dev, torch)
    clock('path 55')
    (fl_counts, fl_out, fl_err, fl_rounding, fl_t,
     fl_shared) = frictionloss_phase(dev, torch)
    clock('path 56')
    (ell_counts, ell_out, ell_err, ell_rounding,
     ell_t) = elliptic_quadruped_phase(dev, torch)

    # ---- slice 20: the last API pieces (57) -----------------------------
    clock('slice 20, path 57')
    api_counts, api_out = api_pieces_phase(dev, torch)
    clock('end of the paths')

    sampler_entry = lambda tiles: ptxas_info(
        'cem_sample_rollout', 'cem_sample_rollout_kernelI' + ''.join(
            f'Li{t}E' for t in tiles[:3]) + ''.join(
                f'Lb{int(b)}E' for b in tiles[3:]))
    ptxas = {'apgd_warp_kernel<1>': ptxas_info('apgd_solve',
                                               'apgd_warp_kernelILi1E'),
             'cem_sample_rollout_kernel<1,7,1,true,true>': sampler_entry(
                 (1, 7, 1, True, True)),
             'cem_sample_rollout_kernel<11,7,9,false,true>': sampler_entry(
                 (11, 7, 9, False, True)),
             'cem_sample_rollout_kernel<11,7,8,false,true>': sampler_entry(
                 (11, 7, 8, False, True)),
             'cem_sample_rollout_kernel<16,16,16,false,false>':
                 sampler_entry((16, 16, 16, False, False)),
             'cem_sample_rollout_kernel<3,7,2,true,true>': sampler_entry(
                 (3, 7, 2, True, True)),
             'cem_sample_rollout_bf16_kernel<2,4,3>': ptxas_info(
                 'cem_sample_rollout',
                 'cem_sample_rollout_bf16_kernelILi2ELi4ELi3ELb1ELb1E'),
             'cem_sample_rollout_bf16_kernel<6,4,9>': ptxas_info(
                 'cem_sample_rollout',
                 'cem_sample_rollout_bf16_kernelILi6ELi4ELi9ELb0ELb1E'),
             'cem_sample_rollout_bf16_kernel<8,8,16>': ptxas_info(
                 'cem_sample_rollout',
                 'cem_sample_rollout_bf16_kernelILi8ELi8ELi16ELb0ELb0E'),
             'apgd_block_kernel': ptxas_info('apgd_solve',
                                             '17apgd_block_kernel'),
             'apgd_global_kernel': ptxas_info('apgd_solve',
                                              '18apgd_global_kernel'),
             'apgd_dense_factors_kernel': ptxas_info(
                 'apgd_factored', '25apgd_dense_factors_kernel'),
             'cem_sample_rollout_kernel<5,7,4,false,true>': sampler_entry(
                 (5, 7, 4, False, True))}
    print(f'ptxas: {ptxas}')
    samp_t['cases']['reacher256_b256_k500_h20_sd6'] = samp_r256
    samp_t['cases']['reacher_agent_b1024_sd6_fitted'] = ra_fit
    samp_t['cases']['guarded_b256_k500_h20_sd40_hid64'] = samp_guarded
    samp_t['cases']['humanoid_b512_k1000_h30_sd67'] = samp_h
    samp_t['cases']['hopper_b1024_k1000_h30_sd15'] = samp_hp

    paths = {'walker_control_step': counts,
             'walker_ens_control_step': ens_counts,
             'walker_agent_loop': agent_counts, 'walker_cli_spline4': cli_counts,
             'cheetah_control_step': c_counts,
             'cheetah_non_fused_control_step': nf_counts,
             'cheetah_full_loop': loop_counts, 'cheetah_cli': c_cli_counts,
             'reacher256_control_step': r_counts,
             'reacher_agent_loop': ra_counts, 'reacher_cli': rc_counts,
             'point_mass_cli': pc_counts,
             'pendulum_step': pend_counts,
             'humanoid_control_step': h_counts, 'humanoid_cli': hc_counts,
             'cartpole_control_step': cp_counts, 'cartpole_cli': cpc_counts,
             'hopper_control_step': hp_counts, 'hopper_cli': hpc_counts,
             'swimmer_cli': swc_counts, 'acrobot_step': ac_counts,
             'walker_rs_cli': rs_counts, 'walker_per_env_cem': pc_cem_counts,
             'reacher_grad_cli': gr_counts, 'reacher_ilqr_cli': il_counts,
             'point_mass_rw_cli': rw_counts, 'walker_lin_cli': lin_counts,
             'walker_ens998_cli': e998_counts,
             'per_env_card_vs_cpu': cv_counts,
             **{f'bench {a}': r['launches'] for a, r in bench_out.items()},
             'finger_spin_control_step': fs_counts,
             'finger_turn_hard_control_step': ft_counts,
             'ball_in_cup_control_step': cu_counts,
             'lqr_6_2_drive': lq_counts,
             'manipulator_bring_ball_control_step': mp_counts,
             'manipulator_agent_loop': ma_counts,
             'stacker_stack_4_control_step': st_counts,
             'manipulator_insert_peg_control_step': ip_counts,
             'fish_swim_control_step': fi_counts,
             **{f'quadruped_{t}_control_step': q[0]
                for t, q in quad.items()},
             'humanoid_cmu_stand_control_step': cmu_counts,
             'builder_walker_control_step': bw_counts,
             'builder_pendulum_pair': pair_counts, 'ik_swimmer6': ik_counts,
             'walker_pixels_control_step': wpx_counts,
             'cartpole_pixels_control_step': cpx_counts,
             'walker_record_rollout': rec_counts,
             'cartpole_sharded_collect': dist_counts,
             'corridor_control_step': cor_counts,
             'props_drop': prop_counts,
             'cmu_walker_control_step': cmuw_counts,
             'soccer_2v2_control_step': soc_counts,
             'viewer_launch_walker': view_counts,
             'viewer_live_session': live_counts,
             'explore_cartpole_swingup': expl_counts,
             'walker_pgs_control_step': pgs_counts,
             'ball_chain_steps': ball_counts,
             'cheetah_frictionloss_control_step': fl_counts,
             'quadruped_fetch_elliptic_control_step': ell_counts,
             'walker_get_rollout': api_counts}
    by_path = lambda key: {p: c[key] for p, c in paths.items() if c[key]}
    src = lambda f: f'mujoco_mbrl_tpu_torch/csrc/{f}'
    tpu = lambda f, line, fn: f'mujoco_mbrl_tpu/ops/{f}:{line} ({fn})'
    plain_keys = ('ms', 'plain_ms', 'bound_ms', 'bound_by')
    pick = lambda d: {k: d[k] for k in plain_keys}
    # the tensor-core kernels (the samplers, #4): held to the tensor-core
    # bound, FP32's beside it
    pick_s = lambda d: dict(pick(d), bound_fp32_ms=d['bound_fp32_ms'],
                            held_to=d['held_to'])
    # the bf16 instantiations (path 29), launched on path 30
    pick_b = lambda d: dict(pick(d), f32_ms=d['f32_ms'], held_to=d['held_to'],
                            max_abs_err=d['max_abs_err'],
                            named=d['named'], named_share=d['named_share'])
    bf16_entry = lambda name, source, replaces, key, case, **kw: dict(
        name=name, route='cuda', source=src(source), replaces=replaces,
        launches=bf16_launches(key), launches_by_path=bench_counts(key),
        library_ms=None, **pick_b(case), **kw)
    kernels = [
        dict(name='apgd_iterate_batched', route='cuda',
             source=src('apgd_solve.cu'),
             replaces=tpu('apgd_solve.py', 60, '_apgd_kernel'),
             launches=counts['apgd_solve'],
             max_abs_err=max(apgd_err, lim_err, sr_err, hb_err, f_err,
                             cu_err),
             library_ms=None, **pick(apgd_t['contact-warm']),
             call_ms=apgd_t['contact-warm']['call_ms'],
             max_iterations=apgd_t['contact-warm']['max_iterations'],
             us_per_dependent_step=apgd_t['contact-warm'][
                 'us_per_dependent_step'],
             iteration_ns=apgd_iter_ns,
             rounding_decided_envs=(rounding_envs + lim_rounding
                                    + sr_rounding + hb_rounding
                                    + f_rounding + cu_rounding),
             launches_by_path=by_path('apgd_solve'),
             cases=dict(apgd_t, **lim_t, **sr_t, **hb_t, **f_t, **cu_t),
             hopper_block=dict(hb_t['hopper-contact-warm'],
                               iteration_ns=hb_iter_ns,
                               rounding_decided_envs=hb_rounding,
                               launches_per_control_step=HOPPER_SOLVES),
             finger=dict(f_t['finger-contact-warm'], iteration_ns=f_iter_ns,
                         rounding_decided_envs=f_rounding,
                         launches_per_control_step=FINGER_SOLVES,
                         iteration_cap=400, rows=39,
                         reset_cold=f_t['finger-reset-cold']),
             ball_in_cup=dict(cu_t['ball_in_cup-contact-warm'],
                              iteration_ns=cu_iter_ns,
                              rounding_decided_envs=cu_rounding,
                              launches_per_control_step=CUP_SOLVES,
                              iteration_cap=60, rows=21,
                              reset_cold=cu_t['ball_in_cup-reset-cold']),
             ptxas_one_row=ptxas['apgd_warp_kernel<1>'],
             ptxas_block=ptxas['apgd_block_kernel']),
        dict(name='mlp_sample_rollout_costs', route='cuda',
             source=src('cem_sample_rollout.cu'),
             replaces=tpu('cem_rollout.py', 364, '_sample_kernel_multi'),
             launches=c_counts['cem_sample_rollout'],
             max_abs_err=max(samp_err, samp_cheetah['max_abs_err'],
                             samp_r256['max_abs_err'], ra_fit['max_abs_err'],
                             samp_guarded['max_abs_err'],
                             samp_h['max_abs_err'], samp_hp['max_abs_err']),
             library_ms=None, **pick_s(samp_cheetah),
             launches_by_path=by_path('cem_sample_rollout'),
             cases=dict(samp_t['cases'], cheetah_sd17=samp_cheetah),
             ptxas_small_exact=ptxas[
                 'cem_sample_rollout_kernel<1,7,1,true,true>'],
             ptxas_humanoid={k: ptxas[
                 f'cem_sample_rollout_kernel<{k},false,true>']
                 for k in ('11,7,9', '11,7,8')},
             ptxas_guarded=ptxas[
                 'cem_sample_rollout_kernel<16,16,16,false,false>'],
             ptxas_hopper_observation=ptxas[
                 'cem_sample_rollout_kernel<3,7,2,true,true>']),
        dict(name='mlp_sample_rollout_costs[spline4]', route='cuda',
             source=src('cem_sample_rollout.cu'),
             replaces=tpu('cem_rollout.py', 258, '_sample_kernel'),
             launches=cli_counts['cem_sample_rollout'],
             max_abs_err=max(cli_fit['max_abs_err'], rc_fit['max_abs_err'],
                             pc_fit['max_abs_err'], hc_fit['max_abs_err'],
                             cpc_fit['max_abs_err'], hpc_fit['max_abs_err'],
                             swc_fit['max_abs_err']),
             library_ms=None, **pick_s(samp_t['cases']['spline4']),
             launches_by_path={p: paths[p]['cem_sample_rollout'] for p in (
                 'walker_cli_spline4', 'reacher_cli', 'point_mass_cli',
                 'humanoid_cli', 'cartpole_cli', 'hopper_cli',
                 'swimmer_cli')},
             cli_b5_h20=cli_fit,
             cases=dict(reacher_cli_b5_h20_sd6_fitted=rc_fit,
                        point_mass_cli_b5_h20_sd4_fitted=pc_fit,
                        humanoid_cli_b5_h20_sd60_fitted=hc_fit,
                        cartpole_cli_b5_h20_sd5_fitted=cpc_fit,
                        hopper_cli_b5_h20_sd17_fitted=hpc_fit,
                        swimmer_cli_b5_h20_sd18_fitted=swc_fit)),
        dict(name='mlp_rollout_costs_t', route='cuda',
             source=src('cem_rollout_costs.cu'),
             replaces=tpu('cem_rollout.py', 70, '_kernel'),
             launches=nf_counts['cem_rollout_costs'],
             max_abs_err=max(max(c['max_abs_err']
                                 for c in costs_t['cases'].values()),
                             fitted_costs['max_abs_err']),
             library_ms=None, **pick_s(costs_t),
             launches_by_path=by_path('cem_rollout_costs'),
             cases=costs_t['cases'], fitted=fitted_costs),
        dict(name='mlp_sample_rollout_costs_ensemble', route='cuda',
             source=src('cem_sample_rollout_ens.cu'),
             replaces=tpu('cem_rollout.py', 671,
                          '_sample_kernel_ens_grouped'),
             launches=agent_counts['cem_sample_rollout_ens'],
             max_abs_err=ens_err, library_ms=None,
             **pick_s(ens_t['cases']['b1024_h30_sd24']),
             launches_by_path=by_path('cem_sample_rollout_ens'),
             cases=ens_t['cases']),
        dict(name='mlp_sample_rollout_costs_ensemble[B=5]', route='cuda',
             source=src('cem_sample_rollout_ens.cu'),
             replaces=tpu('cem_rollout.py', 840, '_sample_kernel_ens'),
             launches=agent_counts['cem_sample_rollout_ens'],
             launches_by_path=by_path('cem_sample_rollout_ens'),
             launches_note='the same CUDA kernel as '
                           'mlp_sample_rollout_costs_ensemble',
             max_abs_err=ens_t['cases']['b5_h20_sd20']['max_abs_err'],
             library_ms=None, **pick_s(ens_t['cases']['b5_h20_sd20'])),
        dict(name='apgd_iterate_factored', route='cuda',
             source=src('apgd_factored.cu'),
             replaces=tpu('apgd_solve.py', 236, '_apgd_factored_kernel'),
             launches=c_counts['apgd_factored'],
             max_abs_err=max(fact_err, h_err, fl_err),
             library_ms=None, **pick(fact_t['moving-cold']),
             path=fact_t['moving-cold']['path'],
             call_ms=fact_t['moving-cold']['call_ms'],
             max_iterations=fact_t['moving-cold']['max_iterations'],
             us_per_dependent_step=fact_t['moving-cold'][
                 'us_per_dependent_step'],
             iteration_ns=fact_iter_ns,
             rounding_decided_envs=fact_rounding + h_rounding + fl_rounding,
             launches_by_path=by_path('apgd_factored'),
             cases=dict(fact_t, **h_fact_t),
             humanoid=dict(h_fact_t['humanoid-moving-warm'],
                           iteration_ns=h_iter_ns,
                           rounding_decided_envs=h_rounding),
             per_env_bounds=dict(
                 fl_t['cheetah-frictionloss-warm'],
                 launches=fl_counts['apgd_factored'],
                 rows=FL_ROWS, nv=FL_NV, max_abs_err=fl_err,
                 rounding_decided_envs=fl_rounding,
                 shared_bounds_ms=fl_shared, cases=fl_t,
                 humanoid_block=fl_t['humanoid-frictionloss-cold'])),
        dict(name='apgd_iterate_batched[global]', route='cuda',
             source=src('apgd_solve.cu'),
             replaces=tpu('apgd_solve.py', 60, '_apgd_kernel'),
             launches=mp_counts['apgd_solve'],
             launches_note='the path of #1 past the rows whose Ad fits in '
                           'shared memory (apgd_global_kernel)',
             launches_by_path={p: paths[p]['apgd_solve'] for p in (
                 'manipulator_bring_ball_control_step',
                 'manipulator_agent_loop', 'stacker_stack_4_control_step',
                 'manipulator_insert_peg_control_step',
                 'quadruped_walk_control_step',
                 'quadruped_escape_control_step',
                 'quadruped_fetch_control_step',
                 'soccer_2v2_control_step',
                 'quadruped_fetch_elliptic_control_step')},
             max_abs_err=max([mp_err, st_err, ell_err]
                             + [q[2] for q in quad.values()]),
             library_ms=None,
             **pick(mp_t['bring_ball-contact-warm']),
             call_ms=mp_t['bring_ball-contact-warm']['call_ms'],
             max_iterations=mp_t['bring_ball-contact-warm'][
                 'max_iterations'],
             us_per_dependent_step=mp_t['bring_ball-contact-warm'][
                 'us_per_dependent_step'],
             bound_every_row_ms=mp_t['bring_ball-contact-warm'][
                 'bound_every_row_ms'],
             iteration_ns=mp_iter_ns,
             rounding_decided_envs=(mp_rounding + st_rounding
                                    + ell_rounding
                                    + sum(q[3] for q in quad.values())),
             cases=dict(mp_t, **st_t,
                        **{k: v for q in quad.values()
                           for k, v in q[4].items()}),
             stack_4=dict(st_t['stack_4-contact-warm'],
                          iteration_ns=st_iter_ns, rows=977),
             quadruped={t: dict(
                 q[4][f'{t}-contact-warm'], iteration_ns=q[5],
                 rounding_decided_envs=q[3], rows=QUAD_ROWS[t],
                 launches_per_control_step=QUAD_SOLVES,
                 reset_cold=q[4][f'{t}-reset-cold'],
                 reset_warm=q[4][f'{t}-reset-warm'],
                 contact_cold=q[4][f'{t}-contact-cold'])
                 for t, q in quad.items()},
             elliptic_fetch=dict(ell_t['elliptic-contact-warm'],
                                 rows=ELLIPTIC_ROWS, cases=ell_t,
                                 rounding_decided_envs=ell_rounding,
                                 launches=ell_counts['apgd_solve']),
             rows=452, ptxas=ptxas['apgd_global_kernel']),
        dict(name='mlp_sample_rollout_costs[5,7,4]', route='cuda',
             source=src('cem_sample_rollout.cu'),
             replaces=tpu('cem_rollout.py', 364, '_sample_kernel_multi'),
             launches=ma_counts['cem_sample_rollout'],
             launches_note='the instantiation of mlp_sample_rollout_costs '
                           'at the manipulator\'s featured state (sd 29, ad '
                           '5; run-time loop bounds)',
             launches_by_path={'manipulator_agent_loop':
                               ma_counts['cem_sample_rollout']},
             max_abs_err=ma_fit['max_abs_err'], library_ms=None,
             **pick_s(ma_fit), fitted_reported=ma_fit['fitted_reported'],
             ptxas=ptxas['cem_sample_rollout_kernel<5,7,4,false,true>']),
        dict(name='apgd_iterate_dense_factors', route='cuda',
             source=src('apgd_factored.cu'),
             replaces=tpu('apgd_solve.py', 60, '_apgd_kernel'),
             launches=cmu_counts['apgd_dense_factors'],
             launches_note='#1\'s dense iterate (the semantics of '
                           '_apgd_kernel, run by JAX as its XLA twin) past '
                           '1024 rows, Ad applied through J~ and M^-1 '
                           '(apgd_dense_factors_kernel)',
             launches_by_path={
                 'humanoid_cmu_stand_control_step':
                     cmu_counts['apgd_dense_factors'],
                 'humanoid_cmu_run_control_step':
                     cmu_run_out['apgd_dense_factors'],
                 'cmu_walker_control_step':
                     cmuw_counts['apgd_dense_factors']},
             max_abs_err=cmu_err, library_ms=None,
             **pick(cmu_t['cmu-fallen-warm']),
             call_ms=cmu_t['cmu-fallen-warm']['call_ms'],
             max_iterations=cmu_t['cmu-fallen-warm']['max_iterations'],
             us_per_dependent_step=cmu_t['cmu-fallen-warm'][
                 'us_per_dependent_step'],
             iteration_ns=cmu_iter_ns, rounding_decided_envs=cmu_rounding,
             rows=CMU_ROWS, nv=CMU_NV,
             launches_per_control_step=CMU_SOLVES, cases=cmu_t,
             ptxas=ptxas['apgd_dense_factors_kernel']),
        bf16_entry('mlp_sample_rollout_costs[bf16]', 'cem_sample_rollout.cu',
                   tpu('cem_rollout.py', 364, '_sample_kernel_multi'),
                   'cem_sample_rollout_bf16',
                   bf16_cases['northstar_triangular'],
                   cases={k: bf16_cases[k] for k in (
                       'northstar_triangular', 'northstar_normal',
                       'humanoid', 'guarded_sd40_hid64')},
                   ptxas=ptxas['cem_sample_rollout_bf16_kernel<2,4,3>']),
        bf16_entry('mlp_sample_rollout_costs[spline4,bf16]',
                   'cem_sample_rollout.cu',
                   tpu('cem_rollout.py', 258, '_sample_kernel'),
                   'cem_sample_rollout_bf16', bf16_cases['northstar_spline4'],
                   launches_note='the same CUDA kernel as '
                                 'mlp_sample_rollout_costs[bf16]'),
        bf16_entry('mlp_rollout_costs_t[bf16]', 'cem_rollout_costs.cu',
                   tpu('cem_rollout.py', 70, '_kernel'),
                   'cem_rollout_costs_bf16', bf16_cases['given_cheetah'],
                   launches_note='no bench path routes bf16 to #4, as in '
                                 'JAX (its rollout_costs_fn takes no '
                                 'compute_dtype); held in path 29 only'),
        bf16_entry('mlp_sample_rollout_costs_ensemble[bf16]',
                   'cem_sample_rollout_ens.cu',
                   tpu('cem_rollout.py', 671, '_sample_kernel_ens_grouped'),
                   'cem_sample_rollout_ens_bf16', bf16_cases['walker_ens']),
        bf16_entry('mlp_sample_rollout_costs_ensemble[B=5,bf16]',
                   'cem_sample_rollout_ens.cu',
                   tpu('cem_rollout.py', 840, '_sample_kernel_ens'),
                   'cem_sample_rollout_ens_bf16',
                   bf16_cases['ensemble_b5_h20_sd20'],
                   launches_note='the same CUDA kernel as '
                                 'mlp_sample_rollout_costs_ensemble[bf16]'),
    ]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'paths': dict(
        cheetah_control_step=c_out, cheetah_non_fused_control_step=nf_out,
        cheetah_full_loop=loop_t, reacher256_control_step=r_out,
        reacher_agent_loop=ra_times, reacher_cli_s=rc_wall,
        point_mass_cli_s=pc_wall, humanoid_control_step=h_out,
        humanoid_cli_s=hc_wall, cartpole_control_step=cp_out,
        cartpole_cli_s=cpc_wall, hopper_control_step=hp_out,
        hopper_cli_s=hpc_wall, swimmer_cli_s=swc_wall,
        acrobot_step=ac_out, walker_rs_cli=rs_out,
        walker_per_env_cem=pc_cem_out, reacher_grad_ilqr=gi_out,
        point_mass_rw_cli=rw_out, walker_scan_clis=scan_out,
        per_env_card_vs_cpu=cv_out,
        finger_spin_control_step=fs_out,
        finger_turn_hard_control_step=ft_out,
        ball_in_cup_control_step=cu_out, lqr_6_2=lq_out,
        manipulator_bring_ball_control_step=mp_out,
        manipulator_agent_loop=ma_times,
        stacker_stack_4_control_step=st_out,
        manipulator_insert_peg_control_step=ip_out,
        fish_swim_control_step=fi_out, slice14_other_tasks=ot_out,
        **{f'quadruped_{t}_control_step': q[1] for t, q in quad.items()},
        slice15_other_tasks=qr_out,
        humanoid_cmu_stand_control_step=cmu_out,
        humanoid_cmu_run_control_step=cmu_run_out,
        builder=b_out, ik_swimmer6=ik_out, walker_pixels=wpx_out,
        cartpole_pixels=cpx_out, movable_camera=mv_out,
        walker_record_rollout=rec_out, distributed=dist_out,
        corridor_composer=cor_out, props_drop=prop_out,
        cmu_walker_go_to_target=cmuw_out, soccer_2v2=soc_out,
        viewer=view_out, walker_pgs=pgs_out, ball_chain=ball_out,
        cheetah_frictionloss=fl_out, quadruped_fetch_elliptic=ell_out,
        api_pieces=api_out,
        bench_cli={a: dict(record=r['record'], seconds=r['seconds'])
                   for a, r in bench_out.items()},
        bf16_ptxas={k: v for k, v in ptxas.items() if 'bf16' in k})}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
