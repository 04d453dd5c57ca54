"""The reference physics: a frozen copy of the port's plain PyTorch
physics (``mujoco_mbrl_tpu_torch/physics``: engine, smooth, collision,
solver, model, mjcf, math), whose constraint solve runs the plain APGD
iterates of ``apgd_plain``. It imports nothing of the program."""
