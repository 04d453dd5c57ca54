"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Return the torch device an entry point runs on (default ``cuda``).

    Raises when CUDA is asked for and no card is present: nothing falls
    back to the CPU silently. Also pins float32 matmuls and convolutions
    to full IEEE precision (no TF32), as the JAX physics pins
    ``precision='highest'`` (mujoco_mbrl_tpu/physics/engine.py:63).
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
