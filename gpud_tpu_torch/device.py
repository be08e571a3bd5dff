"""Where the port's entry points run.

The rule is the card: ``device=None`` means ``cuda``. The CPU is used only
when the caller asks for it, and a missing card is an error, never a silent
move to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` and ``"cuda"`` need a CUDA device and raise ``RuntimeError``
    without one; ``"cpu"`` is taken only when requested.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU"
        )
    return dev
