"""The port's device policy, shared by the controllers and the models."""
from __future__ import annotations

import torch


def resolve_device(device, what: str = "MPPI") -> torch.device:
    """``None`` means the card.  Never falls back to the CPU on its own:
    with no CUDA device it raises and asks ``what``'s caller for
    ``device='cpu'``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device
