"""The device an entry point runs on.

The port's entry points (FusedDmsaSlam, DmsaSlam, convert.state_from_numpy,
pipeline.runner.run) run on the CUDA card unless the caller asks for the
CPU with device="cpu".  Without a card they raise: they never carry on on
the CPU on their own.
"""

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
