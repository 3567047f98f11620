"""Examples of the port (counterparts of the repository's `examples/`)."""

import torch


def resolve_device(name: str) -> torch.device:
    """The device an example runs on: `--device` as given (default
    'cuda'). A CUDA device without a card raises rather than running on the
    CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: torch.cuda.is_available() is false (no "
            "NVIDIA card); pass --device cpu to run on the CPU")
    return device
