"""Device choice for the port's entry points.

``Engine(root, device=None)`` and everything below it run on the CUDA
card unless the caller names another device (the CPU tests pass
``device="cpu"``). A machine without CUDA never falls back to the CPU on
its own: asking for the default there raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def runtime_rows(device: torch.device) -> list[list[str]]:
    """SHOW DIAGNOSTICS' rows of the tensor runtime: its version, the
    device type and how many devices of that type the process sees."""
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    return [["torch", torch.__version__], ["backend", device.type],
            ["devices", str(n)]]
