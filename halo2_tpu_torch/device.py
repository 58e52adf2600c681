"""Where the port's entry points run.

Every entry point takes a `device`. It defaults to "cuda"; the CPU is used
only when the caller asks for it (the tests do), and then every kernel
wrapper takes its plain PyTorch version. A missing GPU is an error, never
a silent fall-back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
