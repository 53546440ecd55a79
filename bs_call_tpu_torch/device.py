"""Device resolution: the CLI names the device, nothing picks one."""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: str) -> torch.device:
    """`cuda` -> the current CUDA device, raising when PyTorch sees none;
    `cpu` -> the plain PyTorch versions of every kernel. There is no
    fallback from one to the other."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: no CUDA device is available to PyTorch "
                f"(torch {torch.__version__}, built for CUDA "
                f"{torch.version.cuda}); use --device cpu to run the "
                "plain PyTorch path"
            )
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}; expected one of {DEVICES}")
