"""Device resolution: the CLI names the device, nothing picks one."""

from __future__ import annotations

from typing import Union

import torch

# `--device numpy`: no torch device; the host engine
# (`pipeline.engine.HostCallEngine`) calls every position through the
# native f64 model
HOST = "numpy"
DEVICES = ("cuda", "cpu", HOST)


def resolve_device(name: str) -> Union[torch.device, str]:
    """`cuda` -> the current CUDA device, raising when PyTorch sees none;
    `cpu` -> the plain PyTorch versions of every kernel; `numpy` -> HOST,
    the host engine with no torch device work. There is no fallback from
    one to another."""
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
    if name == HOST:
        return HOST
    raise ValueError(f"unknown device {name!r}; expected one of {DEVICES}")
