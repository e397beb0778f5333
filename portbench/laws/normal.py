"""Densities: independent standard normal values."""

import torch


def draw(spec: dict, g: torch.Generator, shape, device,
         dtype) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device, dtype=dtype)
