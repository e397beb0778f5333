"""Points: `n` points uniform in the unit cube, float64."""

import torch


def draw(spec: dict, g: torch.Generator, device) -> torch.Tensor:
    return torch.rand((int(spec["n"]), 3), generator=g, device=device,
                      dtype=torch.float64)
