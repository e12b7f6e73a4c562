"""What the example drivers share: host copies and a device sync."""

from __future__ import annotations

import numpy as np
import torch


def to_np(x) -> np.ndarray:
    """A host copy of a tensor (a sync for a card's), or ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
