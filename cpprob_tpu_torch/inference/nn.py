"""The MLP part of the neural building blocks — counterpart of
``cpprob_tpu/inference/nn.py:42-70``.

Parameters keep the reference's layout, a list of layers ``{"w": (in,
out), "b": (out,)}``, so that a net trained by either package runs on the
other (:func:`cpprob_tpu_torch.interop.mlp_params_from_numpy`).  Leaves are
plain tensors: the trainer sets ``requires_grad`` on them.  The LSTM, the
embeddings and conv3d come with CSIS (slice 5).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

__all__ = ["mlp_init", "mlp_apply", "softplus", "SOFTPLUS_EPS"]

SOFTPLUS_EPS = 1e-6     # the floor of every positive proposal scale


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x)) + 1e-6`` in the stable form ``max(x, 0) +
    log1p(exp(-|x|))``: the one proposal scale of the port, in the
    trainer, the fallback hooks and the guided kernel alike."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs())) + SOFTPLUS_EPS


def mlp_init(sizes: Sequence[int], generator: torch.Generator,
             device=None) -> List[Dict[str, torch.Tensor]]:
    """MLP with ReLU hidden activations, ``sizes = [in, h1, ..., out]``:
    Kaiming-normal weights (std sqrt(2 / fan_in)) drawn from ``generator``
    on its own device, zero biases, float32 on ``device`` (default: the
    generator's)."""
    device = generator.device if device is None else torch.device(device)
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=generator.device)
        layers.append({"w": (w * math.sqrt(2.0 / max(fan_in, 1))).to(device),
                       "b": torch.zeros((fan_out,), device=device)})
    return layers


def mlp_apply(layers, x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., in) through the layers: ReLU after each but the last."""
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x
