"""Neural building blocks for inference compilation — counterpart of
``cpprob_tpu/inference/nn.py``: plain functions on plain parameter trees,
so the proposal network runs inside the particle program and batches over
particles under ``torch.func.vmap``.

Parameters keep the reference's layout, so that a net trained by either
package runs on the other (:func:`cpprob_tpu_torch.interop.mlp_params_from_numpy`,
:func:`~cpprob_tpu_torch.interop.csis_params_from_numpy`):

- an MLP is a list of layers ``{"w": (in, out), "b": (out,)}``;
- an embedding table is one ``(num, dim)`` tensor;
- the stacked LSTM is a list of layers ``{"wx": (in, 4H), "wh": (H, 4H),
  "b": (4H,)}``, gates in the order i, f, g, o, with +1 on the forget
  gate.  It is not ``torch.nn.LSTM``, whose gate layout and two biases
  differ and which has no +1;
- conv3d is ``{"convs": [{"w": (out, in, k, k, k), "b": (out,)}, ...],
  "head": MLP}``, weights OIDHW as ``F.conv3d`` takes them.

Leaves are plain float32 tensors: a trainer sets ``requires_grad`` on them.
The products are float32 with TF32 off (torch's default,
``torch.backends.cuda.matmul.allow_tf32 = False``), so the card computes
what the CPU does to float32 rounding; nothing here turns TF32 on.
Initializers draw from an explicit ``torch.Generator`` on its own device
and place the result on ``device`` (default: the generator's), a CPU
draw reaching the card by a pinned, non-blocking copy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..distributions.base import to_device

__all__ = [
    "mlp_init",
    "mlp_apply",
    "embedding_init",
    "embedding_lookup",
    "lstm_init",
    "lstm_obs_gate",
    "lstm_step",
    "lstm_step_split",
    "lstm_zero_state",
    "lstm_embed_sequence",
    "conv3d_init",
    "conv3d_apply",
    "softplus",
    "EMBEDDING_DIM",
    "SOFTPLUS_EPS",
]

EMBEDDING_DIM = 128     # reference default (settings.py:15)
SOFTPLUS_EPS = 1e-6     # the floor of every positive proposal scale


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x)) + 1e-6`` in the stable form ``max(x, 0) +
    log1p(exp(-|x|))``: the one proposal scale of the port, in the
    trainers, the fallback hooks and the guided kernel alike."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs())) + SOFTPLUS_EPS


def _place(device, generator: torch.Generator) -> torch.device:
    return generator.device if device is None else torch.device(device)


def _kaiming(shape, fan_in: int, generator: torch.Generator, device) -> torch.Tensor:
    """Kaiming-normal weights, std sqrt(2 / fan_in) (``util.py:107-112``)."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return to_device(w * math.sqrt(2.0 / max(fan_in, 1)), device)


def mlp_init(sizes: Sequence[int], generator: torch.Generator,
             device=None) -> List[Dict[str, torch.Tensor]]:
    """MLP with ReLU hidden activations, ``sizes = [in, h1, ..., out]``:
    Kaiming-normal weights, zero biases."""
    device = _place(device, generator)
    return [{"w": _kaiming((fan_in, fan_out), fan_in, generator, device),
             "b": torch.zeros((fan_out,), device=device)}
            for fan_in, fan_out in zip(sizes[:-1], sizes[1:])]


def mlp_apply(layers, x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., in) through the layers: ReLU after each but the last."""
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def embedding_init(num: int, dim: int, generator: torch.Generator,
                   device=None) -> torch.Tensor:
    """A ``(num, dim)`` table, normal with std 0.1."""
    t = torch.randn((num, dim), generator=generator, device=generator.device)
    return to_device(t * 0.1, _place(device, generator))


def embedding_lookup(table: torch.Tensor, idx) -> torch.Tensor:
    """Rows ``idx`` (any shape of integers) of ``table``: ``idx.shape +
    (dim,)``.  An ``index_select``, whose gradient is an ``index_add`` and
    never waits on the card."""
    idx = to_device(idx, table.device).long()
    rows = torch.index_select(table, 0, idx.reshape(-1))
    return rows.reshape(tuple(idx.shape) + (table.shape[-1],))


def lstm_init(input_dim: int, hidden: int, generator: torch.Generator,
              layers: int = 2, device=None):
    """Stacked LSTM parameters (reference: 2 layers, ``nn.py:36-40``)."""
    device = _place(device, generator)
    params = []
    for l in range(layers):
        in_dim = input_dim if l == 0 else hidden
        params.append({
            "wx": _kaiming((in_dim, 4 * hidden), in_dim, generator, device),
            "wh": _kaiming((hidden, 4 * hidden), hidden, generator, device),
            "b": torch.zeros((4 * hidden,), device=device),
        })
    return params


def lstm_zero_state(params, batch_shape: Tuple[int, ...] = ()):
    """Zero ``(h, c)`` of each layer, of shape ``batch_shape + (H,)``."""
    wh = params[0]["wh"]
    shape = tuple(batch_shape) + (wh.shape[0],)
    return [(torch.zeros(shape, device=wh.device), torch.zeros(shape, device=wh.device))
            for _ in params]


def _lstm_cell(layer_params, x_gates, h, c):
    gates = x_gates + h @ layer_params["wh"] + layer_params["b"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + 1.0)  # forget-gate bias 1
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def lstm_step(params, x, state):
    """One step of the stacked LSTM.  ``x``: (..., input_dim); ``state``:
    list of (h, c) per layer.  Returns (top_h, new_state)."""
    new_state = []
    inp = x
    for layer_params, (h, c) in zip(params, state):
        h_new, c_new = _lstm_cell(layer_params, inp @ layer_params["wx"], h, c)
        new_state.append((h_new, c_new))
        inp = h_new
    return inp, new_state


def lstm_obs_gate(params, obs_emb):
    """The observation-embedding half of the layer-0 input gates.

    The proposal LSTM's layer-0 input is ``concat([value_emb, obs_emb])``
    (reference ``infcomp/nn/nn.py:32-38``); the split ``value_emb @
    wx[:E] + obs_emb @ wx[E:]`` is the same contraction reassociated, and
    it lets this half be computed once per trace in training and once per
    inference call, instead of once per site and particle (for the HMM at
    T = 16 that is 65,536 of the ~345,000 multiply-adds a particle does
    at each site)."""
    value_dim = params[0]["wx"].shape[0] - obs_emb.shape[-1]
    return obs_emb @ params[0]["wx"][value_dim:]


def lstm_step_split(params, x_val, obs_gate, state):
    """``lstm_step(params, concat([x_val, obs_emb]), state)`` with the
    observation half precomputed by :func:`lstm_obs_gate`."""
    lp0 = params[0]
    x_gates = x_val @ lp0["wx"][: x_val.shape[-1]] + obs_gate
    h_new, c_new = _lstm_cell(lp0, x_gates, *state[0])
    new_state = [(h_new, c_new)]
    inp = h_new
    for layer_params, (h, c) in zip(params[1:], state[1:]):
        h_new, c_new = _lstm_cell(layer_params, inp @ layer_params["wx"], h, c)
        new_state.append((h_new, c_new))
        inp = h_new
    return inp, new_state


def lstm_embed_sequence(params, xs):
    """Run the stacked LSTM over the leading axis of ``xs`` (T, ...,
    input_dim) and return the last top-layer output — counterpart of
    ``ObserveEmbeddingLSTM`` (``observation.py:39-53``); a Python loop
    where the reference scans."""
    state = lstm_zero_state(params, tuple(xs.shape[1:-1]))
    h = None
    for t in range(xs.shape[0]):
        h, state = lstm_step(params, xs[t], state)
    return h


def conv3d_init(generator: torch.Generator, channels=(1, 4, 8), kernel: int = 3,
                out_dim: int = EMBEDDING_DIM, device=None):
    """3-D CNN observation embedding — counterpart of
    ``ObserveEmbeddingCNN3D4C`` (``observation.py:56-93``) for volumetric
    observations."""
    device = _place(device, generator)
    params = {"convs": [], "head": None}
    for cin, cout in zip(channels[:-1], channels[1:]):
        params["convs"].append({
            "w": _kaiming((cout, cin, kernel, kernel, kernel), cin * kernel ** 3,
                          generator, device),
            "b": torch.zeros((cout,), device=device),
        })
    params["head"] = mlp_init([channels[-1], out_dim], generator, device)
    return params


def conv3d_apply(params, vol):
    """``vol``: (..., D, H, W) -> (..., out_dim).  Per-volume
    standardization (the population deviation, as ``jnp.std``), SAME
    convolutions + ReLU, global average pool, dense head.  The
    standardization keeps calorimeter-scale deposits (O(0.01) GeV over
    mostly empty voxels) from vanishing in the pooled activations."""
    batch_shape = tuple(vol.shape[:-3])
    x = vol.reshape((-1, 1) + tuple(vol.shape[-3:]))  # (N, C=1, D, H, W)
    mu = torch.mean(x, dim=(-3, -2, -1), keepdim=True)
    sd = torch.std(x, dim=(-3, -2, -1), keepdim=True, correction=0)
    x = (x - mu) / (sd + 1e-6)
    for conv in params["convs"]:
        x = torch.relu(F.conv3d(x, conv["w"], conv["b"], padding="same"))
    x = torch.mean(x, dim=(-3, -2, -1))          # global average pool -> (N, C)
    x = mlp_apply(params["head"], x)
    return x.reshape(batch_shape + (x.shape[-1],))
