"""Building blocks of E2VID (NCHW, the reference's torch module tree).

Port of the parts of v2v_tpu/models/submodules.py that E2VID with
`recurrent_block_type: convlstm`, `norm: none` and `use_upsample_conv`
runs: ConvLayer, UpsampleConvLayer, ResidualBlock, ConvLSTM and
RecurrentConvLayer. Attribute names follow the reference's state_dict
keys (`conv2d`, `conv1`/`conv2`, `Gates`, `conv`/`recurrent_block`), so
v2v_tpu/models/convert.py::torch_state_dict_to_flax maps them.

Invariants kept: explicit symmetric k//2 padding; ConvLSTM gate order
[input, forget, output, cell] (torch chunk order); zero state ==
the reference's `prev_state=None`.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LSTMState = Tuple[torch.Tensor, torch.Tensor]   # (hidden, cell), NCHW


def activation_fn(name: Optional[str]) -> Optional[Callable]:
    """The reference's `getattr(torch, name)` activation strings."""
    if name is None or name in ("", "none", "None"):
        return None
    return getattr(torch, name)


def _no_norm(norm: Optional[str]) -> None:
    if norm not in (None, "", "none", "None"):
        raise NotImplementedError(
            f"norm={norm!r}: the port covers E2VID with norm none only")


class TorchBatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d (momentum 0.1, eps 1e-5, affine, running stats) that
    also runs on parameter copies of another dtype than its f32 running
    buffers (v2v_tpu/models/submodules.py::TorchBatchNorm). In eval it
    normalizes with the stored statistics; in training with the live
    batch's, computed in f32, and it updates the running mean and the
    unbiased running var in place. The output has x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.to(torch.float32)
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
            n = x.numel() // x.shape[1]
            if n <= 1:
                raise ValueError(
                    f"TorchBatchNorm: {n} value(s) per channel (input shape "
                    f"{tuple(x.shape)}); torch BatchNorm2d rejects this in "
                    f"training mode")
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * var * (n / (n - 1)))
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (x.to(torch.float32) - mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


class ConvLayer(nn.Module):
    """Conv2d + activation (model/submodules.py:7-34)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        _no_norm(norm)
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size,
                                stride, padding=kernel_size // 2)
        self.activation = activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2d(x)
        return self.activation(x) if self.activation is not None else x


class UpsampleConvLayer(nn.Module):
    """Bilinear x2 upsample (align_corners=False) then conv
    (model/submodules.py:68-96)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        _no_norm(norm)
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size,
                                padding=kernel_size // 2)
        self.activation = activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        x = self.conv2d(x)
        return self.activation(x) if self.activation is not None else x


class ResidualBlock(nn.Module):
    """conv-relu-conv + skip, relu (model/submodules.py:143-176)."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm: Optional[str] = None):
        super().__init__()
        _no_norm(norm)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.conv1(x))
        return torch.relu(self.conv2(out) + x)


class ConvLSTM(nn.Module):
    """Convolutional LSTM cell (model/submodules.py:179-235): one gates
    conv over cat(input, hidden), chunked [in, forget, out, cell]."""

    def __init__(self, input_size: int, hidden_size: int,
                 kernel_size: int = 3):
        super().__init__()
        self.hidden_size = hidden_size
        self.Gates = nn.Conv2d(input_size + hidden_size, 4 * hidden_size,
                               kernel_size, padding=kernel_size // 2)

    def forward(self, x: torch.Tensor, state: LSTMState
                ) -> Tuple[torch.Tensor, LSTMState]:
        prev_hidden, prev_cell = state
        gates = self.Gates(torch.cat([x, prev_hidden], dim=1))
        in_gate, remember_gate, out_gate, cell_gate = gates.chunk(4, dim=1)
        cell = (torch.sigmoid(remember_gate) * prev_cell
                + torch.sigmoid(in_gate) * torch.tanh(cell_gate))
        hidden = torch.sigmoid(out_gate) * torch.tanh(cell)
        return hidden, (hidden, cell)


class RecurrentConvLayer(nn.Module):
    """Strided conv then a ConvLSTM (model/submodules.py:99-118).
    `apply_conv` / `apply_cell` expose the halves for the forward split."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 recurrent_block_type: str = "convlstm",
                 activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        if recurrent_block_type != "convlstm":
            raise NotImplementedError(
                f"recurrent_block_type={recurrent_block_type!r}: the port "
                f"covers convlstm only")
        self.conv = ConvLayer(in_channels, out_channels, kernel_size, stride,
                              activation, norm)
        self.recurrent_block = ConvLSTM(out_channels, out_channels, 3)

    def apply_conv(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)

    def apply_cell(self, x: torch.Tensor, state: LSTMState):
        return self.recurrent_block(x, state)

    def forward(self, x: torch.Tensor, state: LSTMState):
        return self.recurrent_block(self.conv(x), state)
