"""Building blocks of the recurrent UNet zoo (NCHW, the reference's
torch module tree).

Port of v2v_tpu/models/submodules.py: ConvLayer, UpsampleConvLayer,
TransposedConvLayer, ResidualBlock, ConvLSTM, ConvGRU and
RecurrentConvLayer, with the BN and IN norms (TorchBatchNorm,
TorchInstanceNorm). Attribute names follow the reference's state_dict
keys (`conv2d`, `transposed_conv2d`, `norm_layer`, `conv1`/`conv2`,
`bn1`/`bn2`, `Gates`, `reset_gate`/`update_gate`/`out_gate`,
`conv`/`recurrent_block`), so
v2v_tpu/models/convert.py::torch_state_dict_to_flax maps them.

Invariants kept: explicit symmetric k//2 padding; ConvLSTM gate order
[input, forget, output, cell] (torch chunk order); zero state ==
the reference's `prev_state=None`; a conv before a BN has no bias.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..ops.upsample import upsample2x_bilinear
from ..parallel import mesh

LSTMState = Tuple[torch.Tensor, torch.Tensor]   # (hidden, cell), NCHW


def activation_fn(name: Optional[str]) -> Optional[Callable]:
    """The reference's `getattr(torch, name)` activation strings."""
    if name is None or name in ("", "none", "None"):
        return None
    return getattr(torch, name)


def _norm(norm: Optional[str]) -> Optional[str]:
    """"BN", "IN" or None: the reference's layers normalize only for
    these two strings, any other is no norm."""
    return norm if norm in ("BN", "IN") else None


class TorchBatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d (momentum 0.1, eps 1e-5, affine, running stats) that
    also runs on parameter copies of another dtype than its f32 running
    buffers (v2v_tpu/models/submodules.py::TorchBatchNorm). In eval it
    normalizes with the stored statistics; in training with the live
    batch's, computed in f32, and it updates the running mean and the
    unbiased running var in place. The output has x's dtype.

    In a process group of more than one process (parallel/mesh.py) the
    live statistics are the global batch's, as under the JAX package's
    data mesh: the per-channel float32 sums, sums of squares and the
    count go through one differentiable all-reduce, so the gradient
    flows through the global moments."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.to(torch.float32)
            n = x.numel() // x.shape[1]
            if n <= 1:
                raise ValueError(
                    f"TorchBatchNorm: {n} value(s) per channel (input shape "
                    f"{tuple(x.shape)}); torch BatchNorm2d rejects this in "
                    f"training mode")
            if mesh.group_live():
                mean, var, n = _global_moments(xf, n)
            else:
                var, mean = torch.var_mean(xf, dim=(0, 2, 3),
                                           unbiased=False)
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


def _global_moments(xf: torch.Tensor, n: int):
    """(mean, biased var, count) per channel of NCHW float32 `xf` over
    every process of the group: each process's sum, sum of squares
    (from its own mean and variance) and count, summed in one
    differentiable all-reduce. The count stays a tensor on the device
    (no host sync)."""
    c = xf.shape[1]
    var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
    packed = torch.cat([mean * n, (var + mean * mean) * n,
                        xf.new_full((1,), float(n))])
    packed = mesh.all_reduce_sum(packed)
    total = packed[-1]
    mean = packed[:c] / total
    var = (packed[c:2 * c] / total - mean * mean).clamp_min(0.0)
    return mean, var, total


class TorchInstanceNorm(nn.InstanceNorm2d):
    """nn.InstanceNorm2d(C, track_running_stats=True), affine False: the
    reference ConvLayer's "IN" option (model/submodules.py:24;
    v2v_tpu/models/submodules.py::TorchInstanceNorm). In eval every
    sample is normalized with the stored running statistics; in training
    each instance with its own over (H, W), and the running statistics
    move (momentum 0.1) toward the batch mean of the per-instance mean
    and unbiased variance. Computed in float32; the output has x's
    dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(num_features, eps, momentum, affine=False,
                         track_running_stats=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            return ((xf - self.running_mean[:, None, None])
                    * inv[:, None, None]).to(x.dtype)
        n = x.shape[2] * x.shape[3]
        if n <= 1:
            raise ValueError(
                f"TorchInstanceNorm: {n} spatial element(s) per instance "
                f"(input shape {tuple(x.shape)}); torch InstanceNorm2d "
                f"rejects this in training mode")
        var, mean = torch.var_mean(xf, dim=(2, 3), keepdim=True,
                                   unbiased=False)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean
                                    + m * mean.mean(dim=(0, 2, 3)))
            self.running_var.copy_((1 - m) * self.running_var + m * (
                var * (n / (n - 1))).mean(dim=(0, 2, 3)))
            self.num_batches_tracked.add_(1)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain nn.InstanceNorm2d (no running statistics, no affine): the
    live per-instance statistics, train and eval alike (the reference
    ResidualBlock's "IN"), in float32."""
    xf = x.to(torch.float32)
    var, mean = torch.var_mean(xf, dim=(2, 3), keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _norm_layer(norm: Optional[str], channels: int) -> Optional[nn.Module]:
    if norm == "BN":
        return TorchBatchNorm(channels)
    if norm == "IN":
        return TorchInstanceNorm(channels)
    return None


class _ConvNormAct(nn.Module):
    """The shared tail of the conv layers: [norm_layer] then the
    activation."""

    def _finish(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_layer is not None:
            x = self.norm_layer(x)
        return self.activation(x) if self.activation is not None else x


class ConvLayer(_ConvNormAct):
    """Conv2d [+ BN/IN] [+ activation] (model/submodules.py:7-34)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        norm = _norm(norm)
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size,
                                stride, padding=kernel_size // 2,
                                bias=norm != "BN")
        self.norm_layer = _norm_layer(norm, out_channels)
        self.activation = activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._finish(self.conv2d(x))


class UpsampleConvLayer(_ConvNormAct):
    """Bilinear x2 upsample (align_corners=False; ops/upsample.py's kernel
    pair on the card) then conv [+ BN/IN] (model/submodules.py:68-96)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        norm = _norm(norm)
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size,
                                padding=kernel_size // 2, bias=norm != "BN")
        self.norm_layer = _norm_layer(norm, out_channels)
        self.activation = activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._finish(self.conv2d(upsample2x_bilinear(x)))


class TransposedConvLayer(_ConvNormAct):
    """Stride-2 transposed conv [+ BN/IN] (model/submodules.py:37-65):
    ConvTranspose2d(stride 2, padding k//2, output_padding 1), so the
    output is twice the input's size."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        norm = _norm(norm)
        self.transposed_conv2d = nn.ConvTranspose2d(
            in_channels, out_channels, kernel_size, stride=2,
            padding=kernel_size // 2, output_padding=1, bias=norm != "BN")
        self.norm_layer = _norm_layer(norm, out_channels)
        self.activation = activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._finish(self.transposed_conv2d(x))


class ResidualBlock(nn.Module):
    """conv-norm-relu-conv-norm + skip, relu (model/submodules.py:
    143-176). BN: TorchBatchNorms `bn1`/`bn2` and no conv bias; IN: the
    plain instance norm (live statistics, no parameters)."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm: Optional[str] = None):
        super().__init__()
        self.norm = _norm(norm)
        bias = self.norm != "BN"
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               bias=bias)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               bias=bias)
        if self.norm == "BN":
            self.bn1 = TorchBatchNorm(out_channels)
            self.bn2 = TorchBatchNorm(out_channels)

    def _apply_norm(self, x: torch.Tensor, bn: str) -> torch.Tensor:
        if self.norm == "BN":
            return getattr(self, bn)(x)
        if self.norm == "IN":
            return instance_norm(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self._apply_norm(self.conv1(x), "bn1"))
        return torch.relu(self._apply_norm(self.conv2(out), "bn2") + x)


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

    @staticmethod
    def zero_state(batch: int, height: int, width: int, hidden: int,
                   dtype=torch.float32, device=None) -> LSTMState:
        z = torch.zeros((batch, hidden, height, width), dtype=dtype,
                        device=device)
        return (z, z)


class OrthogonalConv2d(nn.Conv2d):
    """A Conv2d whose `init_params_` draws an orthogonal weight and a zero
    bias (the reference ConvGRU's init.orthogonal_ / init.constant_)."""

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        nn.init.orthogonal_(self.weight, generator=generator)
        self.bias.zero_()


class ConvGRU(nn.Module):
    """Convolutional GRU cell (model/submodules.py:238-278): update and
    reset gates over cat(x, h), the candidate over cat(x, h * reset);
    h' = h * (1 - update) + candidate * update. The state is h
    (B, hidden, H, W)."""

    def __init__(self, input_size: int, hidden_size: int,
                 kernel_size: int = 3):
        super().__init__()
        self.hidden_size = hidden_size
        conv = lambda: OrthogonalConv2d(input_size + hidden_size,
                                        hidden_size, kernel_size,
                                        padding=kernel_size // 2)
        self.reset_gate = conv()
        self.update_gate = conv()
        self.out_gate = conv()

    def forward(self, x: torch.Tensor, state: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        stacked = torch.cat([x, state], dim=1)
        update = torch.sigmoid(self.update_gate(stacked))
        reset = torch.sigmoid(self.reset_gate(stacked))
        out = torch.tanh(self.out_gate(torch.cat([x, state * reset], dim=1)))
        new_state = state * (1 - update) + out * update
        return new_state, new_state

    @staticmethod
    def zero_state(batch: int, height: int, width: int, hidden: int,
                   dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.zeros((batch, hidden, height, width), dtype=dtype,
                           device=device)


def recurrent_cell(kind: str, channels: int) -> nn.Module:
    """A 3x3 ConvLSTM or ConvGRU of `channels` in and out."""
    if kind == "convlstm":
        return ConvLSTM(channels, channels, 3)
    if kind == "convgru":
        return ConvGRU(channels, channels, 3)
    raise ValueError(f"recurrent_block_type {kind!r}: the reference has "
                     f"convlstm and convgru")


def zero_cell_state(kind: str, batch: int, height: int, width: int,
                    channels: int, dtype=torch.float32, device=None):
    """The zero state of a `recurrent_cell(kind, channels)`."""
    cls = ConvLSTM if kind == "convlstm" else ConvGRU
    return cls.zero_state(batch, height, width, channels, dtype, device)


class RecurrentConvLayer(nn.Module):
    """Strided conv then a ConvLSTM or ConvGRU (model/submodules.py:
    99-118). `apply_conv` / `apply_cell` expose the halves for the
    forward split."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 recurrent_block_type: str = "convlstm",
                 activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        self.conv = ConvLayer(in_channels, out_channels, kernel_size, stride,
                              activation, norm)
        self.recurrent_block = recurrent_cell(recurrent_block_type,
                                              out_channels)

    def apply_conv(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)

    def apply_cell(self, x: torch.Tensor, state):
        return self.recurrent_block(x, state)

    def forward(self, x: torch.Tensor, state):
        return self.recurrent_block(self.conv(x), state)
