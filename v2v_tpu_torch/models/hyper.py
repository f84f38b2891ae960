"""HyperE2VID: E2VID's recurrent UNet whose first decoder is a
hypernetwork dynamic convolution (port of v2v_tpu/models/hyper.py;
reference model/hyper_model.py and model/hyper/hyper_dynamic.py). NCHW
in and out.

Context fusion of (voxel, previous reconstruction) -> per-pixel dynamic
atoms over multiscale Fourier-Bessel bases (models/weights/
fourier_bessel_bases.npz, this package's copy of the JAX package's) ->
a per-pixel dynamic conv, computed as one matmul x -> z (B,H,W,M,CO)
and the atom-weighted k*k shift-sum of z (ops/dynconv.py, K4 on the
card). The state is (encoder states, prev_recs); the GT-mixing
curriculum `prev*(1-beta) + gt*beta` runs when `gt` and `beta` are
given. The atom generator's BatchNorms normalize with stored statistics
in eval mode and with the live batch's (updating the running ones) in
training mode.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dynconv import dynamic_shift_sum
from ..ops.upsample import upsample2x_bilinear
from .submodules import LSTMState, TorchBatchNorm
from .unet import UNetConfig, UNetRecurrent, _encoder_states

_BASES_PATH = os.path.join(os.path.dirname(__file__), "weights",
                           "fourier_bessel_bases.npz")


def fourier_bessel_bases(kernel_size: int) -> np.ndarray:
    """(num_multiscale_bases, ks*ks) basis matrix; (12, 25) for ks 5."""
    with np.load(_BASES_PATH) as data:
        return data[f"ks{kernel_size}"]


class ConvolutionalContextFusion(nn.Module):
    """concat(events, prev_recs) -> bilinear /4 (no antialias) -> conv3x3
    (hyper_dynamic.py:7-23)."""

    def __init__(self, in_channels: int, out_channels: int = 32,
                 downsample_factor: int = 4):
        super().__init__()
        self.downsample_factor = downsample_factor
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)

    def forward(self, ev: torch.Tensor, prev_recs: torch.Tensor
                ) -> torch.Tensor:
        ctx = torch.cat([ev, prev_recs], dim=1)
        h, w = ctx.shape[-2:]
        f = self.downsample_factor
        ctx = F.interpolate(ctx, size=(h // f, w // f), mode="bilinear",
                            align_corners=False, antialias=False)
        return self.conv(ctx)


class DynamicAtomGeneration(nn.Module):
    """context -> per-pixel atoms (B,H,W,M,k*k) float32 over the
    Fourier-Bessel bases (hyper_dynamic.py:26-57)."""

    def __init__(self, in_channels: int, kernel_size: int = 5,
                 num_atoms: int = 6, hid_channels: int = 64):
        super().__init__()
        self.kernel_size = kernel_size
        self.num_atoms = num_atoms
        num_ms = fourier_bessel_bases(kernel_size).shape[0]
        self.bases_net = nn.Sequential(
            nn.Conv2d(in_channels, hid_channels, 3, padding=1),
            TorchBatchNorm(hid_channels), nn.Tanh(),
            nn.Conv2d(hid_channels, num_atoms * num_ms, 3, padding=1),
            TorchBatchNorm(num_atoms * num_ms), nn.Tanh())
        self.register_buffer("bases", torch.empty(num_ms, kernel_size ** 2),
                             persistent=False)

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        """Refill the bases (meta-device construction leaves them empty);
        the convs and BatchNorms are filled as children."""
        self.bases.copy_(torch.from_numpy(
            fourier_bessel_bases(self.kernel_size)))

    def forward(self, context: torch.Tensor) -> torch.Tensor:
        x = self.bases_net(context)                     # (B, M*K, H, W)
        b, _, h, w = x.shape
        coeff = x.permute(0, 2, 3, 1).reshape(b, h, w, self.num_atoms, -1)
        # (B,H,W,M,K) x (K,L) in float32, as the JAX einsum's
        # preferred_element_type
        return torch.matmul(coeff.to(torch.float32), self.bases)


class DynamicConv(nn.Module):
    """Per-pixel dynamic convolution (hyper_dynamic.py:60-92), in the JAX
    package's order: the 1x1 composition first, as one matmul x(C) ->
    z(M*CO), then the atom-weighted k*k shift-sum of z."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, num_atoms: int = 6):
        super().__init__()
        self.kernel_size = kernel_size
        self.num_atoms = num_atoms
        self.compositional_coefficients = nn.Parameter(
            torch.empty(out_channels, in_channels * num_atoms, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        """Kaiming-normal coefficients (fan_in C*M) and a zero bias."""
        fan_in = self.compositional_coefficients.shape[1]
        self.compositional_coefficients.normal_(
            0.0, math.sqrt(2.0 / fan_in), generator=generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, atoms: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        m = self.num_atoms
        co = self.compositional_coefficients.shape[0]
        # input channel index c*M + m (c-major over (c, m)): the (C, M*CO)
        # view of v2v_tpu's (1,1,C*M,CO) kernel
        k2 = self.compositional_coefficients.view(co, c, m).permute(
            1, 2, 0).reshape(c, m * co)
        z = torch.matmul(x.permute(0, 2, 3, 1).reshape(b * h * w, c), k2)
        z = z.view(b, h, w, m, co).to(x.dtype)
        out = dynamic_shift_sum(z, atoms, self.kernel_size)
        return (out.to(x.dtype) + self.bias).permute(0, 3, 1, 2)


class DynamicUpsampleLayer(nn.Module):
    """bilinear x2 + a context-conditioned dynamic conv, relu
    (hyper_model.py:33-60)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, in_fuse_channels: int = 6,
                 out_fuse_channels: int = 32, num_atoms: int = 6):
        super().__init__()
        self.context_fusion = ConvolutionalContextFusion(in_fuse_channels,
                                                         out_fuse_channels)
        self.dynamic_atom_generation = DynamicAtomGeneration(
            out_fuse_channels, kernel_size, num_atoms)
        self.dynamic_conv = DynamicConv(in_channels, out_channels,
                                        kernel_size, num_atoms)

    def forward(self, x: torch.Tensor, ev: torch.Tensor,
                prev_recs: torch.Tensor) -> torch.Tensor:
        x_up = upsample2x_bilinear(x)
        atoms = self.dynamic_atom_generation(self.context_fusion(ev,
                                                                 prev_recs))
        return torch.relu(self.dynamic_conv(x_up, atoms))


class HyperUNetRecurrent(UNetRecurrent):
    """UNetRecurrent with the dynamic first decoder
    (hyper_model.py:138-196); `decoders.0` is a DynamicUpsampleLayer."""

    def __init__(self, cfg: UNetConfig):
        super().__init__(cfg)
        self.decoders[0] = DynamicUpsampleLayer(
            cfg.decoder_input_sizes[0], cfg.encoder_input_sizes[-1],
            cfg.kernel_size, in_fuse_channels=1 + cfg.num_bins)

    def forward(self, x: torch.Tensor, states: List[LSTMState],
                prev_recs: torch.Tensor):
        head, pre0 = self.pre(x)
        blocks, new_states = self.spine_step(pre0, states)
        out = self.tail(head, blocks, (x, prev_recs))
        if self.cfg.num_output_channels == 3:
            # the image (1) + flow (2) head split (hyper_model.py:193-195)
            img = out["image"]
            out = {"image": img[:, 0:1], "flow": img[:, 1:3]}
        return out, new_states


HyperState = Tuple[List[LSTMState], torch.Tensor]


class HyperE2VID(nn.Module):
    """Reference target `model.hyper_model.HyperE2VID`. State =
    (encoder states, prev_recs (B,1,H,W)). `forward(x, state, gt=None,
    beta=None, method="step")` is one recurrent step, as E2VIDRecurrent's
    `method="step"`; there are no split entry points. With
    `num_output_channels: 3` the head's channels are the image [0:1] and
    the flow [1:3]; the image alone feeds back as prev_recs."""

    def __init__(self, unet_kwargs: Dict[str, Any]):
        super().__init__()
        cfg = UNetConfig.from_kwargs(dict(unet_kwargs))
        self.cfg = cfg
        self.unetrecurrent = HyperUNetRecurrent(cfg)

    def forward(self, x: torch.Tensor, state: HyperState,
                gt: Optional[torch.Tensor] = None,
                beta: Optional[float] = None, method: str = "step"):
        if method != "step":
            raise ValueError(f"HyperE2VID has no entry point {method!r}")
        enc_states, prev_recs = state
        if gt is not None and beta is not None:
            prev_recs = prev_recs * (1 - beta) + gt * beta
        out, new_enc = self.unetrecurrent(x, enc_states, prev_recs)
        return out, (new_enc, out["image"].detach())

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None) -> HyperState:
        enc = _encoder_states(self.cfg, batch, height, width, dtype, device)
        prev = torch.zeros((batch, 1, height, width), dtype=dtype,
                           device=device)
        return enc, prev
