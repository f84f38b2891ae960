"""RAFT teachers for pseudo ground-truth optical flow (port of
v2v_tpu/training/raft.py: raft_small and raft_large).

torchvision's RAFT module tree (feature_encoder / context_encoder /
update_block / mask_predictor, Conv2dNormActivation children `0` conv
and `1` norm), so torchvision-layout state_dicts load and
v2v_tpu/models/convert.py::torch_state_dict_to_flax maps this module's
state_dict onto the JAX teacher. As in the JAX package, a conv has a
bias only when no norm follows it. The pretrained checkpoints are not in
the repository: `$V2V_WEIGHTS_DIR/raft_{small,large}.pth`, or
`random_teacher` / V2V_RANDOM_TEACHER=1 for a randomly initialized
teacher (identical compute; flow targets meaningless).

raft_small: bottleneck blocks, no context norm, one 3x3 ConvGRU, lookup
radius 3, an align-corners bilinear 8x upsample. raft_large: residual
blocks, a frozen BatchNorm context encoder (running statistics, always
in eval), two separable GRUs, lookup radius 4 and the convex 8x
upsample of a mask predictor.

The correlation lookup uses the JAX package's separable tent-weight
formulation (v2v_tpu/models/eraft.py::lookup_pyramid), which matches
grid_sample's zero padding, keeps a 1-pixel pyramid level well defined
and reproduces the reference's offset-transposition quirk.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..models.convert import _strip_wrappers
from ..models.eraft import (convex_upsample, correlation_pyramid,
                            instance_norm, lookup_pyramid)
from ..models.init import materialize
from ..models.submodules import TorchBatchNorm
from ..ops.conv import conv_as_input


class ConvNormAct(nn.Sequential):
    """torchvision Conv2dNormActivation: child `0` conv (bias only without
    a norm), child `1` the frozen BatchNorm for norm "batch" (instance
    norm has no state), optional relu."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride: int = 1,
                 norm: Optional[str] = "instance", act: bool = True):
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        layers = [nn.Conv2d(cin, cout, (kh, kw), stride,
                            ((kh - 1) // 2, (kw - 1) // 2),
                            bias=norm is None)]
        if norm == "batch":
            layers.append(TorchBatchNorm(cout))
        super().__init__(*layers)
        self.norm = norm
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_as_input(self[0], x)
        if self.norm == "instance":
            x = instance_norm(x)
        elif self.norm == "batch":
            x = self[1](x)
        return torch.relu(x) if self.act else x


def _downsample(cin: int, cout: int, norm: Optional[str], stride: int
                ) -> Optional[ConvNormAct]:
    return (ConvNormAct(cin, cout, 1, stride, norm, act=False)
            if stride != 1 or cin != cout else None)


class BottleneckBlock(nn.Module):
    """torchvision raft BottleneckBlock (raft_small)."""

    def __init__(self, cin: int, cout: int, norm: Optional[str],
                 stride: int):
        super().__init__()
        q = cout // 4
        self.convnormrelu1 = ConvNormAct(cin, q, 1, 1, norm)
        self.convnormrelu2 = ConvNormAct(q, q, 3, stride, norm)
        self.convnormrelu3 = ConvNormAct(q, cout, 1, 1, norm)
        self.downsample = _downsample(cin, cout, norm, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convnormrelu3(self.convnormrelu2(self.convnormrelu1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class ResidualBlock(nn.Module):
    """torchvision raft ResidualBlock (raft_large)."""

    def __init__(self, cin: int, cout: int, norm: Optional[str],
                 stride: int):
        super().__init__()
        self.convnormrelu1 = ConvNormAct(cin, cout, 3, stride, norm)
        self.convnormrelu2 = ConvNormAct(cout, cout, 3, 1, norm)
        self.downsample = _downsample(cin, cout, norm, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convnormrelu2(self.convnormrelu1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class FeatureEncoder(nn.Module):
    def __init__(self, layers, norm: Optional[str], bottleneck: bool):
        super().__init__()
        block = BottleneckBlock if bottleneck else ResidualBlock
        self.convnormrelu = ConvNormAct(3, layers[0], 7, 2, norm)
        for li in (1, 2, 3):
            stride = 1 if li == 1 else 2
            setattr(self, f"layer{li}", nn.Sequential(
                block(layers[li - 1], layers[li], norm, stride),
                block(layers[li], layers[li], norm, 1)))
        self.conv = nn.Conv2d(layers[3], layers[4], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convnormrelu(x)
        x = self.layer3(self.layer2(self.layer1(x)))
        return conv_as_input(self.conv, x)


class MotionEncoder(nn.Module):
    """Corr convs (one for raft_small, two for raft_large), two flow convs
    and an output conv; the flow is appended to its output."""

    def __init__(self, corr_ch: int, corr_layers: Tuple[int, ...],
                 flow_layers: Tuple[int, int], out_channels: int):
        super().__init__()
        self.convcorr1 = ConvNormAct(corr_ch, corr_layers[0], 1, norm=None)
        self.convcorr2 = (ConvNormAct(corr_layers[0], corr_layers[1], 3,
                                      norm=None)
                          if len(corr_layers) > 1 else None)
        self.convflow1 = ConvNormAct(2, flow_layers[0], 7, norm=None)
        self.convflow2 = ConvNormAct(flow_layers[0], flow_layers[1], 3,
                                     norm=None)
        self.conv = ConvNormAct(corr_layers[-1] + flow_layers[1],
                                out_channels - 2, 3, norm=None)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = self.convcorr1(corr)
        if self.convcorr2 is not None:
            c = self.convcorr2(c)
        f = self.convflow2(self.convflow1(flow))
        return torch.cat([self.conv(torch.cat([c, f], dim=1)), flow], dim=1)


class ConvGRU(nn.Module):
    def __init__(self, input_size: int, hidden: int, kernel=(3, 3)):
        super().__init__()
        pad = (kernel[0] // 2, kernel[1] // 2)
        self.convz = nn.Conv2d(hidden + input_size, hidden, kernel,
                               padding=pad)
        self.convr = nn.Conv2d(hidden + input_size, hidden, kernel,
                               padding=pad)
        self.convq = nn.Conv2d(hidden + input_size, hidden, kernel,
                               padding=pad)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(conv_as_input(self.convz, hx))
        r = torch.sigmoid(conv_as_input(self.convr, hx))
        q = torch.tanh(conv_as_input(self.convq, torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class RecurrentBlock(nn.Module):
    """One ConvGRU a kernel, each over the same input (raft_small: one
    3x3; raft_large: a separable (1,5) then (5,1) pair)."""

    def __init__(self, input_size: int, hidden: int, kernels):
        super().__init__()
        for gi, k in enumerate(kernels, start=1):
            setattr(self, f"convgru{gi}", ConvGRU(input_size, hidden, k))
        self.n = len(kernels)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for gi in range(1, self.n + 1):
            h = getattr(self, f"convgru{gi}")(h, x)
        return h


class FlowHead(nn.Module):
    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_as_input(self.conv2, torch.relu(conv_as_input(self.conv1, x)))


class UpdateBlock(nn.Module):
    def __init__(self, small: bool):
        super().__init__()
        if small:
            self.motion_encoder = MotionEncoder(4 * 7 * 7, (96,), (64, 32), 82)
            self.recurrent_block = RecurrentBlock(64 + 82, 96, ((3, 3),))
            self.flow_head = FlowHead(96, 128)
        else:
            self.motion_encoder = MotionEncoder(4 * 9 * 9, (256, 192),
                                                (128, 64), 128)
            self.recurrent_block = RecurrentBlock(128 + 128, 128,
                                                  ((1, 5), (5, 1)))
            self.flow_head = FlowHead(128, 256)

    def forward(self, net, inp, flow, corr):
        m = self.motion_encoder(flow, corr)
        net = self.recurrent_block(net, torch.cat([inp, m], dim=1))
        return net, self.flow_head(net)


class MaskPredictor(nn.Module):
    """torchvision raft MaskPredictor (raft_large's convex upsampling),
    with its 0.25 scale."""

    def __init__(self, cin: int = 128, hidden: int = 256):
        super().__init__()
        self.convrelu = ConvNormAct(cin, hidden, 3, norm=None)
        self.conv = nn.Conv2d(hidden, 8 * 8 * 9, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return 0.25 * conv_as_input(self.conv, self.convrelu(x))


def _pad8(x: torch.Tensor) -> torch.Tensor:
    """Bottom/right zero pad of NCHW to a multiple of 8."""
    h, w = x.shape[-2:]
    return F.pad(x, (0, -w % 8, 0, -h % 8))


_BACKBONES = ("raft_small", "raft_large")


class RAFT(nn.Module):
    """torchvision-compatible RAFT (raft_small when `small`, else
    raft_large). NCHW 3-channel images in [-1, 1]."""

    def __init__(self, small: bool = False, iters: int = 12):
        super().__init__()
        self.small = small
        self.iters = iters
        if small:
            feat = (32, 32, 64, 96, 128)
            ctx = (32, 32, 64, 96, 160)
        else:
            feat = ctx = (64, 64, 96, 128, 256)
        self.hdim = 96 if small else 128
        self.radius = 3 if small else 4
        self.feature_encoder = FeatureEncoder(feat, "instance", small)
        self.context_encoder = FeatureEncoder(
            ctx, None if small else "batch", small)
        self.update_block = UpdateBlock(small)
        self.mask_predictor = None if small else MaskPredictor()

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """Per-sample feature maps (instance norm), so frames can be
        batched over time."""
        return self.feature_encoder(_pad8(images))

    def flow_from_fmaps(self, fmap1, fmap2, image1) -> torch.Tensor:
        h, w = image1.shape[-2:]
        pyramid = correlation_pyramid(fmap1, fmap2)
        cnet = self.context_encoder(_pad8(image1))
        net, inp = torch.split(cnet, [self.hdim, cnet.shape[1] - self.hdim],
                               dim=1)
        net, inp = torch.tanh(net), torch.relu(inp)
        n, _, h8, w8 = fmap1.shape
        ys, xs = torch.meshgrid(
            torch.arange(h8, dtype=torch.float32, device=fmap1.device),
            torch.arange(w8, dtype=torch.float32, device=fmap1.device),
            indexing="ij")
        coords0 = torch.stack([xs, ys]).expand(n, 2, h8, w8)
        coords1 = coords0
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = lookup_pyramid(pyramid, coords1, radius=self.radius)
            flow = (coords1 - coords0).to(net.dtype)
            net, delta = self.update_block(net, inp, flow, corr)
            coords1 = coords1 + delta
        if self.small:
            flow_up = 8.0 * F.interpolate(coords1 - coords0, scale_factor=8,
                                          mode="bilinear", align_corners=True)
        else:
            # the JAX teacher takes the mask of the last iteration
            flow_up = convex_upsample(coords1 - coords0,
                                      self.mask_predictor(net))
        return flow_up[..., :h, :w]

    def forward(self, image1: torch.Tensor, image2: torch.Tensor):
        fmap1, fmap2 = self.encode(torch.cat([image1, image2])).chunk(2)
        return self.flow_from_fmaps(fmap1, fmap2, image1)


def random_teacher(num_flow_updates: int = 12, device=None,
                   generator: Optional[torch.Generator] = None,
                   source: str = "raft_small") -> RAFT:
    """A randomly initialized `source` teacher (frozen BatchNorms at mean
    0, var 1), set explicitly: same compute and memory as the pretrained
    one, flow targets meaningless."""
    if source not in _BACKBONES:
        raise ValueError(f"unknown RAFT teacher {source!r}; one of "
                         f"{_BACKBONES}")
    device = resolve_device(device)
    model = materialize(lambda: RAFT(source == "raft_small",
                                     num_flow_updates), device, generator)
    return model.requires_grad_(False).eval()


def load_teacher(source: str = "raft_small", num_flow_updates: int = 12,
                 device=None) -> RAFT:
    """The pretrained teacher from $V2V_WEIGHTS_DIR/<source>.pth, or a
    loud random one when V2V_RANDOM_TEACHER is set."""
    if source not in _BACKBONES:
        raise ValueError(f"unknown RAFT teacher {source!r}; one of "
                         f"{_BACKBONES}")
    path = os.path.join(os.environ.get("V2V_WEIGHTS_DIR", "pretrained"),
                        f"{source}.pth")
    if not os.path.exists(path):
        if os.environ.get("V2V_RANDOM_TEACHER", "").lower() not in (
                "", "0", "false", "no"):
            warnings.warn(
                f"V2V_RANDOM_TEACHER=1: no weights at {path}; using a "
                f"RANDOMLY INITIALIZED {source} teacher — training losses "
                f"are not comparable to published numbers")
            return random_teacher(num_flow_updates, device, source=source)
        raise FileNotFoundError(
            f"RAFT teacher weights not found at {path}; save torchvision's "
            f"{source}(pretrained=True).state_dict() there, set "
            f"V2V_RANDOM_TEACHER=1, pass a teacher explicitly, or use "
            f"optical_flow_source: zeros|gt")
    model = random_teacher(num_flow_updates, device, source=source)
    sd = torch.load(path, map_location="cpu")
    model.load_state_dict({_strip_wrappers(k): v for k, v in sd.items()})
    return model


@torch.no_grad()
def raft_flow(teacher: RAFT, frames: torch.Tensor, l0: int = 1,
              compute_dtype: Optional[torch.dtype] = torch.bfloat16
              ) -> torch.Tensor:
    """Pseudo-GT flow for a frame sequence (model/train_utils.py:55-79):
    frames (B,T,H,W,C) in [0,1] -> flow (B,T,H,W,2), zeros for t < l0.

    Runs the teacher in bf16 by default (inference only, no gradient).
    Unique frames are encoded once; the consecutive pairs are chunked so
    the live all-pairs correlation stays under V2V_RAFT_CORR_BUDGET_GB
    (default 1.5)."""
    b, t, h, w, c = frames.shape
    if t <= l0:
        raise ValueError(
            f"raft_flow: sequence has {t} frames but temporal_consistency_"
            f"L0={l0}; need at least L0+1 frames to form a flow pair")
    n = t - l0 + 1
    imgs = frames[:, l0 - 1:].reshape(b * n, h, w, c) * 2 - 1
    if c == 1:
        imgs = imgs.expand(-1, -1, -1, 3)
    imgs = imgs.permute(0, 3, 1, 2)
    if compute_dtype is not None:
        imgs = imgs.to(compute_dtype)
    fmaps = teacher.encode(imgs)
    fseq = fmaps.reshape(b, n, *fmaps.shape[1:])
    fmap1 = fseq[:, :-1].reshape(-1, *fmaps.shape[1:])
    fmap2 = fseq[:, 1:].reshape(-1, *fmaps.shape[1:])
    img1 = imgs.reshape(b, n, *imgs.shape[1:])[:, :-1].reshape(
        -1, *imgs.shape[1:])

    npairs = fmap1.shape[0]
    hw8 = (h // 8) * (w // 8)
    corr_bytes = hw8 * hw8 * (4 if compute_dtype is None else 2) * 1.34
    budget = float(os.environ.get("V2V_RAFT_CORR_BUDGET_GB", "1.5")) * 2**30
    chunk = max(1, min(npairs, int(budget / corr_bytes)))
    flow = torch.cat([
        teacher.flow_from_fmaps(fmap1[i:i + chunk], fmap2[i:i + chunk],
                                img1[i:i + chunk])
        for i in range(0, npairs, chunk)])
    flow = flow.to(frames.dtype).permute(0, 2, 3, 1).reshape(
        b, t - l0, h, w, 2)
    zeros = flow.new_zeros((b, l0, h, w, 2))
    return torch.cat([zeros, flow], dim=1)
