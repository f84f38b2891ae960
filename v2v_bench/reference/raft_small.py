"""RAFT-small, the teacher of the temporal-consistency loss, in plain
PyTorch (Teed and Deng, ECCV 2020; torchvision's raft_small module tree
and state_dict keys): bottleneck encoders with instance norm (features)
and none (context), all-pairs correlation with a 4-level pyramid, a
radius-3 lookup, one 3x3 ConvGRU, 12 refinements and an align-corners
bilinear 8x upsample of the flow.

The lookup samples the pyramid with separable tent weights, which equals
grid_sample's zero-padded bilinear sampling, with the original's swap of
the x and y offsets (model/eraft/corr.py:37-43 of HYLZ-2019/V2V).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def instance_norm(x, eps: float = 1e-5):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class ConvNormAct(nn.Sequential):
    """Child `0` a conv (bias only without a norm); instance norm or
    none; an optional relu."""

    def __init__(self, cin, cout, k, stride=1, norm=None, act=True):
        super().__init__(nn.Conv2d(cin, cout, k, stride, (k - 1) // 2,
                                   bias=norm is None))
        self.norm, self.act = norm, act

    def forward(self, x):
        x = self[0](x)
        if self.norm == "instance":
            x = instance_norm(x)
        return torch.relu(x) if self.act else x


class BottleneckBlock(nn.Module):
    def __init__(self, cin, cout, norm, stride):
        super().__init__()
        q = cout // 4
        self.convnormrelu1 = ConvNormAct(cin, q, 1, 1, norm)
        self.convnormrelu2 = ConvNormAct(q, q, 3, stride, norm)
        self.convnormrelu3 = ConvNormAct(q, cout, 1, 1, norm)
        self.downsample = (ConvNormAct(cin, cout, 1, stride, norm, False)
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        y = self.convnormrelu3(self.convnormrelu2(self.convnormrelu1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class FeatureEncoder(nn.Module):
    def __init__(self, layers, norm):
        super().__init__()
        self.convnormrelu = ConvNormAct(3, layers[0], 7, 2, norm)
        for li in (1, 2, 3):
            stride = 1 if li == 1 else 2
            setattr(self, f"layer{li}", nn.Sequential(
                BottleneckBlock(layers[li - 1], layers[li], norm, stride),
                BottleneckBlock(layers[li], layers[li], norm, 1)))
        self.conv = nn.Conv2d(layers[3], layers[4], 1)

    def forward(self, x):
        x = self.convnormrelu(x)
        return self.conv(self.layer3(self.layer2(self.layer1(x))))


class MotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.convcorr1 = ConvNormAct(4 * 7 * 7, 96, 1)
        self.convflow1 = ConvNormAct(2, 64, 7)
        self.convflow2 = ConvNormAct(64, 32, 3)
        self.conv = ConvNormAct(96 + 32, 80, 3)

    def forward(self, flow, corr):
        c = self.convcorr1(corr)
        f = self.convflow2(self.convflow1(flow))
        return torch.cat([self.conv(torch.cat([c, f], 1)), flow], 1)


class ConvGRU(nn.Module):
    def __init__(self, cin, hidden):
        super().__init__()
        self.convz = nn.Conv2d(hidden + cin, hidden, 3, padding=1)
        self.convr = nn.Conv2d(hidden + cin, hidden, 3, padding=1)
        self.convq = nn.Conv2d(hidden + cin, hidden, 3, padding=1)

    def forward(self, h, x):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1)))
        return (1 - z) * h + z * q


class RecurrentBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.convgru1 = ConvGRU(64 + 82, 96)

    def forward(self, h, x):
        return self.convgru1(h, x)


class FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(96, 128, 3, padding=1)
        self.conv2 = nn.Conv2d(128, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.motion_encoder = MotionEncoder()
        self.recurrent_block = RecurrentBlock()
        self.flow_head = FlowHead()

    def forward(self, net, inp, flow, corr):
        net = self.recurrent_block(
            net, torch.cat([inp, self.motion_encoder(flow, corr)], 1))
        return net, self.flow_head(net)


def correlation_pyramid(f1, f2, levels: int = 4):
    b, c, h, w = f1.shape
    corr = torch.matmul(f1.reshape(b, c, h * w).transpose(1, 2),
                        f2.reshape(b, c, h * w)) / math.sqrt(c)
    corr = corr.reshape(b * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(levels - 1):
        if corr.shape[-2] >= 2 and corr.shape[-1] >= 2:
            corr = F.avg_pool2d(corr, 2, 2)
        pyramid.append(corr)
    return pyramid


def lookup(pyramid, coords, radius: int):
    """(2r+1)^2 bilinear samples around coords (B, 2, H, W) at each level
    -> (B, levels * (2r+1)^2, H, W); channel i*k + j samples x offset
    d[i], y offset d[j]."""
    b, _, h, w = coords.shape
    k = 2 * radius + 1
    dev = coords.device
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype, device=dev)
    flat = coords.permute(0, 2, 3, 1).reshape(b * h * w, 2)
    out = []
    for lvl, corr in enumerate(pyramid):
        plane = corr[:, 0]
        hi, wi = plane.shape[-2:]
        cx = (flat[:, 0] / 2 ** lvl)[:, None, None]
        cy = (flat[:, 1] / 2 ** lvl)[:, None, None]
        gy = torch.arange(hi, dtype=coords.dtype, device=dev)
        gx = torch.arange(wi, dtype=coords.dtype, device=dev)
        wy = (1.0 - (cy + d[None, :, None] - gy).abs()).clamp_min(0.0)
        wx = (1.0 - (cx + d[None, :, None] - gx).abs()).clamp_min(0.0)
        v = torch.bmm(torch.bmm(wy.to(plane.dtype), plane),
                      wx.to(plane.dtype).transpose(1, 2))
        out.append(v.transpose(1, 2).reshape(b, h, w, k * k))
    return torch.cat(out, -1).permute(0, 3, 1, 2)


class RAFTSmall(nn.Module):
    def __init__(self, iters: int = 12):
        super().__init__()
        self.iters = iters
        self.feature_encoder = FeatureEncoder((32, 32, 64, 96, 128),
                                              "instance")
        self.context_encoder = FeatureEncoder((32, 32, 64, 96, 160), None)
        self.update_block = UpdateBlock()

    def forward(self, image1, image2):
        """Images (N, 3, H, W) in [-1, 1], H and W multiples of 8 ->
        flow (N, 2, H, W) in pixels."""
        fmaps = self.feature_encoder(torch.cat([image1, image2]))
        f1, f2 = fmaps.chunk(2)
        pyramid = correlation_pyramid(f1, f2)
        net, inp = torch.split(self.context_encoder(image1), [96, 64], 1)
        net, inp = torch.tanh(net), torch.relu(inp)
        n, _, h8, w8 = f1.shape
        ys, xs = torch.meshgrid(
            torch.arange(h8, dtype=f1.dtype, device=f1.device),
            torch.arange(w8, dtype=f1.dtype, device=f1.device),
            indexing="ij")
        coords0 = torch.stack([xs, ys]).expand(n, 2, h8, w8)
        coords1 = coords0
        for _ in range(self.iters):
            corr = lookup(pyramid, coords1, 3)
            net, delta = self.update_block(net, inp, coords1 - coords0, corr)
            coords1 = coords1 + delta
        return 8.0 * F.interpolate(coords1 - coords0, scale_factor=8,
                                   mode="bilinear", align_corners=True)


def build(iters: int = 12) -> RAFTSmall:
    with torch.device("meta"):
        return RAFTSmall(iters)


@torch.no_grad()
def pseudo_flow(teacher: RAFTSmall, frames: torch.Tensor, l0: int,
                pairs_a_call: int = 64) -> torch.Tensor:
    """The temporal-consistency target: frames (B, T, H, W, 1) in [0, 1]
    -> flow (B, T, H, W, 2) from frame t-1 to frame t for t >= l0, zeros
    before (model/train_utils.py:55-79 of HYLZ-2019/V2V)."""
    b, t, h, w, _ = frames.shape
    p = next(teacher.parameters())
    imgs = (frames[:, l0 - 1:] * 2 - 1).expand(-1, -1, -1, -1, 3)
    imgs = imgs.permute(0, 1, 4, 2, 3).to(p.dtype)
    a = imgs[:, :-1].reshape(-1, 3, h, w)
    z = imgs[:, 1:].reshape(-1, 3, h, w)
    flow = torch.cat([teacher(a[i:i + pairs_a_call], z[i:i + pairs_a_call])
                      for i in range(0, a.shape[0], pairs_a_call)])
    flow = flow.float().permute(0, 2, 3, 1).reshape(b, t - l0, h, w, 2)
    return torch.cat([flow.new_zeros((b, l0, h, w, 2)), flow], 1)
