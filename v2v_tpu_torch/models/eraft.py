"""ERAFT: RAFT for events (port of v2v_tpu/models/eraft.py; reference
model/eraft/*), NCHW, with the reference's torch module tree.

Two BasicEncoders (`fnet` instance norm, `cnet` BatchNorm on live batch
statistics in training), an all-pairs 4-level correlation pyramid with a
9x9 bilinear lookup, a SepConvGRU update block iterated `iters` times,
convex 8x upsampling, and the warm-start carry: the previous low-res flow
forward-splatted to its advected positions
(model/eraft/image_utils.py:53-84). Inputs are zero-padded left and top
to a multiple of 32 (ImagePadder, image_utils.py:85-120) and the flow is
cropped back.

The lookup and the splat are separable tent-weight contractions (batched
matmuls), the JAX package's form: the lookup equals grid_sample's zero
padding, stays defined on a 1-pixel pyramid level (where the reference's
grid_sample normalization divides by W - 1 = 0) and, unlike
grid_sample's CUDA backward, which adds with atomics, repeats bit for bit;
the splat needs no scatter, whose CUDA float32 adds are not deterministic
either. RAFT-large (training/raft.py) shares the correlation, lookup,
upsample and instance norm.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .submodules import TorchBatchNorm


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False, track_running_stats=False)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex combination 8x upsampling (v2v_tpu/models/eraft.py::
    convex_upsample; reference model/eraft/eraft.py:66-77): flow
    (N,2,H,W), mask (N,576,H,W) -> (N,2,8H,8W); each fine pixel is a
    softmax-weighted mix of the 3x3 coarse neighbours of 8 * flow."""
    n, _, h, w = flow.shape
    mask = mask.view(n, 1, 9, 8, 8, h, w).softmax(dim=2)
    up = F.unfold(8.0 * flow, (3, 3), padding=1).view(n, 2, 9, 1, 1, h, w)
    up = (mask * up).sum(dim=2)                      # (N,2,8,8,H,W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


def correlation_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                        num_levels: int = 4) -> List[torch.Tensor]:
    """All-pairs correlation (accumulated in float32, stored in the fmap
    dtype) and its avg-pooled pyramid; fmaps (B,C,H,W) -> list of
    (B*H*W, 1, h_l, w_l)."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.reshape(b, c, h * w)
    f2 = fmap2.reshape(b, c, h * w)
    corr = torch.matmul(f1.transpose(1, 2).float(), f2.float()) / math.sqrt(c)
    corr = corr.to(fmap1.dtype).reshape(b * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        if corr.shape[-2] >= 2 and corr.shape[-1] >= 2:
            corr = F.avg_pool2d(corr, 2, 2)
        pyramid.append(corr)
    return pyramid


def lookup_pyramid(pyramid: List[torch.Tensor], coords: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """(2r+1)^2 bilinear window around coords (B,2,H,W) at each level ->
    (B, levels*(2r+1)^2, H, W). Channel i*k+j samples x offset d[i], y
    offset d[j] (the reference's meshgrid(dy, dx) quirk,
    model/eraft/corr.py:37-43)."""
    b, _, h, w = coords.shape
    k = 2 * radius + 1
    q = b * h * w
    dev = coords.device
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    flat = coords.permute(0, 2, 3, 1).reshape(q, 2).float()
    out = []
    for lvl, corr in enumerate(pyramid):
        plane = corr[:, 0]                                   # (q, hi, wi)
        hi, wi = plane.shape[-2:]
        cx = (flat[:, 0] / 2 ** lvl)[:, None, None]
        cy = (flat[:, 1] / 2 ** lvl)[:, None, None]
        gy = torch.arange(hi, dtype=torch.float32, device=dev)
        gx = torch.arange(wi, dtype=torch.float32, device=dev)
        wy = (1.0 - (cy + d[None, :, None] - gy).abs()).clamp_min(0.0)
        wx = (1.0 - (cx + d[None, :, None] - gx).abs()).clamp_min(0.0)
        tmp = torch.bmm(wy.to(plane.dtype), plane)           # (q, k, wi)
        v = torch.bmm(tmp, wx.to(plane.dtype).transpose(1, 2))  # (q, j, i)
        out.append(v.transpose(1, 2).reshape(b, h, w, k * k))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=False) as a module: no parameters or
    buffers, so it adds no state_dict key, as the reference's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


def _norm(norm_fn: str, planes: int) -> nn.Module:
    if norm_fn == "batch":
        return TorchBatchNorm(planes)
    if norm_fn == "instance":
        return InstanceNorm()
    raise ValueError(f"norm_fn {norm_fn!r}: ERAFT uses 'batch' or "
                     f"'instance'")


class RaftResidualBlock(nn.Module):
    """(model/eraft/extractor.py:7-57) Two 3x3 convs with norms; a strided
    block projects its input through `downsample` = (1x1 conv, norm3). The
    reference registers norm3 as itself and as downsample's second child,
    so a BatchNorm block's state_dict holds its tensors twice, as
    `norm3.*` and `downsample.1.*`; this module keeps that key set."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BasicEncoder(nn.Module):
    """(model/eraft/extractor.py:119-189) A 7x7 stride-2 conv to 64, three
    stages of two residual blocks (64; 96 and 128 at stride 2), a 1x1 conv
    to `output_dim`: 1/8 of the input's resolution."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 n_first_channels: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(n_first_channels, 64, 7, 2, 3)
        self.norm1 = _norm(norm_fn, 64)
        cin = 64
        for li, (dim, stride) in enumerate(((64, 1), (96, 2), (128, 2)), 1):
            setattr(self, f"layer{li}", nn.Sequential(
                RaftResidualBlock(cin, dim, norm_fn, stride),
                RaftResidualBlock(dim, dim, norm_fn, 1)))
            cin = dim
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    """(model/eraft/update.py:63-81) The 324 looked-up correlations and the
    flow into 126 channels, with the flow appended."""

    def __init__(self, corr_planes: int = 4 * 81):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """(model/eraft/update.py:33-60) A GRU pass with 1x5 kernels, then one
    with 5x1 kernels; gates z, r, then the candidate q."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, k, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{suffix}",
                        nn.Conv2d(cin, hidden_dim, k, padding=pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for suffix in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq{suffix}")(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    """(model/eraft/update.py:6-14)"""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    """(model/eraft/update.py:84-106) The motion encoder, the GRU over
    [context, motion], the flow head and the upsampling mask head
    (`mask.0` conv, ReLU, `mask.2` conv, scaled by 0.25)."""

    def __init__(self, hidden_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(nn.Conv2d(hidden_dim, 256, 3, padding=1),
                                  nn.ReLU(), nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def forward_interpolate(flow: torch.Tensor) -> torch.Tensor:
    """The warm-start splat (v2v_tpu/models/eraft.py::forward_interpolate;
    reference model/eraft/image_utils.py:10-84): flow (B,H,W,2) ->
    (B,H,W,2). Each source pixel q, advected to (x1, y1), deposits its
    flow with bilinear weights on the 4 cells around it; a cell takes the
    weighted mean, 0 where nothing lands. With tent weights
    wy[q,s] = max(0, 1 - |y1[q] - s|) (wx likewise) the sums are
    acc[s,t,c] = sum_q wy[q,s] wx[q,t] v[q,c] with v = [1, flow]: one
    batched matmul, no scatter. A source advected out of range collects
    zero weight, as the reference's in-bounds mask drops it; one at an
    integer position lands on a floor == ceil corner, which the
    reference's scatter counts twice in both sums, so the ratio is the
    same.

    The matmul runs in float64: a float32 matmul on the card runs in TF32
    wherever `torch.backends.cuda.matmul.allow_tf32` (or
    `set_float32_matmul_precision`) allows it, which would move the
    quotient, and float64 has no such mode. The tent weights and values
    are float32's, as in the JAX package; their products and sums in
    float64 are rounded to float32 and divided in float32, so the result
    does not depend on the global setting, and cuBLAS's float64 product
    repeats bit for bit."""
    b, h, w, _ = flow.shape
    dev = flow.device
    flow = flow.to(torch.float32)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    x1 = (xs + flow[..., 0]).reshape(b, h * w, 1)
    y1 = (ys + flow[..., 1]).reshape(b, h * w, 1)
    wy = (1.0 - (y1 - ys[:, 0]).abs()).clamp_min(0.0)         # (b, q, h)
    wx = (1.0 - (x1 - xs[0]).abs()).clamp_min(0.0)            # (b, q, w)
    vals = torch.cat([flow.new_ones(b, h, w, 1), flow], dim=-1).reshape(
        b, h * w, 1, 3)
    rows = (wy.double()[..., None] * vals.double()).reshape(b, h * w, h * 3)
    acc = torch.bmm(wx.double().transpose(1, 2), rows)        # (b, w, h*3)
    acc = acc.to(torch.float32).reshape(b, w, h, 3).transpose(1, 2)
    return acc[..., 1:] / (acc[..., :1] + 1e-15)


def _pad32(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Zero-pad NCHW left and top to a multiple of 32 (ImagePadder);
    returns (padded, (top, left))."""
    ph, pw = -x.shape[-2] % 32, -x.shape[-1] % 32
    return F.pad(x, (pw, 0, ph, 0)), (ph, pw)


class ERAFT(nn.Module):
    """Reference target `model.eraft.eraft.ERAFT`: `config` {'subtype':
    'standard' | 'warm_start'}, `n_first_channels` voxel bins, `iters`
    refinements. NCHW voxels in; flows (B,2,H,W) out. The state is the
    warm-start flow (B, Hp/8, Wp/8, 2) at the padded resolution, float32
    and channels-last; `init_state` gives zeros (the reference's
    flow_init None). As in the reference, the splat of every call becomes
    the next call's start, whatever the subtype.

    `forward(*args, method=...)` dispatches, so that
    torch.func.functional_call can run each entry point on substituted
    (e.g. bf16) parameters: "forward" (voxel1, voxel2, state) -> (out,
    state), one pair; "encode" (voxel) -> fnet features (B,256,Hp/8,Wp/8),
    per sample (instance norm), so a sequence's voxels are encoded once
    and batched over time; "step_with_fmaps" (fmap1, fmap2, voxel2,
    state) -> (out, state), the rest of a pair. `cnet`'s BatchNorms follow
    the module's training mode."""

    hidden_dim = context_dim = 128

    def __init__(self, config: Dict[str, Any], n_first_channels: int = 5,
                 iters: int = 12):
        super().__init__()
        subtype = config["subtype"].lower()
        if subtype not in ("standard", "warm_start"):     # eraft.py:102-105
            raise ValueError(f"ERAFT subtype {config['subtype']!r}: "
                             f"'standard' or 'warm_start'")
        self.iters = iters
        self.fnet = BasicEncoder(256, "instance", n_first_channels)
        self.cnet = BasicEncoder(self.hidden_dim + self.context_dim, "batch",
                                 n_first_channels)
        self.update_block = BasicUpdateBlock(self.hidden_dim)

    def forward(self, *args, method: str = "forward"):
        fn = {"forward": self._pair, "encode": self.encode,
              "step_with_fmaps": self.step_with_fmaps}[method]
        return fn(*args)

    def encode(self, voxel: torch.Tensor) -> torch.Tensor:
        return self.fnet(_pad32(voxel)[0])

    def step_with_fmaps(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                        voxel2: torch.Tensor, state: torch.Tensor):
        """The correlation pyramid of the two feature maps, cnet's context
        of voxel2, the refinements from the warm start, the convex
        upsample (cropped back) and the splat of the detached low-res
        flow. The coordinates stay float32 and are detached before each
        lookup (eraft.py:417); the GRU's flow input is in the compute
        dtype."""
        img2, (ph, pw) = _pad32(voxel2)
        pyramid = correlation_pyramid(fmap1, fmap2)
        net, inp = torch.split(self.cnet(img2),
                               [self.hidden_dim, self.context_dim], dim=1)
        net, inp = torch.tanh(net), torch.relu(inp)
        b, _, h8, w8 = fmap1.shape
        ys, xs = torch.meshgrid(
            torch.arange(h8, dtype=torch.float32, device=fmap1.device),
            torch.arange(w8, dtype=torch.float32, device=fmap1.device),
            indexing="ij")
        coords0 = torch.stack([xs, ys]).expand(b, 2, h8, w8)
        coords1 = coords0 + state.permute(0, 3, 1, 2)
        up_mask = None
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = lookup_pyramid(pyramid, coords1, radius=4)
            flow = (coords1 - coords0).to(net.dtype)
            net, up_mask, delta = self.update_block(net, inp, corr, flow)
            coords1 = coords1 + delta
        flow_low = coords1 - coords0
        flow_up = convex_upsample(flow_low, up_mask)[..., ph:, pw:]
        new_state = forward_interpolate(flow_low.detach().permute(0, 2, 3, 1))
        return {"flow": flow_up}, new_state

    def _pair(self, voxel1: torch.Tensor, voxel2: torch.Tensor,
              state: torch.Tensor):
        fmap1, fmap2 = self.encode(torch.cat([voxel1, voxel2])).chunk(2)
        return self.step_with_fmaps(fmap1, fmap2, voxel2, state)

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.zeros(batch, -(-height // 32) * 4, -(-width // 32) * 4,
                           2, dtype=dtype, device=device)
