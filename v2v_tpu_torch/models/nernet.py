"""NerNet / NER-Net+: learned voxelization and a NIAM spatio-temporal
LSTM UNet with Global Context Blocks (port of v2v_tpu/models/nernet.py;
reference model/nernet_model.py and model/nernet/*). Test-only, as in
the reference.

Pipeline: raw events (E,5) [x,y,t,p,b] -> a per-event MLP temporal
kernel (ValueLayer) scattered into +/- polarity bins
(QuantizationLayerTrail) [-> an optional CNN refiner] -> a UNet whose
encoders are NAM ST-cells (h/c/m streams) with GCB attention and an
m-stream upsampler.

NCHW, the reference's torch key names (`representation.
quantization_layer.value_layer.mlp.{i}`, `representation.ConvLayer.
cnn.{i}`, `unetrecurrent.encoders.{i}.recurrent_block.conv_x.0`, ...),
so models/convert.py carries the JAX package's parameters across. The
port runs eagerly: a step takes exactly the frame's events, with no
bucket padding and no count (JAX's `n_events` mask: only the first n
events count, so pass `events[:n]`). The resolution is carried in the
state (`init_state`), where the reference rebuilds its voxelizer.

The scatter adds each event's (C,) row into its pixel in a fixed order
(`scatter_rows`): the keys are sorted stably and each pixel's rows are
summed in event order, so a frame's voxel has the same bits on every run
and on the card and the CPU alike.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pad import CropParameters
from .submodules import (ConvLayer, ResidualBlock, TorchBatchNorm,
                         UpsampleConvLayer, activation_fn)
from .unet import UNetConfig, UNetRecurrent, _encoder_states

NIAM = "NIAM_STcell_GCB"


class ValueLayer(nn.Module):
    """Per-event MLP temporal kernel (nernet/representation_modules.py:
    12-54): Linear layers `mlp.{i}`, leaky ReLU 0.1 between them."""

    def __init__(self, mlp_layers: Sequence[int] = (1, 30, 30, 1)):
        super().__init__()
        self.mlp = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(mlp_layers[:-1], mlp_layers[1:]))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = t[..., None]
        for i, layer in enumerate(self.mlp):
            x = layer(x)
            if i < len(self.mlp) - 1:
                x = F.leaky_relu(x, 0.1)
        return x[..., 0]


def scatter_rows(pix: torch.Tensor, values: torch.Tensor, n_pixels: int
                 ) -> torch.Tensor:
    """(n_pixels, C): the sum of the rows of `values` (E, C) at their
    pixel `pix` (E,) in [0, n_pixels). The keys are sorted stably and each
    pixel's rows are added one after another in event order
    (segment_reduce over the sorted rows), so the result repeats bit for
    bit, where index_add_ on CUDA adds with atomics in any order."""
    order = torch.sort(pix, stable=True).indices
    keys = pix[order]
    offsets = torch.searchsorted(
        keys, torch.arange(n_pixels + 1, device=pix.device, dtype=pix.dtype))
    return torch.segment_reduce(values[order], "sum", offsets=offsets,
                                axis=0)


def _scaled_times(events: torch.Tensor, num_bins: int, normalize: bool
                  ) -> torch.Tensor:
    """t - t0 over the window's span, times C - 1 unless `normalize`; 0
    where the span is 0 (representation_modules.py:199-215)."""
    t = events[:, 2]
    t0 = t[0]
    dt = t[-1] - t0
    scaled = (t - t0) / dt.clamp_min(1e-30)
    if not normalize:
        scaled = scaled * (num_bins - 1)
    return torch.where(dt > 0, scaled, torch.zeros_like(scaled))


class QuantizationLayerTrail(nn.Module):
    """Learned voxelization into +/- polarity bins
    (nernet/representation_modules.py:175-261), one sample (B=1, the
    NerNet test contract).

    forward(events, height, width): events (E,5) float32 [x,y,t,p,b]
    with p in {-1,1}, E >= 1. Returns (1, 2C, H, W): the positive bins,
    then the negative ones (the reference's cat([vox[:,1], vox[:,0]])
    order). The temporal kernel is pixel-independent, so each event adds
    one (C,)-row to its (polarity, y, x) pixel: one row scatter
    (`scatter_rows`), where the reference scatters each bin's scalars
    (`quantize_per_bin`, the semantics check)."""

    def __init__(self, num_bins: int,
                 mlp_layers: Sequence[int] = (1, 30, 30, 1),
                 normalize: bool = False):
        super().__init__()
        self.num_bins = num_bins
        self.normalize = normalize
        self.value_layer = ValueLayer(mlp_layers)

    def offsets(self, device) -> torch.Tensor:
        c = self.num_bins
        return torch.tensor([i / (c - 1) if self.normalize else float(i)
                             for i in range(c)], dtype=torch.float32,
                            device=device)

    def forward(self, events: torch.Tensor, height: int, width: int
                ) -> torch.Tensor:
        c, h, w = self.num_bins, height, width
        t = _scaled_times(events, c, self.normalize)
        values = t[:, None] * self.value_layer(
            t[:, None] - self.offsets(events.device)[None, :])
        p = (events[:, 3] + 1) / 2
        pix = (events[:, 0] + w * events[:, 1] + w * h * p).long()
        pix = pix.clamp(0, 2 * h * w - 1)
        vox = scatter_rows(pix, values, 2 * h * w)
        vox = vox.reshape(2, h, w, c).permute(0, 3, 1, 2)
        return torch.cat([vox[1], vox[0]], dim=0)[None]


def quantize_per_bin(layer: QuantizationLayerTrail, events: torch.Tensor,
                     height: int, width: int) -> torch.Tensor:
    """The reference-shaped voxelization: one scalar scatter a bin into
    the flat (2, C, H, W) grid (representation_modules.py:175-261), in
    plain index_add_. The semantics check of QuantizationLayerTrail."""
    c, h, w = layer.num_bins, height, width
    t = _scaled_times(events, c, layer.normalize)
    p = (events[:, 3] + 1) / 2
    base = (events[:, 0] + w * events[:, 1] + w * h * c * p).long()
    flat = events.new_zeros(2 * c * h * w)
    offsets = layer.offsets(events.device)
    for i in range(c):
        values = t * layer.value_layer(t - offsets[i])
        idx = (base + w * h * i).clamp(0, flat.numel() - 1)
        flat.index_add_(0, idx, values)
    vox = flat.reshape(2, c, h, w)
    return torch.cat([vox[1], vox[0]], dim=0)[None]


class RepresentationCNN(nn.Module):
    """The optional voxel refiner (representation_modules.py:264-284):
    `cnn` Sequential of conv, ReLU, then (conv, BatchNorm, ReLU) for each
    middle layer and the tail conv at 2 + 3 * max(num_layers - 2, 0); no
    conv bias."""

    def __init__(self, channels: int, features: int = 64,
                 kernel_size: int = 3, num_layers: int = 3):
        super().__init__()
        k, pad = kernel_size, kernel_size // 2
        layers: List[nn.Module] = [
            nn.Conv2d(channels, features, k, padding=pad, bias=False),
            nn.ReLU()]
        for _ in range(num_layers - 2):
            layers += [nn.Conv2d(features, features, k, padding=pad,
                                 bias=False),
                       TorchBatchNorm(features), nn.ReLU()]
        layers.append(nn.Conv2d(features, channels, k, padding=pad,
                                bias=False))
        self.cnn = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cnn(x)


class _PReLU(nn.PReLU):
    """nn.PReLU(): one shared slope, 0.25 at init."""

    def init_params_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(0.25)


class ContextBlock2d(nn.Module):
    """Global Context Block (nernet/submodules.py:365-443), pool 'att',
    fusion 'channel_add': softmax attention pooling over H*W, then
    `channel_add_conv` (1x1 conv, LayerNorm([planes/ratio, 1, 1]), PReLU,
    1x1 conv) added to every pixel."""

    def __init__(self, inplanes: int, planes: int, ratio: int = 4):
        super().__init__()
        mid = planes // ratio
        self.conv_mask = nn.Conv2d(inplanes, 1, 1)
        self.channel_add_conv = nn.Sequential(
            nn.Conv2d(inplanes, mid, 1), nn.LayerNorm([mid, 1, 1]),
            _PReLU(), nn.Conv2d(mid, inplanes, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        mask = torch.softmax(self.conv_mask(x).reshape(b, 1, h * w), dim=2)
        context = torch.bmm(x.reshape(b, c, h * w), mask.transpose(1, 2))
        return x + self.channel_add_conv(context.reshape(b, c, 1, 1))


class NAMCell(nn.Module):
    """The NAM spatio-temporal LSTM cell with the Local Adaptation Gate
    (nernet/submodules.py:585-644). x, h, c and m all have `hidden`
    channels at one resolution. Gates from x (7), h (4) and m (3), +1 on
    both forget gates; the LAG exp(sigmoid(LAG_conv(x))) folds into f_t."""

    def __init__(self, hidden: int, kernel_size: int = 3):
        super().__init__()
        k, pad = kernel_size, kernel_size // 2
        self.hidden = hidden

        def conv(cin, cout):
            return nn.Sequential(nn.Conv2d(cin, cout, k, padding=pad,
                                           bias=False))

        self.conv_x = conv(hidden, 7 * hidden)
        self.conv_h = conv(hidden, 4 * hidden)
        self.conv_m = conv(hidden, 3 * hidden)
        self.conv_o = conv(2 * hidden, hidden)
        self.LAG_conv = nn.Conv2d(hidden, hidden, 1, bias=False)
        self.conv_last = nn.Conv2d(2 * hidden, hidden, 1, bias=False)

    def forward(self, x, h, c, m):
        nh = self.hidden
        i_x, f_x, g_x, i_xp, f_xp, g_xp, o_x = torch.split(
            self.conv_x(x), nh, dim=1)
        i_h, f_h, g_h, o_h = torch.split(self.conv_h(h), nh, dim=1)
        i_m, f_m, g_m = torch.split(self.conv_m(m), nh, dim=1)

        i_t = torch.sigmoid(i_x + i_h)
        f_t = torch.sigmoid(f_x + f_h + 1.0)
        alpha = torch.exp(torch.sigmoid(self.LAG_conv(x)))
        f_t = torch.sigmoid(f_t - alpha * i_t)
        g_t = torch.tanh(g_x + g_h)
        c_new = f_t * c + i_t * g_t

        i_tp = torch.sigmoid(i_xp + i_m)
        f_tp = torch.sigmoid(f_xp + f_m + 1.0)
        g_tp = torch.tanh(g_xp + g_m)
        m_new = f_tp * m + i_tp * g_tp

        mem = torch.cat([c_new, m_new], dim=1)
        o_t = torch.sigmoid(o_x + o_h + self.conv_o(mem))
        h_new = o_t * torch.tanh(self.conv_last(mem))
        return h_new, c_new, m_new


class RecurrentConvLayerNAMGCB(nn.Module):
    """`conv_1x1` then the GCB, added to x; strided convs for x (`conv`)
    and the m stream (`conv_mem`); then the NAM cell
    (nernet/submodules.py:747-778)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, stride: int = 2, norm=None):
        super().__init__()
        self.conv_1x1 = nn.Conv2d(in_channels, in_channels, 1)
        self.GCB = ContextBlock2d(in_channels, in_channels)
        self.conv = ConvLayer(in_channels, out_channels, kernel_size, stride,
                              norm=norm)
        self.conv_mem = ConvLayer(in_channels, out_channels, kernel_size,
                                  stride, norm=norm)
        self.recurrent_block = NAMCell(out_channels, 3)

    def forward(self, x, h, c, m):
        x = x + self.GCB(self.conv_1x1(x))
        return self.recurrent_block(self.conv(x), h, c, self.conv_mem(m))


def _up_stack(in_sizes: Sequence[int], out_sizes: Sequence[int],
              kernel_size: int, norm) -> nn.ModuleList:
    return nn.ModuleList(UpsampleConvLayer(i, o, kernel_size, norm=norm)
                         for i, o in zip(in_sizes, out_sizes))


def _decode_sum(stack: nn.ModuleList, x: torch.Tensor,
                skips: Sequence[torch.Tensor]) -> torch.Tensor:
    """An upsample stack with sum skips, the deepest skip first."""
    n = len(stack)
    for i, dec in enumerate(stack):
        x = dec(x + skips[n - i - 1])
    return x


class UNetNIAMSTcellGCB(nn.Module):
    """(nernet/unet.py:139-240): a head conv on the 2C learned bins, NAM
    encoders, the m-stream upsampler `m_t_UpsampleLayer` back to full
    resolution, residual blocks and the sum-skip `decoders`, and `pred`
    (with the UNet's norm) on decoders + head. State (h, c, m): h and c a
    tuple over the encoders, m at full resolution with `base` channels."""

    def __init__(self, num_bins: int, base_num_channels: int = 32,
                 num_encoders: int = 3, num_residual_blocks: int = 2,
                 kernel_size: int = 5, norm=None, final_activation=None):
        super().__init__()
        enc_in = [base_num_channels * 2 ** i for i in range(num_encoders)]
        enc_out = [base_num_channels * 2 ** (i + 1)
                   for i in range(num_encoders)]
        self.head = ConvLayer(2 * num_bins, base_num_channels, kernel_size, 1)
        self.encoders = nn.ModuleList(
            RecurrentConvLayerNAMGCB(i, o, kernel_size, norm=norm)
            for i, o in zip(enc_in, enc_out))
        ups = (list(reversed(enc_out)), list(reversed(enc_in)))
        self.m_t_UpsampleLayer = _up_stack(*ups, kernel_size, norm)
        self.resblocks = nn.ModuleList(
            ResidualBlock(enc_out[-1], enc_out[-1], norm)
            for _ in range(num_residual_blocks))
        self.decoders = _up_stack(*ups, kernel_size, norm)
        self.pred = ConvLayer(base_num_channels, 1, 1, activation=None,
                              norm=norm)
        self.final_activation = activation_fn(final_activation)

    def forward(self, x: torch.Tensor, state):
        h_t, c_t, m = state
        head = x = self.head(x)
        new_h, new_c, blocks_m = [], [], []
        for i, enc in enumerate(self.encoders):
            x, c, m = enc(x, h_t[i], c_t[i], m)
            new_h.append(x)
            new_c.append(c)
            blocks_m.append(m)
        new_m = _decode_sum(self.m_t_UpsampleLayer, blocks_m[-1], blocks_m)
        xx = new_h[-1]
        for rb in self.resblocks:
            xx = rb(xx)
        xx = _decode_sum(self.decoders, xx, new_h)
        img = self.pred(xx + head)
        if self.final_activation is not None:
            img = self.final_activation(img)
        return {"image": img}, (tuple(new_h), tuple(new_c), new_m)


class _Voxelization(nn.Module):
    """The reference's Voxelization: `quantization_layer` and the
    optional refiner `ConvLayer`."""

    def __init__(self, kw: Dict[str, Any]):
        super().__init__()
        num_bins = kw["num_bins"]
        self.quantization_layer = QuantizationLayerTrail(
            num_bins, tuple(kw.get("mlp_layers", [1, 30, 30, 1])),
            kw.get("normalize", False))
        if kw.get("use_cnn_representation", False):
            self.ConvLayer = RepresentationCNN(
                2 * num_bins, kw.get("RepCNN_channel", 64),
                kw.get("RepCNN_kernel_size", 3),
                kw.get("RepCNN_num_layers", 3))

    def forward(self, events: torch.Tensor, height: int, width: int
                ) -> torch.Tensor:
        vox = self.quantization_layer(events, height, width)
        if hasattr(self, "ConvLayer"):
            vox = self.ConvLayer(vox)
        return vox


class RepresentationRecurrent(nn.Module):
    """Reference target `model.nernet_model.RepresentationRecurrent`.

    forward(events, state) with events (E,5) float32 [x,y,t,p,b] (p in
    {-1,1}, t from a zero origin) voxelizes at the resolution the state
    was built for, center-pads to 2^num_encoders and runs the NIAM UNet
    (or, with another `recurrent_network`, the plain recurrent UNet on
    the 2C bins). Returns ({"image" (1,1,H,W), "voxel" (1,2C,H,W)},
    new state)."""

    def __init__(self, unet_kwargs: Dict[str, Any]):
        super().__init__()
        kw = dict(unet_kwargs)
        self.unet_kwargs = kw
        self.num_encoders = kw.get("num_encoders", 3)
        self.network = kw.get("recurrent_network", NIAM)
        self.representation = _Voxelization(kw)
        if self.network == NIAM:
            norm = kw.get("norm") or None
            self.unetrecurrent = UNetNIAMSTcellGCB(
                kw["num_bins"], kw.get("base_num_channels", 32),
                self.num_encoders, kw.get("num_residual_blocks", 2),
                kw.get("kernel_size", 5), norm=norm,
                final_activation=kw.get("final_activation", "none"))
        else:
            # the plain recurrent UNet (nernet/unet.py:80-137) on the 2C
            # learned bins
            self.cfg = UNetConfig.from_kwargs(kw)
            self.cfg.num_bins = 2 * kw["num_bins"]
            self.cfg.num_output_channels = 1
            self.unetrecurrent = UNetRecurrent(self.cfg)

    def forward(self, events: torch.Tensor, state):
        unet_state, (height, width) = state
        vox = self.representation(events, height, width)
        padded = CropParameters(width, height, self.num_encoders).pad(vox)
        out, new_unet_state = self.unetrecurrent(padded, unet_state)
        if self.network != NIAM:
            new_unet_state = tuple(new_unet_state)
        # Reference quirk kept for benchmark parity: a TOP-LEFT [:H, :W]
        # crop of the symmetrically padded output (train_utils.py:364),
        # not CropParameters.crop
        img = out["image"][..., :height, :width]
        return {"image": img, "voxel": vox}, (new_unet_state,
                                              (height, width))

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None) -> Tuple:
        """The zero state at `height` x `width`, which it carries: NerNet
        runs one sample at a time (train_utils.py:354)."""
        if batch != 1:
            raise ValueError(f"NerNet runs batch size 1, not {batch}")
        cp = CropParameters(width, height, self.num_encoders)
        ph, pw = cp.height_crop_size, cp.width_crop_size
        if self.network != NIAM:
            return (tuple(_encoder_states(self.cfg, batch, ph, pw, dtype,
                                          device)), (height, width))
        base = self.unet_kwargs.get("base_num_channels", 32)
        h_t = tuple(
            torch.zeros(batch, base * 2 ** (i + 1), ph // 2 ** (i + 1),
                        pw // 2 ** (i + 1), dtype=dtype, device=device)
            for i in range(self.num_encoders))
        c_t = tuple(torch.zeros_like(h) for h in h_t)
        m = torch.zeros(batch, base, ph, pw, dtype=dtype, device=device)
        return ((h_t, c_t, m), (height, width))
