"""E2VID (E2VIDRecurrent, the flagship) and ETNet (EITR) in plain
PyTorch, written from the published architectures (HYLZ-2019/V2V,
model/unet.py, model/submodules.py, model/eitr/*), with no kernel and no
mixed precision. Every module keeps the reference repository's
state_dict keys, so one set of weights loads into this network and into
the program's.

Only the options the benchmark's configurations use are here: norm none,
ConvLSTM cells, sum skips, bilinear upsample convs, 5x5 kernels. The
networks compute in the dtype of their parameters and inputs, float32
for the reference; the transformer runs in that dtype too.

The one stochastic part, ETNet's dropout, takes its masks from a
`Dropout` object (below) so that a block of clips draws the rows of the
whole batch's masks that belong to it.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class ConvLayer(nn.Module):
    """Conv2d (padding k//2) then an optional relu."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 relu: bool = True):
        super().__init__()
        self.conv2d = nn.Conv2d(cin, cout, k, stride, padding=k // 2)
        self.relu = relu

    def forward(self, x):
        x = self.conv2d(x)
        return torch.relu(x) if self.relu else x


class UpsampleConvLayer(nn.Module):
    """Bilinear x2 upsample (align_corners False), conv, relu."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv2d = nn.Conv2d(cin, cout, k, padding=k // 2)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        return torch.relu(self.conv2d(x))


class ResidualBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return torch.relu(self.conv2(torch.relu(self.conv1(x))) + x)


class ConvLSTM(nn.Module):
    """Gates over cat(x, h), chunked [input, forget, output, cell]."""

    def __init__(self, cin: int, hidden: int, k: int = 3):
        super().__init__()
        self.Gates = nn.Conv2d(cin + hidden, 4 * hidden, k, padding=k // 2)

    def forward(self, x, state):
        h, c = state
        i, f, o, g = self.Gates(torch.cat([x, h], 1)).chunk(4, 1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


class RecurrentConvLayer(nn.Module):
    """Strided ConvLayer, then a 3x3 ConvLSTM."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.conv = ConvLayer(cin, cout, k, stride)
        self.recurrent_block = ConvLSTM(cout, cout, 3)

    def forward(self, x, state):
        return self.recurrent_block(self.conv(x), state)


def zero_states(b: int, h: int, w: int, widths, dtype, device):
    """The zero (h, c) of each recurrent encoder, halving H and W."""
    out = []
    for c in widths:
        h, w = h // 2, w // 2
        z = torch.zeros((b, c, h, w), dtype=dtype, device=device)
        out.append((z, z))
    return out


class UNetRecurrent(nn.Module):
    """E2VID's recurrent UNet: head, 3 recurrent encoders (32 -> 64 ->
    128 -> 256), 2 residual blocks, 3 upsample decoders with sum skips, a
    1x1 prediction."""

    def __init__(self, bins: int = 5, base: int = 32, k: int = 5):
        super().__init__()
        ins = [base, 2 * base, 4 * base]
        outs = [2 * base, 4 * base, 8 * base]
        self.widths = outs
        self.head = ConvLayer(bins, base, k)
        self.encoders = nn.ModuleList(
            RecurrentConvLayer(i, o, k, 2) for i, o in zip(ins, outs))
        self.resblocks = nn.ModuleList(ResidualBlock(outs[-1])
                                       for _ in range(2))
        self.decoders = nn.ModuleList(
            UpsampleConvLayer(i, o, k)
            for i, o in zip(reversed(outs), reversed(ins)))
        self.pred = ConvLayer(base, 1, 1, relu=False)

    def encode(self, x, states):
        head = self.head(x)
        blocks, new = [], []
        y = head
        for enc, st in zip(self.encoders, states):
            y, s = enc(y, st)
            blocks.append(y)
            new.append(s)
        return head, blocks, new

    def tail(self, head, blocks, drop=None):
        y = blocks[-1]
        for rb in self.resblocks:
            y = rb(y)
        for i, dec in enumerate(self.decoders):
            y = dec(y + blocks[-1 - i])
        return self.pred(y + head)


class E2VIDRecurrent(nn.Module):
    """`model.model.E2VIDRecurrent` with final_activation ''."""

    def __init__(self):
        super().__init__()
        self.unetrecurrent = UNetRecurrent()

    def init_state(self, b, h, w, dtype, device):
        return zero_states(b, h, w, self.unetrecurrent.widths, dtype, device)

    def encode(self, x, states):
        return self.unetrecurrent.encode(x, states)

    def tail(self, head, blocks, drop=None):
        return self.unetrecurrent.tail(head, blocks)

    def step(self, x, states, drop=None):
        head, blocks, new = self.encode(x, states)
        return self.tail(head, blocks), new


class Dropout:
    """ETNet's dropout masks for rows [r0, r1) of a batch of `rows`: each
    site draws float32 uniforms of the whole batch's shape from
    `generator`, in the order the sites run, and keeps the block's rows;
    an element is kept where its uniform is >= p and scaled by 1/(1-p).
    `generator=None` applies no dropout (eval, or a FLOP count)."""

    def __init__(self, p: float, generator: Optional[torch.Generator],
                 rows: int = 0, r0: int = 0, r1: int = 0):
        self.p, self.generator = p, generator
        self.rows, self.r0, self.r1 = rows, r0, r1

    def __call__(self, x):
        if self.generator is None or self.p == 0:
            return x
        u = torch.rand((self.rows,) + tuple(x.shape[1:]),
                       generator=self.generator, device=x.device,
                       dtype=torch.float32)[self.r0:self.r1]
        return torch.where(u >= self.p, x / (1 - self.p), 0.0)


def _no_drop(x):
    return x


class MultiheadAttention(nn.Module):
    """Packed in-projection [q; k; v], out_proj; (B, N, d) inputs. The
    softmax runs over every key, a block of 2048 queries at a time, so
    that a 720p frame's 14,400 tokens fit."""

    def __init__(self, d: int = 256, h: int = 8):
        super().__init__()
        self.d, self.h = d, h
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, q, k, v, drop=_no_drop):
        d, h = self.d, self.h
        dh = d // h
        w, b = self.in_proj_weight, self.in_proj_bias

        def heads(x, i):
            x = F.linear(x, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d])
            return x.view(x.shape[0], x.shape[1], h, dh).transpose(1, 2)

        aq, ak, av = heads(q, 0), heads(k, 1), heads(v, 2)
        kt = ak.transpose(-1, -2)
        outs = []
        for i in range(0, aq.shape[2], 2048):
            logits = torch.matmul(aq[:, :, i:i + 2048], kt) / math.sqrt(dh)
            outs.append(torch.matmul(drop(torch.softmax(logits, -1)), av))
        out = torch.cat(outs, 2).transpose(1, 2).reshape(q.shape[0], -1, d)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Pre-norm self-attention and FFN (eps 1e-6, FFN 1024)."""

    def __init__(self, d: int = 256):
        super().__init__()
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.self_attn = MultiheadAttention(d)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.linear1 = nn.Linear(d, 1024)
        self.linear2 = nn.Linear(1024, d)

    def forward(self, x, drop=_no_drop):
        q = self.norm1(x)
        x = x + drop(self.self_attn(q, q, q, drop))
        y = drop(torch.relu(self.linear1(self.norm2(x))))
        return x + drop(self.linear2(y))


class DecoderLayer(nn.Module):
    """Pre-norm self-attention, cross-attention on the normed memory,
    FFN."""

    def __init__(self, d: int = 256):
        super().__init__()
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.self_attn = MultiheadAttention(d)
        self.norm21 = nn.LayerNorm(d, eps=1e-6)
        self.norm22 = nn.LayerNorm(d, eps=1e-6)
        self.cross_attn = MultiheadAttention(d)
        self.norm3 = nn.LayerNorm(d, eps=1e-6)
        self.linear1 = nn.Linear(d, 1024)
        self.linear2 = nn.Linear(1024, d)

    def forward(self, x, memory, drop=_no_drop):
        q = self.norm1(x)
        x = x + drop(self.self_attn(q, q, q, drop))
        kv = self.norm22(memory)
        x = x + drop(self.cross_attn(self.norm21(x), kv, kv, drop))
        y = drop(torch.relu(self.linear1(self.norm3(x))))
        return x + drop(self.linear2(y))


class _Layers(nn.Module):
    def __init__(self, cls, n: int):
        super().__init__()
        self.layers = nn.ModuleList(cls() for _ in range(n))


def sinusoid_table(n: int, d: int) -> np.ndarray:
    pos = np.arange(n)[:, None]
    dim = np.arange(d)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d)
    table = np.zeros((n, d), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class EITR(nn.Module):
    """ETNet: head conv, 3 strided ConvLSTM encoders (32 -> 64 -> 128 ->
    256), tokens of width 256 from 1x1, 2x2 and 4x4 patches at 1/8
    resolution, three transformer streams (3 encoder layers, 2 decoder
    layers cross-attending stream 0, 0 and 1), the mean of the six
    outputs, 3 upsample decoders with sum skips, a 1x1 prediction and a
    sigmoid. H and W must be multiples of 8."""

    def __init__(self, bins: int = 5, d: int = 256):
        super().__init__()
        self.widths = (64, 128, 256)
        self.head = ConvLayer(bins, 32, 5)
        self.DownsampleConv = nn.ModuleList(
            RecurrentConvLayer(i, o, 5, 2)
            for i, o in ((32, 64), (64, 128), (128, 256)))
        self.split1 = nn.Conv2d(128, d, 2, 2)
        self.split2 = nn.Conv2d(64, d, 4, 4)
        for i in range(3):
            self.add_module(f"trans_encoder{i}", nn.ModuleDict(
                {"encoder": _Layers(EncoderLayer, 3)}))
            self.add_module(f"trans_decoder{i}", nn.ModuleDict(
                {"decoder": _Layers(DecoderLayer, 2)}))
        self.UpsampleConv = nn.ModuleList(
            UpsampleConvLayer(i, o, 5)
            for i, o in ((256, 128), (128, 64), (64, 32)))
        self.pred = ConvLayer(32, 1, 1, relu=False)

    def init_state(self, b, h, w, dtype, device):
        return zero_states(b, h, w, self.widths, dtype, device)

    def encode(self, x, states):
        if x.shape[-2] % 8 or x.shape[-1] % 8:
            raise ValueError("EITR reference: H and W must be multiples "
                             "of 8")
        head = self.head(x)
        blocks, new = [], []
        y = head
        for enc, st in zip(self.DownsampleConv, states):
            y, s = enc(y, st)
            blocks.append(y)
            new.append(s)
        return head, blocks, new

    def tail(self, head, blocks, drop=_no_drop):
        b, d, h8, w8 = blocks[-1].shape
        tokens = lambda t: t.flatten(2).transpose(1, 2)
        words = [tokens(blocks[2]), tokens(self.split1(blocks[1])),
                 tokens(self.split2(blocks[0]))]
        pos = torch.from_numpy(sinusoid_table(words[0].shape[1], d)).to(
            device=head.device, dtype=head.dtype)[None]
        enc = []
        for i in range(3):
            t = words[i] + pos
            for layer in getattr(self, f"trans_encoder{i}")[
                    "encoder"].layers:
                t = layer(t, drop)
            enc.append(t)
        memory = (enc[0], enc[0], enc[1])
        dec = []
        for i in range(3):
            t = enc[i]
            for layer in getattr(self, f"trans_decoder{i}")[
                    "decoder"].layers:
                t = layer(t, memory[i], drop)
            dec.append(t)
        hs = ((enc[0] + enc[1] + enc[2]) + (dec[0] + dec[1] + dec[2])) / 6.0
        hs = hs.transpose(1, 2).reshape(b, d, h8, w8)
        for i, up in enumerate(self.UpsampleConv):
            hs = up(hs + blocks[2 - i])
        return torch.sigmoid(self.pred(hs + head))

    def step(self, x, states, drop=_no_drop):
        head, blocks, new = self.encode(x, states)
        return self.tail(head, blocks, drop), new


NETS = {"E2VIDRecurrent": E2VIDRecurrent, "EITR": EITR}


def build(name: str) -> nn.Module:
    """The network a configuration's `model.target` names (its last
    dotted part), on the meta device: weights come from
    `v2v_bench.weights`."""
    with torch.device("meta"):
        return NETS[name.rsplit(".", 1)[-1]]()


def forward_clips(net: nn.Module, events: torch.Tensor,
                  drop=_no_drop) -> torch.Tensor:
    """events (B, T, H, W, bins) -> predictions (B, T, H, W, 1) float32,
    from the zero state, in the parameters' dtype: the recurrent encoders
    a frame at a time, then the rest of the network once over the B*T
    frames, row b*T + t for clip b's frame t, where `drop` draws its
    masks."""
    b, t, h, w, _ = events.shape
    p = next(net.parameters())
    state = net.init_state(b, h, w, p.dtype, events.device)
    x = events.to(p.dtype).permute(0, 1, 4, 2, 3)
    heads, per_step = [], []
    for i in range(t):
        head, blocks, state = net.encode(x[:, i], state)
        heads.append(head)
        per_step.append(blocks)
    rows = lambda z: torch.stack(z, 1).reshape(b * t, *z[0].shape[1:])
    img = net.tail(rows(heads), [rows(z) for z in zip(*per_step)], drop)
    return img.reshape(b, t, *img.shape[1:]).permute(0, 1, 3, 4, 2).float()


def stream(net: nn.Module, frames: torch.Tensor, state
           ) -> Tuple[torch.Tensor, List]:
    """One eval window: frames (1, T, H, W, bins) from `state` -> (the
    window's predictions (1, T, H, W, 1) float32, the carried state)."""
    p = next(net.parameters())
    x = frames.to(p.dtype).permute(0, 1, 4, 2, 3)
    outs = []
    for i in range(x.shape[1]):
        out, state = net.step(x[:, i], state)
        outs.append(out.permute(0, 2, 3, 1).float())
    return torch.stack(outs, 1), state
