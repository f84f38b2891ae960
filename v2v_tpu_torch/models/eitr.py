"""ETNet / EITR (port of v2v_tpu/models/eitr.py; reference model/eitr/*).

Head conv -> 3 strided ConvLSTM encoders (32->64->128->256) -> per-scale
tokens of width 256 (1x1, 2x2 and 4x4 patches at 1/8 resolution) -> three
transformer streams, each a pre-norm encoder (3 layers) and a decoder (2
layers) that cross-attends a coarser stream -> token mean -> upsample
conv decoders with sum skips -> 1x1 pred -> sigmoid. NCHW in and out;
H and W are padded to x8 inside and cropped back.

Modules and attributes keep the reference's state_dict keys:
`trans_encoder{i}.encoder.layers.{j}.*`, `trans_decoder{i}.decoder.
layers.{j}.*`, `DownsampleConv.{i}`, `UpsampleConv.{i}`, packed
`in_proj_weight`/`in_proj_bias`. The three streams run one after the
other as in the reference (the JAX package batches them); the
transformer runs in float32 whatever the input dtype.

In eval, an attention over more than `MultiheadAttention.chunk_threshold`
queries goes to ops/attention.py::attention: the CUDA kernel K3 on the
card, its chunked plain version on the CPU. Dropout is not ported: a
module in training mode with dropout > 0 raises.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.pad import CropParameters
from .submodules import (ConvLayer, LSTMState, RecurrentConvLayer,
                         UpsampleConvLayer)


def sinusoid_pos_table(n_position: int, d_hid: int) -> np.ndarray:
    """1-D sine/cosine table over token index
    (model/eitr/position_encoding.py:12-19)."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed q/k/v projection
    rows [q; k; v], then out_proj), batch-first (B, N, d) inputs."""

    chunk_threshold = 4096      # eval attention over more queries -> K3

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.1):
        super().__init__()
        self.d_model, self.nhead, self.dropout = d_model, nhead, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.init_params_(None)

    @torch.no_grad()
    def init_params_(self, generator: Optional[torch.Generator]) -> None:
        """xavier-uniform packed projection, zero bias (torch's MHA);
        out_proj is an nn.Linear like any other."""
        bound = math.sqrt(6.0 / (4 * self.d_model))
        self.in_proj_weight.uniform_(-bound, bound, generator=generator)
        self.in_proj_bias.zero_()

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
        if self.training and self.dropout > 0:
            raise NotImplementedError("EITR dropout is not ported: run the "
                                      "model in eval mode or with dropout 0")
        d, h = self.d_model, self.nhead
        dh = d // h
        w, b = self.in_proj_weight, self.in_proj_bias

        def heads(x, i):      # (B, N, d) -> (B, h, N, dh)
            x = F.linear(x, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d])
            return x.view(x.shape[0], x.shape[1], h, dh).transpose(1, 2)

        aq, ak, av = heads(q, 0), heads(k, 1), heads(v, 2)
        if not self.training and aq.shape[2] > self.chunk_threshold:
            out = attention(aq.contiguous(), ak.contiguous(),
                            av.contiguous())
        else:
            logits = torch.matmul(aq, ak.transpose(-1, -2)) / math.sqrt(dh)
            out = torch.matmul(torch.softmax(logits, dim=-1), av)
        out = out.transpose(1, 2).reshape(q.shape[0], -1, d)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Pre-norm self-attention + FFN
    (model/eitr/transformer_encoder.py:48-76)."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 1024, dropout: float = 0.1):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, src: torch.Tensor) -> torch.Tensor:
        q = self.norm1(src)
        src2 = src + self.self_attn(q, q, q)
        x = self.linear2(torch.relu(self.linear1(self.norm2(src2))))
        return src2 + x


class DecoderLayer(nn.Module):
    """Pre-norm self + cross attention + FFN
    (model/eitr/transformer_decoder.py:44-82)."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 1024, dropout: float = 0.1):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.norm21 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm22 = nn.LayerNorm(d_model, eps=1e-6)
        self.cross_attn = MultiheadAttention(d_model, nhead, dropout)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-6)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor
                ) -> torch.Tensor:
        q = self.norm1(tgt)
        tgt2 = tgt + self.self_attn(q, q, q)
        kv = self.norm22(memory)
        tgt4 = tgt2 + self.cross_attn(self.norm21(tgt2), kv, kv)
        x = self.linear2(torch.relu(self.linear1(self.norm3(tgt4))))
        return tgt4 + x


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int = 3, d_model: int = 256,
                 nhead: int = 8, dim_feedforward: int = 1024,
                 dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, dim_feedforward, dropout)
            for _ in range(num_layers))

    def forward(self, src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        x = src + pos
        for layer in self.layers:
            x = layer(x)
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int = 2, d_model: int = 256,
                 nhead: int = 8, dim_feedforward: int = 1024,
                 dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, dim_feedforward, dropout)
            for _ in range(num_layers))

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor
                ) -> torch.Tensor:
        x = tgt
        for layer in self.layers:
            x = layer(x, memory)
        return x


class EITR(nn.Module):
    """Reference target `model.eitr.eitr.EITR` (eitr_kwargs: num_bins,
    norm, and `dropout` for deterministic tests). State: 3 ConvLSTM
    states. `forward(*args, method=...)` dispatches to one recurrent
    step ("step") or to the split entry points ("pre", "spine_step",
    "tail"), as E2VIDRecurrent does."""

    def __init__(self, eitr_kwargs: Dict[str, Any]):
        super().__init__()
        norm = eitr_kwargs.get("norm")
        if norm in ("none", "None", ""):
            norm = None
        bins = int(eitr_kwargs.get("num_bins", 5))
        drop = float(eitr_kwargs.get("dropout", 0.1))
        d = 256
        self.head = ConvLayer(bins, 32, 5, 1, norm=norm)
        self.DownsampleConv = nn.ModuleList(
            RecurrentConvLayer(cin, cout, 5, 2, "convlstm", norm=norm)
            for cin, cout in ((32, 64), (64, 128), (128, 256)))
        self.split1 = nn.Conv2d(128, d, 2, 2)
        self.split2 = nn.Conv2d(64, d, 4, 4)
        for i in range(3):
            self.add_module(f"trans_encoder{i}", nn.ModuleDict(
                {"encoder": TransformerEncoder(3, d, 8, 1024, drop)}))
            self.add_module(f"trans_decoder{i}", nn.ModuleDict(
                {"decoder": TransformerDecoder(2, d, 8, 1024, drop)}))
        self.UpsampleConv = nn.ModuleList(
            UpsampleConvLayer(cin, cout, 5, norm=norm)
            for cin, cout in ((256, 128), (128, 64), (64, 32)))
        self.pred = ConvLayer(32, 1, 1, activation=None, norm=norm)
        self._pos: Dict[Tuple, torch.Tensor] = {}

    def pre(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pad to x8 + head conv + encoder-0's input conv."""
        h_in, w_in = x.shape[-2:]
        if h_in % 8 or w_in % 8:
            x = CropParameters(w_in, h_in, 3).pad(x)
        head = self.head(x)
        return head, self.DownsampleConv[0].apply_conv(head)

    def spine_step(self, pre0: torch.Tensor, states: List[LSTMState]):
        """The recurrent spine: encoder-0 cell + encoders 1-2."""
        x, s0 = self.DownsampleConv[0].apply_cell(pre0, states[0])
        blocks, new_states = [x], [s0]
        for enc, st in zip(self.DownsampleConv[1:], states[1:]):
            x, s = enc(x, st)
            blocks.append(x)
            new_states.append(s)
        return blocks, new_states

    def _pos_table(self, n: int, d: int, device) -> torch.Tensor:
        """The (1, n, d) table on `device`, made once per token count."""
        key = (n, d, device)
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(
                sinusoid_pos_table(n, d)).to(device)[None]
        return self._pos[key]

    def tail(self, head: torch.Tensor, blocks: List[torch.Tensor],
             out_hw: Optional[Tuple[int, int]] = None
             ) -> Dict[str, torch.Tensor]:
        """Tokens + transformer streams + upsample decoder + pred;
        `out_hw` crops back when pre() padded."""
        b, d, h8, w8 = blocks[-1].shape
        tokens = lambda x: x.flatten(2).transpose(1, 2)    # (B, N, d)
        words = [tokens(blocks[-1]), tokens(self.split1(blocks[-2])),
                 tokens(self.split2(blocks[-3]))]
        dtype = words[0].dtype
        words = [w.to(torch.float32) for w in words]
        pos = self._pos_table(words[0].shape[1], d, words[0].device)
        hs_enc = [getattr(self, f"trans_encoder{i}")["encoder"](words[i], pos)
                  for i in range(3)]
        memory = (hs_enc[0], hs_enc[0], hs_enc[1])
        hc = [getattr(self, f"trans_decoder{i}")["decoder"](hs_enc[i],
                                                          memory[i])
              for i in range(3)]
        hs = ((hs_enc[0] + hs_enc[1] + hs_enc[2]) + (hc[0] + hc[1] + hc[2])
              ) / 6.0
        hs = hs.to(dtype).transpose(1, 2).reshape(b, d, h8, w8)
        # skips: blocks[2] (256ch), blocks[1] (128), blocks[0] (64)
        # (reference u_trans.py:107-108)
        for i, up in enumerate(self.UpsampleConv):
            hs = up(hs + blocks[2 - i])
        img = torch.sigmoid(self.pred(hs + head))
        if out_hw is not None and (out_hw[0] % 8 or out_hw[1] % 8):
            img = CropParameters(out_hw[1], out_hw[0], 3).crop(img)
        return {"image": img}

    def step(self, x: torch.Tensor, states: List[LSTMState]):
        head, pre0 = self.pre(x)
        blocks, new_states = self.spine_step(pre0, states)
        return self.tail(head, blocks, out_hw=tuple(x.shape[-2:])), new_states

    def forward(self, *args, method: str = "step"):
        fn = {"step": self.step, "pre": self.pre,
              "spine_step": self.spine_step, "tail": self.tail}[method]
        return fn(*args)

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None) -> List[LSTMState]:
        h, w = -(-height // 8) * 8, -(-width // 8) * 8
        states = []
        for ch in (64, 128, 256):
            h, w = h // 2, w // 2
            z = torch.zeros((batch, ch, h, w), dtype=dtype, device=device)
            states.append((z, z))
        return states
