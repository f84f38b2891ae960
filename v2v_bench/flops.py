"""The work a cell does, counted once on the plain reference at the
cell's shapes on the meta device, and stored in the cell's file: the
numerator of both `mfu` metrics. It does not move when the program
replaces a kernel, adds or drops recomputation, or moves work into a
kernel of its own that a counter cannot see.

The rules are a frozen copy of those of the port's
utils/flops.py (themselves the JAX package's): only matrix products and
convolutions count, a multiply-add as 2; a convolution counts 2 x its
output's elements x its taps x its input channels a group, its input
gradient 2 x the input's elements x taps x output channels a group, its
weight gradient as the forward; a bilinear resize counts as the two
interpolation matmuls of jax.image.resize, and its gradient as many.

    python -m v2v_bench.flops --workload e2vid.train    # prints the count
"""
from __future__ import annotations

import argparse
import math
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten


def _conv_flop(x_shape, w_shape, _bias, _stride, _padding, _dilation,
               transposed, _output_padding, groups, *args, out_shape=None,
               **kwargs) -> int:
    return 2 * math.prod(out_shape) * math.prod(w_shape[2:]) * (
        x_shape[1] // groups)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias_sizes,
                        _stride, _padding, _dilation, _transposed,
                        _output_padding, groups, output_mask,
                        out_shape=None, **kwargs) -> int:
    taps = math.prod(w_shape[2:])
    flops = 0
    if output_mask[0]:
        flops += 2 * math.prod(x_shape) * taps * (grad_out_shape[1] // groups)
    if output_mask[1]:
        flops += 2 * math.prod(grad_out_shape) * taps * (x_shape[1] // groups)
    return flops


def _resize_flop(x_shape, *args, out_shape=None, **kwargs) -> int:
    n, c, h, w = x_shape
    big_h, big_w = out_shape[2:]
    return 2 * n * c * (big_h * h * w + big_h * big_w * w)


def _resize_backward_flop(grad_out_shape, _output_size, input_size, *args,
                          out_shape=None, **kwargs) -> int:
    return _resize_flop(input_size, out_shape=grad_out_shape)


RULES = {aten.convolution: _conv_flop, aten._convolution: _conv_flop,
         aten.convolution_backward: _conv_backward_flop,
         aten.upsample_bilinear2d: _resize_flop,
         aten.upsample_bilinear2d_backward: _resize_backward_flop}


def count(fn, *args, **kwargs) -> int:
    """Matmul and convolution FLOPs of one call of `fn`."""
    with FlopCounterMode(display=False, custom_mapping=dict(RULES)) as c:
        fn(*args, **kwargs)
    return int(c.get_total_flops())


def train_step_flops(cfg: dict) -> int:
    """One train step of configuration `cfg` at its batch, length and
    crop: the teacher's flow, the network's forward over the clips, the
    loss (LPIPS's ground-truth branch included) and the backward, with no
    recomputation. The simulator and the optimizer do no matmul."""
    from .reference import lpips_vgg, nets, raft_small
    from .reference.loss import clip_losses
    tr, loss_cfg = cfg["train"], cfg["module"]["loss"]
    b, t, hw = tr["batch"], tr["sequence_length"], tr["crop_size"]
    net = nets.build(cfg["module"]["model"]["target"])
    lp = lpips_vgg.build().requires_grad_(False)
    teacher = raft_small.build(loss_cfg.get("raft_num_flow_updates", 12))
    teacher.requires_grad_(False)
    meta = torch.device("meta")
    events = torch.empty((b, t, hw, hw, tr["num_bins"]), device=meta)
    frames = torch.empty((b, t, hw, hw, 1), device=meta)

    def step():
        flow = raft_small.pseudo_flow(teacher, frames,
                                      loss_cfg["temporal_consistency_L0"])
        pred = nets.forward_clips(net, events)
        clip_losses(loss_cfg, pred, frames, flow, lp).mean().backward()

    return count(step)


def eval_frame_flops(cfg: dict, height: int, width: int) -> int:
    """One frame of streaming eval at height x width, batch 1."""
    from .reference import nets
    net = nets.build(cfg["module"]["model"]["target"]).requires_grad_(False)
    meta = torch.device("meta")
    frames = torch.empty((1, 1, height, width, cfg["test"]["num_bins"]),
                         device=meta)
    state = net.init_state(1, height, width, torch.float32, meta)
    return count(nets.stream, net, frames, state)


def cell_flops(cell) -> int:
    """The count a cell's file stores: a train step's, or an eval
    frame's."""
    if cell.traffic["kind"] == "train":
        return train_step_flops(cell.config)
    return eval_frame_flops(cell.config, cell.traffic["height"],
                            cell.traffic["width"])


def main(argv=None) -> int:
    from . import cell as cellmod
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    args = ap.parse_args(argv)
    print(cell_flops(cellmod.load(args.workload)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
