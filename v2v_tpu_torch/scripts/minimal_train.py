"""The port as a library, without the config system (port of
examples/minimal_train.py; the map is docs/API_torch.md): synthesize
voxels from uint8 video on the device inside the train step, run E2VID
over T, take Adam steps, then stream inference from an explicit zero
state.

    python -m v2v_tpu_torch.scripts.minimal_train [--device DEV] [--steps 5]

On the card each step's voxels come from K1 (ops/voxel_cuda.py::
simulate_batch); on the CPU (--device cpu) from its plain version.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device
from ..ops import voxel_cuda
from ..ops.voxel import SimConfig
from ..training.interface import ModelInterface
from ..training.optim import Adam
from ..training.steps import make_train_step

B, T, BINS, H, W = 2, 3, 5, 32, 32

MODULE_CFG = {
    "loss": {"l1_weight": 1.0},
    "model": {
        "target": "model.model.E2VIDRecurrent",   # the reference's target
        "params": {"unet_kwargs": {
            "num_bins": BINS, "skip_type": "sum",
            "recurrent_block_type": "convlstm", "num_encoders": 3,
            "base_num_channels": 8, "num_residual_blocks": 1,
            "use_upsample_conv": True, "final_activation": "",
            "norm": "none"}},
    },
}


def drifting_video() -> np.ndarray:
    """(B, T*BINS+1, H, W) uint8: a gradient drifting 3 px a frame."""
    xx = np.mgrid[0:H, 0:W][1]
    video = np.stack([((xx + 3 * t) % W) / W * 255
                      for t in range(T * BINS + 1)])
    return np.broadcast_to(video, (B,) + video.shape).astype(np.uint8)


def main(device=None, steps: int = 5) -> Dict[str, Any]:
    """`steps` train steps, then one streaming forward. Returns the
    losses, each step's synchronized ms, the prediction's shape and
    range, and K1's launches in the steps."""
    dev = resolve_device(device)
    iface = ModelInterface(MODULE_CFG, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
    opt = Adam(lr=1e-4).make(iface.model.parameters())
    # one step: uint8 video -> simulator -> forward over T -> loss ->
    # backward -> update (what training/train.py runs a batch)
    step = make_train_step(iface, opt, SimConfig())
    batch = {"video": torch.from_numpy(drifting_video()).to(dev),
             "data_source_idx": torch.full((B,), 11, dtype=torch.int64,
                                           device=dev)}
    k1_before = voxel_cuda.simulate_batch.launches
    losses, step_ms = [], []
    for i in range(steps):
        # training seeds a generator afresh each step (new thresholds and
        # noise a synthesis); one seed here, so the loss visibly falls
        t0 = time.perf_counter()
        loss, _ = step(batch, torch.Generator(dev).manual_seed(1))
        losses.append(float(loss))          # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"step {i}: loss {losses[-1]:.4f}")
    k1 = voxel_cuda.simulate_batch.launches - k1_before

    # streaming inference: the recurrent state is passed in and returned
    state = iface.init_state(1, H, W)
    events = torch.from_numpy(np.random.RandomState(0).randint(
        -2, 3, (1, T, H, W, BINS)).astype(np.float32)).to(dev)
    iface.model.eval()
    with torch.no_grad():
        pred, state = iface.forward_sequence(events, state, train=False)
    print("pred", tuple(pred.shape), "range", float(pred.min()),
          float(pred.max()))
    return {"losses": losses, "step_ms": step_ms,
            "pred_shape": tuple(pred.shape),
            "pred_range": (float(pred.min()), float(pred.max())),
            "k1_launches": k1}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; cpu runs the plain path")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    main(args.device, args.steps)
