"""Event-stream ops (port of v2v_tpu/ops/events.py; reference
utils/event_utils.py): event images with an optional bilinear spatial
splat, temporal-bilinear voxel grids, polarity-split voxels, Zhu-style
average-timestamp images, flow-based event warping, a sort-based
discrete voxelizer, and a binary search over a sorted h5 dataset.

The device functions take padded event tensors plus a valid count
`n_events` (an int or a 0-d tensor) and run wherever their tensors lie.
JAX scatters with `.at[].add(mode="drop")`, which drops an index out of
range; `index_add_` raises on one, so each scatter here drops the padded
tail and the out-of-range indices itself. The padded tail weighs 0 in
JAX, so dropping it leaves the sums as they are. On the CPU the adds run
in event order; on a card in atomic order, so float sums there may
differ in their last bits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _valid(e: int, n_events, device) -> torch.Tensor:
    return torch.arange(e, device=device) < n_events


def _last(ts: torch.Tensor, n_events) -> torch.Tensor:
    """ts[max(n_events - 1, 0)], without a trip to the host."""
    n = torch.as_tensor(n_events, device=ts.device)
    return ts[(n - 1).clamp(min=0)]


def _scatter(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
             keep: torch.Tensor) -> torch.Tensor:
    """Add vals into the flat `out` at idx where keep and idx is in range
    (JAX's mode="drop"), in place."""
    keep = keep & (idx >= 0) & (idx < out.shape[0])
    return out.index_add_(0, idx[keep].long(), vals[keep].float())


def _zeros(size: int, device) -> torch.Tensor:
    return torch.zeros(size, dtype=torch.float32, device=device)


def events_to_image(xs: torch.Tensor, ys: torch.Tensor, ws: torch.Tensor,
                    n_events, *, sensor_size: Tuple[int, int] = (180, 240),
                    interpolation: Optional[str] = None,
                    padding: bool = False) -> torch.Tensor:
    """Scatter event weights into an (H, W) float32 image
    (events_to_image_torch, utils/event_utils.py:330-376). xs/ys float or
    int pixel coordinates; `interpolation='bilinear'` splats each event
    into its 4 neighbours; `padding` adds a row and a column."""
    h, w = sensor_size
    if padding:
        h, w = h + 1, w + 1
    valid = _valid(xs.shape[0], n_events, xs.device)
    ws = torch.where(valid, ws.float(), 0.0)
    img = _zeros(h * w, xs.device)
    if interpolation == "bilinear":
        pxs, pys = torch.floor(xs), torch.floor(ys)
        dxs, dys = (xs - pxs).float(), (ys - pys).float()
        px, py = pxs.to(torch.int32), pys.to(torch.int32)
        for ox, oy, wt in ((0, 0, (1 - dxs) * (1 - dys)),
                           (1, 0, dxs * (1 - dys)),
                           (0, 1, (1 - dxs) * dys),
                           (1, 1, dxs * dys)):
            xi, yi = px + ox, py + oy
            inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            _scatter(img, yi * w + xi, ws * wt, inb & valid)
    else:
        xi, yi = xs.to(torch.int32), ys.to(torch.int32)
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        _scatter(img, yi * w + xi, ws, inb & valid)
    return img.reshape(h, w)


def events_to_voxel_bilinear(xs: torch.Tensor, ys: torch.Tensor,
                             ts: torch.Tensor, ps: torch.Tensor, n_events,
                             *, num_bins: int,
                             sensor_size: Tuple[int, int] = (180, 240),
                             temporal_bilinear: bool = True) -> torch.Tensor:
    """(B, H, W) voxel grid (events_to_voxel_torch,
    utils/event_utils.py:466-507): t normalized to [0, B-1], each event
    adds max(0, 1 - |t - b|) * p to bin b; else discrete bins of
    (dt + 0.001) / B."""
    h, w = sensor_size
    valid = _valid(xs.shape[0], n_events, xs.device)
    ps = torch.where(valid, ps.float(), 0.0)
    t0 = ts[0]
    dt = _last(ts, n_events) - t0
    if temporal_bilinear:
        t_norm = (ts - t0) / torch.clamp(dt, min=1e-30) * (num_bins - 1)
        return torch.stack([
            events_to_image(xs, ys, ps * torch.clamp(
                1.0 - torch.abs(t_norm - bi), min=0.0), n_events,
                sensor_size=sensor_size)
            for bi in range(num_bins)])
    t_per_bin = (dt + 0.001) / num_bins
    bin_idx = torch.floor((ts - t0) / t_per_bin).to(torch.int32).clamp(
        0, num_bins - 1)
    idx = bin_idx * (h * w) + ys.to(torch.int32) * w + xs.to(torch.int32)
    return _scatter(_zeros(num_bins * h * w, xs.device), idx, ps,
                    valid).reshape(num_bins, h, w)


def events_to_neg_pos_voxel(xs, ys, ts, ps, n_events, *, num_bins: int,
                            sensor_size: Tuple[int, int] = (180, 240),
                            temporal_bilinear: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polarity-split voxels (utils/event_utils.py:509-541): the
    positive events' grid and the others'."""
    kw = dict(num_bins=num_bins, sensor_size=sensor_size,
              temporal_bilinear=temporal_bilinear)
    pos = torch.where(ps > 0, 1.0, 0.0)
    neg = torch.where(ps <= 0, 1.0, 0.0)
    return (events_to_voxel_bilinear(xs, ys, ts, pos, n_events, **kw),
            events_to_voxel_bilinear(xs, ys, ts, neg, n_events, **kw))


def events_to_timestamp_image(xs: torch.Tensor, ys: torch.Tensor,
                              ts: torch.Tensor, ps: torch.Tensor, n_events,
                              *, sensor_size: Tuple[int, int] = (180, 240)
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zhu'19 average-timestamp images per polarity
    (utils/event_utils.py:251-319): a bilinear splat of the timestamps
    over (t_last + 1e-6), the positive and negative events apart, padded
    by one row and column as the reference's padding=True default."""
    valid = _valid(xs.shape[0], n_events, xs.device)
    t_norm = (ts - ts[0]) / (_last(ts, n_events) + 1e-6)
    pos = torch.where((ps > 0) & valid, 1.0, 0.0)
    neg = torch.where((ps <= 0) & valid, 1.0, 0.0)
    kw = dict(sensor_size=sensor_size, interpolation="bilinear",
              padding=True)
    return (events_to_image(xs, ys, t_norm * pos, n_events, **kw),
            events_to_image(xs, ys, t_norm * neg, n_events, **kw))


def warp_events_by_flow(xs: torch.Tensor, ys: torch.Tensor,
                        ts: torch.Tensor, flow: torch.Tensor,
                        t_ref) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move each event at (x, y, t) by flow(x, y) * (t - t_ref)
    (warp_events_flow_torch, utils/event_utils.py:574-616). flow is
    (H, W, 2), sampled bilinearly at the event's position with zeros
    outside (grid_sample with align_corners=True on exact pixel
    coordinates)."""
    h, w, _ = flow.shape
    x0, y0 = torch.floor(xs), torch.floor(ys)
    tx, ty = (xs - x0)[:, None], (ys - y0)[:, None]

    def tap(yy, xx):
        inb = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
        xi = xx.to(torch.int32).clamp(0, w - 1).long()
        yi = yy.to(torch.int32).clamp(0, h - 1).long()
        return torch.where(inb[:, None], flow[yi, xi], 0.0)

    f = (tap(y0, x0) * (1 - tx) * (1 - ty)
         + tap(y0, x0 + 1) * tx * (1 - ty)
         + tap(y0 + 1, x0) * (1 - tx) * ty
         + tap(y0 + 1, x0 + 1) * tx * ty)
    warped = f * (ts - t_ref)[:, None]
    return xs + warped[:, 0], ys + warped[:, 1]


def events_to_voxel_sorted(t_us: torch.Tensor, xs: torch.Tensor,
                           ys: torch.Tensor, ps: torch.Tensor, n_events, *,
                           num_bins: int, height: int, width: int
                           ) -> torch.Tensor:
    """Discrete events -> (B, H, W) voxel by a sort of the cell indices
    and sums over the sorted cells (the math of
    ops/voxel.py::events_to_voxel, discrete). Polarities in {0, 1},
    t_us relative to the first event. The padded tail goes to a cell past
    the grid, which is dropped."""
    e = t_us.shape[0]
    valid = _valid(e, n_events, t_us.device)
    pol = torch.where(valid, ps.to(torch.int32) * 2 - 1, 0).float()
    t_us = t_us.float()
    t_per_bin = (_last(t_us, n_events) + 0.001) / num_bins
    bin_idx = torch.floor(t_us / t_per_bin).to(torch.int32).clamp(
        0, num_bins - 1)
    n_seg = num_bins * height * width
    flat = (bin_idx * (height * width) + ys.to(torch.int32) * width
            + xs.to(torch.int32))
    flat = torch.where(valid, flat.clamp(0, n_seg - 1), n_seg).long()
    order = torch.argsort(flat, stable=True)
    vox = _zeros(n_seg + 1, t_us.device).index_add_(0, flat[order],
                                                    pol[order])
    return vox[:n_seg].reshape(num_bins, height, width)


def binary_search_h5_dset(dset, x, side: str = "left") -> int:
    """Bisect a sorted h5 dataset or memmap without loading it
    (utils/event_utils.py:10-35): the first index whose value is >= x
    (side 'left') or > x (side 'right')."""
    lo, hi = 0, len(dset)
    while lo < hi:
        mid = (lo + hi) // 2
        v = dset[mid]
        if (v < x) if side == "left" else (v <= x):
            lo = mid + 1
        else:
            hi = mid
    return lo
