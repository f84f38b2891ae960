"""Video -> signed event counts, the plain PyTorch simulator.

Port of v2v_tpu/ops/voxel.py (reference data/v2v_core_esim.py:26-69 and
data/v2v_datasets.py:363-410): reverse gamma, log-intensity diffs
integrated into a per-pixel membrane potential, multi-event
quantization by float floor division with threshold subtraction, base
gaussian noise per frame plus persistent hot-pixel noise.

The fused CUDA simulator (K1) and its plain twin with the same Philox
bits live in ops/voxel_cuda.py; this module holds the parameter
sampling and the generator-driven path that `put_noise_external` keeps
(the kernel implements potential noise only), the numpy simulator of
WebVid's `output="voxel"`, the host voxelizer of the h5 test path and
its device twin for padded event tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


def reverse_gamma_correction(imgs: torch.Tensor, gamma: float = 2.2
                             ) -> torch.Tensor:
    """Linearize sRGB-ish video (data/v2v_core_esim.py:3-4)."""
    return (imgs / 255.0) ** gamma * 255.0


def log_intensity(video: torch.Tensor) -> torch.Tensor:
    """log(0.001 + reverse_gamma(v)/255) in float32, the reference form
    with the x255/255 round trip kept (ops/voxel.py:94 of the JAX
    package)."""
    return torch.log(0.001 + reverse_gamma_correction(
        video.to(torch.float32)) / 255.0)


class SimParams(NamedTuple):
    """Per-sample emulator parameters: scalars, or (B,) tensors."""
    pos_thres: torch.Tensor
    neg_thres: torch.Tensor
    base_noise_std: torch.Tensor
    hot_pixel_fraction: torch.Tensor
    hot_pixel_std: torch.Tensor


class SimConfig(NamedTuple):
    """Randomization ranges for per-sample simulator parameters
    (data/v2v_datasets.py:54-60)."""
    threshold_range: Tuple[float, float] = (0.05, 2.0)
    max_thres_pos_neg_gap: float = 1.5
    base_noise_std_range: Tuple[float, float] = (0.0, 0.2)
    hot_pixel_fraction_range: Tuple[float, float] = (0.0, 0.001)
    hot_pixel_std_range: Tuple[float, float] = (0.0, 0.2)
    put_noise_external: bool = False
    scale_noise_strength: bool = False


def _quantize_events(potential, pos_thres, neg_thres):
    """How many events fire this frame, and the residual potential
    (v2v_core_esim.py:51-58, float floor-division semantics)."""
    pos_events = torch.where(potential >= pos_thres,
                             torch.floor(potential / pos_thres), 0.0)
    neg_events = torch.where(potential <= -neg_thres,
                             torch.floor(-potential / neg_thres), 0.0)
    new_potential = potential - pos_events * pos_thres + neg_events * neg_thres
    return pos_events - neg_events, new_potential


def sample_sim_params(generator: torch.Generator, cfg: SimConfig,
                      batch: int,
                      fixed_pos: Optional[torch.Tensor] = None,
                      fixed_neg: Optional[torch.Tensor] = None) -> SimParams:
    """Draw (B,) emulator parameters on the generator's device
    (data/v2v_datasets.py:368-386): theta1 ~ U(range), gap ~ U(1,
    max_gap), random pos/neg assignment, noise stds ~ U(range), optional
    scaling of noise by the (possibly fixed) positive threshold."""
    u = torch.rand((6, batch), generator=generator,
                   device=generator.device, dtype=torch.float32)

    def uniform(row, lo, hi):
        return lo + (hi - lo) * u[row]

    lo, hi = cfg.threshold_range
    thres_1 = uniform(0, lo, hi)
    thres_2 = thres_1 * uniform(1, 1.0, cfg.max_thres_pos_neg_gap)
    swap = u[2] > 0.5
    pos_thres = torch.where(swap, thres_1, thres_2)
    neg_thres = torch.where(swap, thres_2, thres_1)
    if fixed_pos is not None:
        pos_thres = torch.as_tensor(fixed_pos, dtype=torch.float32,
                                    device=u.device).expand(batch)
    if fixed_neg is not None:
        neg_thres = torch.as_tensor(fixed_neg, dtype=torch.float32,
                                    device=u.device).expand(batch)
    base_noise_std = uniform(3, *cfg.base_noise_std_range)
    hot_pixel_fraction = uniform(4, *cfg.hot_pixel_fraction_range)
    hot_pixel_std = uniform(5, *cfg.hot_pixel_std_range)
    if cfg.scale_noise_strength and not cfg.put_noise_external:
        base_noise_std = base_noise_std * pos_thres
        hot_pixel_std = hot_pixel_std * pos_thres
    return SimParams(pos_thres, neg_thres, base_noise_std,
                     hot_pixel_fraction, hot_pixel_std)


def esim_video_to_voxel(video: torch.Tensor, params: SimParams, *,
                        generator: Optional[torch.Generator] = None,
                        put_noise_external: bool = False,
                        init_potential: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(N, H, W) video in [0, 255] -> (N-1, H, W) float32 signed counts.

    `generator=None` runs noise-free from a zero potential (the golden
    path); otherwise the potential starts at U(-neg, pos) and gaussian
    base and hot-pixel noise come from `generator`. Scalar params."""
    n, h, w = video.shape
    dev = video.device
    logs = log_intensity(video)
    pos, neg = params.pos_thres, params.neg_thres
    if generator is None:
        potential = torch.zeros((h, w), dtype=torch.float32, device=dev)
        hot_noise = torch.zeros((h, w), dtype=torch.float32, device=dev)
    else:
        def draw(fn, shape):
            return fn(shape, generator=generator, device=dev,
                      dtype=torch.float32)
        potential = draw(torch.rand, (h, w)) * (pos + neg) - neg
        hot_mask = draw(torch.rand, (h, w)) < params.hot_pixel_fraction
        hot_noise = torch.where(
            hot_mask, params.hot_pixel_std * draw(torch.randn, (h, w)), 0.0)
    if init_potential is not None:
        potential = init_potential.to(torch.float32)
    out = torch.empty((n - 1, h, w), dtype=torch.float32, device=dev)
    for i in range(1, n):
        potential = potential + (logs[i] - logs[i - 1])
        noise = None
        if generator is not None:
            noise = params.base_noise_std * torch.randn(
                (h, w), generator=generator, device=dev,
                dtype=torch.float32)
            if not put_noise_external:
                potential = potential + noise + hot_noise
        counts, potential = _quantize_events(potential, pos, neg)
        if noise is not None and put_noise_external:
            counts = counts + noise + hot_noise
        out[i - 1] = counts
    return out


def simulate_sequence(frames: torch.Tensor, generator: torch.Generator,
                      cfg: SimConfig = SimConfig(), *, num_bins: int = 5,
                      frames_per_bin: int = 1,
                      fixed_params: Optional[SimParams] = None
                      ) -> Tuple[torch.Tensor, SimParams]:
    """Full imgs->voxels pipeline for one sample with the generator's
    noise: (N, H, W) -> ((L, num_bins, H, W), params)."""
    n, h, w = frames.shape
    fpi = num_bins * frames_per_bin
    assert (n - 1) % fpi == 0, (n, num_bins, frames_per_bin)
    if fixed_params is None:
        p = sample_sim_params(generator, cfg, 1)
        fixed_params = SimParams(*(v[0] for v in p))
    counts = esim_video_to_voxel(frames, fixed_params, generator=generator,
                                 put_noise_external=cfg.put_noise_external)
    voxels = counts.reshape((n - 1) // fpi, num_bins, frames_per_bin,
                            h, w).sum(dim=2)
    return voxels, fixed_params


def esim_video_to_voxel_np(video: np.ndarray, pos_thres: float,
                           neg_thres: float, base_noise_std: float = 0.0,
                           hot_pixel_fraction: float = 0.0,
                           hot_pixel_std: float = 0.0,
                           put_noise_external: bool = False,
                           rng=None) -> np.ndarray:
    """(N, H, W) video -> (N-1, H, W) float64 signed counts on the host,
    the numpy emulator of data/v2v_core_esim.py:26-69 (a copy of
    v2v_tpu/ops/voxel.py::esim_video_to_voxel_np). Draws from `rng` (a
    RandomState; default the global np.random) in the reference's order:
    the potential, the hot mask, the hot values, then one base-noise field
    a frame."""
    rng = np.random if rng is None else rng
    n, h, w = video.shape
    potential = rng.rand(h, w) * (pos_thres + neg_thres) - neg_thres
    video = reverse_gamma_correction(video)
    log_imgs = np.log(0.001 + video / 255.0)
    hot_mask = rng.rand(h, w) < hot_pixel_fraction
    hot_noise = np.where(hot_mask, hot_pixel_std * rng.randn(h, w), 0)

    out = []
    for i in range(n - 1):
        potential += log_imgs[i + 1] - log_imgs[i]
        base_noise = base_noise_std * rng.randn(h, w)
        if not put_noise_external:
            potential += base_noise + hot_noise
        pos_ev = np.where(potential >= pos_thres,
                          np.floor_divide(potential, pos_thres), 0)
        neg_ev = np.where(potential <= -neg_thres,
                          np.floor_divide(-potential, neg_thres), 0)
        potential -= pos_ev * pos_thres
        potential += neg_ev * neg_thres
        frame = pos_ev - neg_ev
        if put_noise_external:
            frame = frame + base_noise + hot_noise
        out.append(frame)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# events -> voxel on the host (the h5 test path)
# ---------------------------------------------------------------------------

def events_to_voxel_np(ts: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                       ps: np.ndarray, *, num_bins: int, height: int,
                       width: int, interpolate_bins: bool = False
                       ) -> np.ndarray:
    """The reference h5 voxelizer (data/testh5.py:60-90), the same numpy
    operations as v2v_tpu/ops/voxel.py::events_to_voxel_np, so the voxels
    are the same bits. Polarities in {0, 1}, timestamps in seconds.
    Returns (num_bins, H, W) float64."""
    voxel = np.zeros((num_bins, height, width))
    if ts.shape[0] == 0:
        return voxel
    pol = ps.astype(np.int8) * 2 - 1
    t_us = relative_us(ts)
    if not interpolate_bins:
        t_per_bin = (t_us[-1] + 0.001) / num_bins
        bin_idx = np.floor(t_us / t_per_bin).astype(np.uint8)
        np.add.at(voxel, (bin_idx, ys, xs), pol)
    else:
        dt = t_us[-1] - t_us[0]
        t_norm = (t_us - t_us[0]) / (dt + 0.0001) * (num_bins - 1)
        for bi in range(num_bins):
            weights = np.maximum(0, 1.0 - np.abs(t_norm - bi))
            np.add.at(voxel, (bi, ys, xs), weights * pol)
    return voxel


def relative_us(ts: np.ndarray) -> np.ndarray:
    """float64 second timestamps -> int64 microseconds since the first
    event (data/testh5.py:68), on the host: float32 seconds would lose
    ~10 us."""
    if ts.shape[0] == 0:
        return ts.astype(np.int64)
    return ((ts - ts[0]) * 1e6).astype(np.int64)


def events_to_voxel(t_us: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                    ps: torch.Tensor, n_events, *, num_bins: int,
                    height: int, width: int,
                    interpolate_bins: bool = False) -> torch.Tensor:
    """`events_to_voxel_np`'s math on padded event tensors, wherever they
    lie: t_us (E,) microseconds since the first event (`relative_us` on
    the host), xs/ys (E,) pixel coordinates, ps (E,) in {0, 1}, the first
    `n_events` (an int or a 0-d tensor) valid. Returns (num_bins, H, W)
    float32. The padded tail weighs 0 and is dropped before the scatter,
    as an index out of the grid is (JAX's mode="drop"); CUDA adds the
    bilinear weights in atomic order."""
    e = t_us.shape[0]
    dev = t_us.device
    valid = torch.arange(e, device=dev) < n_events
    pol = torch.where(valid, ps.to(torch.int32) * 2 - 1, 0).float()
    t_us = t_us.float()
    n = torch.as_tensor(n_events, device=dev)
    t_last = t_us[(n - 1).clamp(min=0)]
    flat_hw = ys.to(torch.int32) * width + xs.to(torch.int32)
    size = num_bins * height * width
    voxel = torch.zeros(size, dtype=torch.float32, device=dev)

    def add(idx, vals):
        keep = valid & (idx >= 0) & (idx < size)
        voxel.index_add_(0, idx[keep].long(), vals[keep])

    if not interpolate_bins:
        t_per_bin = (t_last + 0.001) / num_bins
        bin_idx = torch.floor(t_us / t_per_bin).to(torch.int32).clamp(
            0, num_bins - 1)
        add(bin_idx * (height * width) + flat_hw, pol)
    else:
        t_norm = t_us / (t_last + 0.0001) * (num_bins - 1)
        for bi in range(num_bins):
            add(bi * height * width + flat_hw,
                torch.clamp(1.0 - torch.abs(t_norm - bi), min=0.0) * pol)
    return voxel.reshape(num_bins, height, width)
