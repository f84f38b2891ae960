"""V2E-style DVS pixel model (port of v2v_tpu/ops/voxel_v2e.py;
reference data/v2v_core_v2e.py, which the reference keeps as a
deprecated, more physical alternative to the ESIM emulator).

Per pixel:
  * lin-log intensity: the reference's lin_log overwrites its piecewise
    result with log(x/255 + 0.01) (v2v_core_v2e.py:135), so that is the
    mapping;
  * an intensity-dependent first-order IIR low pass (cutoff_hz, tau
    scaled by the rescaled intensity, :139-182);
  * a leak with a per-pixel log-normal rate and jitter (:192-211);
  * multi-event threshold quantization by floor division (:44-63);
  * Poisson shot noise scaled by intensity and the pixel's threshold
    (:65-105);
  * refractory clipping (:534-537);
  * four per-pixel threshold models (:280-283, 333-343, 417-426).

A loop over frames in torch on the video's device, every draw from an
explicit `torch.Generator` on that device. The draws are not JAX's
(`jax.random` there): with the threshold stds, the noise-rate spread,
the jitter and the shot noise at 0 the path draws nothing that matters
and is held to JAX's exactly, up to float32 flips at a threshold; the
noisy path is held by its statistics.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

SHOT_NOISE_INTEN_FACTOR = 0.25

THRESHOLD_MODELS = ("pn_related", "spatial_temporal_independent",
                    "spatial_independent",
                    "spatial_independent_temporal_changing")


class V2EConfig(NamedTuple):
    threshold_model: str = "pn_related"
    thres_mean_mean: float = 0.5
    thres_mean_std: float = 0.1
    thres_diff_mean: float = 0.0
    thres_diff_std: float = 0.1
    cutoff_hz: float = 0.0
    leak_rate_hz: float = 0.1
    refractory_period_s: float = 0.0
    shot_noise_rate_hz: float = 0.0
    leak_jitter_fraction: float = 0.1
    noise_rate_cov_decades: float = 0.1


def lin_log(x: torch.Tensor) -> torch.Tensor:
    """The reference's effective mapping (v2v_core_v2e.py:135)."""
    return torch.log(x / 255.0 + 0.01)


def rescale_intensity_frame(frame: torch.Tensor) -> torch.Tensor:
    """(v2v_core_v2e.py:185-191)"""
    return (frame + 20.0) / 275.0


def v2e_video_to_voxel(video: torch.Tensor, cfg: V2EConfig,
                       generator: torch.Generator,
                       fps: float = 24.0) -> torch.Tensor:
    """(N, H, W) uint8 or float video -> (N-1, H, W) float32 signed event
    counts, shot noise included (video_to_voxel, v2v_core_v2e.py:
    560-585). `generator` lies on the video's device."""
    if cfg.threshold_model not in THRESHOLD_MODELS:
        raise ValueError(cfg.threshold_model)
    video = video.float()
    n, h, w = video.shape
    dev = video.device
    delta_time = 1.0 / fps

    def randn():
        return torch.randn((h, w), generator=generator, device=dev,
                           dtype=torch.float32)

    # initial per-pixel thresholds (_init, :333-343)
    if cfg.threshold_model == "pn_related":
        pn_mean = cfg.thres_mean_mean + cfg.thres_mean_std * randn()
        pn_diff = cfg.thres_diff_mean + cfg.thres_diff_std * randn()
        pos_thres, neg_thres = pn_mean + pn_diff / 2, pn_mean - pn_diff / 2
    else:
        pos_thres = cfg.thres_mean_mean + cfg.thres_mean_std * randn()
        neg_thres = cfg.thres_mean_mean + cfg.thres_mean_std * randn()
    # per-pixel log-normal leak and noise rate (:348-350)
    noise_rate = torch.exp(math.log(10) * cfg.noise_rate_cov_decades
                           * randn())
    pos_nominal = cfg.thres_mean_mean + cfg.thres_diff_mean / 2
    neg_nominal = cfg.thres_mean_mean - cfg.thres_diff_mean / 2
    max_evs = (int(delta_time / cfg.refractory_period_s)
               if cfg.refractory_period_s > 0 else None)

    base_log = lp_log = lin_log(video[0])
    out = torch.empty((n - 1, h, w), dtype=torch.float32, device=dev)
    for i in range(1, n):
        frame = video[i]
        # threshold model updates (:417-426)
        if cfg.threshold_model == "spatial_temporal_independent":
            pos_thres = cfg.thres_mean_mean + cfg.thres_mean_std * randn()
            neg_thres = cfg.thres_mean_mean + cfg.thres_mean_std * randn()
        elif cfg.threshold_model == "spatial_independent_temporal_changing":
            pos_thres = pos_thres + cfg.thres_diff_std * randn()
            neg_thres = neg_thres + cfg.thres_diff_std * randn()
        pos_thres = pos_thres.clamp(min=0.01)
        neg_thres = neg_thres.clamp(min=0.01)

        log_new = lin_log(frame)
        inten01 = rescale_intensity_frame(frame)
        # intensity-dependent IIR low pass (:139-182)
        if cfg.cutoff_hz > 0:
            tau = 1.0 / (math.pi * 2 * cfg.cutoff_hz)
            eps = torch.clamp(inten01 * (delta_time / tau), max=1.0)
            lp_log = (1 - eps) * lp_log + eps * log_new
        else:
            lp_log = log_new
        # leak current (:192-211)
        if cfg.leak_rate_hz > 0:
            leak_rate = (cfg.leak_rate_hz * noise_rate
                         * (1 - cfg.leak_jitter_fraction * randn()))
            base_log = base_log - delta_time * leak_rate * pos_thres

        diff = lp_log - base_log
        pos_evts = torch.floor(torch.clamp(diff, min=0.0) / pos_thres)
        neg_evts = torch.floor(torch.clamp(-diff, min=0.0) / neg_thres)
        # shot noise (:65-105)
        if cfg.shot_noise_rate_hz > 0:
            inten_factor = 1 - (1 - SHOT_NOISE_INTEN_FACTOR) * inten01
            pos_factor = inten_factor * (pos_nominal / pos_thres)
            neg_factor = inten_factor * (neg_nominal / neg_thres)
            shot = (cfg.shot_noise_rate_hz / 2) * delta_time
            pos_evts = pos_evts + torch.poisson(
                pos_factor / pos_factor.mean() * shot, generator=generator)
            neg_evts = neg_evts + torch.poisson(
                neg_factor / neg_factor.mean() * shot, generator=generator)
        if max_evs is not None:
            pos_evts = pos_evts.clamp(max=max_evs)
            neg_evts = neg_evts.clamp(max=max_evs)
        base_log = base_log + pos_evts * pos_thres - neg_evts * neg_thres
        out[i - 1] = pos_evts - neg_evts
    return out
