"""The port's interleaved-chain simulator K5 (v2v_tpu_torch ops/
sim_interleave.py and scripts/exp_sim_interleave.py) against the JAX
experiment scripts/exp_sim_interleave.py and against K1's plain version.

The CPU runs K5's plain version. JAX's K5 runs in the TPU interpret
mode, where the on-core generator yields zero bits: the port's plain
version with every Philox word forced to zero computes the same counts.
The kernel itself is compared with the plain version on the card (the
`cuda` test below, and chip_smoke.py)."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from v2v_tpu_torch.ops import sim_interleave as si
from v2v_tpu_torch.ops import voxel_cuda as vc
from v2v_tpu_torch.ops.voxel import SimParams
from v2v_tpu_torch.scripts import exp_sim_interleave as exp

# device-log flip budget (docs/PERF.md "Round 4: device-log flip
# budget"): two log implementations may differ by an ulp, which moves a
# near-threshold crossing by one frame: |delta| <= 1 at a rate <= 5e-4
FLIP_RATE = 5e-4
# per-clip (pos, neg, noise): noise 0 still adds the hot gaussian
CLIP_PARAMS = ((0.4, 0.5, 0.05), (0.3, 0.4, 0.0), (0.6, 0.3, 0.1),
               (0.2, 0.25, 0.2))
SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "exp_sim_interleave.py"


class _InterpretPallas:
    """`pl` for the JAX script: pallas_call in the TPU interpret mode
    (plain interpret mode has no CPU rule for `prng_seed`), without the
    TPU compiler parameters."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, compiler_params=None, **kw):
        return pl.pallas_call(*args, interpret=pltpu.InterpretParams(), **kw)


@pytest.fixture(scope="module")
def jax_exp():
    spec = importlib.util.spec_from_file_location("jax_exp_sim_interleave",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = _InterpretPallas()
    return mod


def _clip_params(b):
    pos, neg, noise = (np.array([CLIP_PARAMS[i % 4][k] for i in range(b)],
                                np.float32) for k in range(3))
    return pos, neg, noise


def _flips(got, want):
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    return float(diff.max()), int((diff > 0).sum())


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_jax_interpret_k5_matches_plain_with_zero_bits(jax_exp, monkeypatch,
                                                       dtype):
    b, n, h, w = 4, 21, 16, 128
    video = exp.make_video((b, n, h, w)).astype(dtype)
    seeds = np.arange(b, dtype=np.int32) + 7
    pos, neg, noise = _clip_params(b)
    monkeypatch.setattr(vc, "_philox_draws", lambda seed, pixel, counter,
                        stream: ((seed + pixel) * 0,) * 4)
    want = si.simulate_interleave_plain(
        torch.from_numpy(video), torch.from_numpy(seeds),
        *map(torch.from_numpy, (pos, neg, noise))).to(torch.float32).numpy()
    assert np.abs(want).mean() > 0.05
    outs = []
    for spp in (1, 2, 4):
        got = jax_exp.simulate(jnp.asarray(video), jnp.asarray(seeds),
                               jnp.asarray(pos), jnp.asarray(neg),
                               jnp.asarray(noise), spp=spp, tile_h=h // spp)
        assert got.dtype == jnp.bfloat16 and got.shape == (b, n - 1, h, w)
        outs.append(np.asarray(got.astype(jnp.float32)))
        dmax, flips = _flips(outs[-1], want)
        print(f"{dtype} spp={spp}: {flips} of {want.size} counts differ "
              f"(max |diff| {dmax})")
        assert dmax <= 1.0 and flips <= FLIP_RATE * want.size, (spp, flips)
    # the premise: interpret-mode bits do not depend on the seeding
    for spp, got in zip((2, 4), outs[1:]):
        np.testing.assert_array_equal(got, outs[0], err_msg=f"spp={spp}")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_plain_equals_k1_plain_with_every_pixel_hot(dtype):
    """K5 is K1 with the hot mask always on (fraction 2.0: K1's uniform
    may be exactly 1.0) and hot std 0.05, written in bfloat16."""
    b, n, h, w = 4, 15, 12, 20
    video = torch.from_numpy(exp.make_video((b, n, h, w), 1)).to(dtype)
    seeds = torch.tensor([3, 2 ** 31 - 1, 0, 12345], dtype=torch.int32)
    pos, neg, noise = map(torch.from_numpy, _clip_params(b))
    got = si.simulate_interleave_plain(video, seeds, pos, neg, noise)
    want = vc.simulate_batch_plain(video, seeds,
                                   SimParams(pos, neg, noise, 2.0, 0.05))
    assert got.dtype == torch.bfloat16
    assert want.abs().mean() > 0.05
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("spp", si.SPPS)
def test_wrapper_on_cpu_is_the_plain_version_for_every_spp(spp):
    b, n, h, w = 8, 6, 4, 8
    video = torch.from_numpy(exp.make_video((b, n, h, w), 2))
    seeds = torch.arange(b, dtype=torch.int32)
    pos, neg, noise = map(torch.from_numpy, _clip_params(b))
    got = si.simulate_interleave(video, seeds, pos, neg, noise, spp=spp)
    assert got.dtype == torch.bfloat16 and got.shape == (b, n - 1, h, w)
    assert torch.equal(got, si.simulate_interleave_plain(video, seeds, pos,
                                                         neg, noise))


@pytest.mark.parametrize("b,spp", [(6, 4), (4, 3), (16, 16)])
def test_wrapper_rejects_leftover_clips_and_unknown_spp(b, spp):
    video = torch.zeros((b, 3, 2, 2), dtype=torch.uint8)
    with pytest.raises(ValueError):
        si.simulate_interleave(video, torch.zeros(b, dtype=torch.int32), 0.4,
                               0.5, 0.05, spp=spp)


def test_script_run_on_cpu():
    rates = exp.run(device="cpu", shape=(4, 11, 16, 32), iters=2)
    assert set(rates) == set(exp.SPPS)
    assert all(r > 0 and np.isfinite(r) for r in rates.values())


def test_script_run_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        exp.run(shape=(4, 11, 16, 32), iters=2)


def test_script_video_is_the_jax_experiments(jax_exp, monkeypatch):
    """make_video draws what the JAX experiment's main draws."""
    shape = (2, 5, 8, 16)
    monkeypatch.setattr(jax_exp, "B", shape[0])
    monkeypatch.setattr(jax_exp, "N", shape[1])
    monkeypatch.setattr(jax_exp, "H", shape[2])
    monkeypatch.setattr(jax_exp, "W", shape[3])

    class Stop(Exception):
        pass

    class Jnp:
        """jnp whose first asarray (main's video) stops main."""

        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def asarray(video):
            raise Stop(video)

    monkeypatch.setattr(jax_exp, "jnp", Jnp())
    with pytest.raises(Stop) as stopped:
        jax_exp.main()
    np.testing.assert_array_equal(exp.make_video(shape),
                                  stopped.value.args[0])


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    b, n, h, w = 8, 21, 24, 72
    video = torch.from_numpy(exp.make_video((b, n, h, w), 3)).to(dev)
    seeds = torch.arange(b, dtype=torch.int32, device=dev) + 11
    pos, neg, noise = (torch.from_numpy(v).to(dev) for v in _clip_params(b))
    for v in (video, video.to(torch.float32)):
        want = si.simulate_interleave_plain(v, seeds, pos, neg, noise)
        for spp in si.SPPS:
            got = si.simulate_interleave(v, seeds, pos, neg, noise, spp=spp)
            if v.dtype == torch.uint8:
                assert torch.equal(got, want), spp
            else:
                dmax, flips = _flips(got.float().cpu().numpy(),
                                     want.float().cpu().numpy())
                assert dmax <= 1.0 and flips <= FLIP_RATE * want.numel()
