"""The port's interleaved-chain simulator K5 (v2v_tpu_torch ops/
sim_interleave.py and scripts/exp_sim_interleave.py) against the JAX
experiment scripts/exp_sim_interleave.py and against K1's plain version.

The CPU runs K5's plain version. JAX's K5 runs in the TPU interpret
mode, where the on-core generator yields zero bits: the port's plain
version with every Philox word forced to zero computes the same counts.
csrc/sim_interleave.cu's thread walk is emulated in plain PyTorch
against the plain version. The kernel itself is compared with the plain
version on the card (the `cuda` tests below, and chip_smoke.py), as is
K2 (csrc/esim.cu's gaussian_kernel) at ragged sizes and an unaligned
output."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from v2v_tpu_torch.ops import _sass
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,spp", [((4, 201, 2048, 2048), 4),
                                       ((2 ** 31 // 16 + 1, 2, 4, 4), 1)])
def test_wrapper_rejects_what_32_bit_offsets_cannot_reach(shape, spp):
    """The kernel offsets a group of spp clips, and a thread, in 32 bits:
    on a CUDA video, spp*N*H*W or B*H*W at 2^31 raises before anything
    launches (an expanded view allocates nothing). The plain version
    has no such limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the limit is the CUDA kernel's")
    dev = torch.device("cuda")
    video = torch.zeros(1, dtype=torch.uint8, device=dev).view(
        1, 1, 1, 1).expand(shape)
    b = shape[0]
    launches = si.simulate_interleave.launches
    with pytest.raises(ValueError, match="2\\^31"):
        si.simulate_interleave(video, torch.zeros(b, dtype=torch.int32,
                                                  device=dev), 0.4, 0.5,
                               0.05, spp=spp)
    assert si.simulate_interleave.launches == launches


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


def _quantize_one_division(pot, tp, tn):
    """csrc/esim.cuh::quantize_events: one division of |pot| by the
    threshold of the side that fires, then selects."""
    up = pot >= tp
    down = pot <= -tn
    q = torch.floor(pot.abs() / torch.where(up, tp, tn))
    pos = torch.where(up, q, 0.0)
    neg = torch.where(down, q, 0.0)
    return pos - neg, pot - pos * tp + neg * tn


def _emulate_kernel(video, seeds, pos, neg, noise, spp, pix):
    """csrc/sim_interleave.cu::sim_interleave_kernel's walk in plain
    PyTorch, vectorized over its threads: thread t of group g (clips
    g*spp .. g*spp + spp-1) owns pixels pix*t' .. pix*t' + pix-1 of each
    of its clips (t' its place in the group), the ones past H*W masked
    (they read level 0 and store nothing); every element is reached by
    the kernel's offsets, the group's first clip plus j clips plus a
    frame's; whole quads of 4 frames draw one Philox call a pixel and
    clip and use its words in order, the last 1-3 frames the next
    quad's; the counts go through the one-division quantization and are
    stored as bfloat16. Chains are (threads, spp, pix)."""
    b, n, h, w = video.shape
    hw = h * w
    per_group = -(-hw // pix)
    t = torch.arange(b // spp * per_group)
    group = (t // per_group).view(-1, 1, 1)
    j = torch.arange(spp).view(1, spp, 1)
    p = ((t.view(-1, 1, 1) - group * per_group) * pix
         + torch.arange(pix).view(1, 1, pix))
    valid = (p < hw).expand(-1, spp, -1)
    clip = group * spp + j
    src = group * spp * n * hw + j * (n * hw) + p
    dst = group * spp * (n - 1) * hw + j * ((n - 1) * hw) + p
    flat = video.reshape(-1)
    out = torch.full((b * (n - 1) * hw,), float("nan"), dtype=torch.bfloat16)

    def load(i):
        idx = torch.where(valid, src + i * hw, 0)
        return vc.log_table("cpu")[torch.where(valid, flat[idx], 0).long()]

    def store(counts, i):
        out[(dst + i * hw)[valid]] = counts[valid].to(torch.bfloat16)

    tp, tn, std = pos[clip], neg[clip], noise[clip]
    seed = seeds.to(torch.int64)[clip] & 0xFFFFFFFF
    x, _, z, _ = vc._philox_draws(seed, p, 0, vc.STREAM_INIT)
    pot = vc._uniform01(x) * (tp + tn) - tn
    hot = torch.tensor(si.HOT_STD) * vc._gaussian(z)
    prev = load(0)
    for q in range((n - 1) // 4 + 1):
        w4 = vc._philox_draws(seed, p, q, vc.STREAM_NOISE)
        for f, i in enumerate(i for i in range(4 * q + 1, 4 * q + 5)
                              if i < n):
            log_new = load(i)
            pot = pot + (log_new - prev)
            pot = pot + std * vc._gaussian(w4[f])
            pot = pot + hot
            counts, pot = _quantize_one_division(pot, tp, tn)
            store(counts, i - 1)
            prev = log_new
    return out.view(b, n - 1, h, w)


@pytest.mark.parametrize("pix", sorted({1, 2, 4} | {
    pix for pix, _ in _sass.k5_shapes().values()}))
@pytest.mark.parametrize("spp", [1, 2, 4])
@pytest.mark.parametrize("n", [8, 9])
def test_kernel_walk_equals_plain_for_any_thread_shape(pix, spp, n):
    """The kernel's thread shape does not change the counts: 1, 2 or 4
    pixels (and the source's table's) of 1, 2 or 4 clips a thread, H*W
    = 21 (a ragged last thread a group), N-1 = 7 or 8 (a ragged last
    quad or none)."""
    b, h, w = 4, 3, 7
    video = torch.from_numpy(exp.make_video((b, n, h, w), pix * 10 + n))
    seeds = torch.tensor([5, 0, 2 ** 31 - 1, 77], dtype=torch.int32)
    pos, neg, noise = map(torch.from_numpy, _clip_params(b))
    want = si.simulate_interleave_plain(video, seeds, pos, neg, noise)
    got = _emulate_kernel(video, seeds, pos, neg, noise, spp, pix)
    assert want.float().abs().mean() > 0.05
    assert torch.equal(got, want)


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """`t`'s values in a view that starts one element into its storage."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.flatten()
    return buf[1:].view(t.shape)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Every spp on uint8 (equal bits) and float32 (the flip budget)
    video: whole vectors, a ragged H*W with an odd N, and unaligned
    views of the video and the output."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    for b, n, h, w in ((8, 21, 24, 72), (8, 12, 5, 7)):
        video = torch.from_numpy(exp.make_video((b, n, h, w), 3)).to(dev)
        seeds = torch.arange(b, dtype=torch.int32, device=dev) + 11
        pos, neg, noise = (torch.from_numpy(v).to(dev)
                           for v in _clip_params(b))
        for v in (video, video.to(torch.float32), _unaligned(video)):
            want = si.simulate_interleave_plain(v, seeds, pos, neg, noise)
            for spp in si.SPPS:
                got = si.simulate_interleave(v, seeds, pos, neg, noise,
                                             spp=spp)
                if v.dtype == torch.uint8:
                    assert torch.equal(got, want), (b, n, h, w, spp)
                else:
                    dmax, flips = _flips(got.float().cpu().numpy(),
                                         want.float().cpu().numpy())
                    assert dmax <= 1.0 and flips <= FLIP_RATE * want.numel()
        # an unaligned output: the library's C entry, as the wrapper calls it
        out = _unaligned(torch.zeros((b, n - 1, h, w), dtype=torch.bfloat16,
                                     device=dev))
        want = si.simulate_interleave_plain(video, seeds, pos, neg, noise)
        for spp in si.SPPS:
            assert si.LIB.get().v2v_simulate_interleave(
                video.data_ptr(), 1, vc.cached_log_table(dev).data_ptr(),
                seeds.data_ptr(), pos.data_ptr(), neg.data_ptr(),
                noise.data_ptr(), out.data_ptr(), b, n, h, w, spp,
                torch.cuda.current_stream().cuda_stream) == 0
            torch.cuda.synchronize()
            assert torch.equal(out, want), spp


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4 * 1000 + r for r in range(4)])
def test_gaussian_kernel_matches_plain_at_ragged_sizes_on_card(n):
    """K2 at n = 4k .. 4k+3, into an aligned and an unaligned output."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    want = vc.sample_gaussian_plain(99, n, dev)
    assert torch.equal(vc.sample_gaussian(99, (n,), device=dev), want)
    out = _unaligned(torch.zeros(n, device=dev))
    assert vc.LIB.get().v2v_sample_gaussian(
        99, out.data_ptr(), n, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, want)
