"""K1, the event simulator in the port (v2v_tpu_torch/csrc/esim.cu,
philox.cuh, esim.cuh): its one-division quantization, its Philox draw
layout and its thread shapes emulated in plain PyTorch against the plain
version; the plain version's bfloat16 counts against the JAX package's
Pallas kernel in interpret mode; the train step's binning of bfloat16
counts; the cached log table; the SASS loop count of ops/_sass.py and
chip_smoke.py's K1 bounds. The kernel itself runs only on the card
(chip_smoke.py's [k1])."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from v2v_tpu.ops import voxel as vx
from v2v_tpu.ops.voxel_pallas import simulate_batch_pallas
from v2v_tpu_torch.ops import _sass
from v2v_tpu_torch.ops import voxel as tvx
from v2v_tpu_torch.ops import voxel_cuda as vc
from v2v_tpu_torch.training import steps as tsteps

F32 = np.float32
# (pos, neg) thresholds, from the configs' range (0.05, 2.0) with a gap
# up to 1.5
THETAS = ((0.05, 0.05), (0.1, 0.15), (0.3, 0.25), (0.7, 1.05), (2.0, 1.4),
          (0.123, 0.171))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _quantize_one_division(pot, tp, tn):
    """csrc/esim.cuh::quantize_events: one division of |pot| by the
    threshold of the side that fires, then selects."""
    up = pot >= tp
    down = pot <= -tn
    q = torch.floor(pot.abs() / torch.where(up, tp, tn))
    pos = torch.where(up, q, 0.0)
    neg = torch.where(down, q, 0.0)
    return pos - neg, pot - pos * tp + neg * tn


@pytest.mark.parametrize("tp,tn", THETAS)
def test_one_division_quantization_equals_two_division_bits(tp, tn):
    """Potentials at and within 3 ulps of +-k*theta for k up to 150 on
    both sides, signed zeros, tiny values and a random spread: the counts
    and the residuals are the same bits, and no count is -0."""
    tp, tn = torch.tensor(tp), torch.tensor(tn)
    k = torch.arange(-150, 151, dtype=torch.float32)
    base = torch.cat([k * tp, k * tn, torch.tensor(
        [0.0, -0.0, 1e-30, -1e-30, 1e-45, -1e-45])])
    pots = [base]
    up, down = base, base
    for _ in range(3):
        up = torch.nextafter(up, torch.tensor(float("inf")))
        down = torch.nextafter(down, torch.tensor(float("-inf")))
        pots += [up, down]
    rng = np.random.RandomState(0)
    pots.append(torch.from_numpy(rng.uniform(-40, 40, 4096).astype(F32)))
    pot = torch.cat(pots)
    want_c, want_p = tvx._quantize_events(pot, tp, tn)
    got_c, got_p = _quantize_one_division(pot, tp, tn)
    assert torch.equal(_bits(got_c), _bits(want_c))
    assert torch.equal(_bits(got_p), _bits(want_p))
    assert not (torch.signbit(got_c) & (got_c == 0)).any()
    assert (want_c != 0).sum() > 1000


def test_irwin_hall_float_trick_equals_the_conversion():
    """philox.cuh's device path: (2^23 | s) as a float minus 2^23 + 510 is
    the same bits as float(s) - 510 for every byte sum s in 0..1020."""
    s = np.arange(1021, dtype=np.uint32)
    trick = (np.uint32(0x4B000000) | s).view(F32) - F32(8389118.0)
    plain = s.astype(F32) - F32(510.0)
    np.testing.assert_array_equal(trick.view(np.int32), plain.view(np.int32))


def _words(seed, c0, c1, stream):
    return [int(w) for w in vc.philox4x32_10(c0, c1, stream, 0, seed, 0)]


def _uniform(w):
    return F32(w >> 8) * F32(2.0 ** -24) + F32(2.0 ** -24)


def _gauss(w):
    s = sum((w >> k) & 0xFF for k in (0, 8, 16, 24))
    return (F32(s) - F32(510.0)) * F32(1.0 / 147.7950834)


def _scalar_pixel(logs, seed, p, tp, tn, std, frac, hstd):
    """One pixel's chain in numpy float32 scalars, each draw taken from
    Philox on Python ints by the layout of csrc/philox.cuh."""
    x, y, z, _ = _words(seed, p, 0, vc.STREAM_INIT)
    pot = _uniform(x) * (tp + tn) - tn
    hot = hstd * _gauss(z) if _uniform(y) < frac else F32(0.0)
    out = []
    for i in range(1, len(logs)):
        g = _gauss(_words(seed, p, (i - 1) // 4, vc.STREAM_NOISE)[(i - 1) % 4])
        pot = pot + (logs[i] - logs[i - 1])
        pot = pot + std * g
        pot = pot + hot
        pos = np.floor(pot / tp) if pot >= tp else F32(0.0)
        neg = np.floor(-pot / tn) if pot <= -tn else F32(0.0)
        pot = pot - pos * tp + neg * tn
        out.append(pos - neg)
    return np.array(out, F32)


@pytest.mark.parametrize("n", [5, 8, 11, 12])
def test_draw_layout_scalar_reference(n):
    """Each pixel's start-up words and each frame's word slot: the plain
    version equals a scalar chain that draws word (i-1) & 3 of the call
    at (p, (i-1) >> 2) for frame i, for N-1 = 4, 7, 10 and 11."""
    b, h, w = 2, 3, 5
    rng = np.random.RandomState(n)
    video = rng.randint(0, 256, (b, n, h, w)).astype(np.uint8)
    prm = [(F32(0.11), F32(0.13), F32(0.2), F32(0.5), F32(0.3)),
           (F32(0.3), F32(0.2), F32(0.1), F32(2.0), F32(0.05))]
    seeds = [12345, 2 ** 31 - 1]
    params = tvx.SimParams(*(torch.tensor([p[k] for p in prm])
                             for k in range(5)))
    got = vc.simulate_batch_plain(torch.from_numpy(video),
                                  torch.tensor(seeds, dtype=torch.int32),
                                  params).float().numpy()
    table = vc.log_table("cpu").numpy()
    fired = 0
    for bi in range(b):
        logs = table[video[bi].reshape(n, h * w)]
        for p in range(h * w):
            want = _scalar_pixel(logs[:, p], seeds[bi], p, *prm[bi])
            np.testing.assert_array_equal(
                got[bi].reshape(n - 1, h * w)[:, p], want, err_msg=(bi, p))
            fired += int(np.abs(want).sum())
    assert fired > 20


@pytest.mark.parametrize("n", [10, 16])
def test_gaussian_sample_layout(n):
    """K2: sample i is word i & 3 of the call at (i >> 2, 0)."""
    got = vc.sample_gaussian_plain(77, n, "cpu").numpy()
    want = [_gauss(_words(77, i >> 2, 0, vc.STREAM_NOISE)[i & 3])
            for i in range(n)]
    np.testing.assert_array_equal(got, np.array(want, F32))


def _emulate_kernel(video, seeds, params, pix, noise_free):
    """csrc/esim.cu::esim_kernel's walk, in plain PyTorch vectorized over
    its threads: thread t of a clip owns pixels pix*t .. pix*t + pix-1,
    the ones past H*W masked (they read level 0 and store nothing); whole
    quads of 4 frames draw one Philox call a pixel and use its words in
    order; the last 1-3 frames draw the next quad's call; the counts go
    through the one-division quantization and are stored as bfloat16."""
    b, n, h, w = video.shape
    hw = h * w
    threads = -(-hw // pix)
    p = (torch.arange(threads)[:, None] * pix + torch.arange(pix)).view(
        1, threads, pix)
    valid = p < hw
    raw = video.reshape(b, n, hw)[:, :, p.clamp(max=hw - 1)[0]]
    raw = torch.where(valid, raw, 0)
    logs = vc.log_table("cpu")[raw.long()]            # (b, n, threads, pix)
    col = lambda v: torch.as_tensor(v, dtype=torch.float32).expand(b).view(
        b, 1, 1)
    tp, tn = col(params.pos_thres), col(params.neg_thres)
    seed = seeds.to(torch.int64).view(b, 1, 1) & 0xFFFFFFFF
    pot = torch.zeros((b, threads, pix))
    hot = torch.zeros((b, threads, pix))
    if not noise_free:
        x, y, z, _ = vc._philox_draws(seed, p, 0, vc.STREAM_INIT)
        pot = vc._uniform01(x) * (tp + tn) - tn
        hot = torch.where(vc._uniform01(y) < col(params.hot_pixel_fraction),
                          col(params.hot_pixel_std) * vc._gaussian(z), 0.0)
    out = torch.zeros((b, n - 1, hw), dtype=torch.bfloat16)
    prev = logs[:, 0]
    quads = (n - 1) // 4
    for q in range(quads + 1):
        frames = [4 * q + 1 + f for f in range(4) if 4 * q + 1 + f < n]
        if not noise_free:
            w4 = vc._philox_draws(seed, p, q, vc.STREAM_NOISE)
        for f, i in enumerate(frames):
            pot = pot + (logs[:, i] - prev)
            if not noise_free:
                pot = pot + col(params.base_noise_std) * vc._gaussian(w4[f])
                pot = pot + hot
            counts, pot = _quantize_one_division(pot, tp, tn)
            prev = logs[:, i]
            out[:, i - 1, p[valid]] = counts[:, valid[0]].to(torch.bfloat16)
    return out.view(b, n - 1, h, w)


@pytest.mark.parametrize("pix", sorted({1, 2, 4,
                                         _sass.k1_pixels_a_thread()}))
@pytest.mark.parametrize("n", [8, 9])
@pytest.mark.parametrize("noise_free", [False, True])
def test_kernel_walk_equals_plain_for_any_pixels_a_thread(pix, n,
                                                          noise_free):
    """The kernel's thread shape does not change the counts: 1, 2 or 4
    pixels a thread (and the source's kPix), H*W = 21 (a ragged last
    thread a clip), N-1 = 7 or 8."""
    b, h, w = 3, 3, 7
    rng = np.random.RandomState(pix * 10 + n)
    video = torch.from_numpy(np.clip(
        128 + np.cumsum(rng.randn(b, n, h, w) * 40, axis=1), 0, 255
    ).astype(np.uint8))
    seeds = torch.tensor([5, 0, 2 ** 31 - 1], dtype=torch.int32)
    params = tvx.SimParams(torch.tensor([0.2, 0.3, 0.15]),
                           torch.tensor([0.25, 0.2, 0.15]),
                           torch.tensor([0.1, 0.05, 0.2]),
                           torch.tensor([0.3, 0.0, 2.0]),
                           torch.tensor([0.2, 0.1, 0.3]))
    want = vc.simulate_batch_plain(video, seeds, params,
                                   noise_free=noise_free)
    got = _emulate_kernel(video, seeds, params, pix, noise_free)
    assert want.dtype == torch.bfloat16 and want.shape == (b, n - 1, h, w)
    assert want.float().abs().mean() > 0.05
    assert torch.equal(got, want)


def _levels_both_logs_agree() -> np.ndarray:
    """The uint8 levels whose log value is the same float32 in the port's
    table and in the TPU kernel's expression (XLA on the CPU)."""
    v = jnp.arange(256, dtype=jnp.float32)
    jax_logs = np.asarray(jax.jit(
        lambda v: jnp.log(0.001 + (v * (1.0 / 255.0)) ** 2.2))(v))
    return np.nonzero(vc.log_table("cpu").numpy() == jax_logs)[0]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_plain_bf16_counts_equal_jax_pallas_noise_free(dtype):
    """On video whose levels have the same log value in both packages,
    the plain version's bfloat16 counts are JAX's simulate_batch_pallas
    counts (interpret mode, bfloat16 in the kernel), exactly. XLA on the
    CPU contracts the kernel's residual update pot - pos*tp + neg*tn into
    fused multiply-adds, which round once where the plain version (and
    the CUDA kernel, built with -fmad=false) rounds twice; thresholds
    with short mantissas make k*theta exact in float32, so both round
    alike. At other thresholds tests/test_torch_voxel.py holds the two to
    the flip budget."""
    levels = _levels_both_logs_agree()
    assert len(levels) > 100
    b, n, h, w = 2, 11, 8, 128
    rng = np.random.RandomState(1)
    idx = np.clip(len(levels) // 2 + np.cumsum(
        rng.randint(-12, 13, (b, n, h, w)), axis=1), 0, len(levels) - 1)
    video = levels[idx].astype(dtype)
    pos, neg = np.array([0.25, 0.125], F32), np.array([0.375, 0.1875], F32)
    got = vc.simulate_batch(
        torch.from_numpy(video), torch.zeros(b, dtype=torch.int32),
        tvx.SimParams(torch.from_numpy(pos), torch.from_numpy(neg),
                      torch.zeros(b), torch.zeros(b), torch.zeros(b)),
        noise_free=True)
    want = np.asarray(simulate_batch_pallas(
        jnp.asarray(video), jnp.zeros((b,), jnp.int32),
        vx.SimParams(jnp.asarray(pos), jnp.asarray(neg), *(jnp.zeros(b),) * 3),
        noise_free=True, interpret=True))
    assert got.dtype == torch.bfloat16
    assert np.abs(want).mean() > 0.05
    np.testing.assert_array_equal(got.float().numpy(), want)


def _fused(a, b, c):
    """a*b + c rounded once to float32 (a fused multiply-add): float32
    products of the counts here (below 2^9) and the thresholds are exact
    in float64, and so are their sums with potentials of like size."""
    return (a.double() * b.double() + c.double()).float()


@pytest.mark.parametrize("tp,tn", THETAS)
def test_jax_cpu_fuses_the_residual_update(tp, tn):
    """The cause the test above names, shown on its own: XLA on the CPU
    runs pot - pos*tp + neg*tn as two fused multiply-adds. Its bits equal
    fma(neg, tn, fma(-pos, tp, pot)) everywhere, and differ from the
    separately rounded products (the plain version's and the CUDA
    kernel's) at many points."""
    rng = np.random.RandomState(7)
    n = 1 << 14
    pos = np.floor(rng.uniform(0, 40, n)).astype(F32)
    neg = np.where(pos > 0, 0, np.floor(rng.uniform(0, 40, n))).astype(F32)
    pot = (pos * F32(tp) - neg * F32(tn) + rng.uniform(0, 1, n).astype(F32)
           * np.where(pos > 0, F32(tp), F32(-tn))).astype(F32)
    got = np.asarray(jax.jit(lambda p, a, b: p - a * F32(tp) + b * F32(tn))(
        pot, pos, neg))
    t = lambda v: torch.from_numpy(v)
    fused = _fused(t(neg), torch.tensor(tn), _fused(
        -t(pos), torch.tensor(tp), t(pot))).numpy()
    separate = (t(pot) - t(pos) * tp + t(neg) * tn).numpy()
    np.testing.assert_array_equal(got.view(np.int32), fused.view(np.int32))
    assert (got != separate).mean() > 0.01


def _plain_fused_noise_free(video, pos, neg):
    """The plain version's noise-free chain with XLA's fused residual
    update, float32 counts."""
    logs = vc.log_table("cpu")[torch.from_numpy(video).long()]
    tp, tn = (torch.from_numpy(v).view(-1, 1, 1) for v in (pos, neg))
    pot = torch.zeros_like(logs[:, 0])
    out = []
    for i in range(1, logs.shape[1]):
        pot = pot + (logs[:, i] - logs[:, i - 1])
        up = torch.where(pot >= tp, torch.floor(pot / tp), 0.0)
        down = torch.where(pot <= -tn, torch.floor(-pot / tn), 0.0)
        pot = _fused(down, tn, _fused(-up, tp, pot))
        out.append(up - down)
    return torch.stack(out, 1)


@pytest.mark.parametrize("tp,tn,plain_differs", [
    (*THETAS[0], True), (*THETAS[1], True), *((*t, False) for t in
                                              THETAS[2:])])
def test_fused_plain_chain_equals_jax_pallas_at_any_threshold(
        tp, tn, plain_differs):
    """At thresholds whose multiples round (where the test above it picks
    short mantissas), the plain chain with the residual update fused as
    XLA fuses it gives JAX's simulate_batch_pallas counts (interpret
    mode) exactly: the fusion is the whole of the difference. At the two
    lowest thresholds of this input the plain version's counts differ
    from JAX's; at the others no residual happens to round apart."""
    levels = _levels_both_logs_agree()
    b, n, h, w = 2, 11, 8, 128
    rng = np.random.RandomState(3)
    idx = np.clip(len(levels) // 2 + np.cumsum(
        rng.randint(-12, 13, (b, n, h, w)), axis=1), 0, len(levels) - 1)
    video = levels[idx].astype(np.uint8)
    pos, neg = np.array([tp, tn], F32), np.array([tn, tp], F32)
    want = np.asarray(simulate_batch_pallas(
        jnp.asarray(video), jnp.zeros((b,), jnp.int32),
        vx.SimParams(jnp.asarray(pos), jnp.asarray(neg), *(jnp.zeros(b),) * 3),
        noise_free=True, interpret=True))
    got = _plain_fused_noise_free(video, pos, neg).numpy()
    plain = vc.simulate_batch_plain(
        torch.from_numpy(video), torch.zeros(b, dtype=torch.int32),
        tvx.SimParams(torch.from_numpy(pos), torch.from_numpy(neg),
                      torch.zeros(b), torch.zeros(b), torch.zeros(b)),
        noise_free=True).float().numpy()
    assert np.abs(want).mean() > 0.01
    np.testing.assert_array_equal(got, want)
    assert (plain != want).any() == plain_differs


@pytest.mark.parametrize("fpb,extra_frame,extra_evs", [
    (1, False, False), (1, True, True), (2, False, False)])
def test_bin_and_select_bf16_counts_equal_f32(fpb, extra_frame, extra_evs):
    bins, groups, b, h, w = 5, 3, 2, 6, 10
    n1 = groups * bins * fpb
    rng = np.random.RandomState(fpb)
    counts = torch.from_numpy(rng.randint(-40, 41, (b, n1, h, w)).astype(F32))
    video = torch.from_numpy(rng.randint(0, 256, (b, n1 + 1, h, w)).astype(
        np.uint8))
    want = tsteps.bin_and_select(counts, video, bins, fpb, extra_frame,
                                 extra_evs)
    got = tsteps.bin_and_select(counts.to(torch.bfloat16), video, bins, fpb,
                                extra_frame, extra_evs)
    assert got[0].dtype == torch.float32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cached_log_table_is_log_tables_bits():
    a = vc.cached_log_table("cpu")
    assert a is vc.cached_log_table(torch.device("cpu"))
    assert a.dtype == torch.float32 and a.shape == (256,)
    assert torch.equal(_bits(a), _bits(vc.log_table("cpu")))


SASS = """\
\t\tFunction : _Z6kernelv
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0020*/                   NOP ;
        /*0030*/                   FCHK P0, R3, R4 ;
        /*0040*/               @!P0 BRA `(.L_x_2) ;
        /*0050*/                   MOV R5, 0x70 ;
        /*0060*/                   CALL.REL.NOINC `(.L_x_9) ;
.L_x_2:
        /*0070*/                   FADD R3, R3, R4 ;
        /*0080*/               @P1 BRA `(.L_x_1) ;
        /*0090*/                   BRA 0x10 ;
        /*00a0*/                   EXIT ;
"""


def test_sass_loop_count(monkeypatch):
    """ops/_sass.py's loop count: the longest backward branch's span, by
    label or by address, NOPs left out; and without the block a
    predicated forward branch skips that holds a call (a division's slow
    path)."""
    monkeypatch.setattr(_sass, "demangle", lambda names: [
        "void kernel()" for _ in names])
    count, issued, listing = _sass.sass_loop(SASS, "kernel")
    assert (count, issued) == (8, 6) and "EXIT" not in listing
    assert "(skipped) CALL" in listing
    assert _sass.sass_loop(SASS, "other") == (None, None, "")
    one_loop = SASS.replace("        /*0090*/                   BRA 0x10 ;\n",
                            "")
    assert _sass.sass_loop(one_loop, "kernel")[:2] == (7, 5)


def _two_kernels(first: str, second: str) -> str:
    """The stored listing twice, as two functions: `second`'s loop is
    one instruction longer than `first`'s."""
    longer = SASS.replace("        /*0020*/                   NOP ;\n",
                          "        /*0020*/                   IADD3 R6, R6, "
                          "0x1, RZ ;\n")
    return (SASS.replace("_Z6kernelv", first)
            + longer.replace("_Z6kernelv", second))


@pytest.mark.parametrize("pixels,clips", [(1, 1), (2, 1), (1, 2), (1, 4),
                                          (2, 4)])
def test_loop_report_divides_by_the_pixel_frames_of_a_quad(monkeypatch,
                                                          pixels, clips):
    """ops/_sass.py's report for any kernel's quad loop: the loop's
    instructions (and those issued without the divisions' slow paths)
    over the 4 frames of `pixels` pixels of `clips` clips it covers."""
    names = {"_Za": "void esim_kernel<(bool)1, (bool)1, (bool)1, (int)2>"
                    "(SimArgs)",
             "_Zb": "void (anonymous namespace)::sim_interleave_kernel<"
                    "(int)4, (bool)1, (bool)1>(K5Args)"}
    monkeypatch.setattr(_sass, "demangle",
                        lambda mangled: [names[m] for m in mangled])
    listing = _two_kernels("_Za", "_Zb")
    per = 4 * pixels * clips
    all_, issued, body = _sass.loop_report(
        listing, "sim_interleave_kernel<4, true, true>", pixels, clips)
    assert (all_, issued) == (9 / per, 7 / per) and "IADD3 R6" in body
    all_, issued, body = _sass.loop_report(
        listing, "esim_kernel<true, true, true, 2>", pixels, clips)
    assert (all_, issued) == (8 / per, 6 / per) and "IADD3 R6" not in body
    assert _sass.loop_report(listing, "other", pixels, clips) == (
        None, None, "")


def test_k1_and_k5_issue_reports_name_their_instances(monkeypatch):
    """k1_issue_report keeps its numbers (K1's kPix, a loop's count over
    4 * kPix); k5_issue_report reads each kept spp's uint8 vector
    instance with its kPix from csrc/sim_interleave.cu's table."""
    shapes = _sass.k5_shapes()
    assert set(shapes) == {1, 2, 4, 8}
    assert all(p in (1, 2, 4) and t in (128, 256)
               for p, t in shapes.values())
    pix = _sass.k1_pixels_a_thread()
    mangled = {f"_Zk{spp}": f"void (anonymous namespace)::"
               f"sim_interleave_kernel<(int){spp}, (bool)1, (bool)1>(K5Args)"
               for spp in shapes}
    mangled["_Zesim"] = (f"void (anonymous namespace)::esim_kernel<(bool)1, "
                         f"(bool)1, (bool)1, (int){pix}>(SimArgs)")
    listing = "".join(SASS.replace("_Z6kernelv", m) for m in mangled)
    monkeypatch.setattr(_sass, "demangle",
                        lambda names: [mangled.get(n, n) for n in names])
    monkeypatch.setattr(_sass, "sass", lambda library: listing)
    all_, issued, got_pix, body = _sass.k1_issue_report("lib.so")
    assert (all_, issued, got_pix) == (8 / (4 * pix), 6 / (4 * pix), pix)
    assert "(skipped) CALL" in body
    report = _sass.k5_issue_report("lib.so")
    assert set(report) == set(shapes)
    for spp, (all_, issued, got_pix, body) in report.items():
        per = 4 * shapes[spp][0] * spp
        assert (all_, issued, got_pix) == (8 / per, 6 / per, shapes[spp][0])
        assert "EXIT" not in body


def test_k1_bounds_at_the_flagship_shape():
    """Counts at 2 bytes: 118.2 MB, 0.0353 ms at 3.35 TB/s; 55
    instructions a pixel-frame issue in ~0.065 ms on 132 SMs."""
    b, n, h, w = chip_smoke.K1_SHAPE
    px_frames = b * (n - 1) * h * w
    bytes_ = b * n * h * w + 2 * px_frames
    ms, by = chip_smoke._bound(bytes_, chip_smoke.K1_FLOPS_NOISY * px_frames)
    assert by == "bytes" and abs(ms - 0.0353) < 5e-5
    assert abs(_sass.issue_ms(55 * px_frames) - 0.0646) < 5e-4
