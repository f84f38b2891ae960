"""The bilinear x2 upsample of the port (v2v_tpu_torch/ops/upsample.py,
csrc/upsample.cu): on CPU tensors the wrapper is `F.interpolate`, forward
and gradient, bit for bit, and launches nothing; the kernels' taps and
weights, emulated in plain PyTorch, against ATen's forward and gradient in
float64; the wrapper's refusals; the two model call sites. The `cuda`
tests hold the kernels against ATen on the card:

    python -m pytest -p no:cacheprovider --noconftest \\
        tests/test_torch_upsample.py -m cuda

(tests/conftest.py imports JAX, which the card's machine lacks; this file
imports none.)"""
import re

import pytest
import torch
import torch.nn.functional as F

from v2v_tpu_torch.models import hyper
from v2v_tpu_torch.models import submodules
from v2v_tpu_torch.ops import _build
from v2v_tpu_torch.ops import upsample as up

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# odd sizes, sizes of 1, a width under the kernel's 4 columns a thread,
# widths that are and are not multiples of 4
SHAPES = ((2, 3, 4, 4), (1, 1, 1, 1), (1, 2, 1, 5), (2, 1, 7, 1),
          (1, 3, 5, 7), (2, 2, 3, 8), (3, 2, 16, 16), (2, 3, 8, 9))


def _launches():
    return (up.upsample2x_bilinear.launches,
            up.upsample2x_bilinear_backward.launches)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES[:4] + SHAPES[-1:], ids=str)
def test_cpu_tensors_take_f_interpolate_bit_for_bit(shape, dtype):
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=gen).to(dtype)
    g = torch.randn(shape[:2] + (2 * shape[2], 2 * shape[3]),
                    generator=gen).to(dtype)
    before = _launches()
    xa = x.clone().requires_grad_()
    want = F.interpolate(xa, scale_factor=2, mode="bilinear",
                         align_corners=False)
    want.backward(g)
    xb = x.clone().requires_grad_()
    got = up.upsample2x_bilinear(xb)
    got.backward(g)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(xb.grad, xa.grad)
    assert torch.equal(up.upsample2x_bilinear_backward_plain(g), xa.grad)
    assert _launches() == before


def _taps(n: int):
    """csrc/upsample.cu's forward along one axis of n: for outputs 2j and
    2j+1, their two source indices and weights (ATen's w0 * a + w1 * b)."""
    src, wts = [], []
    for j in range(n):
        src += [(0, min(1, n - 1)) if j == 0 else (j - 1, j),
                (j, min(j + 1, n - 1))]
        wts += [(1.0, 0.0) if j == 0 else (0.25, 0.75), (0.75, 0.25)]
    return torch.tensor(src), torch.tensor(wts, dtype=torch.float64)


def _emulated_forward(x: torch.Tensor) -> torch.Tensor:
    """The forward kernel's arithmetic, in x's precision (float64 here):
    each row along the width, then the rows along the height."""
    _, _, h, w = x.shape
    (cs, cw), (rs, rw) = _taps(w), _taps(h)
    across = x[..., cs[:, 0]] * cw[:, 0] + x[..., cs[:, 1]] * cw[:, 1]
    return (across[..., rs[:, 0], :] * rw[:, 0, None]
            + across[..., rs[:, 1], :] * rw[:, 1, None])


def _gather_weights(n: int) -> torch.Tensor:
    """csrc/upsample.cu's backward along one axis of n: (n, 4) weights of
    outputs 2j-1 .. 2j+2 for input j (`weight` there), zero where the
    output is past the edge."""
    j = torch.arange(n)
    wts = torch.stack([torch.full((n,), 0.25),
                       torch.where(j == 0, 1.0, 0.75),
                       torch.where(j == n - 1, 1.0, 0.75),
                       torch.full((n,), 0.25)], 1).double()
    x = 2 * j[:, None] + torch.arange(-1, 3)
    return torch.where((x >= 0) & (x < 2 * n), wts, 0.0)


def _emulated_backward(g: torch.Tensor) -> torch.Tensor:
    """The gather kernel's sums: each output-gradient row along the width
    with `_gather_weights`, then rows 2k-1 .. 2k+2 along the height."""
    _, _, h2, w2 = g.shape
    h, w = h2 // 2, w2 // 2
    gp = F.pad(g, (1, 1, 1, 1))                     # output -1 at index 0
    cols = 2 * torch.arange(w)[:, None] + torch.arange(4)   # -1 .. 2, shifted
    rows = 2 * torch.arange(h)[:, None] + torch.arange(4)
    across = (gp[..., cols] * _gather_weights(w)).sum(-1)   # (.., 2h+2, w)
    ww = _gather_weights(h)
    return sum(across[..., rows[:, d], :] * ww[:, d, None] for d in range(4))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_weights_equal_atens_resize_and_gradient(shape):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    want = F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)
    torch.testing.assert_close(_emulated_forward(x), want, rtol=0,
                               atol=1e-14)
    g = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    torch.testing.assert_close(_emulated_backward(g), up.upsample2x_bilinear_backward_plain(g),
                               rtol=0, atol=1e-14)
    # every input collects weight 2 along each axis
    for n in shape[2:]:
        assert torch.equal(_gather_weights(n).sum(1),
                           torch.full((n,), 2.0).double())


@pytest.mark.parametrize("case", ["cpu", "3d", "float64", "empty image"])
def test_kernel_wrapper_rejects(case):
    x = {"cpu": torch.zeros(1, 2, 3, 4),
         "3d": torch.zeros(2, 3, 4),
         "float64": torch.zeros(1, 2, 3, 4, dtype=torch.float64),
         "empty image": torch.zeros(1, 2, 0, 4)}[case]
    before = _launches()
    with pytest.raises(ValueError):
        up.upsample2x_bilinear_forward(x)
    assert _launches() == before


@pytest.mark.parametrize("case", ["cpu", "3d", "float64", "empty image",
                                  "odd size"])
def test_backward_kernel_rejects(case):
    g = {"cpu": torch.zeros(1, 2, 4, 6),
         "3d": torch.zeros(2, 4, 6),
         "float64": torch.zeros(1, 2, 4, 6, dtype=torch.float64),
         "empty image": torch.zeros(1, 2, 0, 6),
         "odd size": torch.zeros(1, 2, 5, 6)}[case]
    if case == "odd size" and torch.cuda.is_available():
        g = g.cuda()
    before = _launches()
    with pytest.raises(ValueError):
        up.upsample2x_bilinear_backward(g)
    assert _launches() == before


def _walk(shape, nhwc: bool):
    """csrc/upsample.cu's address arithmetic, emulated over every thread:
    `place` gives (row, k, j0, c) from the thread index; in the kernels a
    column is cs elements apart and an input row rs = w * cs (cs 1 in NCHW,
    C in NHWC); input row r at r * rs + c, output rows 2k and 2k + 1 at
    4 * row * rs + 2 * j0 * cs + c and 2 * rs further. Returns each
    thread's image, channel, k, j0, input offset of (k, j0) and output
    offset of (2k, 2j0)."""
    n, c, h, w = shape
    groups = -(-w // 4)
    t = torch.arange(n * c * h * groups)
    ch = t % c if nhwc else torch.zeros_like(t)
    if nhwc:
        t = t // c
    row = t // groups
    j0 = (t - row * groups) * 4
    k = row % h
    cs = c if nhwc else 1
    rs = w * cs
    image, channel = ((row // h, ch) if nhwc
                      else ((row // h) // c, (row // h) % c))
    return (image, channel, k, j0, row * rs + j0 * cs + ch,
            4 * row * rs + 2 * j0 * cs + ch, cs, rs)


@pytest.mark.parametrize("nhwc", (False, True), ids=("nchw", "nhwc"))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_addresses_follow_the_layout(shape, nhwc):
    """Each thread's input and output offsets are those of its elements in
    a tensor of that layout, and the outputs written (2 rows of up to 8
    columns a thread, those inside the row) cover each element once."""
    n, c, h, w = shape
    fmt = torch.channels_last if nhwc else torch.contiguous_format
    si = torch.empty(shape, memory_format=fmt).stride()
    so = torch.empty((n, c, 2 * h, 2 * w), memory_format=fmt).stride()
    image, channel, k, j0, in_at, out_at, cs, rs = _walk(shape, nhwc)
    assert torch.equal(in_at, image * si[0] + channel * si[1] + k * si[2]
                       + j0 * si[3])
    assert cs == si[3] and rs == si[2] and 2 * rs == so[2] and cs == so[3]
    written = []
    for r in range(2):
        for m in range(8):
            inside = 2 * j0 + m < 2 * w
            at = out_at + r * 2 * rs + m * cs
            want = (image * so[0] + channel * so[1] + (2 * k + r) * so[2]
                    + (2 * j0 + m) * so[3])
            assert torch.equal(at[inside], want[inside])
            written.append(at[inside])
    written = torch.cat(written).sort().values
    assert torch.equal(written, torch.arange(4 * n * c * h * w))


def test_dtype_codes_follow_the_source():
    src = (_build.CSRC / "upsample.cu").read_text()
    cases = dict(re.findall(r"case (\d): return launch<(\w+), kBackward>",
                            src))
    names = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16",
             torch.float16: "__half"}
    assert {int(k): v for k, v in cases.items()} == {
        code: names[dt] for dt, code in up._DTYPES.items()}


class _Counted:
    def __init__(self, monkeypatch, module):
        self.calls = 0
        real = module.upsample2x_bilinear

        def counted(x):
            self.calls += 1
            return real(x)
        monkeypatch.setattr(module, "upsample2x_bilinear", counted)


def test_upsample_conv_layer_calls_the_wrapper(monkeypatch):
    counted = _Counted(monkeypatch, submodules)
    torch.manual_seed(0)
    layer = submodules.UpsampleConvLayer(4, 3, 3)
    x = torch.randn(2, 4, 5, 6)
    out = layer(x)
    assert counted.calls == 1 and out.shape == (2, 3, 10, 12)
    want = layer._finish(layer.conv2d(F.interpolate(
        x, scale_factor=2, mode="bilinear", align_corners=False)))
    assert torch.equal(out, want)


def test_hyper_dynamic_decoder_calls_the_wrapper(monkeypatch):
    counted = _Counted(monkeypatch, hyper)
    torch.manual_seed(0)
    layer = hyper.DynamicUpsampleLayer(8, 4, 5, in_fuse_channels=6,
                                       out_fuse_channels=8, num_atoms=2)
    x = torch.randn(1, 8, 4, 6)
    # the events at the frame's size, four times the decoder's output
    ev = torch.randn(1, 5, 32, 48)
    prev = torch.randn(1, 1, 32, 48)
    out = layer(x, ev, prev)
    assert counted.calls == 1 and out.shape == (1, 4, 8, 12)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# the flagship's three decoder inputs (B*T = 480), EVFlowNet's four
# (B*T = 400, concat skips) and E2VID's and ETNet's at 720p (N = 1)
FLAGSHIP = ((480, 256, 16, 16), (480, 128, 32, 32), (480, 64, 64, 64))
EVFLOW = ((400, 1024, 8, 8), (400, 512, 16, 16), (400, 256, 32, 32),
          (400, 128, 64, 64))
EVAL720 = ((1, 256, 90, 160), (1, 128, 180, 320), (1, 64, 360, 640))
ODD = ((3, 5, 7, 9), (2, 3, 1, 6), (2, 3, 6, 1), (1, 1, 1, 1),
       (4, 2, 5, 4), (2, 3, 9, 2))
# HyperE2VID's dynamic decoder input in training (B = 12, channels last)
HYPER = ((12, 256, 16, 16),)


def _ulp(t: torch.Tensor, dtype) -> torch.Tensor:
    """One unit in the last place of `dtype` at |t| (float64)."""
    fi = torch.finfo(dtype)
    return fi.eps * t.abs().clamp(min=fi.tiny)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _forward_within_an_ulp(x: torch.Tensor) -> None:
    """The kernel against ATen's forward on the card: equal, or apart by
    at most one unit in the last place of the output type at ATen's value
    (the kernel rounds each sum as ATen's kernel does, so it gives ATen's
    bits); equal bits over two calls."""
    before = _launches()
    got = up.upsample2x_bilinear(x)
    assert _launches() == (before[0] + 1, before[1])
    want = F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)
    assert got.dtype == x.dtype and got.shape == want.shape
    # the layout follows the tensor as ATen's does: channels-last in,
    # channels-last out; any other view NCHW
    assert got.stride() == want.stride()
    diff = (got.double() - want.double()).abs()
    assert bool((diff <= _ulp(want.double(), x.dtype)).all()), (
        f"{tuple(x.shape)} {x.dtype}: max|diff| {float(diff.max()):.3e}")
    assert torch.equal(got, up.upsample2x_bilinear(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
def test_forward_matches_aten_on_card(dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in FLAGSHIP + EVFLOW[:1] + ODD:
        _forward_within_an_ulp(
            torch.randn(shape, generator=gen, device=dev).to(dtype))
    # channels-last inputs (HyperE2VID's dynamic decoder hands one over),
    # which stay channels-last
    for shape in FLAGSHIP[:1] + HYPER + ODD:
        _forward_within_an_ulp(torch.randn(shape, generator=gen, device=dev)
                               .to(dtype, memory_format=torch.channels_last))
    # a view in neither layout, made NCHW-contiguous
    x = torch.randn(4, 6, 10, 12, generator=gen, device=dev).to(dtype)
    _forward_within_an_ulp(x[:, ::2, :, 1:])
    # float16 where the taps are exact
    _forward_within_an_ulp(x.to(torch.float16))


@pytest.mark.cuda
def test_forward_matches_aten_at_the_720p_eval_shapes():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    for shape in EVAL720:
        _forward_within_an_ulp(torch.randn(shape, generator=gen, device=dev))


def _backward_within_a_rounding(g: torch.Tensor) -> None:
    """The gather kernel against float64 on the CPU: apart by one unit of
    the output type at the true gradient, with float32's rounding of its
    16 terms (2^-20 of sum w|g|) besides; no farther than ATen's backward
    on the card, at its worst and on average; equal bits over two calls."""
    before = _launches()
    got = up.upsample2x_bilinear_backward(g)
    assert _launches() == (before[0], before[1] + 1)
    assert torch.equal(got, up.upsample2x_bilinear_backward(g))
    aten = up.upsample2x_bilinear_backward_plain(g)
    assert got.stride() == aten.stride()
    g64 = g.cpu().double()
    want = up.upsample2x_bilinear_backward_plain(g64)
    scale = up.upsample2x_bilinear_backward_plain(g64.abs())
    err = (got.cpu().double() - want).abs()
    bound = _ulp(want, g.dtype) + 2.0 ** -20 * scale
    assert bool((err <= bound).all()), (
        f"{tuple(g.shape)} {g.dtype}: max|err| {float(err.max()):.3e}")
    aten_err = (aten.cpu().double() - want).abs()
    assert float(err.max()) <= float(aten_err.max())
    assert float(err.mean()) <= float(aten_err.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
def test_backward_matches_float64_on_card(dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(2)
    for n, c, h, w in FLAGSHIP + ODD:
        _backward_within_a_rounding(torch.randn(
            (n, c, 2 * h, 2 * w), generator=gen, device=dev).to(dtype))
    # channels-last gradients give channels-last gradients
    for n, c, h, w in HYPER + ODD:
        _backward_within_a_rounding(torch.randn(
            (n, c, 2 * h, 2 * w), generator=gen, device=dev).to(
                dtype, memory_format=torch.channels_last))


@pytest.mark.cuda
def test_autograd_runs_both_kernels_on_card():
    dev = _card()
    x = torch.randn(2, 3, 5, 8, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    g = torch.randn(2, 3, 10, 16, device=dev, dtype=torch.bfloat16)
    before = _launches()
    up.upsample2x_bilinear(x).backward(g)
    assert _launches() == (before[0] + 1, before[1] + 1)
    assert torch.equal(x.grad, up.upsample2x_bilinear_backward(g))
    # channels last through autograd: both kernels, the layout kept
    xc = x.detach().to(memory_format=torch.channels_last).requires_grad_()
    out = up.upsample2x_bilinear(xc)
    out.backward(g.to(memory_format=torch.channels_last))
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out, up.upsample2x_bilinear(x.detach()))
    assert torch.equal(xc.grad, x.grad)
