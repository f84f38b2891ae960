"""K4's gradient in the port (v2v_tpu_torch/ops/dynconv.py): the plain
backward against JAX's VJP of v2v_tpu.ops.dynconv.dynamic_shift_sum (the
Pallas forward in interpret mode, its jnp backward), a plain-PyTorch
emulation of the CUDA kernels' tiling and sum order (csrc/dynconv_bwd.cu)
against the plain backward, the wrapper's host helpers against the
source note, its refusals, and the dispatch of `_ShiftSum.backward`. The
kernels themselves run only on the card (the `cuda` test below, and
chip_smoke.py's [k4])."""
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from v2v_tpu.ops.dynconv import dynamic_shift_sum as j_shift_sum

from v2v_tpu_torch.ops import _build
from v2v_tpu_torch.ops import dynconv as dc

from test_torch_hyper import SHIFT_CASES

T = torch.from_numpy
# the kernels' tiling (csrc/dynconv_bwd.cu kTw, kCo, kK)
COLS, CHUNK, K = 8, 128, 5
# H100 SMs; the dynamic shared memory a block may opt into, and an SM's
SMS, SMEM_LIMIT, SMEM_SM = 132, 232_448, 233_472


def _inputs(shape, k, dtype, seed=0):
    b, h, w, m, co = shape
    rng = np.random.RandomState(seed)
    z = rng.randn(*shape).astype(np.float32).astype(dtype)
    atoms = rng.randn(b, h, w, m, k * k).astype(np.float32)
    cot = rng.randn(b, h, w, co).astype(np.float32)
    return z, atoms, cot


def _nchw_view(cot):
    """The cotangent as the model hands it back: the (B,H,W,CO) view of
    an NCHW-contiguous tensor (models/hyper.py DynamicConv permutes)."""
    return T(cot).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


@pytest.mark.parametrize("shape,k,dtype", SHIFT_CASES + [
    ((1, 11, 13, 6, 97), 5, np.float32),        # odd CO, ragged tiles
    ((1, 9, 10, 4, 256), 5, np.float32)])       # two channel chunks
def test_backward_plain_matches_jax_vjp(shape, k, dtype):
    """dynamic_shift_sum_backward_plain against jax.vjp of the JAX
    package's dynamic_shift_sum (Pallas in interpret mode, jnp backward).
    float32 sums of the same products in other orders: 3e-5; bfloat16
    dz, a float32 sum rounded to bfloat16 on each side, may differ by one
    bfloat16 ulp (2^-7 relative)."""
    z, atoms, cot = _inputs(shape, k, dtype)

    @jax.jit        # one XLA program: the interpreted kernel runs 5x faster
    def vjp(z_, a_, cot_):
        return jax.vjp(lambda z2, a2: j_shift_sum(z2, a2, k, interpret=True),
                       z_, a_)[1](cot_)

    jdz, jda = vjp(jnp.asarray(z), jnp.asarray(atoms), jnp.asarray(cot))
    tdtype = torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32
    zt = T(z.astype(np.float32)).to(tdtype)
    dz, da = dc.dynamic_shift_sum_backward_plain(zt, T(atoms), _nchw_view(cot),
                                                 k)
    assert dz.dtype == tdtype and da.dtype == torch.float32
    assert dz.shape == shape and da.shape == atoms.shape
    np.testing.assert_allclose(dz.float().numpy(), np.asarray(jdz, np.float32),
                               rtol=2 ** -7 if tdtype == torch.bfloat16
                               else 3e-5, atol=3e-5)
    np.testing.assert_allclose(da.numpy(), np.asarray(jda), rtol=3e-5,
                               atol=3e-5)


def _tiles(h, w, rows, cols_left):
    """The (y0, x0) origins of a kernel's tiles: rows x 8 outputs, the
    first column cols_left left of a multiple of 8 (dz: 2, datoms: 0)."""
    return [(y0, x0) for y0 in range(0, h, rows)
            for x0 in range(-cols_left, w, COLS)]


def _window(x, y0, x0, rows, cols, c0=None):
    """x (B,H,W,...) float32 over rows x cols pixels from (y0, x0), zero
    off the image (and, with c0, the 128 channels from c0, zero past CO)."""
    b, h, w = x.shape[:3]
    if c0 is not None:
        x = x[..., c0:c0 + CHUNK]
        x = F.pad(x, (0, CHUNK - x.shape[-1]))
    out = torch.zeros((b, rows, cols) + x.shape[3:])
    ys, xs = slice(max(y0, 0), min(y0 + rows, h)), \
        slice(max(x0, 0), min(x0 + cols, w))
    out[:, ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0] = \
        x[:, ys, xs].to(torch.float32)
    return out


def _emulate_dz(z, atoms, g, per_block):
    """dz in the order csrc/dynconv_bwd.cu takes it, float32, rounded once
    to z's type: tiles of 8 x 8 outputs starting 2 columns left of a
    multiple of 8, a block per (tile, group of per_block atoms, 128-channel
    chunk); output (py, px) adds atoms[source, 5i+j] * g[source] over the
    source rows py + s of the haloed window (i = 4 - s) and their columns
    sx in order (px = sx + j - 4). Each output is written once."""
    b, h, w, m, co = z.shape
    rows = dc.DZ_ROWS
    out = torch.full((b, h, w, m, co), float("nan"))
    for y0, x0 in _tiles(h, w, rows, 2):
        for m0 in range(0, m, per_block):
            for c0 in range(0, co, CHUNK):
                gw = _window(g, y0 - 2, x0 - 2, rows + 4, COLS + 4, c0)
                for mm in range(m0, min(m0 + per_block, m)):
                    aw = _window(atoms[:, :, :, mm], y0 - 2, x0 - 2, rows + 4,
                                 COLS + 4)
                    acc = torch.zeros((b, rows, COLS, CHUNK))
                    for s in range(K):
                        i = K - 1 - s
                        for sx in range(COLS + K - 1):
                            for j in range(K):
                                px = sx + j - (K - 1)
                                if 0 <= px < COLS:
                                    acc[:, :, px] += (
                                        aw[:, s:s + rows, sx, i * K + j, None]
                                        * gw[:, s:s + rows, sx])
                    ys = slice(max(y0, 0), min(y0 + rows, h))
                    xs = slice(max(x0, 0), min(x0 + COLS, w))
                    dst = out[:, ys, xs, mm, c0:c0 + CHUNK]
                    assert torch.isnan(dst).all()    # written once
                    dst[...] = acc[:, ys.start - y0:ys.stop - y0,
                                   xs.start - x0:xs.stop - x0, :dst.shape[-1]]
    assert not torch.isnan(out).any()
    return out.to(z.dtype)


def _lane_channels(dtype):
    """The 16 channels of a 128-channel chunk that lane k (0..7) of an
    8-lane group sums, in its order: 16-byte units k, k+8, k+16, k+24 of
    a float32 z pixel, or k, k+8 of a bfloat16 one."""
    per = 16 // (2 if dtype == torch.bfloat16 else 4)
    return torch.tensor([[(k + 8 * v) * per + e for v in range(16 // per)
                          for e in range(per)] for k in range(8)])


def _emulate_datoms(z, atoms, g, per_block):
    """datoms in the order csrc/dynconv_bwd.cu takes it, float32: tiles of
    4 x 8 pixels, a block per (tile, group of per_block atoms) walking
    the 128-channel chunks; lane k of a pixel's 8-lane group sums its 16
    channels of each offset (_lane_channels) in order, a tree over the
    group adds lanes that differ in bit 2, then 1, then 0, and each chunk
    after the first adds to the previous ones. Each output is written
    once."""
    b, h, w, m, co = z.shape
    rows = dc.DATOMS_ROWS
    lanes = _lane_channels(z.dtype)
    out = torch.full(atoms.shape, float("nan"))
    for y0, x0 in _tiles(h, w, rows, 0):
        for m0 in range(0, m, per_block):
            for mm in range(m0, min(m0 + per_block, m)):
                total = None
                for c0 in range(0, co, CHUNK):
                    gt = _window(g, y0, x0, rows, COLS, c0)[..., lanes]
                    zw = _window(z[:, :, :, mm], y0 - 2, x0 - 2, rows + 4,
                                 COLS + 4, c0)[..., lanes]
                    sums = torch.empty((b, rows, COLS, K * K))
                    for i in range(K):
                        for j in range(K):
                            zq = zw[:, i:i + rows, j:j + COLS]
                            part = zq[..., 0] * gt[..., 0]
                            for c in range(1, 16):
                                part = part + zq[..., c] * gt[..., c]
                            part = part[..., :4] + part[..., 4:]
                            part = part[..., :2] + part[..., 2:]
                            sums[..., i * K + j] = part[..., 0] + part[..., 1]
                    total = sums if total is None else total + sums
                ys, xs = slice(y0, min(y0 + rows, h)), \
                    slice(x0, min(x0 + COLS, w))
                dst = out[:, ys, xs, mm]
                assert torch.isnan(dst).all()        # written once
                dst[...] = total[:, :ys.stop - y0, :xs.stop - x0]
    assert not torch.isnan(out).any()
    return out


@pytest.mark.parametrize("shape,dtype,tiling", [
    ((2, 13, 19, 6, 97), torch.float32, None),     # ragged tiles, odd CO
    ((2, 13, 19, 6, 97), torch.float32, (4, 5)),   # uneven groups
    ((1, 8, 16, 2, 256), torch.float32, None),     # two channel chunks
    ((1, 8, 16, 2, 256), torch.float32, (2, 2)),
    ((1, 9, 8, 3, 128), torch.bfloat16, None),     # the train dtype
    ((1, 9, 8, 3, 128), torch.bfloat16, (3, 3))])
def test_kernel_gather_order_matches_plain(shape, dtype, tiling):
    """The kernels' tiling (dz's tiles 2 columns left of a multiple of 8,
    groups of atoms, 128-channel chunks), index algebra (mirrored source
    offsets in a haloed window for dz) and sum order (datoms' 8-lane
    groups and their tree), emulated in plain PyTorch under the wrapper's
    atoms a block and others, against the scatter-form plain backward: float32
    sums of the same products in other orders, 2e-5; bfloat16 dz within
    one bfloat16 ulp (2^-7 relative) of the plain version's rounding."""
    z, atoms, cot = _inputs(shape, K, np.float32, seed=1)
    zt = T(z).to(dtype)
    g = _nchw_view(cot)
    tiling = tiling or dc._bwd_tiling(*shape, SMS)
    want_dz, want_da = dc.dynamic_shift_sum_backward_plain(zt, T(atoms), g, K)
    got_dz = _emulate_dz(zt, T(atoms), g, tiling[0])
    got_da = _emulate_datoms(zt, T(atoms), g, tiling[1])
    assert got_dz.dtype == dtype
    torch.testing.assert_close(got_da, want_da, rtol=0, atol=2e-5)
    torch.testing.assert_close(got_dz.float(), want_dz.float(),
                               rtol=2 ** -7 if dtype == torch.bfloat16
                               else 0, atol=2e-5)


def test_lane_channels_partition_the_chunk():
    """datoms' 8 lanes cover a chunk's 128 channels once; the g slots the
    kernel stores unit u at (g_slot) put lane k's units at k, k+8, k+16,
    k+24, in the order the lane reads its z channels."""
    for dtype in (torch.float32, torch.bfloat16):
        lanes = _lane_channels(dtype)
        assert sorted(lanes.flatten().tolist()) == list(range(CHUNK))
        slots = {u: u if dtype == torch.float32 else
                 u % 16 // 2 + 8 * (u % 2) + 16 * (u // 16)
                 for u in range(32)}
        for k in range(8):
            units = lanes[k].view(4, 4)[:, 0] // 4
            assert [slots[int(u)] for u in units] == [k, k + 8, k + 16,
                                                      k + 24]


def test_bwd_tiling_fills_the_card():
    """At the train shape all 6 atoms a block in both kernels, dz 240
    blocks of 8 rows (5 tiles a row: W = 32 plus the 2-column shift) and
    datoms 384 of 4, each at least one an SM; on shapes too small for
    that, an atom a block."""
    assert (dc.DZ_ROWS, dc.DATOMS_ROWS) == (8, 4)
    assert dc._bwd_tiling(12, 32, 32, 6, 128, SMS) == (6, 6)
    assert dc._bwd_blocks(12, 32, 32, 6, 128, (6, 6)) == (240, 384)
    assert dc._bwd_blocks(12, 32, 32, 6, 128, (1, 1)) == (1440, 2304)
    for shape in ((2, 37, 53, 6, 97), (2, 16, 24, 6, 256), (2, 9, 10, 6, 16),
                  (1, 8, 8, 6, 128)):
        tiling = dc._bwd_tiling(*shape, SMS)
        for atoms, n in zip(tiling, dc._bwd_blocks(*shape, tiling)):
            assert 1 <= atoms <= shape[3]
            assert n >= SMS or atoms == 1
    assert dc._bwd_tiling(2, 16, 24, 6, 256, SMS) == (1, 1)


def test_bwd_smem_bytes_match_the_source_note():
    """`_bwd_smem_bytes` follows the layout csrc/dynconv_bwd.cu states,
    with the note's sizes: dz two blocks an SM, datoms three in bfloat16,
    all under the opt-in limit (an SM keeps 1 KB a block)."""
    note = (_build.CSRC / "dynconv_bwd.cu").read_text().replace("\n//", "")
    sizes = {2: (111_312, 65_696), 4: (111_312, 65_680)}
    for itemsize, want in sizes.items():
        assert dc._bwd_smem_bytes(itemsize) == want
        for size in want:
            assert re.search(rf"\b{size:,}\b", note), size
            assert size <= SMEM_LIMIT
    assert 2 * (111_312 + 1024) <= SMEM_SM
    assert 3 * (65_696 + 1024) <= SMEM_SM


def test_shift_sum_backward_on_cpu_runs_the_plain_version():
    """On CPU tensors _ShiftSum's backward launches no kernel and returns
    exactly what dynamic_shift_sum_backward_plain does."""
    z, atoms, cot = _inputs((2, 9, 10, 6, 16), K, np.float32, seed=2)
    zt = T(z).to(torch.bfloat16).requires_grad_()
    at = T(atoms).requires_grad_()
    before = dc.dynamic_shift_sum_backward.launches
    dc.dynamic_shift_sum(zt, at, K).backward(T(cot))
    assert dc.dynamic_shift_sum_backward.launches == before
    dz, da = dc.dynamic_shift_sum_backward_plain(zt.detach(), at.detach(),
                                                 T(cot), K)
    assert torch.equal(zt.grad, dz) and torch.equal(at.grad, da)
    assert torch.equal(dc.dynamic_shift_sum_backward(
        zt.detach(), at.detach(), T(cot), K)[1], da)


def test_backward_wrapper_raises_off_cpu_and_cuda():
    """Tensors on neither the CPU nor a CUDA device (here `meta`) reach no
    plain version: the wrapper raises."""
    z = torch.empty((1, 8, 8, 6, 128), device="meta")
    atoms = torch.empty((1, 8, 8, 6, 25), device="meta")
    g = torch.empty((1, 8, 8, 128), device="meta")
    with pytest.raises(ValueError):
        dc.dynamic_shift_sum_backward(z, atoms, g, K)


def _bad_args(case):
    z, atoms, cot = _inputs((1, 8, 8, 6, 128), K, np.float32)
    z, atoms, g = T(z), T(atoms), _nchw_view(cot)
    return {"k3": (z, atoms[..., :9].contiguous(), g, 3),
            "half z": (z.half(), atoms, g, K),
            "bf16 g": (z, atoms, g.bfloat16(), K),
            "g shape": (z, atoms, g[:, :-1], K),
            "not contiguous": (z.transpose(1, 2), atoms, g, K),
            "empty": (z[:, :0], atoms[:, :0], g[:, :0], K),
            "cpu": (z, atoms, g, K)}[case]


@pytest.mark.parametrize("case,match", [
    ("k3", "the kernels take k = 5"),
    ("half z", "must be float32 or bfloat16"),
    ("bf16 g", "must be float32 or bfloat16"),
    ("g shape", "the kernels take k = 5"),
    ("not contiguous", "must be contiguous"),
    ("empty", "is empty"),
    ("cpu", "must lie on one CUDA device")])
def test_kernel_wrapper_rejects(case, match):
    """The kernels' wrapper raises for what csrc/dynconv_bwd.cu does not
    take (k != 5, z neither float32 nor bfloat16, g not float32, shapes
    that disagree, non-contiguous z, empty z) and for tensors that are
    not on a CUDA device, before any launch. The device is checked last,
    so each case here, on CPU tensors, reaches its own check."""
    before = dc.dynamic_shift_sum_backward.launches
    with pytest.raises(ValueError, match=match):
        dc._shift_sum_bwd_kernel(*_bad_args(case))
    assert dc.dynamic_shift_sum_backward.launches == before


@pytest.mark.cuda
def test_backward_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, dtype in (((2, 19, 27, 6, 128), torch.float32),
                         ((3, 16, 8, 2, 97), torch.bfloat16),
                         ((1, 11, 9, 3, 256), torch.float32),
                         ((2, 12, 30, 6, 136), torch.bfloat16)):
        z = torch.randn(shape, generator=gen, device=dev).to(dtype)
        atoms = torch.randn(shape[:4] + (25,), generator=gen, device=dev)
        g = torch.randn((shape[0], shape[4]) + shape[1:3], generator=gen,
                        device=dev).permute(0, 2, 3, 1)
        before = dc.dynamic_shift_sum_backward.launches
        dz, da = dc.dynamic_shift_sum_backward(z, atoms, g, 5)
        assert dc.dynamic_shift_sum_backward.launches == before + 1
        want_dz, want_da = dc.dynamic_shift_sum_backward_plain(
            z.float(), atoms, g, 5)
        for tiling in (None, (2, 3), (6, 1)):
            got = dc._shift_sum_bwd_kernel(z, atoms, g, 5, tiling)
            again = dc._shift_sum_bwd_kernel(z, atoms, g.contiguous(), 5,
                                             tiling)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            assert all(torch.equal(a, b) for a, b in zip(got, (dz, da)))
            torch.testing.assert_close(got[1], want_da, atol=1e-4, rtol=0)
            excess = (got[0].float() - want_dz).abs() - (
                2 ** -8 if dtype == torch.bfloat16 else 0) * want_dz.abs()
            assert float(excess.max()) <= 1e-4
    with pytest.raises(ValueError):                     # g's shape
        dc.dynamic_shift_sum_backward(z, atoms, g[:, :-1], 5)
    with pytest.raises(ValueError):                     # k = 3
        dc.dynamic_shift_sum_backward(z, atoms[..., :9].contiguous(), g, 3)
    with pytest.raises(ValueError):                     # g in bfloat16
        dc.dynamic_shift_sum_backward(z, atoms, g.bfloat16(), 5)
    with pytest.raises(ValueError):                     # z not contiguous
        dc.dynamic_shift_sum_backward(z.transpose(1, 2), atoms, g, 5)
