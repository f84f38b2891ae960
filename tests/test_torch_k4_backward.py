"""K4's gradient in the port (v2v_tpu_torch/ops/dynconv.py): the plain
backward against JAX's VJP of v2v_tpu.ops.dynconv.dynamic_shift_sum (the
Pallas forward in interpret mode, its jnp backward), a plain-PyTorch
emulation of the CUDA kernels' gather order (csrc/dynconv_bwd.cu)
against the plain backward, and the dispatch of `_ShiftSum.backward`. The
kernels themselves run only on the card (the `cuda` test below, and
chip_smoke.py's [k4])."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from v2v_tpu.ops.dynconv import dynamic_shift_sum as j_shift_sum

from v2v_tpu_torch.ops import dynconv as dc

from test_torch_hyper import SHIFT_CASES

T = torch.from_numpy
# the kernels' tiling (csrc/dynconv_bwd.cu kT, kCo, kK)
TILE, CHUNK, K = 8, 128, 5


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


def _emulate_kernels(z, atoms, g):
    """(dz, datoms) in the order csrc/dynconv_bwd.cu takes them, float32:
    8x8 tiles whose 12x12 haloed windows read zero off the image, a warp
    per tile row. dz: output row py walks the source rows py + s of the
    haloed tile (i = 4 - s) and their 12 columns sx, and adds
    atoms[source, 5i+j] * g[source] into column px = sx + j - 4. datoms:
    pixels in pairs px0 + d, source column px0 + cx serving j = cx - d,
    each pixel's 25 sums over a chunk of 128 channels added to the
    previous chunks' in order."""
    b, h, w, m, co = z.shape
    hp, wp = -(-h // TILE) * TILE, -(-w // TILE) * TILE
    halo = K // 2
    pad = (halo, hp - h + halo, halo, wp - w + halo)

    def padded(x, lead):
        return F.pad(x.to(torch.float32), (0, 0) * lead + pad[2:] + pad[:2])

    zp, ap, gp = padded(z, 2), padded(atoms, 2), padded(g, 1)
    dz = torch.zeros((b, hp, wp, m, co))
    da = torch.zeros((b, hp, wp, m, K * K))
    span = TILE + K - 1
    for y0 in range(0, hp, TILE):
        for x0 in range(0, wp, TILE):
            gt = gp[:, y0:y0 + span, x0:x0 + span]
            at = ap[:, y0:y0 + span, x0:x0 + span]
            zt = zp[:, y0:y0 + span, x0:x0 + span]
            for py in range(TILE):
                for s in range(K):
                    i = K - 1 - s
                    for sx in range(span):
                        gv = gt[:, py + s, sx, None, :]
                        for j in range(K):
                            px = sx + j - (K - 1)
                            if 0 <= px < TILE:
                                dz[:, y0 + py, x0 + px] += \
                                    at[:, py + s, sx, :, i * K + j, None] * gv
                for c0 in range(0, co, CHUNK):
                    for px0 in range(0, TILE, 2):
                        for i in range(K):
                            for cx in range(K + 1):
                                zq = zt[:, py + i, px0 + cx, :, c0:c0 + CHUNK]
                                for d in range(2):
                                    j = cx - d
                                    if not 0 <= j < K:
                                        continue
                                    gq = gp[:, y0 + halo + py,
                                            x0 + halo + px0 + d, None,
                                            c0:c0 + CHUNK]
                                    da[:, y0 + py, x0 + px0 + d, :,
                                       i * K + j] += (zq * gq).sum(-1)
    return dz[:, :h, :w].to(z.dtype), da[:, :h, :w]


@pytest.mark.parametrize("shape,dtype", [
    ((2, 13, 19, 6, 97), torch.float32),    # ragged tiles, odd CO
    ((1, 8, 16, 2, 256), torch.float32),    # two channel chunks
    ((1, 9, 8, 3, 128), torch.bfloat16)])   # the train dtype
def test_kernel_gather_order_matches_plain(shape, dtype):
    """The kernels' index algebra (mirrored source offsets in a haloed
    tile for dz, 128-channel chunks for datoms), emulated in plain
    PyTorch, against the scatter-form plain backward: float32 sums of the
    same products in other orders, 2e-5; bfloat16 dz within one bfloat16
    ulp (2^-7 relative) of the plain version's rounding."""
    z, atoms, cot = _inputs(shape, K, np.float32, seed=1)
    zt = T(z).to(dtype)
    g = _nchw_view(cot)
    want_dz, want_da = dc.dynamic_shift_sum_backward_plain(zt, T(atoms), g, K)
    got_dz, got_da = _emulate_kernels(zt, T(atoms), g)
    assert got_dz.dtype == dtype
    torch.testing.assert_close(got_da, want_da, rtol=0, atol=2e-5)
    torch.testing.assert_close(got_dz.float(), want_dz.float(),
                               rtol=2 ** -7 if dtype == torch.bfloat16
                               else 0, atol=2e-5)


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


@pytest.mark.cuda
def test_backward_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, dtype in (((2, 19, 27, 6, 128), torch.float32),
                         ((3, 16, 8, 2, 97), torch.bfloat16),
                         ((1, 11, 9, 3, 256), torch.float32)):
        z = torch.randn(shape, generator=gen, device=dev).to(dtype)
        atoms = torch.randn(shape[:4] + (25,), generator=gen, device=dev)
        g = torch.randn((shape[0], shape[4]) + shape[1:3], generator=gen,
                        device=dev).permute(0, 2, 3, 1)
        before = dc.dynamic_shift_sum_backward.launches
        dz, da = dc.dynamic_shift_sum_backward(z, atoms, g, 5)
        assert dc.dynamic_shift_sum_backward.launches == before + 1
        dz2, da2 = dc.dynamic_shift_sum_backward(z, atoms, g.contiguous(), 5)
        assert torch.equal(dz, dz2) and torch.equal(da, da2)
        want_dz, want_da = dc.dynamic_shift_sum_backward_plain(
            z.float(), atoms, g, 5)
        torch.testing.assert_close(da, want_da, atol=1e-4, rtol=0)
        excess = (dz.float() - want_dz).abs() - (
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
