"""K4's forward kernel in the port (v2v_tpu_torch/csrc/dynconv.cu): a
plain-PyTorch emulation of the kernel's tiling, index algebra and
summation order against `dynamic_shift_sum_plain`, the wrapper's contract
(`_shift_sum_kernel`, `_tile_rows`, `_smem_bytes`) and the CPU dispatch.
The kernel itself runs only on the card (the `cuda` test below, and
chip_smoke.py's [k4]); the plain version is held against the JAX
package's Pallas kernel in tests/test_torch_hyper.py."""
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from v2v_tpu_torch.ops import _build
from v2v_tpu_torch.ops import dynconv as dc

T = torch.from_numpy
# the kernel's tiling (csrc/dynconv.cu kTw, kCo, kK, kAp)
COLS, CHUNK, K, PAD = 8, 128, 5, 8
# H100 SMs, and the dynamic shared memory a block may opt into
SMS, SMEM_LIMIT = 132, 232_448


def _inputs(shape, dtype, seed=0):
    b, h, w, m, _ = shape
    rng = np.random.RandomState(seed)
    z = T(rng.randn(*shape).astype(np.float32)).to(dtype)
    atoms = T(rng.randn(b, h, w, m, K * K).astype(np.float32))
    return z, atoms


def _emulate_kernel(z, atoms, rows):
    """out in the order csrc/dynconv.cu takes it, float32. Tiles of `rows`
    x 8 outputs and 128-channel chunks; for each atom m the tile's haloed
    (rows+4) x 12 z window in z's own type, zero off the image and past
    CO, and its taps with each offset row's 5 padded to 8 (the pad is NaN
    here: the kernel never reads it). The warp of tile row py walks source
    row py + i once: its 12 z vectors, widened, then for each output px
    the row's 5 taps, adding a[j] * zv[px + j] in the order m, i, j."""
    b, h, w, m, co = z.shape
    hp, wp = -(-h // rows) * rows, -(-w // COLS) * COLS
    cp = -(-co // CHUNK) * CHUNK
    halo = K // 2
    zp = F.pad(z, (0, cp - co, 0, 0, halo, wp - w + halo,
                   halo, hp - h + halo))
    ap = F.pad(atoms, (0, 0, 0, 0, 0, wp - w, 0, hp - h))
    out = torch.zeros((b, hp, wp, cp))
    for y0 in range(0, hp, rows):
        for x0 in range(0, wp, COLS):
            for c0 in range(0, cp, CHUNK):
                acc = torch.zeros((b, rows, COLS, CHUNK))
                for mi in range(m):
                    zt = zp[:, y0:y0 + rows + K - 1, x0:x0 + COLS + K - 1, mi,
                            c0:c0 + CHUNK]
                    at = torch.full((b, rows, COLS, K, PAD), float("nan"))
                    at[..., :K] = ap[:, y0:y0 + rows, x0:x0 + COLS,
                                     mi].reshape(b, rows, COLS, K, K)
                    for i in range(K):
                        zv = zt[:, i:i + rows].to(torch.float32)
                        for px in range(COLS):
                            a = at[:, :, px, i]
                            for j in range(K):
                                acc[:, :, px] += a[..., j, None] * \
                                    zv[:, :, px + j]
                out[:, y0:y0 + rows, x0:x0 + COLS, c0:c0 + CHUNK] = acc
    return out[:, :h, :w, :co]


@pytest.mark.parametrize("shape,dtype,rows", [
    ((2, 13, 19, 6, 97), torch.float32, 8),    # ragged tiles, odd CO
    ((2, 13, 19, 6, 97), torch.float32, 4),    # the 4-row tiling
    ((1, 9, 11, 2, 256), torch.float32, 8),    # two channel chunks
    ((2, 9, 8, 3, 128), torch.bfloat16, 4)])   # the train dtype and tiling
def test_kernel_order_matches_plain(shape, dtype, rows):
    """The kernel's index algebra (haloed tiles with a zero border,
    channel chunks, the sliding-window walk, the padded taps), emulated in
    plain PyTorch, against the plain loop: float32 sums of the same 150
    products in another order, on unit-normal inputs (|out| up to ~50,
    where a float32 ulp is 3.8e-6): 4e-5, about ten ulps. bfloat16 z is
    widened exactly on both sides."""
    z, atoms = _inputs(shape, dtype, seed=1)
    want = dc.dynamic_shift_sum_plain(z, atoms, K)
    got = _emulate_kernel(z, atoms, rows)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=4e-5)


def test_tile_rows_fill_the_card():
    """8-row tiles at the 720p eval shape; 4-row ones at the train shape,
    where 8 rows give 192 blocks on 132 SMs and 4 rows 384, at least two
    an SM."""
    assert dc._tile_rows(1, 180, 320, 128, SMS) == 8
    assert dc._tile_rows(12, 32, 32, 128, SMS) == 4
    blocks = 12 * (32 // 4) * (32 // COLS)
    assert blocks == 384 and blocks >= 2 * SMS
    assert dc._tile_rows(12, 32, 32, 256, SMS) == 8       # two chunks: 384


def test_smem_bytes_match_the_source_note():
    """`_smem_bytes` follows the layout csrc/dynconv.cu states: the haloed
    (rows+4) x 12 x 128 z tile in z's type and rows x 8 x 5 x 8 float32
    taps, with the note's sizes, all under the opt-in limit."""
    note = (_build.CSRC / "dynconv.cu").read_text().replace("\n//", "")
    for rows, itemsize, size in ((8, 4, 83_968), (8, 2, 47_104),
                                 (4, 4, 54_272), (4, 2, 29_696)):
        want = ((rows + 4) * 12 * 128 * itemsize + rows * 8 * 5 * 8 * 4)
        assert dc._smem_bytes(rows, itemsize) == want == size
        assert re.search(rf"\b{size:,}\b", note), size
        assert size <= SMEM_LIMIT


def test_cpu_tensors_run_the_plain_version():
    """CPU tensors take the plain loop through dynamic_shift_sum and count
    no launch."""
    z, atoms = _inputs((2, 9, 10, 6, 16), torch.bfloat16, seed=2)
    before = dc.dynamic_shift_sum.launches
    got = dc.dynamic_shift_sum(z, atoms, K)
    assert dc.dynamic_shift_sum.launches == before
    assert torch.equal(got, dc.dynamic_shift_sum_plain(z, atoms, K))


def _bad_args(case):
    z, atoms = _inputs((1, 8, 8, 6, 128), torch.float32)
    return {"k3": (z, atoms[..., :9].contiguous(), 3),
            "half z": (z.half(), atoms, K),
            "double atoms": (z, atoms.double(), K),
            "atoms shape": (z, atoms[:, :, :7].contiguous(), K),
            "not contiguous": (z.transpose(1, 2), atoms, K),
            "cpu": (z, atoms, K)}[case]


@pytest.mark.parametrize("case", ["k3", "half z", "double atoms",
                                  "atoms shape", "not contiguous", "cpu"])
def test_kernel_wrapper_rejects(case):
    """The kernel's wrapper raises for what csrc/dynconv.cu does not take
    (k != 5, z neither float32 nor bfloat16, atoms not float32, shapes
    that disagree, non-contiguous tensors) and for tensors that are not
    on a CUDA device, before any launch."""
    before = dc.dynamic_shift_sum.launches
    with pytest.raises(ValueError):
        dc._shift_sum_kernel(*_bad_args(case))
    assert dc.dynamic_shift_sum.launches == before


@pytest.mark.cuda
def test_forward_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, dtype in (((2, 19, 27, 6, 128), torch.float32),
                         ((3, 16, 8, 2, 97), torch.bfloat16),
                         ((1, 11, 9, 3, 256), torch.float32),
                         ((2, 12, 20, 6, 136), torch.bfloat16)):
        z = torch.randn(shape, generator=gen, device=dev).to(dtype)
        atoms = torch.randn(shape[:4] + (25,), generator=gen, device=dev)
        want = dc.dynamic_shift_sum_plain(z, atoms, K)
        before = dc.dynamic_shift_sum.launches
        got = dc.dynamic_shift_sum(z, atoms, K)
        assert dc.dynamic_shift_sum.launches == before + 1
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        for rows in (4, 8):
            one = dc._shift_sum_kernel(z, atoms, K, rows)
            torch.testing.assert_close(one, want, atol=1e-4, rtol=0)
            assert torch.equal(one, dc._shift_sum_kernel(z, atoms, K, rows))
