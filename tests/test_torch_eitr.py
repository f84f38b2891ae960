"""The port's ETNet (v2v_tpu_torch models/eitr.py, ops/attention.py) and
its converter against the JAX package on weights carried from JAX, in
float32. On the CPU the long-sequence attention runs its plain version;
the CUDA kernel K3 is held against that on the card (the `cuda` test
below, and chip_smoke.py)."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import v2v_tpu.models.eitr as jeitr
from v2v_tpu.models.convert import torch_state_dict_to_flax

import v2v_tpu_torch.models.eitr as teitr
from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.ops import attention as at

KW = {"num_bins": 5, "norm": None}
# float32 on both sides; matmuls and convs sum in different orders (XLA
# vs oneDNN), so outputs agree to ~1e-6 after a few recurrent steps
ATOL = 1e-5


def _mha_pair(d, h, threshold, seed=0):
    """A JAX MultiheadAttention with its parameters, and the port's on
    the converted parameters."""
    jm = jeitr.MultiheadAttention(d, h, dropout=0.0,
                                  chunk_threshold=threshold)
    x = jnp.zeros((1, 4, d))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(seed), x, x, x))
    tm = teitr.MultiheadAttention(d, h, dropout=0.0)
    tm.chunk_threshold = threshold
    tm.load_state_dict(jax_params_to_state_dict(params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("threshold,nq,nk", [
    (10 ** 9, 64, 64),      # dense
    (10 ** 9, 40, 72),      # dense cross attention
    (16, 64, 64),           # forced long-sequence route, one query block
    (16, 40, 72),           # ... cross attention
    (16, 2500, 2500),       # two query blocks of 2048, the last ragged
])
def test_multihead_attention_matches_jax(threshold, nq, nk):
    """d=64 with 2 heads (dh = 32, the kernel's): the dense path, and the
    route to ops/attention.py (attention_plain on the CPU) against the
    JAX module's chunked query-block branch."""
    d = 64
    jm, params, tm = _mha_pair(d, 2, threshold)
    rng = np.random.RandomState(1)
    q = rng.randn(2, nq, d).astype(np.float32)
    kv = rng.randn(2, nk, d).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(q),
                                        jnp.asarray(kv), jnp.asarray(kv)))
    before = at.attention.launches
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(kv),
                 torch.from_numpy(kv)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert at.attention.launches == before       # the CPU runs no kernel


def test_attention_plain_matches_float64_softmax():
    """attention_plain on a ragged token count, against softmax(QK^T /
    sqrt(dh)) V in float64 (float32 rounding: 1e-6)."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(1, 3, n, 32).astype(np.float32)
               for n in (2100, 77, 77))
    s = q.astype(np.float64) @ k.astype(np.float64).swapaxes(-1, -2)
    s = s / np.sqrt(32)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = (p / p.sum(-1, keepdims=True)) @ v.astype(np.float64)
    got = at.attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_dropout_in_training_mode_is_refused():
    tm = teitr.MultiheadAttention(64, 2, dropout=0.1)
    x = torch.zeros(1, 4, 64)
    with pytest.raises(NotImplementedError):
        tm(x, x, x)


@functools.lru_cache(maxsize=None)
def _jax_eitr():
    m = jeitr.EITR(eitr_kwargs=KW)
    x = jnp.zeros((1, 64, 64, 5))
    params = jax.jit(m.init)(jax.random.PRNGKey(0), x,
                             m.init_state(1, 64, 64))
    return m, jax.tree.map(np.asarray, params)


def _port_eitr():
    m, params = _jax_eitr()
    tm = teitr.EITR(KW)
    tm.load_state_dict(jax_params_to_state_dict(params))
    return tm.eval()


@pytest.mark.parametrize("h,w,threshold", [
    (64, 64, None),     # 64 tokens a stream: dense attention
    (60, 76, 16),       # x8 pad and crop; the long-sequence route
])
def test_eitr_steps_with_carried_state_match_jax(h, w, threshold,
                                                 monkeypatch):
    if threshold is not None:
        monkeypatch.setattr(jeitr.MultiheadAttention, "chunk_threshold",
                            threshold)
        monkeypatch.setattr(teitr.MultiheadAttention, "chunk_threshold",
                            threshold)
    m, params = _jax_eitr()
    tm = _port_eitr()
    xs = (np.random.RandomState(3).randn(3, 1, h, w, 5) * 0.5).astype(
        np.float32)
    js = m.init_state(1, h, w)
    ts = tm.init_state(1, h, w)
    apply = jax.jit(m.apply)
    for x in xs:                               # 3 steps, state carried
        out, js = apply(params, jnp.asarray(x), js)
        with torch.no_grad():
            tout, ts = tm(torch.from_numpy(x).permute(0, 3, 1, 2), ts)
        assert tout["image"].shape == (1, 1, h, w)
        np.testing.assert_allclose(
            tout["image"].permute(0, 2, 3, 1).numpy(),
            np.asarray(out["image"]), atol=ATOL)
    for (th, tc), (jh, jc) in zip(ts, js):
        np.testing.assert_allclose(th.numpy(),
                                   np.asarray(jh).transpose(0, 3, 1, 2),
                                   atol=ATOL)
        np.testing.assert_allclose(tc.numpy(),
                                   np.asarray(jc).transpose(0, 3, 1, 2),
                                   atol=ATOL)


def test_converter_round_trips_and_keeps_reference_keys():
    """JAX params -> port state_dict -> torch_state_dict_to_flax gives the
    JAX params back leaf for leaf, and a port state_dict survives the
    other round trip; the keys are the reference's."""
    _, params = _jax_eitr()
    sd = jax_params_to_state_dict(params)
    back = torch_state_dict_to_flax(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)

    port = teitr.EITR(KW).state_dict()
    again = jax_params_to_state_dict(torch_state_dict_to_flax(port))
    assert sorted(again) == sorted(port)
    for k, v in port.items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0)
    for key in ("head.conv2d.weight",
                "DownsampleConv.2.recurrent_block.Gates.weight",
                "split2.weight",
                "trans_encoder0.encoder.layers.2.self_attn.in_proj_weight",
                "trans_encoder1.encoder.layers.0.norm2.bias",
                "trans_decoder2.decoder.layers.1.cross_attn.out_proj.weight",
                "trans_decoder0.decoder.layers.0.norm22.weight",
                "UpsampleConv.2.conv2d.weight", "pred.conv2d.bias"):
        assert key in port, key
    assert port["trans_encoder0.encoder.layers.0.self_attn."
                "in_proj_weight"].shape == (768, 256)
    assert sum(v.numel() for v in port.values()) == 22_175_361


@pytest.mark.cuda
def test_k3_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # ragged Nq and Nk, cross attention, fewer keys than one key tile
    # (64), Nq not a multiple of 64, B*h = 16
    for shape, nk in (((1, 8, 5001, 32), 5001), ((2, 3, 300, 32), 777),
                      ((1, 8, 1000, 32), 50), ((2, 8, 300, 32), 777)):
        q = torch.randn(shape, generator=g, device=dev)
        k, v = (torch.randn(shape[:2] + (nk, 32), generator=g, device=dev)
                for _ in range(2))
        before = at.attention.launches
        got = at.attention(q, k, v)
        assert at.attention.launches == before + 1
        torch.testing.assert_close(got, at.attention_plain(q, k, v),
                                   atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        at.attention(q.transpose(2, 3), k, v)       # not contiguous
