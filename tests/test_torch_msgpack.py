"""The port's msgpack reader (v2v_tpu_torch/utils/msgpack.py) and its
use by training/checkpoint.py::load_params_only: the reader against
flax.serialization.msgpack_restore on every type flax writes and on
checkpoint files written by the JAX package's save_checkpoint for a small
E2VID and a small HyperE2VID; load_params_only of such a file against
jax_params_to_state_dict; `cli test_e2vid --device cpu` on a ckpt_paths
line that names a `.msgpack`, against the same run from a `.pth`."""
import copy
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization

from v2v_tpu.models.convert import torch_state_dict_to_flax
from v2v_tpu.training import checkpoint as jckpt

from v2v_tpu_torch import cli
from v2v_tpu_torch.losses.lpips import LPIPS
from v2v_tpu_torch.models import hyper
from v2v_tpu_torch.models.convert import jax_params_to_state_dict
from v2v_tpu_torch.models.init import materialize
from v2v_tpu_torch.training import checkpoint
from v2v_tpu_torch.training.interface import ModelInterface
from v2v_tpu_torch.utils import msgpack

import chip_smoke
from test_data import make_hqf_h5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_HYPER = dict(chip_smoke.HYPER_UNET, base_num_channels=8,
                   num_residual_blocks=1)
SMALL_E2VID = {"target": "model.model.E2VIDRecurrent", "params": {
    "unet_kwargs": {"num_bins": 5, "skip_type": "sum",
                    "recurrent_block_type": "convlstm", "num_encoders": 2,
                    "base_num_channels": 8, "num_residual_blocks": 1,
                    "use_upsample_conv": True, "final_activation": "",
                    "norm": "none"}}}


def _same_tree(got, want, path="root"):
    """Equal trees: the same keys and types, arrays of the same dtype,
    shape and bits (a bfloat16 array as a torch.bfloat16 tensor)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and (
            want.dtype == jnp.bfloat16):
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert np.shape(got) == np.shape(want), path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_every_type_flax_writes(monkeypatch):
    """Maps of 3 and 20 keys, lists of 3 and 40, ints of every width and
    sign, floats, short and long str, bin, nil, bools, ndarrays of several
    dtypes and ranks (0-d, empty, bfloat16), numpy scalars, a complex,
    and an array cut into chunks (flax's chunk limit lowered to 64
    bytes)."""
    rng = np.random.RandomState(0)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                 2 ** 63 + 5, -1, -32, -33, -128, -129, -32769, -2 ** 31 - 1,
                 -2 ** 62],
        "floats": [0.0, -1.5, 1e300, float("inf")],
        "str": ["", "a" * 31, "b" * 32, "c" * 300, "é" * 40_000],
        "bin": [b"", b"\x00" * 300, bytes(range(256)) * 300],
        "nil": None, "bools": [True, False],
        "many": {f"k{i}": i for i in range(20)},
        "long": list(range(40)),
        "arrays": {"f32": rng.randn(3, 4).astype(np.float32),
                   "f64": rng.randn(5), "i8": np.arange(-5, 5, dtype=np.int8),
                   "u16": np.arange(7, dtype=np.uint16).reshape(7, 1, 1),
                   "zero_d": np.array(3.5, np.float32),
                   "empty": np.zeros((0, 3), np.float32),
                   "bool": rng.rand(6) > 0.5,
                   "bf16": np.asarray(rng.randn(2, 3), jnp.bfloat16),
                   "bf16_empty": np.zeros((0,), jnp.bfloat16)},
        "scalars": [np.float32(2.5), np.int64(-7), np.bool_(True),
                    np.asarray(1.5, jnp.bfloat16)[()]],
        "complex": 1.5 - 2j,
        "chunked": rng.randn(37).astype(np.float32),
    }
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    want = serialization.msgpack_restore(data)
    got = msgpack.restore(data)
    _same_tree(got, want)
    np.testing.assert_array_equal(got["chunked"], tree["chunked"])
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(data[:-3])
    with pytest.raises(ValueError, match="after the object"):
        msgpack.unpackb(data + b"\x00")


def _e2vid():
    return ModelInterface({"model": SMALL_E2VID}, device="cpu").model


def _hyper():
    """A small HyperE2VID with BatchNorm running statistics that are not
    their defaults."""
    m = materialize(lambda: hyper.HyperE2VID(SMALL_HYPER), "cpu")
    with torch.no_grad():
        for k, buf in m.named_buffers():
            if "running" in k:
                buf.uniform_(0.5, 1.5)
    return m


def _jax_checkpoint(path, model):
    """The model's weights as the JAX package's tree, saved by its
    save_checkpoint with an Adam state beside them, as its train driver
    saves (v2v_tpu/training/train.py:425-432)."""
    variables = torch_state_dict_to_flax(model.state_dict())
    opt_state = optax.adam(1e-3).init(variables["params"])
    jckpt.save_checkpoint(path, variables, opt_state, 3,
                          extra={"scheduler": {"last_epoch": 3}})
    return variables


@pytest.mark.parametrize("make", [_e2vid, _hyper], ids=["e2vid", "hyper"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, make):
    path = str(tmp_path / "epoch_0003.msgpack")
    model = make()
    variables = _jax_checkpoint(path, model)
    assert ("batch_stats" in variables) == (make is _hyper)
    with open(path, "rb") as f:
        data = f.read()
    _same_tree(msgpack.restore(data),
               serialization.msgpack_restore(data))
    want = jax_params_to_state_dict(serialization.msgpack_restore(
        data)["params"])
    assert sorted(checkpoint.jax_checkpoint_state_dict(path)) == sorted(want)
    fresh = make()
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    checkpoint.load_params_only(path, fresh)
    got = fresh.state_dict()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.filterwarnings("ignore:LPIPS")
def test_cli_test_e2vid_scores_a_jax_checkpoint(tmp_path, monkeypatch,
                                                capsys):
    """test_hypere2vid_original.yaml at small widths on a synthetic h5:
    `cli test_e2vid --device cpu` with the last ckpt_paths line naming
    the JAX package's `.msgpack` scores what it scores from a `.pth` of
    the same weights (not the model's initial ones), metric for
    metric."""
    with open(os.path.join(ROOT, "configs",
                           "test_hypere2vid_original.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.pop("test_output_dir")
    cfg["module"]["model"]["params"]["unet_kwargs"] = SMALL_HYPER
    h5 = make_hqf_h5(str(tmp_path / "ball.h5"), n_frames=5, h=40, w=56,
                     events_per_frame=300)
    listing = tmp_path / "evaid_test.txt"
    listing.write_text(h5 + "\n")
    cfg["test_stage"]["test_num_workers"] = 1
    cfg["test_stage"]["test"] = [dict(cfg["test_stage"]["test"][0],
                                      data_file=str(listing),
                                      sequence_length=4)]
    exp = cfg["experiment_name"]
    lp = LPIPS("alex", device="cpu")
    monkeypatch.setattr(ModelInterface, "lpips_test", property(lambda s: lp))
    model = _hyper()
    with torch.no_grad():
        for prm in model.parameters():
            prm.mul_(1.25)
    metrics = {}
    for kind in ("msgpack", "pth"):
        root = tmp_path / kind
        os.makedirs(root / "ckpt")
        path = str(root / "ckpt" / f"hyper.{kind}")
        if kind == "msgpack":
            _jax_checkpoint(path, model)
        else:
            torch.save({"state_dict": model.state_dict()}, path)
        checkpoint.append_ckpt_path(exp, path, str(root))
        yaml_path = root / "hyper.yaml"
        yaml_path.write_text(yaml.safe_dump(copy.deepcopy(cfg)))
        monkeypatch.chdir(root)
        assert cli.main(["test_e2vid", str(yaml_path), "--device",
                         "cpu"]) == 0
        with open(root / "tensorboard_logs" / exp / "test_metrics.txt") as f:
            metrics[kind] = {k: float(v) for k, v in (
                ln.rsplit(": ", 1) for ln in f if ln.strip())}
    assert len(metrics["pth"]) == 3           # MSE, SSIM, LPIPS
    assert metrics["msgpack"] == metrics["pth"]
    assert "Loaded checkpoint: " + str(tmp_path / "msgpack" / "ckpt" /
                                       "hyper.msgpack") in capsys.readouterr().out
