"""The plain reference against the program at a small size on the CPU,
where both compute in float32: one E2VID step, one ETNet step (dropout
on; apart from its AdamW's amsgrad, which the program drops), and an
ETNet eval over two windows of a sequence and a reset. Also: the
reference's modules hold the program's state_dict keys and shapes."""
import copy

import numpy as np
import pytest
import torch

from v2v_bench.reference import lpips_vgg, nets, raft_small
from v2v_bench.tests.small import CPU, eval_cell, train_cell
from v2v_bench.traffic import eval_windows, train

torch.set_num_threads(4)


def _float32_step(config):
    c = train_cell(float32=True, config=config)
    prog, rec, w, videos, seeds = train.setup(c, 2 ** 33 + 7, CPU,
                                              train.LOOKS["float32_teacher"])
    return c, rec, w, videos[:3], seeds


def _up_to_the_optimizer(got):
    assert got["sim_mismatch"] == 0
    assert got["flow_gap"] < 1e-6
    assert got["pred_gap"] < 1e-5
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-4


def test_train_step_equals_the_program_in_float32():
    c, rec, w, videos, seeds = _float32_step("e2vid")
    got = train.compare(rec, train.reference_record(c.config, w, videos,
                                                    seeds))
    _up_to_the_optimizer(got)
    assert got["change_gap"] < 1e-4


def test_etnet_step_equals_the_program_but_for_amsgrad():
    """ETNet's configuration asks AdamW for amsgrad, which the program's
    AdamW drops (training/optim.py): the departure that keeps this
    configuration out of the train cells. The program's step equals the
    reference's up to the optimizer; its parameter change equals the
    reference's without amsgrad and departs from the configuration's by
    more than rounding."""
    c, rec, w, videos, seeds = _float32_step("etnet")
    got = train.compare(rec, train.reference_record(c.config, w, videos,
                                                    seeds))
    _up_to_the_optimizer(got)
    assert got["change_gap"] > 1e-4
    cfg = copy.deepcopy(c.config)
    cfg["train"]["optimizer"]["params"]["amsgrad"] = False
    plain = train.compare(rec, train.reference_record(cfg, w, videos, seeds))
    assert plain["change_gap"] < 1e-4


def test_eval_windows_equal_the_program_across_a_window_and_a_reset():
    c = eval_cell()
    cfg, tr = c.config, c.traffic
    w = eval_windows.make_weights(cfg, 99, CPU)
    windows = eval_windows.make_windows(cfg, tr, 99, CPU)
    prog = eval_windows.Program(cfg, w, CPU)
    n, _, kept, finite, _ = eval_windows.stream(
        prog, windows, 0.0, CPU, keep=lambda s, k: k < 2, most=4)
    assert n == 4 and all(bool(f) for f in finite)
    extra = tr["compare_past_boundary"]
    pred = eval_windows.sampled(c, 99, kept, n, extra)
    assert pred is not None and pred.shape[1] == 3 + extra
    # the sampled sequence is the second, which the program had to reset
    assert np.array_equal(pred, np.concatenate(
        [kept[(1, 0)], kept[(1, 1)][:, :extra]], 1))
    ref = eval_windows.reference_frames(cfg, w, windows, extra, CPU)
    got = eval_windows.compare(pred, ref)
    assert got["pred_max_gap"] < 1e-5 and got["pred_rms_gap"] < 1e-5


@pytest.mark.parametrize("name", ["E2VIDRecurrent", "EITR"])
def test_network_keys_and_shapes_are_the_programs(name):
    from v2v_tpu_torch.config import instantiate_from_config
    params = ({"unet_kwargs": {"num_bins": 5, "skip_type": "sum",
                               "recurrent_block_type": "convlstm",
                               "num_encoders": 3, "base_num_channels": 32,
                               "num_residual_blocks": 2,
                               "use_upsample_conv": True,
                               "final_activation": "", "norm": "none"}}
              if name == "E2VIDRecurrent" else
              {"eitr_kwargs": {"num_bins": 5, "norm": "none"}})
    target = {"E2VIDRecurrent": "model.model.E2VIDRecurrent",
              "EITR": "model.eitr.eitr.EITR"}[name]
    with torch.device("meta"):
        prog = instantiate_from_config({"target": target, "params": params})
    shapes = lambda m: {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes(nets.build(name)) == shapes(prog)


def test_lpips_and_teacher_keys_are_the_programs():
    from v2v_tpu_torch.losses.lpips import _LPIPSModule
    from v2v_tpu_torch.training.raft import RAFT
    shapes = lambda m: {k: tuple(v.shape) for k, v in m.state_dict().items()}
    with torch.device("meta"):
        assert shapes(lpips_vgg.build()) == shapes(_LPIPSModule("vgg"))
        assert shapes(raft_small.build()) == shapes(RAFT(small=True))
