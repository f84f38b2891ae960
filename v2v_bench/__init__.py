"""The benchmark of v2v_tpu_torch, the PyTorch and CUDA port, on an
NVIDIA H100: `python3 -m v2v_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout. See cell.py for
where each cell, configuration, traffic mix and metric lives."""
