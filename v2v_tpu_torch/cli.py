"""Command-line entry points of the port.

    python -m v2v_tpu_torch.cli train <config.yaml> [--device DEV]
    python -m v2v_tpu_torch.cli test_e2vid <config.yaml> [all] [--device DEV]
    python -m v2v_tpu_torch.cli test_flow <config.yaml> [all] [--device DEV]

The argv contract is the reference's train.py, test_e2vid.py and
test_flow.py (README.md:9-13): the config YAML, and for the tests an
optional second argument that means "test every checkpoint in
ckpt_paths/<experiment>.txt" instead of the last one. All run on the
card; `--device cpu` asks for the CPU (the repo-root train.py,
test_e2vid.py and test_flow.py stay the JAX drivers). `train` also runs a process a card under

    torchrun --nproc_per_node N -m v2v_tpu_torch.cli train <config.yaml>

(NCCL; with `--device cpu`, gloo): see training/train.py.
"""
from __future__ import annotations

import argparse
import sys

USAGE = ("usage: python -m v2v_tpu_torch.cli train <config.yaml> "
         "[--device DEV]\n"
         "       python -m v2v_tpu_torch.cli test_e2vid <config.yaml> [all] "
         "[--device DEV]\n"
         "       python -m v2v_tpu_torch.cli test_flow <config.yaml> [all] "
         "[--device DEV]")


def train(argv) -> None:
    """argv = [command, config.yaml, optional --device DEV]."""
    from .config import load_yaml
    from .training.train import main
    ap = argparse.ArgumentParser(prog="python -m v2v_tpu_torch.cli train")
    ap.add_argument("config", nargs="?", default="configs/template.yaml")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv[1:])
    main(load_yaml(args.config), device=args.device)


def _test(argv, main) -> None:
    """argv = [command, config.yaml, optional "all", optional --device
    DEV]: `main` of a harness on the config, over every checkpoint when
    the second argument is given."""
    from .config import load_yaml
    ap = argparse.ArgumentParser(prog=f"python -m v2v_tpu_torch.cli "
                                      f"{argv[0]}")
    ap.add_argument("config", nargs="?", default="configs/template.yaml")
    ap.add_argument("all", nargs="?", default=None,
                    help="any value: test every checkpoint in ckpt_paths")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv[1:])
    main(load_yaml(args.config), test_all_pths=args.all is not None,
         device=args.device)


def test_e2vid(argv) -> None:
    from .eval.harness import main
    _test(argv, main)


def test_flow(argv) -> None:
    from .eval.flow_harness import main
    _test(argv, main)


COMMANDS = {"train": train, "test_e2vid": test_e2vid, "test_flow": test_flow}


def main(argv) -> int:
    if not argv or argv[0] not in COMMANDS:
        print(USAGE, file=sys.stderr)
        return 2
    COMMANDS[argv[0]](argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
