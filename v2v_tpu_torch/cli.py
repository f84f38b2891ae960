"""Command-line entry points of the port.

    python -m v2v_tpu_torch.cli train <config.yaml> [--device DEV]
    python -m v2v_tpu_torch.cli test_e2vid <config.yaml> [all]

The argv contract is the reference's train.py and test_e2vid.py
(README.md:9-13): the config YAML, and for test_e2vid an optional second
argument that means "test every checkpoint in ckpt_paths/<experiment>.txt"
instead of the last one. Both run on the card; `train --device cpu` asks
for the CPU (the repo-root train.py and test_e2vid.py stay the JAX
drivers).
"""
from __future__ import annotations

import argparse
import sys

USAGE = ("usage: python -m v2v_tpu_torch.cli train <config.yaml> "
         "[--device DEV]\n"
         "       python -m v2v_tpu_torch.cli test_e2vid <config.yaml> [all]")


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


def test_e2vid(argv) -> None:
    """argv = [command, config.yaml, optional "all"]."""
    from .config import load_yaml
    from .eval.harness import main
    config_path = argv[1] if len(argv) > 1 else "configs/template.yaml"
    main(load_yaml(config_path), test_all_pths=len(argv) > 2)


COMMANDS = {"train": train, "test_e2vid": test_e2vid}


def main(argv) -> int:
    if not argv or argv[0] not in COMMANDS:
        print(USAGE, file=sys.stderr)
        return 2
    COMMANDS[argv[0]](argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
