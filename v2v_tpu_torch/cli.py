"""Command-line entry points of the port.

    python -m v2v_tpu_torch.cli test_e2vid <config.yaml> [all]

The argv contract is the reference's test_e2vid.py (README.md:9-13):
the config YAML, and an optional second argument that means "test every
checkpoint in ckpt_paths/<experiment>.txt" instead of the last one. It
runs on the card (the repo-root test_e2vid.py stays the JAX driver).
"""
from __future__ import annotations

import sys


def test_e2vid(argv) -> None:
    """argv = [command, config.yaml, optional "all"]."""
    from .config import load_yaml
    from .eval.harness import main
    config_path = argv[1] if len(argv) > 1 else "configs/template.yaml"
    main(load_yaml(config_path), test_all_pths=len(argv) > 2)


if __name__ == "__main__":
    if sys.argv[1:2] != ["test_e2vid"]:
        sys.exit("usage: python -m v2v_tpu_torch.cli test_e2vid "
                 "<config.yaml> [all]")
    test_e2vid(sys.argv[1:])
