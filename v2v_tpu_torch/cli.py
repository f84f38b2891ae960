"""Command-line entry points of the port.

    python -m v2v_tpu_torch.cli train <config.yaml> [--device DEV]
    python -m v2v_tpu_torch.cli test_e2vid <config.yaml> [all] [--device DEV]
    python -m v2v_tpu_torch.cli test_flow <config.yaml> [all] [--device DEV]
    python -m v2v_tpu_torch.cli validate_release --assets DIR [...]
        [--device DEV]

The argv contract is the reference's train.py, test_e2vid.py and
test_flow.py (README.md:9-13): the config YAML, and for the tests an
optional second argument that means "test every checkpoint in
ckpt_paths/<experiment>.txt" instead of the last one. `validate_release`
is the release acceptance kit (eval/release.py). All run on the card;
`--device cpu` asks for the CPU (the repo-root train.py, test_e2vid.py
and test_flow.py stay the JAX drivers). The console scripts
`v2v-torch-train`, `v2v-torch-test-e2vid`, `v2v-torch-test-flow` and
`v2v-torch-validate-release` (pyproject.toml) call the functions of the
same names with sys.argv. `train` also runs a process a card under

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
         "[--device DEV]\n"
         "       python -m v2v_tpu_torch.cli validate_release --assets DIR "
         "[...] [--device DEV]")


def _argv(argv, command: str):
    """`argv` as the commands take it, [command, args...]; None means a
    console script's sys.argv."""
    return [command] + sys.argv[1:] if argv is None else argv


def train(argv=None) -> None:
    """argv = [command, config.yaml, optional --device DEV]."""
    from .config import load_yaml
    from .training.train import main
    argv = _argv(argv, "train")
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


def test_e2vid(argv=None) -> None:
    from .eval.harness import main
    _test(_argv(argv, "test_e2vid"), main)


def test_flow(argv=None) -> None:
    from .eval.flow_harness import main
    _test(_argv(argv, "test_flow"), main)


def validate_release(argv=None) -> int:
    """argv = [command, kit arguments...]: eval/release.py's main; returns
    its exit code (0 within tol, 2 acceptance failures, 1 nothing ran)."""
    from .eval.release import main
    return main(_argv(argv, "validate_release")[1:])


COMMANDS = {"train": train, "test_e2vid": test_e2vid, "test_flow": test_flow,
            "validate_release": validate_release}


def main(argv) -> int:
    if not argv or argv[0] not in COMMANDS:
        print(USAGE, file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv) or 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
