"""The binaries' command line: the JAX binaries' flag names and forms
(`--gin_configs=...` and `--gin_bindings=...`, each repeatable), parsed
with argparse (the card's machine has no absl)."""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence


def parse_flags(description: str, argv: Optional[Sequence[str]] = None,
                root_dir: bool = False) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--gin_configs", action="append", default=[],
                        help="Paths to config files applied in order.")
    parser.add_argument("--gin_bindings", action="append", default=[],
                        help="Individual bindings applied after config files.")
    if root_dir:
        parser.add_argument("--root_dir", default=None,
                            help="Experiment root directory.")
    return parser.parse_args(argv)


def parse_config(args: argparse.Namespace) -> None:
    """Logs at INFO (as the JAX binaries' absl does), registers the
    framework surface, then applies the configs and the bindings."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    import tensor2robot_tpu_torch.config.defaults  # noqa: F401
    from tensor2robot_tpu_torch import config as cfg

    cfg.parse_config_files_and_bindings(args.gin_configs, args.gin_bindings)
