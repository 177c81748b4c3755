"""Trainer binary: parse configs and bindings, run train_eval_model.

    python -m tensor2robot_tpu_torch.bin.run_t2r_trainer \
        --gin_configs=path/to/config.gin \
        --gin_bindings="train_eval_model.max_train_steps = 1000"

Port of tensor2robot_tpu/bin/run_t2r_trainer.py. Trains on the card
unless bound otherwise (`train_eval_model.device = 'cpu'`).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from tensor2robot_tpu_torch.bin.cli import parse_config, parse_flags


def main(argv: Optional[Sequence[str]] = None) -> int:
    parse_config(parse_flags(__doc__.split("\n")[0], argv))
    from tensor2robot_tpu_torch import config as cfg

    cfg.get_configurable("train_eval_model")()
    return 0


if __name__ == "__main__":
    sys.exit(main())
