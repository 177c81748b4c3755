"""Continuous-eval binary: a standalone eval job tailing a trainer's
model_dir.

    python -m tensor2robot_tpu_torch.bin.run_continuous_eval \
        --gin_configs=path/to/config.gin \
        --gin_bindings="continuous_eval.model_dir = '/tmp/run'"

Port of tensor2robot_tpu/bin/run_continuous_eval.py, the eval half of the
learner/eval process pair. Evaluates on the card unless bound otherwise
(`continuous_eval.device = 'cpu'`).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from tensor2robot_tpu_torch.bin.cli import parse_config, parse_flags


def main(argv: Optional[Sequence[str]] = None) -> int:
    parse_config(parse_flags(__doc__.split("\n")[0], argv))
    from tensor2robot_tpu_torch import config as cfg

    cfg.get_configurable("continuous_eval")()
    return 0


if __name__ == "__main__":
    sys.exit(main())
