"""Collect/eval binary: parse configs and bindings, run the continuous
collect/eval loop.

    python -m tensor2robot_tpu_torch.bin.run_collect_eval \
        --root_dir=/tmp/run \
        --gin_configs=path/to/config.gin

Port of tensor2robot_tpu/bin/run_collect_eval.py.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from tensor2robot_tpu_torch.bin.cli import parse_config, parse_flags


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_flags(__doc__.split("\n")[0], argv, root_dir=True)
    parse_config(args)
    from tensor2robot_tpu_torch import config as cfg

    kwargs = {"root_dir": args.root_dir} if args.root_dir else {}
    cfg.get_configurable("collect_eval_loop")(**kwargs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
