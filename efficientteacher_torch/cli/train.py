"""Training CLI (counterpart of the root `train.py`; reference
train.py:31-84).

    python -m efficientteacher_torch.cli.train --cfg <yaml> [key value ...]

Reads the YAML without PyYAML (`configs/yaml_lite.py`), applies the dotted
overrides (strings parsed as YAML), and runs `SSODTrainer` when
`SSOD.train_domain` is set, else `Trainer`. It trains on the CUDA card
unless the override `device cpu` is given. A YAML trains as it is
written: the host augments (`Dataset.device_aug False`, the default), or
the card does under `Dataset.device_aug True`. Returns the best fitness.

DDP: launched by torchrun, each process joins the group its environment
describes (`parallel/distributed.maybe_initialize`: nccl, one card per
rank, `cuda:LOCAL_RANK`; gloo with `device cpu`), trains on its share of
the global `Dataset.batch_size`, and rank 0 alone logs, validates and
saves:

    torchrun --nproc_per_node 4 -m efficientteacher_torch.cli.train \
        --cfg <yaml> [key value ...]
"""

from __future__ import annotations

import argparse
import logging

from ..parallel.distributed import (is_main_process, maybe_initialize,
                                    shutdown)
from . import compute_dtype, resolve_device


def parse_opt(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m efficientteacher_torch.cli.train")
    parser.add_argument("--cfg", type=str, required=True, help="config YAML")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="dotted-path config overrides: key value ...")
    return parser.parse_args(argv)


def main(argv=None) -> float:
    opt = parse_opt(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from ..configs import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(opt.cfg)
    if opt.opts:
        cfg.merge_from_list(opt.opts)
    cfg.freeze()
    device = maybe_initialize(resolve_device(cfg.device))
    if not is_main_process():
        logging.getLogger().setLevel(logging.WARNING)  # rank 0 logs
    if cfg.SSOD.train_domain:
        from ..train.ssod_trainer import SSODTrainer as cls
    else:
        from ..train.trainer import Trainer as cls
    try:
        trainer = cls(cfg, compute_dtype=compute_dtype(device),
                      device=device)
        return trainer.train()
    finally:
        shutdown()


if __name__ == "__main__":
    main()
