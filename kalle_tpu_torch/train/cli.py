"""Training CLI of the port (counterpart of tools/train.py).

    python -m kalle_tpu_torch.train.cli <cfg.yaml> [--max-steps N] [--device cpu]

Reads the reference's experiment-YAML schema (kalle_tpu_torch.core.config
.load_experiment_config), copies the YAML into the experiment directory and
runs Trainer.fit on one device (the card unless --device says otherwise).
"""
from __future__ import annotations

import argparse
import os
import shutil


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from ..core.config import load_experiment_config
    from ..data.tokens import build_tokenizer
    from .trainer import Trainer

    exp = load_experiment_config(args.config)
    os.makedirs(os.path.join(exp.exp_dir, exp.project_name), exist_ok=True)
    shutil.copyfile(args.config, os.path.join(exp.exp_dir, exp.project_name, "config.yaml"))
    trainer = Trainer(exp, build_tokenizer(exp.tokenizer_path or None), device=args.device)
    print("final:", trainer.fit(max_steps=args.max_steps))


if __name__ == "__main__":
    main()
