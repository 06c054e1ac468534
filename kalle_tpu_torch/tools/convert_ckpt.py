"""Checkpoint converter CLI of the port (counterpart of tools/convert_ckpt.py).

    reference .pt -> npz:     python -m kalle_tpu_torch.tools.convert_ckpt pt2npz in.pt out.npz -c cfg.yaml
    npz -> reference .pt:     python -m kalle_tpu_torch.tools.convert_ckpt npz2pt in.npz out.pt -c cfg.yaml
    training run -> npz:      python -m kalle_tpu_torch.tools.convert_ckpt ckpt2npz OUTPUT_DIR out.npz -c cfg.yaml

The `.npz` is `core/checkpoint.save_params_npz`'s flat layout (keys joined
with '/'), which the JAX package's `load_params_npz` reads too. The JAX
tool's third mode, `orbax2npz`, reads a JAX training run's orbax
directory; the port's trainer writes torch checkpoints
(core/checkpoint.CheckpointManager: `step_N.pt` under
`<output_dir>/torch`), so its third mode, `ckpt2npz`, reads that: the
newest step's params (or --step's). The tensors pass through --device
(default cuda) on their way, as the inference entry points load them.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["pt2npz", "npz2pt", "ckpt2npz"])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--step", type=int, default=None,
                    help="ckpt2npz: the checkpoint step (default: the newest)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from ..bridge import params_from_jax, tree_map
    from ..core.checkpoint import CheckpointManager, load_params_npz, save_params_npz
    from ..core.config import load_experiment_config
    from ..models.lm.convert import (llasa_params_from_state_dict,
                                     llasa_state_dict_from_params, load_torch_checkpoint)
    from .common import device

    dev = device(args.device)
    cfg = load_experiment_config(args.config).model
    if args.mode == "pt2npz":
        params = llasa_params_from_state_dict(load_torch_checkpoint(args.src), cfg)
        save_params_npz(args.dst, params_from_jax(params, device=dev))
    elif args.mode == "npz2pt":
        params = params_from_jax(load_params_npz(args.src), device=dev)
        torch.save(llasa_state_dict_from_params(params, cfg), args.dst)
    else:
        src = args.src
        if os.path.isdir(os.path.join(src, "torch")):  # an output_dir: its checkpoints
            src = os.path.join(src, "torch")
        payload, step = CheckpointManager(src).load(args.step)
        if payload is None:
            raise FileNotFoundError(f"no checkpoint under {src}")
        print(f"restored step {step}")
        save_params_npz(args.dst, tree_map(lambda t: t.to(dev), payload["params"]))
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
