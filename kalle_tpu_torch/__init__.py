"""kalle_tpu_torch — the PyTorch/CUDA port of kalle_tpu for NVIDIA Hopper.

Layout mirrors `kalle_tpu/` (core, data, ops, models/lm, models/codecs,
infer, train);
the hand-written CUDA kernels live in `csrc/` and are bound in
`ops/kernels/`. The package imports neither JAX nor `kalle_tpu`.
"""
