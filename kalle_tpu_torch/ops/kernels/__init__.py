"""Port of kalle_tpu/ops/kernels."""
