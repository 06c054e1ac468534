"""Port of kalle_tpu/infer."""
