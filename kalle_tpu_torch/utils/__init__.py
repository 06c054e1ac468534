"""Port of kalle_tpu/utils."""
