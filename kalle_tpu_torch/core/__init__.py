"""Port of kalle_tpu/core."""
