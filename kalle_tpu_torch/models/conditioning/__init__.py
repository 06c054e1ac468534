"""Port of kalle_tpu/models/conditioning."""
