"""Port of kalle_tpu/models/codecs."""
