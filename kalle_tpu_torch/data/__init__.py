"""Host-side data pipeline (numpy), copied from kalle_tpu/data."""
