"""Evaluation: the WER scorer, the CTC ASR, the speaker embedder and the
ASR / speaker-similarity harness (port of kalle_tpu/eval)."""
