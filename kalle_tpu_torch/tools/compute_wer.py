"""WER scorer CLI (counterpart of tools/compute_wer.py, a drop-in for the
reference's tools/compute-wer.py):

    python -m kalle_tpu_torch.tools.compute_wer --char=1 --v=1 gt.txt asr.txt > wer.txt

Runs on the host only (eval/wer.py; the alignment in the native library)."""
import sys

from ..eval.wer import main

if __name__ == "__main__":
    sys.exit(main())
