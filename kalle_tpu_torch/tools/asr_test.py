"""ASR transcription harness CLI of the port (counterpart of
tools/asr_test.py).

    python -m kalle_tpu_torch.tools.asr_test en WAV_DIR --meta meta.lst

Transcribes each meta.lst row's `{utt}---gen.wav` (else `{utt}.wav`) into
WAV_DIR/aaa_gt.txt and aaa_asr.txt (eval/harness.run_asr), to be scored
with `python -m kalle_tpu_torch.tools.compute_wer`. The reference's
Whisper (en) and Paraformer (zh) back-ends need downloaded weights, which
the port does not load: from the command line the tool reports that and
exits 1 (the JAX tool does the same without local weights). Callers pass
a transcriber (wav path -> text, e.g. eval.ctc_asr.make_ctc_transcriber)
to `main(argv, transcriber=...)`. Host-side file work; the transcriber
runs where its weights are.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional


def main(argv=None, transcriber: Optional[Callable[[str], str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("lang", choices=["en", "zh"])
    ap.add_argument("wav_dir")
    ap.add_argument("--meta", required=True,
                    help="meta.lst: utt|prompt_text|prompt_wav|target_text")
    ap.add_argument("--model", default="openai/whisper-large-v3",
                    help="local ASR model path (the reference's back-ends; not loaded "
                         "by the port)")
    args = ap.parse_args(argv)

    from ..eval.harness import make_transcriber, read_meta_lst, run_asr

    meta = read_meta_lst(args.meta)
    if transcriber is None:
        try:
            transcriber = make_transcriber(args.lang, model=args.model)
        except ValueError as e:
            print(f"ERROR: could not load ASR model '{args.model}': {e}", file=sys.stderr)
            return 1
    gt, hyp = run_asr(args.lang, args.wav_dir, meta, transcriber)
    print(f"wrote {gt} and {hyp}; score with python -m kalle_tpu_torch.tools.compute_wer "
          f"--char={'1' if args.lang == 'zh' else '0'} --v=1 {gt} {hyp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
