"""Web demo launcher of the port (counterpart of kalle_tpu/serve/app.py).

    python -m kalle_tpu_torch.serve.app -c cfg.yaml [-p params.npz] [--port 7860] \\
        [--http] [--device cpu]

The default UI needs gradio (a clear ImportError without it). `--http`
serves the dependency-free streaming server instead (serve/http.py): every
GET /tts?text=... rides one shared decode batch and streams a chunked wav.
Runs on the card unless --device says otherwise.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-p", "--checkpoint", default="")
    ap.add_argument("--codec-kind", default="sigma")
    ap.add_argument("--codec-config", default="")
    ap.add_argument("--codec-ckpt", default="")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--max-frames", type=int, default=200)
    ap.add_argument("--http", action="store_true",
                    help="stdlib streaming server (no gradio needed): "
                         "GET /tts?text=... streams chunked wav")
    ap.add_argument("--chunk-frames", type=int, default=25,
                    help="--http mode: frames decoded between streamed chunks")
    ap.add_argument("--serve-batch", type=int, default=8,
                    help="--http mode: rows in the shared decode batch that "
                         "concurrent requests ride")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from ..core.checkpoint import load_llasa_params
    from ..core.config import load_experiment_config
    from ..data.tokens import build_tokenizer
    from ..infer.pipeline import Codec, InferTools
    from . import http
    from .web import build_app

    exp = load_experiment_config(args.config)
    tokenizer = build_tokenizer(exp.tokenizer_path or None)
    cfg = exp.model
    params = load_llasa_params(args.checkpoint, cfg, args.device)
    if args.codec_config and args.codec_ckpt:
        codec = Codec.load(args.codec_kind, args.codec_config, args.codec_ckpt,
                           device=args.device)
    else:
        codec = Codec.random_init(args.codec_kind, device=args.device,
                                  latent_dim=cfg.latent_dim)

    if args.http:
        stream = http.make_stream_fn(params, cfg, tokenizer, codec,
                                     chunk_frames=args.chunk_frames,
                                     max_frames=args.max_frames,
                                     batch_size=args.serve_batch, device=args.device)
        srv = http.serve_http(stream, sample_rate=codec.sample_rate, port=args.port)
        print(f"streaming TTS server on :{args.port} (GET /tts?text=...)")
        try:
            srv.serve_forever()
        finally:
            srv.server_close()
            stream.service.close()
        return

    it = InferTools(cfg, params, tokenizer, codec,
                    output_root=os.path.join(tempfile.gettempdir(), "serve_out"))
    app = build_app(it, max_frames=args.max_frames)
    app.launch(server_name="0.0.0.0", server_port=args.port)


if __name__ == "__main__":
    main()
