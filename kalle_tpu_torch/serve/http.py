"""Dependency-free streaming TTS HTTP server (port of
kalle_tpu/serve/http.py).

Every request shares ONE persistent ContinuousBatcher on a background
decode thread (serve/service.BatcherService): concurrent /tts clients ride
the same decode batch with admission mid-decode. A response streams the
wav: the unbounded-size chunk header (serve/web.wav_chunk_header) first,
then PCM chunks as the LM decodes.

Endpoints:
  GET /            minimal HTML demo page (form + <audio>)
  GET /tts?text=…  chunked audio/wav stream
  GET /healthz     liveness probe

Each codec chunk is decoded again with `stream_ctx` frames of left context,
so the convolutions' receptive fields span chunk boundaries. A stalled
client stalls only its own handler thread (60 s socket timeout); decoding
for the other rows goes on. Codec decodes run on the handler threads,
beside the decode thread, on the same card.
"""
from __future__ import annotations

import json
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterator

import numpy as np

from ..data.tokens import build_prompt_ids
from .service import BatcherService
from .web import normalize_text, wav_chunk_header

_PAGE = """<!doctype html>
<html><head><title>kalle_tpu TTS</title></head>
<body style="font-family: sans-serif; max-width: 40em; margin: 2em auto">
<h1>kalle_tpu &mdash; streaming TTS</h1>
<form onsubmit="p.src='/tts?text='+encodeURIComponent(t.value);p.play();return false">
<input id="t" size="60" placeholder="Text to synthesize">
<button>Synthesize</button></form>
<audio id="p" controls autoplay></audio>
</body></html>"""


def make_stream_fn(params, cfg, tokenizer, codec, chunk_frames: int = 25,
                   max_frames: int = 200, stream_ctx: int = 8,
                   greedy: bool = False, batch_size: int = 8,
                   service=None, device="cuda") -> Callable[[str], Iterator[bytes]]:
    """text -> iterator of int16 PCM chunks (LM decode and codec decode
    both incremental). Every call shares ONE BatcherService decode batch
    (built on `device` unless `service` is given), exposed as
    `stream.service`: callers close() it on shutdown."""
    svc = service or BatcherService(params, cfg, batch_size=batch_size,
                                    max_frames=max_frames, chunk_frames=chunk_frames,
                                    greedy=greedy, device=device)
    spf = codec.samples_per_frame
    sigma = cfg.head_variant == "sigma"

    def stream(text: str) -> Iterator[bytes]:
        ids = np.asarray(build_prompt_ids(tokenizer, normalize_text(text)), np.int64)
        _, q = svc.submit(ids)
        buf = np.zeros((0, cfg.latent_dim), np.float32)
        while True:
            ev = q.get()
            if ev is None:
                break
            kind, payload = ev
            if kind == "error":
                raise payload
            if kind != "chunk":
                continue  # "done": its frames came as chunks
            buf = np.concatenate([buf, payload.samples if sigma else payload.means])
            lo = max(0, payload.start_frame - stream_ctx)
            audio = codec.decode_latents(buf[None, lo:])
            new = audio[0, 0, (payload.start_frame - lo) * spf:]
            yield (np.clip(new, -1, 1) * 32767).astype("<i2").tobytes()

    stream.service = svc
    return stream


class _Handler(BaseHTTPRequestHandler):
    # class attributes set by serve_http
    stream_fn: Callable[[str], Iterator[bytes]] = None
    sample_rate: int = 24000
    # a dead client's blocked write raises instead of pinning its handler
    # thread (the shared batcher decodes on its own thread regardless)
    timeout = 60

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, ctype: str, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API name)
        url = urllib.parse.urlparse(self.path)
        if url.path == "/":
            return self._send(200, "text/html; charset=utf-8", _PAGE.encode())
        if url.path == "/healthz":
            return self._send(200, "application/json", json.dumps({"ok": True}).encode())
        if url.path != "/tts":
            return self._send(404, "text/plain", b"not found")
        text = urllib.parse.parse_qs(url.query).get("text", [""])[0]
        if not text.strip():
            return self._send(400, "text/plain", b"missing ?text=")
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Cache-Control", "no-store")
        self.end_headers()  # no Content-Length: stream until close
        try:
            self.wfile.write(wav_chunk_header(self.sample_rate))
            self.wfile.flush()
            for pcm in self.stream_fn(text):
                self.wfile.write(pcm)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            pass  # the client hung up or stalled: its loss alone


def serve_http(stream_fn: Callable[[str], Iterator[bytes]], sample_rate: int = 24000,
               host: str = "0.0.0.0", port: int = 7860) -> ThreadingHTTPServer:
    """Build the server; the caller runs .serve_forever() (tests bind port 0
    and serve from a daemon thread)."""
    handler = type("Handler", (_Handler,), {"stream_fn": staticmethod(stream_fn),
                                            "sample_rate": sample_rate})
    return ThreadingHTTPServer((host, port), handler)
