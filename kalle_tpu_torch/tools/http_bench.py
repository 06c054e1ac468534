"""Open-loop Poisson benchmark through the port's HTTP layer (counterpart
of tools/http_bench.py): arrivals fired as real GET /tts requests against
a live serve/http.serve_http server over make_stream_fn (every request a
row of one shared BatcherService decode batch), reporting p50/p95 time to
first audio (the first PCM byte after the streaming wav header) and
end-to-end seconds per rate. A client that fails is counted in "errors".

    python -m kalle_tpu_torch.tools.http_bench --tiny --device cpu --rates 4 --requests 4
    python -m kalle_tpu_torch.tools.http_bench --rates 2,5 --requests 32   (the card)

Full width is latency_bench's: the flagship in bf16 and the default
SigmaVAE in bf16 (K1's sideband mode in the decode, K4 in every chunk's
codec decode). The server binds 127.0.0.1 on a free port and is shut down
before `main` returns. Prints one JSON line per rate with the JAX tool's
keys; `main` returns them, each with "bodies": every request's response
bytes (header included) in request order, or None where it failed, and,
counted from the start (the warm-up request included), the batcher's
decode steps ("decode_steps") and the PCM chunks served ("chunks": one
codec decode each), for callers that check the kernels' launch counts.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import threading
import time
import urllib.parse
import urllib.request

import numpy as np


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rates", default="2.0", help="comma-separated arrival rates (req/s)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--serve-batch", type=int, default=8)
    ap.add_argument("--chunk-frames", type=int, default=8)
    ap.add_argument("--max-frames", type=int, default=64)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from ..data.tokens import build_tokenizer
    from ..serve.http import make_stream_fn, serve_http
    from ..serve.web import wav_chunk_header
    from .common import device, pct
    from .latency_bench import build

    dev = device(args.device)
    cfg, params, codec = build(args.tiny, dev)
    cfg = dataclasses.replace(cfg, end_kl_threshold=-1.0)
    tok = build_tokenizer(None)
    stream = make_stream_fn(params, cfg, tok, codec, chunk_frames=args.chunk_frames,
                            max_frames=args.max_frames, batch_size=args.serve_batch,
                            greedy=True, device=dev)
    chunks, lock = [0], threading.Lock()

    def counted(text):
        for pcm in stream(text):
            with lock:
                chunks[0] += 1
            yield pcm

    srv = serve_http(counted, sample_rate=codec.sample_rate, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    hdr_len = len(wav_chunk_header(codec.sample_rate))
    texts = [f"utterance number {i} with some extra words " * (1 + i % 3)
             for i in range(args.requests)]
    out = []
    try:
        # warm-up through the whole stack
        urllib.request.urlopen(base + "/tts?text=warmup+request", timeout=1200).read()
        rng = np.random.default_rng(0)
        for rate in (float(r) for r in args.rates.split(",")):
            arrivals = np.cumsum(rng.exponential(1.0 / rate, args.requests)).tolist()
            ttfa, e2e, errs = {}, {}, []
            bodies = [None] * args.requests
            t0 = time.perf_counter()

            def client(i):
                try:
                    delay = arrivals[i] - (time.perf_counter() - t0)
                    if delay > 0:
                        time.sleep(delay)
                    with urllib.request.urlopen(
                            base + "/tts?text=" + urllib.parse.quote(texts[i]),
                            timeout=1200) as resp:
                        got = b""
                        while len(got) <= hdr_len:  # the first PCM byte after the header
                            chunk = resp.read(hdr_len + 1 - len(got))
                            if not chunk:
                                break
                            got += chunk
                        ttfa[i] = time.perf_counter() - t0 - arrivals[i]
                        parts = [got]
                        while True:
                            chunk = resp.read(65536)
                            if not chunk:
                                break
                            parts.append(chunk)
                    e2e[i] = time.perf_counter() - t0 - arrivals[i]
                    bodies[i] = b"".join(parts)
                except Exception as e:  # noqa: BLE001 — a failed client is counted
                    errs.append((i, repr(e)))

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(args.requests)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            line = {"metric": "http_poisson_slo", "rate_req_s": rate,
                    "batch": args.serve_batch, "requests": args.requests,
                    "errors": len(errs), "wall_s": round(wall, 2),
                    "p50_ttfa_s": pct(ttfa.values(), 0.5),
                    "p95_ttfa_s": pct(ttfa.values(), 0.95),
                    "p50_e2e_s": pct(e2e.values(), 0.5),
                    "p95_e2e_s": pct(e2e.values(), 0.95),
                    "chunk_frames": args.chunk_frames}
            print(json.dumps(line), flush=True)
            if errs:
                print(f"# errors: {errs[:3]}", file=sys.stderr)
            out.append({**line, "bodies": bodies, "decode_steps": stream.service.cb.step_count,
                        "chunks": chunks[0]})
    finally:
        srv.shutdown()
        srv.server_close()
        stream.service.close()
    return out


if __name__ == "__main__":
    main()
