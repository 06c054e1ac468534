"""The port's BatcherService and streaming HTTP server on the CPU, tiny
config: concurrent requests share one decode batch and stream exactly
run()'s frames (rtol 2e-3 / atol 2e-4 against the JAX batcher, as
tests/test_service.py), decode errors reach every waiting request, and
serve_http on port 0 streams a wav header and (max_frames - 1) *
samples_per_frame 16-bit samples per request, the same PCM as the JAX
package's server to within 2 of 32767 (f32 audio rounded to int16)."""
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kalle_tpu.core.config import LlamaConfig as JLlamaConfig
from kalle_tpu.core.config import LlasaConfig as JLlasaConfig
from kalle_tpu.data.tokens import build_tokenizer as jbuild_tokenizer
from kalle_tpu.infer.pipeline import Codec as JCodec
from kalle_tpu.infer.serve_loop import ContinuousBatcher as JBatcher
from kalle_tpu.models.codecs.sigmavae import SigmaVAEConfig as JSigmaVAEConfig
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu.serve.http import make_stream_fn as jmake_stream_fn
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
from kalle_tpu_torch.data.tokens import build_tokenizer
from kalle_tpu_torch.infer.pipeline import Codec
from kalle_tpu_torch.infer.serve_loop import ContinuousBatcher
from kalle_tpu_torch.models.codecs.sigmavae import SigmaVAEConfig
from kalle_tpu_torch.serve import web
from kalle_tpu_torch.serve.http import make_stream_fn, serve_http
from kalle_tpu_torch.serve.service import BatcherService

MAXF = 8
TOL = dict(rtol=2e-3, atol=2e-4)
KW = dict(batch_size=2, max_frames=MAXF, prompt_buckets=(8, 16), greedy=True)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = JLlasaConfig(llama=JLlamaConfig.tiny(vocab_size=300), latent_dim=8,
                        audio_proj_dim=64, head_variant="stableaudio", end_kl_threshold=-1.0)
    tcfg = LlasaConfig(llama=LlamaConfig.tiny(vocab_size=300), latent_dim=8,
                       audio_proj_dim=64, head_variant="stableaudio", end_kl_threshold=-1.0)
    jp = jllasa.init_params(jcfg, jax.random.key(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 300, (n,)).astype(np.int32) for n in (5, 11, 7)]
    ref = {c.index: c for c in JBatcher(jp, jcfg, **KW).run(prompts)}
    return tcfg, tp, prompts, ref


def _drain(q):
    chunks, done = [], None
    while True:
        ev = q.get(timeout=120)
        if ev is None:
            return chunks, done
        kind, payload = ev
        if kind == "error":
            raise payload
        if kind == "chunk":
            chunks.append(payload)
        else:
            done = payload


def test_three_concurrent_submits_match_run(setup):
    """Three prompts on two rows from three threads at once: each stream's
    chunks join to run()'s completion (the port's, and JAX's), and the
    third request waits for a free row."""
    tcfg, tp, prompts, ref = setup
    run = {c.index: c for c in ContinuousBatcher(tp, tcfg, device="cpu", **KW).run(prompts)}
    svc = BatcherService(tp, tcfg, chunk_frames=2, device="cpu", **KW)
    results, errs = {}, []

    def client(i):
        try:
            _, q = svc.submit(prompts[i])
            results[i] = _drain(q)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errs, errs
        assert not any(t.is_alive() for t in threads)
        assert svc.cb.step_count <= 2 * MAXF + 4
        for i in range(3):
            chunks, done = results[i]
            assert done is not None and done.n_frames == MAXF - 1
            assert chunks[-1].final
            got = np.concatenate([c.means for c in chunks])
            np.testing.assert_array_equal(got, run[i].means)
            np.testing.assert_allclose(got, ref[i].means, **TOL)
    finally:
        svc.close()


def test_two_requests_share_one_batch(setup):
    """Two requests submitted together decode at the same time: the steps
    taken are about one generation's, not two in a row."""
    tcfg, tp, prompts, _ = setup
    svc = BatcherService(tp, tcfg, chunk_frames=2, device="cpu", **KW)
    try:
        qs = [svc.submit(p)[1] for p in prompts[:2]]
        for q in qs:
            chunks, done = _drain(q)
            assert sum(len(c.means) for c in chunks) == done.n_frames == MAXF - 1
        assert svc.cb.step_count <= MAXF + 4, svc.cb.step_count
    finally:
        svc.close()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_decode_error_reaches_every_waiter(setup):
    """An exception on the decode thread is sent to every request waiting,
    admitted or queued, followed by the closing None; the thread then
    re-raises it, as the JAX service does."""
    tcfg, tp, prompts, _ = setup
    svc = BatcherService(tp, tcfg, chunk_frames=2, device="cpu", **KW)
    boom = RuntimeError("decode failed")

    def fail(max_steps):
        raise boom

    svc.cb._step = fail
    try:
        qs = [svc.submit(p)[1] for p in prompts]
        for q in qs:
            assert q.get(timeout=60) == ("error", boom)
            assert q.get(timeout=60) is None
        svc._thread.join(timeout=30)
        assert not svc._thread.is_alive()
    finally:
        svc.close()


def test_close_releases_waiters(setup):
    tcfg, tp, _, _ = setup
    svc = BatcherService(tp, tcfg, chunk_frames=2, device="cpu", **KW)
    svc.close()
    assert not svc._thread.is_alive()
    with pytest.raises(RuntimeError):
        svc.submit(np.ones((4,), np.int32))


def _start(stream_fn, sr=24000):
    srv = serve_http(stream_fn, sample_rate=sr, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def test_http_surface_with_fake_stream():
    chunks = [np.full(100, 1000, "<i2").tobytes(), np.full(50, -2000, "<i2").tobytes()]
    srv, base = _start(lambda text: iter(chunks))
    try:
        assert b"/tts" in urllib.request.urlopen(base + "/", timeout=10).read()
        assert b"true" in urllib.request.urlopen(base + "/healthz", timeout=10).read()
        body = urllib.request.urlopen(base + "/tts?text=hi", timeout=10).read()
        hdr = web.wav_chunk_header(24000)
        assert body == hdr + b"".join(chunks)
        for path, code in (("/tts", 400), ("/nope", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + path, timeout=10)
            assert e.value.code == code
    finally:
        srv.shutdown()
        srv.server_close()


def test_web_helpers_match_jax():
    from kalle_tpu.serve import web as jweb

    for sr in (24000, 16000):
        assert web.wav_chunk_header(sr) == jweb.wav_chunk_header(sr)
    assert web.normalize_text("  a \t b\n c ") == jweb.normalize_text("  a \t b\n c ") == "a b c"


@pytest.fixture(scope="module")
def tiny_tts():
    """The sigma head and the tiny SigmaVAE, JAX params and their port."""
    jcodec = JCodec.random_init("sigma", cfg=JSigmaVAEConfig.tiny())
    codec = Codec("sigma", SigmaVAEConfig.tiny(),
                  bridge.params_from_jax(jax.tree.map(np.asarray, jcodec.params), device="cpu"))
    jcfg = JLlasaConfig(llama=JLlamaConfig.tiny(), latent_dim=8, audio_proj_dim=64,
                        head_variant="sigma", end_kl_threshold=-1.0)
    tcfg = LlasaConfig(llama=LlamaConfig.tiny(), latent_dim=8, audio_proj_dim=64,
                       head_variant="sigma", end_kl_threshold=-1.0)
    jp = jllasa.init_params(jcfg, jax.random.key(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, jcodec, tcfg, tp, codec


def test_serve_http_streams_the_exact_pcm(tiny_tts):
    """Two concurrent /tts clients on the real service: each body is the
    wav header and exactly (max_frames - 1) * samples_per_frame int16
    samples; the PCM is the JAX server's for the same text; both requests
    shared the batch."""
    jcfg, jp, jcodec, tcfg, tp, codec = tiny_tts
    maxf = 6
    kw = dict(chunk_frames=2, max_frames=maxf, greedy=True, batch_size=2)
    stream = make_stream_fn(tp, tcfg, build_tokenizer(), codec, device="cpu", **kw)
    srv, base = _start(stream)
    bodies, errs = {}, []

    def client(i):
        try:
            bodies[i] = urllib.request.urlopen(base + f"/tts?text=request+{i}",
                                               timeout=300).read()
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errs, errs
        hdr = web.wav_chunk_header(24000)
        pcm = {}
        for i in range(2):
            assert bodies[i][:len(hdr)] == hdr
            pcm[i] = np.frombuffer(bodies[i][len(hdr):], "<i2")
            assert len(pcm[i]) == (maxf - 1) * codec.samples_per_frame
        assert stream.service.cb.step_count <= maxf + 4
    finally:
        srv.shutdown()
        srv.server_close()
        stream.service.close()

    jstream = jmake_stream_fn(jp, jcfg, jbuild_tokenizer(None), jcodec, **kw)
    try:
        ref = np.frombuffer(b"".join(jstream("request 1")), "<i2")
    finally:
        jstream.service.close()
    assert np.abs(pcm[1].astype(np.int32) - ref.astype(np.int32)).max() <= 2


def test_stream_fn_reuses_its_service(tiny_tts):
    *_, tcfg, tp, codec = tiny_tts
    stream = make_stream_fn(tp, tcfg, build_tokenizer(), codec, chunk_frames=2,
                            max_frames=5, greedy=True, batch_size=1, device="cpu")
    try:
        for text in ("hello world", "another"):
            chunks = list(stream(text))
            assert len(chunks) >= 2  # incremental, not one blob
            assert sum(len(c) for c in chunks) == 2 * 4 * codec.samples_per_frame
        assert stream.service.cb.step_count >= 2 * 5
    finally:
        stream.service.close()


def test_entry_points_default_to_the_card():
    """Without device=, the batcher, the service and the stream function
    put their state on the CUDA card."""
    import inspect

    for fn in (ContinuousBatcher.__init__, BatcherService.__init__, make_stream_fn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
