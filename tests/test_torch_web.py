"""Tokenizer chat prompts and the web demo of the port: the byte and HF
tokenizers' chat prompt ids, decode and special-token encoding against the
JAX package's (the HF tokenizer built in code, nothing downloaded); the
web helpers' contracts, as tests/test_web_demo.py pins the JAX ones
(gradio stubbed through the import hook, `sys.modules` untouched); a
16 kHz int16 voice prompt through `make_synthesize_fn`; and the launcher
`serve.app.main` with the server and the app stubbed."""
import builtins
import io
import json
import types
import wave
from dataclasses import astuple

import numpy as np
import pytest
import torch

from kalle_tpu.data import tokens as jtokens
from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
from kalle_tpu_torch.data import tokens
from kalle_tpu_torch.infer.pipeline import Codec, InferTools
from kalle_tpu_torch.models.codecs import sigmavae
from kalle_tpu_torch.models.lm import llasa
from kalle_tpu_torch.serve import app, http, web

TEXTS = ["hi", "a dog barking in the distance", "ünïcödé ✓", ""]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ tokenizers


@pytest.mark.parametrize("text", TEXTS)
def test_byte_tokenizer_matches_jax(text):
    tok, jtok = tokens.ByteTokenizer(), jtokens.ByteTokenizer()
    assert len(tok) == len(jtok)
    assert tokens.build_chat_prompt_ids(tok, text) == jtokens.build_chat_prompt_ids(jtok, text)
    assert tokens.build_chat_messages(text) == jtokens.build_chat_messages(text)
    marked = "<|SPEECH_GENERATION_START|>" + text + "<|eot_id|><|TEXT_GENERATION_END|>"
    assert tok.encode_with_specials(marked) == jtok.encode_with_specials(marked)
    ids = tok.encode_with_specials(marked)
    assert tok.decode(ids) == jtok.decode(ids) == text + "<|eot_id|>"
    for t in tokens.SPECIAL_TOKENS:
        assert tok.convert_tokens_to_ids(t) == jtok.convert_tokens_to_ids(t)


def _hf_dir(path, template: bool):
    transformers = pytest.importorskip("transformers")
    vocab = {chr(c): i for i, c in enumerate(range(32, 127))}
    vocab["<|endoftext|>"] = len(vocab)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n")
    tok = transformers.GPT2Tokenizer.from_pretrained(str(path))
    if template:
        tok.chat_template = "{% for m in messages %}[{{ m.role }}]{{ m.content }}{% endfor %}"
    tok.save_pretrained(str(path))
    return str(path)


@pytest.mark.parametrize("template", [True, False], ids=["template", "llama3_render"])
def test_hf_tokenizer_matches_jax(tmp_path, template):
    path = _hf_dir(tmp_path, template)
    tok, jtok = tokens.HFTokenizer(path), jtokens.HFTokenizer(path)
    assert len(tok) == len(jtok) and astuple(tok.special) == astuple(jtok.special)
    ids = tokens.build_chat_prompt_ids(tok, "hey there")
    assert ids == jtokens.build_chat_prompt_ids(jtok, "hey there")
    assert tok.special.speech_generation_start in ids
    if template:
        assert ids == list(tok.tok.apply_chat_template(tokens.build_chat_messages("hey there"),
                                                       tokenize=True))
    assert tok.decode(tok.encode("hey")) == jtok.decode(jtok.encode("hey"))
    for t in tokens.SPECIAL_TOKENS:
        assert tok.convert_tokens_to_ids(t) == jtok.convert_tokens_to_ids(t)


# ------------------------------------------------------------ web helpers


class _Ctx:
    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Component:
    def __init__(self, *a, **k):
        self.kwargs = k


class _Button(_Component):
    def click(self, fn, inputs, outputs):
        self.clicks.append((fn, inputs, outputs))


def _gradio_stub(clicks):
    gr = types.SimpleNamespace(Blocks=_Ctx, Row=_Ctx, Column=_Ctx, Markdown=_Component,
                               Audio=_Component, Textbox=_Component, Checkbox=_Component,
                               Text=_Component)
    gr.Button = type("Button", (_Button,), {"clicks": clicks})
    return gr


def _import_gradio_as(monkeypatch, module):
    """Route `import gradio` to `module` (None: ImportError) in the import
    hook, leaving sys.modules alone."""
    real = builtins.__import__

    def fake(name, *a, **k):
        if name == "gradio":
            if module is None:
                raise ImportError("No module named 'gradio'")
            return module
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", fake)


class _FakeCodec:
    kind = "sigma"
    sample_rate = 16000

    def encode_audio(self, wav):
        w = np.asarray(wav)[0]  # (1, T) of the (B, 1, T) input
        t = max(w.shape[-1] // 100, 1)
        means = w[0, : t * 100].reshape(t, 100).mean(-1, keepdims=True)
        return (means * np.ones((1, 4)))[None]  # (B, T, d), the sigma layout


class _FakeTools:
    codec = _FakeCodec()
    cfg = types.SimpleNamespace(latent_dim=4)

    def __init__(self, fail=False):
        self.fail = fail
        self.calls = []

    def synthesize(self, text, max_frames=200, prompt_latents=None):
        if self.fail:
            raise RuntimeError("decode exploded")
        self.calls.append((text, max_frames,
                           None if prompt_latents is None else np.asarray(prompt_latents).shape))
        return np.zeros((1, 1600), np.float32)


def test_build_app_wires_the_safe_fn(monkeypatch):
    clicks = []
    _import_gradio_as(monkeypatch, _gradio_stub(clicks))
    assert web.build_app(_FakeTools(), max_frames=64) is not None
    assert len(clicks) == 1
    fn, inputs, outputs = clicks[0]
    assert len(inputs) == 4 and len(outputs) == 2
    (sr, wav), err = fn(None, "", "hello world", False)
    assert sr == 16000 and wav.dtype == np.int16 and err == "no error"


def test_build_app_without_gradio_raises(monkeypatch):
    _import_gradio_as(monkeypatch, None)
    with pytest.raises(ImportError, match="gradio"):
        web.build_app(_FakeTools())


def test_safe_synthesize_error_contract():
    out, err = web.make_safe_synthesize_fn(_FakeTools(fail=True))(None, "", "hello", False)
    assert out is None and err.startswith("error:") and "decode exploded" in err
    out, err = web.make_safe_synthesize_fn(_FakeTools())(None, "", "   ", False)
    assert out is None and err.startswith("error:")
    tools = _FakeTools()
    ref = (8000, (np.sin(np.arange(8000) / 20.0) * 32767).astype(np.int16))
    (sr, wav), err = web.make_safe_synthesize_fn(tools, max_frames=32)(ref, "ref", "say  this",
                                                                        True)
    # 8 kHz -> the codec's 16 kHz: 16000 samples, one fake frame a 100
    assert err == "no error" and tools.calls[-1] == ("say this", 32, (160, 4))


def test_html_error_message_escapes():
    msg = web.build_html_error_message("<script>alert(1)</script> & x")
    assert "<script>" not in msg and "&lt;script&gt;" in msg and "&amp;" in msg
    assert "color: red" in msg


def _wav_bytes(sr=16000, n=1600):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.zeros(n, np.int16).tobytes())
    return buf.getvalue()


def test_check_audio_validity_good_and_bad():
    assert web.check_audio_validity(_wav_bytes()) is True
    assert web.check_audio_validity(b"not audio at all") is False
    assert web.check_audio_validity(_wav_bytes()[:16]) is False  # truncated header


# ------------------------------------------------- a real voice prompt


@pytest.fixture(scope="module")
def tiny_tools(tmp_path_factory):
    tok = tokens.ByteTokenizer()
    cfg = LlasaConfig(llama=LlamaConfig.tiny(vocab_size=len(tok)), latent_dim=8,
                      audio_proj_dim=64)
    params = llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    codec = Codec.random_init("sigma", device="cpu", cfg=sigmavae.SigmaVAEConfig.tiny())
    return InferTools(cfg, params, tok, codec, output_root=str(tmp_path_factory.mktemp("o")),
                      timestamp=False)


@pytest.mark.parametrize("n", [1000, 1603])
def test_voice_prompt_frames(tiny_tools, monkeypatch, n):
    """int16 audio at 16 kHz -> resampled to 24 kHz -> encoded: the prompt
    has floor(n * 24000 / 16000 / hop) frames of the latent width."""
    seen = []
    real = tiny_tools.synthesize

    def spy(text, max_frames=200, prompt_latents=None):
        seen.append(prompt_latents.shape)
        return real(text, max_frames=max_frames, prompt_latents=prompt_latents)

    monkeypatch.setattr(tiny_tools, "synthesize", spy)
    ref = (16000, (np.sin(np.arange(n) / 7.0) * 20000).astype(np.int16))
    sr, wav = web.make_synthesize_fn(tiny_tools, max_frames=4)(ref, "", "speak", True)
    hop = tiny_tools.codec.samples_per_frame
    assert seen == [(int(round(n * 24000 / 16000)) // hop, 8)]
    assert seen[0][0] == (n * 24000 // 16000) // hop
    assert sr == 24000 and wav.dtype == np.int16 and wav.shape == (3 * hop,)


# ------------------------------------------------------------ launcher


@pytest.fixture
def tiny_yaml(tmp_path):
    p = tmp_path / "tiny.yaml"
    p.write_text("project_name: tiny\nmodel:\n  latent_dim: 8\n  audio_proj_dim: 64\n"
                 "  llama: {vocab_size: 265, hidden_size: 64, intermediate_size: 128, "
                 "num_layers: 2, num_heads: 4, num_kv_heads: 2, head_dim: 16, "
                 "max_seq_len: 128, dtype: float32}\n")
    return str(p)


class _Server:
    def __init__(self):
        self.served = self.closed = False

    def serve_forever(self):
        self.served = True

    def server_close(self):
        self.closed = True


def test_app_http_mode(tiny_yaml, monkeypatch, capsys):
    calls = []

    def fake_serve_http(stream, sample_rate=24000, host="0.0.0.0", port=7860):
        calls.append((stream, sample_rate, port, _Server()))
        return calls[-1][3]

    monkeypatch.setattr(http, "serve_http", fake_serve_http)
    app.main(["-c", tiny_yaml, "--http", "--port", "0", "--max-frames", "8",
              "--serve-batch", "2", "--device", "cpu"])
    (stream, sr, port, srv), = calls
    assert sr == 24000 and port == 0 and srv.served and srv.closed
    assert stream.service.cb.B == 2
    assert not stream.service._thread.is_alive()  # closed on the way out
    assert "streaming TTS server on :0" in capsys.readouterr().out


def test_app_demo_mode(tiny_yaml, monkeypatch):
    built = []

    class _App:
        def launch(self, server_name, server_port):
            built.append((server_name, server_port))

    monkeypatch.setattr(web, "build_app", lambda it, max_frames: (
        built.append((type(it).__name__, it.device.type, max_frames)) or _App()))
    app.main(["-c", tiny_yaml, "--max-frames", "16", "--port", "7999", "--device", "cpu"])
    assert built == [("InferTools", "cpu", 16), ("0.0.0.0", 7999)]
    with pytest.raises(FileNotFoundError):  # a reference .pt is read now; this one is missing
        app.main(["-c", tiny_yaml, "-p", "llasa.pt", "--device", "cpu"])
