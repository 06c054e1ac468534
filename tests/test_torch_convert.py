"""The port's checkpoint converters (kalle_tpu_torch/models/lm/convert.py,
core/checkpoint.load_reference_llasa_checkpoint) against the JAX
package's, on the CPU at the tiny config.

A random `transformers.LlamaForCausalLM` built from an in-code config (no
download) goes through both packages' HF converters: bit-equal, with the
vocab resize to the config's larger vocabulary. Llasa state dicts cross
both ways (port export -> JAX import, JAX export -> port import) bit for
bit, in both head layouts. `.pt` (wrapped or not) and `.safetensors` files
load. A Trainer warm-started from a `.pt` computes the JAX loss on the
JAX-loaded params (1e-5), and one pointed at an HF directory loads its
backbone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.core import checkpoint as jckpt
from kalle_tpu.core import config as jconfig
from kalle_tpu.models.lm import convert as jconvert
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core import checkpoint, config
from kalle_tpu_torch.data import tokens
from kalle_tpu_torch.models.lm import convert, llama, llasa
from kalle_tpu_torch.train.trainer import Trainer

HF_VOCAB = 250  # below the tiny config's 300: the converters add mean rows


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _hf_config():
    from transformers import LlamaConfig as HFLlamaConfig

    return HFLlamaConfig(
        vocab_size=HF_VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-5,
        rope_theta=500000.0, max_position_embeddings=128, tie_word_embeddings=False,
        rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 8192})


@pytest.fixture(scope="module")
def hf_model():
    from transformers import LlamaForCausalLM

    torch.manual_seed(0)
    return LlamaForCausalLM(_hf_config()).eval()


@pytest.fixture(scope="module")
def jax_llasa():
    jcfg = jconfig.LlasaConfig.tiny(head_variant="stableaudio")
    return jcfg, jllasa.init_params(jcfg, jax.random.key(0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_trees_equal(got[k], ref[k], f"{path}/{k}")
        return
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = ref.detach().cpu().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, path
    np.testing.assert_array_equal(got, ref, err_msg=path)


def test_hf_llama_state_dict_matches_jax(hf_model):
    sd = hf_model.state_dict()
    got = convert.llama_params_from_state_dict(sd, config.LlamaConfig.tiny())
    ref = jconvert.llama_params_from_state_dict(sd, jconfig.LlamaConfig.tiny())
    _assert_trees_equal(got, ref)
    assert got["embed"].shape == (300, 64)
    np.testing.assert_array_equal(got["embed"][HF_VOCAB:],
                                  np.broadcast_to(got["embed"][:HF_VOCAB].mean(0), (50, 64)))


def test_hf_llama_converted_forward_matches_transformers(hf_model):
    """The converted backbone's hidden states equal the HF model's (the
    layout and transposes, not only the converters' agreement)."""
    cfg = config.LlamaConfig.tiny()
    params = bridge.params_from_jax(
        convert.llama_params_from_state_dict(hf_model.state_dict(), cfg), device="cpu")
    ids = torch.randint(0, HF_VOCAB, (2, 9), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = hf_model.model(input_ids=ids).last_hidden_state
        got = llama.forward(params, cfg, llama.embed_tokens(params, ids, cfg),
                            torch.ones_like(ids, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("head", ["two_layer", "linear"])
def test_llasa_state_dict_crosses_both_ways(jax_llasa, head):
    jcfg, jp = jax_llasa
    tcfg = config.LlasaConfig.tiny(head_variant="stableaudio")
    jp = _np(jp)
    if head == "linear":  # a single-Linear distribution head (export only)
        rng = np.random.default_rng(2)
        jp = dict(jp, distribution_linear={
            "w": rng.normal(size=(64, 16)).astype(np.float32),
            "b": rng.normal(size=(16,)).astype(np.float32)})
    tp = bridge.params_from_jax(jp, device="cpu")
    ours = convert.llasa_state_dict_from_params(tp, tcfg)
    theirs = jconvert.llasa_state_dict_from_params(jp, jcfg)
    assert list(ours) == list(theirs)
    for k in theirs:
        assert ours[k].dtype == torch.float32
        assert torch.equal(ours[k], theirs[k]), k
    if head == "linear":
        assert "distribution_linear.weight" in ours
        return
    # port export -> JAX import, JAX export -> port import
    _assert_trees_equal(jconvert.llasa_params_from_state_dict(ours, jcfg), tp)
    _assert_trees_equal(convert.llasa_params_from_state_dict(theirs, tcfg), jp)


@pytest.mark.parametrize("fmt", ["pt", "pt_wrapped", "safetensors"])
def test_reference_checkpoint_files_load(jax_llasa, tmp_path, fmt):
    jcfg, jp = jax_llasa
    tcfg = config.LlasaConfig.tiny(head_variant="stableaudio")
    sd = jconvert.llasa_state_dict_from_params(_np(jp), jcfg)
    path = str(tmp_path / f"llasa.{'safetensors' if fmt == 'safetensors' else 'pt'}")
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()}, path)
    else:
        torch.save({"state_dict": sd} if fmt == "pt_wrapped" else sd, path)
    loaded = checkpoint.load_reference_llasa_checkpoint(path, tcfg, device="cpu")
    _assert_trees_equal(loaded, _np(jp))
    _assert_trees_equal(checkpoint.load_llasa_params(path, tcfg, device="cpu"), loaded)
    _assert_trees_equal(loaded, jckpt.load_reference_llasa_checkpoint(path, jcfg))


def test_codec_checkpoint_generator_is_unwrapped(tmp_path):
    sd = {"generator": {"conv.weight": torch.ones(2, 3)}, "discriminator": {"x": 1}}
    torch.save(sd, tmp_path / "codec.pt")
    got = convert.load_torch_checkpoint(str(tmp_path / "codec.pt"))
    assert list(got) == ["conv.weight"] and torch.equal(got["conv.weight"], torch.ones(2, 3))


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    b, t, d = 2, 24, 8
    ids_mask = np.zeros((b, t), np.int32)
    audio_mask = np.zeros((b, t), np.int32)
    ids_mask[:, :6] = 1
    audio_mask[0, 6:20] = 1
    audio_mask[1, 6:14] = 1
    target = np.roll(audio_mask, -1, axis=1)
    end = np.zeros((b, t), np.int32)
    end[0, 19] = end[1, 13] = 1
    labels = np.ones((b, t, 2 * d), np.float32)
    labels[..., :d] = rng.normal(size=(b, t, d))
    labels[..., d:] = rng.uniform(0.5, 1.5, size=(b, t, d))
    return {"input_ids": rng.integers(0, 300, (b, t)).astype(np.int32),
            "audio_latents": rng.normal(size=(b, t, d)).astype(np.float32),
            "distribute_labels": labels, "ids_mask": ids_mask, "audio_mask": audio_mask,
            "target_mask": target, "end_mask": end}


def test_trainer_warm_start_matches_jax(jax_llasa, tmp_path):
    """A Trainer with start_checkpoint = a reference .pt starts from the
    file's weights; its forward loss equals the JAX forward's on the
    JAX-loaded params (stableaudio head: no draws, 1e-5)."""
    jcfg, jp = jax_llasa
    path = str(tmp_path / "epoch_1_step_2.pt")
    torch.save(jconvert.llasa_state_dict_from_params(_np(jp), jcfg), path)
    exp = config.ExperimentConfig(
        exp_dir=str(tmp_path / "exp"), start_checkpoint=path,
        model=config.LlasaConfig.tiny(head_variant="stableaudio"))
    tr = Trainer(exp, tokens.build_tokenizer(), device="cpu")
    assert tr.start_step == 0
    _assert_trees_equal({k: v for k, v in tr.state.params.items()}, _np(jp))
    batch = _batch()
    with torch.no_grad():
        out = llasa.forward(tr.state.params, exp.model, tr._device_batch(batch))
    jparams = jckpt.load_reference_llasa_checkpoint(path, jcfg)
    ref = jllasa.forward(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    for k in ("audio_loss", "end_loss"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-5, atol=1e-5)


def test_trainer_loads_an_hf_backbone(hf_model, tmp_path, capsys):
    hf_dir = str(tmp_path / "hf")
    hf_model.save_pretrained(hf_dir)
    exp = config.ExperimentConfig(exp_dir=str(tmp_path / "exp"),
                                  llm_model_name_or_path=hf_dir,
                                  model=config.LlasaConfig.tiny())
    tr = Trainer(exp, tokens.build_tokenizer(), device="cpu")
    assert f"loaded Llama backbone from {hf_dir}" in capsys.readouterr().out
    ref = convert.llama_params_from_state_dict(hf_model.state_dict(), exp.model.llama)
    _assert_trees_equal(tr.state.params["llama"], ref)
