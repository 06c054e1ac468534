"""The port's Trainer.fit against the JAX package's on the same data and
weights (CPU, tiny config, one data worker so the batches come in the same
order), its resume, and the training CLI.

The runs use the stableaudio head and latents: the dataset samples the
latents with numpy from the config's seed in both packages, and the model
draws nothing at random, so the two runs see the same numbers. The JAX
trainer spreads the batch over the 8 virtual CPU devices and pads it with
loss-neutral rows; the losses are the same. Losses at rtol 1e-4, params at
rtol 1e-4 / atol 1e-2 * lr (see tests/test_torch_train_step.py).
"""
import json

import jax
import numpy as np
import pytest
import torch

from kalle_tpu.core import config as jconfig
from kalle_tpu.data import tokens as jtokens
from kalle_tpu.train import trainer as jtrainer
from kalle_tpu_torch import bridge
from kalle_tpu_torch.core import config
from kalle_tpu_torch.data import tokens
from kalle_tpu_torch.train import cli
from kalle_tpu_torch.train.trainer import Trainer

LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _meta(root, kind="stableaudio", n=6):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        t = int(rng.integers(5, 14))
        arr = (rng.normal(size=(1, t, 8)) if kind == "sigma"
               else np.concatenate([rng.normal(size=(1, 8, t)),
                                    rng.uniform(0.5, 1.5, (1, 8, t))], 1))
        path = root / f"lat{i}.npy"
        np.save(path, arr.astype(np.float32))
        rows.append({"id": f"u{i}", "caption": f"some text {i}", "vae": str(path)})
    meta = root / "meta.jsonl"
    meta.write_text("\n".join(json.dumps(r) for r in rows))
    return str(meta)


def _configs(mod, root, meta, **train_kw):
    kw = dict(lr=LR, warmup_steps=1, total_steps=20, log_interval=1, save_interval=1000,
              seed=7, **train_kw)
    return mod.ExperimentConfig(
        exp_dir=str(root), model=mod.LlasaConfig.tiny(head_variant="stableaudio"),
        train=mod.TrainConfig(**kw),
        data=mod.DataConfig(meta_path=meta, latent_kind="stableaudio", batch_size=2,
                            use_dynamic=False, num_workers=1, length_buckets=(32,),
                            max_length=32))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}{k}/")]
    return [prefix]


def _load_into(params, np_tree):
    """Copy a numpy tree (any dict order) into the port's param tensors."""
    by_path = dict(zip(_paths(np_tree), bridge.tree_leaves(np_tree)))
    with torch.no_grad():
        for path, p in zip(_paths(params), bridge.tree_leaves(params)):
            p.copy_(torch.from_numpy(np.array(by_path[path])))


def _losses(log_dir):
    with open(f"{log_dir}/metrics.jsonl") as f:
        return [json.loads(line)["total_loss"] for line in f]


def test_fit_matches_jax(tmp_path):
    meta = _meta(tmp_path)
    jexp = _configs(jconfig, tmp_path / "jax", meta, gradient_accumulation_steps=2)
    exp = _configs(config, tmp_path / "port", meta, gradient_accumulation_steps=2)
    jtr = jtrainer.Trainer(jexp, jtokens.build_tokenizer())
    tr = Trainer(exp, tokens.build_tokenizer(), device="cpu")
    _load_into(tr.state.params, jax.tree.map(np.asarray, jtr.state.params))

    jm = jtr.fit(max_steps=3)
    m = tr.fit(max_steps=3)
    np.testing.assert_allclose(_losses(exp.log_dir), _losses(jexp.log_dir), rtol=1e-4)
    assert [h["step"] for h in tr.history] == [1, 2, 3]
    np.testing.assert_allclose(m["audio_loss"], jm["audio_loss"], rtol=1e-4)
    ref = jax.tree.map(np.asarray, jtr.state.params)
    ref_flat = dict(zip(_paths(ref), bridge.tree_leaves(ref)))
    got = bridge.params_to_numpy(tr.state.params)
    for path, g in zip(_paths(got), bridge.tree_leaves(got)):
        np.testing.assert_allclose(g, ref_flat[path], rtol=1e-4, atol=1e-2 * LR, err_msg=path)
    # the text log in the JAX package's format
    with open(f"{exp.log_dir}/train_log.txt") as f:
        assert "Epoch:0, Step:1, batch_size:2, total_loss:" in f.readline()


def test_fit_resumes_from_its_checkpoint(tmp_path):
    meta = _meta(tmp_path, kind="sigma")
    exp = config.ExperimentConfig(
        exp_dir=str(tmp_path / "exp"), model=config.LlasaConfig.tiny(),
        train=config.TrainConfig(lr=LR, warmup_steps=1, log_interval=1, save_interval=2),
        data=config.DataConfig(meta_path=meta, batch_size=2, use_dynamic=False,
                               num_workers=1, length_buckets=(32,), max_length=32))
    first = Trainer(exp, tokens.build_tokenizer(), device="cpu")
    first.fit(max_steps=3)
    assert first.ckpt.steps() == [2, 3]
    again = Trainer(exp, tokens.build_tokenizer(), device="cpu")
    assert again.start_step == 3 and again.state.step == 3
    for a, b in zip(bridge.tree_leaves(first.state.params),
                    bridge.tree_leaves(again.state.params)):
        assert torch.equal(a, b)
    again.fit(max_steps=4)
    assert [h["step"] for h in again.history] == [4]


def test_cli_trains_from_a_reference_yaml(tmp_path, capsys):
    meta = _meta(tmp_path, kind="sigma")
    yml = tmp_path / "tiny.yaml"
    yml.write_text(f"""
project_name: "tiny"
exp_dir: "{tmp_path / 'exp'}"
use_flash_attation: true
model:
  latent_dim: 8
  audio_proj_dim: 64
  head_variant: sigma
  llama: {{vocab_size: 300, hidden_size: 64, intermediate_size: 128, num_layers: 2,
          num_heads: 4, num_kv_heads: 2, head_dim: 16, dtype: float32}}
lr: 1e-3
warmup_steps: 1
log_interval: 1
save_interval: 1000
dataset: {{meta_path: "{meta}"}}
datapool: {{num_workers: 1}}
batch_generator: {{use_dynamic: false, batch_size: 2}}
""")
    cli.main([str(yml), "--max-steps", "2", "--device", "cpu"])
    assert "final: {'total_loss'" in capsys.readouterr().out
    run = tmp_path / "exp" / "tiny"
    assert (run / "config.yaml").exists()
    assert len(_losses(run / "logs")) == 2
    assert (run / "output" / "torch" / "step_2.pt").exists()


def test_trainer_refuses_a_mesh(tmp_path):
    exp = config.ExperimentConfig(exp_dir=str(tmp_path), model=config.LlasaConfig.tiny(),
                                  train=config.TrainConfig(tp=2))
    with pytest.raises(NotImplementedError, match="one device"):
        Trainer(exp, tokens.build_tokenizer(), device="cpu")


def test_trainer_says_what_it_cannot_load(tmp_path, capsys):
    exp = config.ExperimentConfig(exp_dir=str(tmp_path), model=config.LlasaConfig.tiny(),
                                  llm_model_name_or_path="/models/llama",
                                  start_checkpoint="/ckpt/epoch_1_step_2.pt")
    Trainer(exp, tokens.build_tokenizer(), device="cpu")
    out = capsys.readouterr().out
    # a backbone that fails to load warns and keeps the random init, and a
    # start checkpoint that does not exist is passed over, as in the JAX package
    assert "could not load backbone from /models/llama" in out
    assert "warm-started" not in out
