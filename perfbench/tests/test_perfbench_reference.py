"""The plain reference against an independent computation at a tiny size:
the program's own CPU path (its kernels' plain versions), run here only
as a witness, with the same seeded weights."""
import numpy as np
import pytest
import torch

from perfbench import modelcfg, weights
from perfbench.reference.llasa import Model, microbatch_loss, prepare, quant_int4, quant_int8
from perfbench.reference.sigmavae import Decoder
from perfbench.tests import tiny

S = modelcfg.sizes(tiny.CFG)


def test_int8_and_int4_match_the_program():
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    p = weights.lm_params(S, 3, "cpu")
    for bits, fn in ((8, quant_int8), (4, quant_int4)):
        q = quantize_llama_params(p, bits=bits, group=128)["llama"]["layers"]["wg"]
        deq = q["q"].float() * (q["scale"][:, None, :] if bits == 8
                                else q["scale"].repeat_interleave(
                                    q["q"].shape[1] // q["scale"].shape[1], dim=1))
        assert torch.equal(fn(p["llama"]["layers"]["wg"]), deq)


def test_served_means_match_the_program_decode():
    """Prefill and decode through the program's cache (greedy, so each fed
    frame is the mean) against the reference's full forward."""
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    lcfg = modelcfg.llasa_config(tiny.CFG, "serve")
    p = weights.lm_params(S, 5, "cpu")
    ids = torch.tensor([[5, 6, 7, 8, 9, S["base_vocab"] + 7, S["base_vocab"] + 4]])
    out = generate(quantize_llama_params(p, bits=8), lcfg, ids, torch.ones_like(ids),
                   max_frames=6, greedy=True)
    means = out.means[0].float()
    ref = Model(S, prepare(p, layer_bits=8)).served_means(ids[0], out.samples[0].float())
    torch.testing.assert_close(ref, means, rtol=1e-4, atol=1e-5)
    # the same frames through int4 layer weights are visibly further off
    ctl = Model(S, prepare(p, layer_bits=4)).served_means(ids[0], out.samples[0].float())
    assert (ctl - ref).abs().max() > 100 * (means - ref).abs().max()


def test_training_loss_and_gradients_match_the_program():
    from kalle_tpu_torch.core.config import TrainConfig
    from kalle_tpu_torch.data.collate import Item, collate
    from kalle_tpu_torch.train.step import loss_fn

    lcfg = modelcfg.llasa_config(tiny.CFG, "train")
    g = np.random.default_rng(0)
    items = [Item(input_ids=np.array([1, 2, 3, 307, 304], np.int32),
                  audio_latents=g.standard_normal((4, 8), dtype=np.float32),
                  audio_distribution=None),
             Item(input_ids=np.array([4, 5, 307, 304], np.int32),
                  audio_latents=g.standard_normal((6, 8), dtype=np.float32),
                  audio_distribution=None)]
    for it in items:
        it.audio_distribution = it.audio_latents.copy()
    b = collate(items, 256)
    batch = {k: torch.as_tensor(v) for k, v in b.items() if isinstance(v, np.ndarray)}
    batch["input_ids"] = batch["input_ids"].long()
    noise = torch.randn(batch["audio_latents"].shape, generator=torch.Generator().manual_seed(1))
    p = weights.lm_params(S, 9, "cpu")
    for leaf in weights.tree_paths(p).values():
        leaf.requires_grad_(True)
    tcfg = TrainConfig()
    loss, _ = loss_fn(p, lcfg, tcfg, batch, latent_noise=noise, use_flash=False)
    loss.backward()
    want = {k: v.grad.clone() for k, v in weights.tree_paths(p).items()}

    r = weights.lm_params(S, 9, "cpu")
    flat = weights.tree_paths(r)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    model = Model(S, {"embed": r["llama"]["embed"], "layers": r["llama"]["layers"],
                      "final_norm": r["llama"]["final_norm"],
                      "audio_linear": r["audio_linear"],
                      "distribution_linear": r["distribution_linear"]})
    rows = []
    for i, it in enumerate(items):
        n, t = len(it.input_ids), len(it.audio_latents)
        rows.append({"ids": torch.as_tensor(it.input_ids).long(),
                     "latents": torch.as_tensor(it.audio_latents), "noise": noise[i, n:n + t]})
    total = microbatch_loss(model, rows, tcfg.end_loss_weight, block=1)
    assert total == pytest.approx(float(loss), rel=1e-5)
    for k, gr in want.items():
        torch.testing.assert_close(flat[k].grad, gr, rtol=1e-4, atol=1e-7)


def test_codec_matches_the_program():
    from kalle_tpu_torch.models.codecs.sigmavae import SigmaVAEConfig, decode

    c = dict(weights.SIGMAVAE, **{k: (tuple(v) if isinstance(v, list) else v)
                                  for k, v in tiny.CODEC.items()})
    params = weights.codec_params(4, "cpu", torch.float32, c)
    z = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(2))
    want = decode(params, SigmaVAEConfig(**c), z)[:, 0]
    got = Decoder(params, c)(z)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    ctl = Decoder(params, c, precision="fp8")(z)
    assert (ctl - want).abs().max() > 100 * (got - want).abs().max()
