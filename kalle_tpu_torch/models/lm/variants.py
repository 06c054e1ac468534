"""Llasa capability variants (port of kalle_tpu/models/lm/variants.py):
speaker conditioning, speaker dropout, the text/audio stream interleave
and the global speaker VAE.

All use a single-Linear distribution head emitting mean||log_scale (2d),
not the main Llasa's MLP head:
  * speaker frame: the ECAPA embedding prepended as frame 0, hidden[1:]
    into the head (`speaker_forward`);
  * speaker dropout: rows whose `speaker_cond_keep` is False get an
    embedding of ONES (`speaker_forward(speaker_dropout=True)`);
  * text stream: embed = text[i] + audio[i], loss = the KL's mean over
    every position (`text_stream_forward`);
  * stream + speaker VAE: the audio stream takes the BOS embedding where
    `bos_mask`, ECAPA -> (mean, logs) -> a sampled speaker frame, and a
    KL(speaker || N(0, 1)) / h regulariser (`stream_spkvae_forward`);
  * framewise: the embedding ADDED to every input embedding
    (`framewise_speaker_forward`).
The backbone runs `llama.forward`: K5 in the forward and K6/K7 in the
backward on the card when flash is on and the length (speaker frame
included) is a multiple of 128. Each draw comes from a `torch.Generator`,
or from an injected tensor of the draw's shape (torch cannot reproduce
the JAX package's draws).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ...core.config import LlasaConfig, torch_dtype
from ..conditioning import ecapa
from . import llama
from .losses import gaussian_kl, masked_frame_loss, split_mean_scale_btd


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_variant_params(cfg: LlasaConfig, generator: torch.Generator,
                        ecapa_cfg: Optional[ecapa.EcapaConfig] = None,
                        speaker_vae: bool = False, device="cuda") -> dict:
    """The variants' tree: llama + audio_linear + a LINEAR
    distribution_linear (h -> 2d) + the ECAPA speaker encoder (+ the
    speaker VAE's speaker_cond_disp_linear, h -> 2h). Linears uniform(±fan
    in^-½), f32."""
    d, h = cfg.latent_dim, cfg.audio_proj_dim

    def lin(cin, cout):
        bound = cin ** -0.5
        u = lambda *shape: (torch.rand(shape, generator=generator, device=device)
                            * (2 * bound) - bound)
        return {"w": u(cin, cout), "b": u(cout)}

    params = {
        "llama": llama.init_params(cfg.llama, generator, device),
        "audio_linear": lin(d, h),
        "distribution_linear": lin(h, 2 * d),
        "speaker_encoder": ecapa.init_params(ecapa_cfg or ecapa.EcapaConfig(embd_dim=h),
                                             generator, device),
    }
    if speaker_vae:
        params["speaker_cond_disp_linear"] = lin(h, 2 * h)
    return params


def _linear(params, name, x, dt):
    p = params[name]
    return x.to(dt) @ p["w"].to(dt) + p["b"].to(dt)


def _head_kl(params, cfg: LlasaConfig, hidden, labels, dt):
    """The Linear head and KL(pred || label), both stds exp(logs)."""
    mean2, logs2 = split_mean_scale_btd(_linear(params, "distribution_linear", hidden, dt))
    mean1, logs1 = split_mean_scale_btd(labels)
    return gaussian_kl(mean2, torch.exp(logs2), mean1, torch.exp(logs1)), mean2, logs2


def speaker_embedding(params: dict, ecapa_cfg: ecapa.EcapaConfig,
                      mels_bdt: torch.Tensor) -> torch.Tensor:
    """mels (B, n_mels, T) -> (B, h): the encoder reads (B, T, n_mels)."""
    return ecapa.forward(params["speaker_encoder"], ecapa_cfg, mels_bdt.transpose(1, 2))


def _normal(generator, shape, like: torch.Tensor, noise: Optional[torch.Tensor]):
    """N(0, 1) of `shape` in like's dtype: `noise` where given, else drawn."""
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise {tuple(noise.shape)} for a draw of {tuple(shape)}")
        return noise.to(like.device, like.dtype)
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


def _embeds(params, cfg: LlasaConfig, batch, dt):
    text = llama.embed_tokens(params["llama"], batch["input_ids"], cfg.llama)
    return text, _linear(params, "audio_linear", batch["audio_latents"], dt)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def speaker_forward(params: dict, cfg: LlasaConfig, batch: Dict[str, torch.Tensor],
                    ecapa_cfg: ecapa.EcapaConfig, speaker_dropout: bool = False,
                    use_flash: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """The speaker frame at position 0; loss KL(pred || label) over the
    target / end masks. With speaker_dropout, rows whose
    speaker_cond_keep is False take an embedding of ONES."""
    dt = torch_dtype(cfg.llama.dtype)
    text, audio = _embeds(params, cfg, batch, dt)
    spk = speaker_embedding(params, ecapa_cfg, batch["mels"].float())
    if speaker_dropout:
        keep = batch["speaker_cond_keep"].bool()[:, None]
        spk = torch.where(keep, spk, torch.ones_like(spk))
    x = audio * batch["audio_mask"].to(dt)[..., None] + text * batch["ids_mask"].to(dt)[..., None]
    x = torch.cat([spk.to(dt)[:, None, :], x], dim=1)
    attn = torch.cat([torch.ones_like(batch["ids_mask"][:, :1], dtype=torch.int32),
                      batch["ids_mask"].int() + batch["audio_mask"].int()], dim=1)
    hidden = llama.forward(params["llama"], cfg.llama, x, attn, use_flash=use_flash)[:, 1:]
    kl, mean2, logs2 = _head_kl(params, cfg, hidden, batch["distribute_labels"], dt)
    audio_loss, end_loss = masked_frame_loss(kl, cfg.latent_dim, batch["target_mask"],
                                             batch["end_mask"])
    return {"audio_loss": audio_loss, "end_loss": end_loss,
            "pre_mean": mean2, "pre_log_scale": logs2}


def text_stream_forward(params: dict, cfg: LlasaConfig, batch: Dict[str, torch.Tensor],
                        ecapa_cfg: ecapa.EcapaConfig,
                        use_flash: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """Streaming interleave: embed = text + audio a step, the speaker frame
    prepended, loss = the mean KL over every position."""
    dt = torch_dtype(cfg.llama.dtype)
    text, audio = _embeds(params, cfg, batch, dt)
    spk = speaker_embedding(params, ecapa_cfg, batch["mels"].float())
    x = torch.cat([spk.to(dt)[:, None, :], text + audio], dim=1)
    attn = torch.ones(x.shape[:2], dtype=torch.int32, device=x.device)
    hidden = llama.forward(params["llama"], cfg.llama, x, attn, use_flash=use_flash)[:, 1:]
    kl, mean2, logs2 = _head_kl(params, cfg, hidden, batch["distribute_labels"], dt)
    return {"audio_loss": (kl.sum(2) / cfg.latent_dim).mean(), "end_loss": None,
            "pre_mean": mean2, "pre_log_scale": logs2}


def stream_spkvae_forward(params: dict, cfg: LlasaConfig, batch: Dict[str, torch.Tensor],
                          ecapa_cfg: ecapa.EcapaConfig,
                          generator: Optional[torch.Generator] = None,
                          spk_noise: Optional[torch.Tensor] = None,
                          use_flash: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """Streaming + the global speaker VAE: the audio stream takes the BOS
    embedding where bos_mask; ECAPA -> (mean, logs) -> a speaker frame
    sampled with one (b, h) N(0, 1) draw (`spk_noise` injects it); plus
    speaker_cond_kl = mean over rows of KL(spk || N(0, 1)).sum / h."""
    dt = torch_dtype(cfg.llama.dtype)
    h = cfg.audio_proj_dim
    text, audio = _embeds(params, cfg, batch, dt)
    bos = llama.embed_tokens(params["llama"], batch["bos_token"], cfg.llama)
    audio = torch.where(batch["bos_mask"].bool()[..., None], bos, audio)

    spk = speaker_embedding(params, ecapa_cfg, batch["mels"].float())
    pd = params["speaker_cond_disp_linear"]
    disp = spk @ pd["w"] + pd["b"]
    spk_mean, spk_logs = disp[..., :h], disp[..., h:]
    spk_sample = spk_mean + _normal(generator, spk_mean.shape, spk_mean,
                                    spk_noise) * torch.exp(spk_logs)
    spk_kl = gaussian_kl(spk_mean, torch.exp(spk_logs), torch.zeros_like(spk_mean),
                         torch.ones_like(spk_logs))
    speaker_cond_kl = (spk_kl.sum(1) / h).mean()

    x = torch.cat([spk_sample.to(dt)[:, None, :], text + audio], dim=1)
    attn = torch.cat([torch.ones_like(batch["attention_mask"][:, :1], dtype=torch.int32),
                      batch["attention_mask"].int()], dim=1)
    hidden = llama.forward(params["llama"], cfg.llama, x, attn, use_flash=use_flash)[:, 1:]
    kl, mean2, logs2 = _head_kl(params, cfg, hidden, batch["distribute_labels"], dt)
    audio_loss, end_loss = masked_frame_loss(kl, cfg.latent_dim, batch["target_mask"],
                                             batch["end_mask"])
    return {"speaker_cond_kl": speaker_cond_kl, "audio_loss": audio_loss,
            "end_loss": end_loss, "pre_mean": mean2, "pre_log_scale": logs2}


def framewise_speaker_forward(params: dict, cfg: LlasaConfig, batch: Dict[str, torch.Tensor],
                              ecapa_cfg: ecapa.EcapaConfig,
                              use_flash: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """Per-frame speaker conditioning: the embedding is ADDED to every
    input embedding instead of prepended as a frame."""
    dt = torch_dtype(cfg.llama.dtype)
    text, audio = _embeds(params, cfg, batch, dt)
    spk = speaker_embedding(params, ecapa_cfg, batch["mels"].float())
    x = audio * batch["audio_mask"].to(dt)[..., None] + text * batch["ids_mask"].to(dt)[..., None]
    x = x + spk.to(dt)[:, None, :]
    attn = batch["ids_mask"].int() + batch["audio_mask"].int()
    hidden = llama.forward(params["llama"], cfg.llama, x, attn, use_flash=use_flash)
    kl, mean2, logs2 = _head_kl(params, cfg, hidden, batch["distribute_labels"], dt)
    audio_loss, end_loss = masked_frame_loss(kl, cfg.latent_dim, batch["target_mask"],
                                             batch["end_mask"])
    return {"audio_loss": audio_loss, "end_loss": end_loss,
            "pre_mean": mean2, "pre_log_scale": logs2}


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def sample_within_confidence_interval(generator: Optional[torch.Generator], mean: torch.Tensor,
                                      std: torch.Tensor, confidence: float = 0.95,
                                      n_samples: int = 1,
                                      uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Truncated-normal samples inside the two-sided `confidence` interval:
    mean + std * x, x ~ N(0, 1) truncated to ±ndtri(0.5 + confidence / 2).
    x is ndtri of a uniform draw over the interval's CDF range; `uniform`
    ((n_samples,) + mean.shape, in [0, 1)) injects the draw. Returns
    (n_samples,) + mean.shape."""
    shape = (n_samples,) + tuple(mean.shape)
    if uniform is None:
        uniform = torch.rand(shape, generator=generator, device=mean.device,
                             dtype=torch.float64)
    lo, hi = (1.0 - confidence) / 2.0, (1.0 + confidence) / 2.0
    x = torch.special.ndtri(lo + (hi - lo) * uniform.to(mean.device, torch.float64))
    return mean[None] + x.to(mean.dtype) * std[None]


def batch_weighted_difference_sampling(generator: Optional[torch.Generator],
                                       mean: torch.Tensor, std: torch.Tensor,
                                       cfg_mean: torch.Tensor, cfg_std: torch.Tensor,
                                       K: float = 0.1,
                                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Guidance: push the conditional mean away from the unconditional one
    by K times their difference, then sample with the conditional std
    (one N(0, 1) draw of mean's shape; `noise` injects it)."""
    guided = mean + K * (mean - cfg_mean)
    return guided + std * _normal(generator, mean.shape, mean, noise)


def cfg_attention_masks(text_len: int, audio_len: int, variant: str,
                        generator: Optional[torch.Generator] = None, cfg_prob: float = 0.5,
                        uniform: Optional[torch.Tensor] = None, device="cuda"):
    """The CFG branch's prompt mask (1, text_len + audio_len) bool and
    whether generated frames stay visible in it. v1: text masked out, audio
    kept, frames kept. v2: text kept, each audio frame dropped with
    probability cfg_prob (one (1, audio_len) U(0, 1) draw; `uniform`
    injects it), frames masked."""
    if variant == "v1":
        text = torch.zeros((1, text_len), dtype=torch.bool, device=device)
        audio = torch.ones((1, audio_len), dtype=torch.bool, device=device) if audio_len else None
        append = True
    elif variant == "v2":
        text = torch.ones((1, text_len), dtype=torch.bool, device=device)
        audio = None
        if audio_len:
            if uniform is None:
                uniform = torch.rand((1, audio_len), generator=generator, device=device)
            audio = ~(uniform.to(device) < cfg_prob)
        append = False
    else:
        raise ValueError(variant)
    mask = text if audio is None else torch.cat([text, audio], dim=1)
    return mask, append
