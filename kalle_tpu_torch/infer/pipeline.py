"""The synthesis entry point (port of kalle_tpu/infer/pipeline.py): the
`Codec` facade and `InferTools`.

`InferTools` holds a Llasa, a tokenizer and a codec; for each row of a
jsonl test set it writes {utt}.txt (the caption), {utt}---copysyn.wav (the
row's ground-truth latents through the codec: the codec's own baseline)
and {utt}---gen.wav (generated from the caption), into
{output_root}/{version}-{ckpt}[-timestamp]. Generation is batched,
KV-cached decode (infer/generate.py) over prompts packed into left-padded
length buckets.

`Codec` covers the three codec families: "sigma" (SigmaVAE, 24 kHz),
"stableaudio" (Oobleck, 44.1 kHz stereo) and "melvae" (the mel-VAE, 16
kHz, whose LMs may predict flow-space latents: `flow_reverse`).
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..bridge import tree_leaves, tree_map
from ..core.config import LlasaConfig
from ..data.datasets import load_sigma_latent, load_stableaudio_latent, read_jsonl
from ..data.tokens import build_prompt_ids
from ..models.codecs import melvae, oobleck, sigmavae
from ..utils import trace
from ..utils.audio import write_wav
from .generate import generate


_MODULES = {"sigma": (sigmavae, sigmavae.SigmaVAEConfig),
            "stableaudio": (oobleck, oobleck.OobleckConfig),
            "melvae": (melvae, melvae.MelVAEConfig)}


class Codec:
    """Uniform facade over the three codec families."""

    def __init__(self, kind: str, cfg, params):
        if kind not in _MODULES:
            raise ValueError(f"unknown codec {kind!r}")
        self.kind = kind
        self.cfg = cfg
        self.params = params
        self.dtype = torch.float32

    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    @property
    def samples_per_frame(self) -> int:
        """Audio samples produced per latent frame."""
        if self.kind == "stableaudio":
            return int(self.cfg.downsampling_ratio)
        return int(self.cfg.hop)  # sigma, melvae

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.params)[0].device

    def astype(self, dtype) -> "Codec":
        """Cast the codec params; bf16 sends SigmaVAE's residual blocks
        through K4 on the card (the other codecs have no kernel)."""
        self.params = tree_map(lambda t: t.to(dtype), self.params)
        self.dtype = dtype
        return self

    def decode_latents(self, latents, flow_reverse: bool = False) -> np.ndarray:
        """latents (B, T, d) -> host audio (B, C, T_audio) as float32.

        flow_reverse (melvae only): the LM predicts FLOW-space latents, so
        the coupling flow is inverted before the decoder. The codec draws
        nothing: the mel-VAE decodes the latents as they are. Traced:
        `codec.decode`, with `codec.copy_out` around the host copy."""
        with trace.span("codec.decode"):
            z = torch.as_tensor(latents, device=self.device).to(self.dtype)
            if self.kind == "sigma":
                y = sigmavae.decode(self.params, self.cfg, z)
            elif self.kind == "stableaudio":
                y = oobleck.decode(self.params, self.cfg, z.transpose(1, 2))
            else:
                z = z.transpose(1, 2)
                if flow_reverse:
                    z = melvae.flow(self.params, self.cfg, z, reverse=True)
                y = melvae.inference_from_latents(self.params, self.cfg, z, do_sample=False)
            y = y.float()
            with trace.span("codec.copy_out"):
                return y.cpu().numpy()

    def encode_audio(self, wav) -> np.ndarray:
        """wav at `sample_rate` -> host float32: sigma takes (B, 1, T) or
        (B, T) and gives latent means (B, T // hop, d); stableaudio takes
        (B, 2, T) and gives mean||scale (B, 2d, T // ratio); melvae takes
        (B, 1, T) and gives mean||logs (B, 2d, T // hop)."""
        x = torch.as_tensor(wav, device=self.device).to(self.dtype)
        if self.kind == "sigma":
            z = sigmavae.encode(self.params, self.cfg, x)
        elif self.kind == "stableaudio":
            z = oobleck.encode(self.params, self.cfg, x)
        else:
            z = melvae.extract_latents(self.params, self.cfg, x)
        return z.float().cpu().numpy()

    @staticmethod
    def random_init(kind: str = "sigma", generator: Optional[torch.Generator] = None,
                    device="cuda", **overrides) -> "Codec":
        """Random f32 params; `generator` defaults to one seeded 0 on
        `device`. `cfg=` or config fields may be passed as overrides."""
        if kind not in _MODULES:
            raise ValueError(f"unknown codec {kind!r}")
        mod, cfg_cls = _MODULES[kind]
        cfg = overrides.pop("cfg", None) or cfg_cls(**overrides)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return Codec(kind, cfg, mod.init_params(cfg, generator, device))

    @staticmethod
    def load(kind: str, config_path: str, ckpt_path: str, device="cuda") -> "Codec":
        """Pretrained codec weights: stableaudio from a stable_audio_tools
        model_config.json and its .safetensors / .pt, melvae from an
        h-config JSON and a g_* checkpoint. Sigma has no pretrained loader
        (its weights come through `sigmavae.params_from_torch_state_dict`)."""
        if kind == "stableaudio":
            cfg, params = oobleck.load_pretrained(config_path, ckpt_path, device)
        elif kind == "melvae":
            cfg, params = melvae.load_pretrained(config_path, ckpt_path, device)
        else:
            raise ValueError(f"no pretrained loader for {kind}")
        return Codec(kind, cfg, params)


class InferTools:
    """Synthesis over one model, tokenizer and codec, on the device that
    holds `params`.

    Randomness: one `torch.Generator` on that device, seeded by `seed`,
    draws everything in call order. `synthesize` and each group of
    `synthesize_batch` draw `generate`'s noise (one (b, 1, d) normal a
    decode step), then, for a non-sigma head with `resample_std`, the
    resampling noise; `infer_jsonl` first draws each row's copysyn noise
    (sigma: `sigmavae.sample`, (1, T, d)) in row order, then the
    generation's. A stableaudio or melvae row's copysyn latents are drawn
    on the host from the row's mean||scale, by a numpy generator seeded 0
    for each row, as in the JAX package. The codec draws nothing.

    flow_reverse: the model predicts the mel-VAE's flow-space latents, so
    the codec inverts the flow before decoding generated latents (copysyn
    latents are decoded as they are)."""

    def __init__(
        self,
        cfg: LlasaConfig,
        params: dict,
        tokenizer,
        codec: Codec,
        output_root: str = "inference_results",
        version: str = "kalle_tpu",
        ckpt_name: str = "ckpt",
        timestamp: bool = True,
        seed: int = 0,
        flow_reverse: bool = False,
    ):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.codec = codec
        self.flow_reverse = flow_reverse
        self.device = params["audio_linear"]["w"].device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        name = f"{version}-{ckpt_name}"
        if timestamp:
            name += "-" + datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        self.output_dir = os.path.join(output_root, name)
        os.makedirs(self.output_dir, exist_ok=True)

    # ---- single utterance ----

    def synthesize(self, text: str, max_frames: int = 200,
                   prompt_latents: Optional[np.ndarray] = None) -> np.ndarray:
        """text [+ an audio prompt (tl, d)] -> audio (1, T) as float32."""
        ids = torch.tensor([build_prompt_ids(self.tokenizer, text)], device=self.device)
        res = generate(
            self.params, self.cfg, ids, torch.ones_like(ids, dtype=torch.int32),
            self.generator, max_frames=max_frames,
            prompt_latents=None if prompt_latents is None
            else torch.as_tensor(prompt_latents, device=self.device)[None].float(),
        )
        n = int(res.n_frames[0])
        return self.codec.decode_latents(self._latents_for_decode(res, slice(0, max(n, 1))),
                                         flow_reverse=self.flow_reverse)[0]

    def _latents_for_decode(self, res, sl: slice,
                            resample_std: Optional[float] = None) -> torch.Tensor:
        """The sigma head decodes the SAMPLED latents; the other heads decode
        the means, or resample them with the predicted std times
        `resample_std` (0.8 in the reference)."""
        if self.cfg.head_variant == "sigma":
            return res.samples[:, sl]
        mean = res.means[:, sl]
        if resample_std:
            std = torch.exp(res.log_scales[:, sl]) * resample_std
            noise = torch.randn(mean.shape, generator=self.generator,
                                device=mean.device, dtype=mean.dtype)
            return mean + std * noise
        return mean

    # ---- batched synthesis ----

    PROMPT_BUCKETS = (16, 32, 64, 128, 256, 512)

    def synthesize_batch(
        self,
        texts: Sequence[str],
        max_frames: int = 200,
        batch_size: int = 8,
        prompt_buckets: Sequence[int] = PROMPT_BUCKETS,
    ) -> List[np.ndarray]:
        """Batched text -> audio. Texts are sorted by prompt length and
        packed `batch_size` at a time into left-padded prompt buckets, so a
        batch has one of a few shapes; a short last group repeats its last
        row (discarded). Returns (1, T_i) arrays aligned with `texts`, each
        trimmed to max(n_frames_i, 1) * samples_per_frame.

        Traced (`utils/trace`): `synth.call` around it all, and for each
        group `synth.pack` (the ids and mask, moved to the device), then
        `generate`'s and the codec's spans, then `synth.unpack` (n_frames
        to the host, the row trims)."""
        with trace.span("synth.call", texts=len(texts)):
            ids_list = [build_prompt_ids(self.tokenizer, t) for t in texts]
            order = sorted(range(len(texts)), key=lambda i: len(ids_list[i]))
            out: List[Optional[np.ndarray]] = [None] * len(texts)
            spf = self.codec.samples_per_frame

            for g0 in range(0, len(order), batch_size):
                group = order[g0:g0 + batch_size]
                with trace.span("synth.pack"):
                    max_len = max(len(ids_list[i]) for i in group)
                    bucket = next((bk for bk in prompt_buckets if bk >= max_len), max_len)
                    rows = group + [group[-1]] * (batch_size - len(group))
                    ids = np.zeros((batch_size, bucket), np.int64)
                    mask = np.zeros((batch_size, bucket), np.int32)
                    for r, i in enumerate(rows):
                        n = len(ids_list[i])
                        ids[r, bucket - n:] = ids_list[i]  # LEFT padding
                        mask[r, bucket - n:] = 1
                    ids_t = torch.from_numpy(ids).to(self.device)
                    mask_t = torch.from_numpy(mask).to(self.device)

                res = generate(self.params, self.cfg, ids_t, mask_t, self.generator,
                               max_frames=max_frames)
                audio = self.codec.decode_latents(
                    self._latents_for_decode(res, slice(0, max_frames)),
                    flow_reverse=self.flow_reverse)
                with trace.span("synth.unpack"):
                    n_frames = res.n_frames.cpu().numpy()
                    for r, i in enumerate(group):
                        out[i] = audio[r, :, :max(int(n_frames[r]), 1) * spf]
        return out  # type: ignore[return-value]

    # ---- a jsonl test set ----

    def infer_jsonl(self, meta_path_or_rows, max_frames: int = 200,
                    copysyn: bool = True, limit: Optional[int] = None,
                    caption_keys: Sequence[str] = ("AudioSetCaps", "caption", "text"),
                    batch_size: int = 8) -> List[str]:
        """Write {utt}.txt, {utt}---copysyn.wav (rows with a "vae" latent)
        and {utt}---gen.wav for each row; the caption is the first of
        `caption_keys` the row has. Generation runs through
        `synthesize_batch`; copysyn runs row by row, since ground-truth
        latent lengths vary freely. Returns the wav paths, each row's
        copysyn before its gen, rows in order."""
        rows = (read_jsonl(meta_path_or_rows)
                if isinstance(meta_path_or_rows, str) else list(meta_path_or_rows))
        if limit:
            rows = rows[:limit]
        sr = self.codec.sample_rate
        utts, texts, copysyn_paths = [], [], {}
        for idx, row in enumerate(rows):
            utt = str(row.get("id", idx))
            text = next(str(row[k]) for k in caption_keys if row.get(k))
            utts.append(utt)
            texts.append(text)
            with open(os.path.join(self.output_dir, f"{utt}.txt"), "w") as f:
                f.write(text)

            if copysyn and row.get("vae"):
                if self.codec.kind == "sigma":
                    mean = torch.from_numpy(load_sigma_latent(row["vae"])).to(self.device)
                    lat = sigmavae.sample(self.generator, mean[None], self.cfg.sigma)
                else:
                    _, lat = load_stableaudio_latent(row["vae"], np.random.default_rng(0))
                    lat = lat[None]
                p = os.path.join(self.output_dir, f"{utt}---copysyn.wav")
                write_wav(p, self.codec.decode_latents(lat)[0], sr)
                copysyn_paths[utt] = p

        gens = self.synthesize_batch(texts, max_frames=max_frames, batch_size=batch_size)
        written = []
        for utt, audio in zip(utts, gens):
            if utt in copysyn_paths:
                written.append(copysyn_paths[utt])
            p = os.path.join(self.output_dir, f"{utt}---gen.wav")
            write_wav(p, audio, sr)
            written.append(p)
        return written
