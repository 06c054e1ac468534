"""The plain reference of the Llasa model: a Llama-family decoder (RoPE
without scaling, RMSNorm, grouped-query causal attention, SwiGLU) with the
sigma head, in float32 PyTorch with TF32 off, written from the published
architecture. It imports nothing of the program and reads nothing the
program made: weights come from the benchmark's seed (`perfbench.weights`)
and every derived form (int8 or int4 layer weights) is worked out here
again.

`precision` selects what the reference computes in:
  "f32"   the model as the configuration states it (with `layer_bits` 8 the
          per-channel int8 layer weights the configuration serves with,
          dequantised; with None the dense weights), every product in f32;
  "fp8"   every linear layer's operands rounded to float8 e4m3 with a
          per-tensor scale (the control of a bf16 configuration).
`layer_bits` 4 gives group-wise int4 layer weights (groups of 128 inputs),
the control of an int8 configuration.

Departures from a textbook decoder, each as the program's model defines
it: a sequence is [text ids][audio frames], the frames entering through
`audio_linear`; the head is Linear -> exact GELU -> Linear emitting the
next frame's mean (sigma fixed).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

F8_MAX = 448.0  # float8 e4m3's largest finite value


@contextlib.contextmanager
def strict_f32():
    """TF32 off for matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor absmax scale, back in f32;
    the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-12) / F8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def quant_int8(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel absmax int8 of w (..., in, out), dequantised: the
    form the configuration serves its layer weights in."""
    w = w.float()
    scale = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(w / scale), -127, 127) * scale


def quant_int4(w: torch.Tensor, group: int = 128) -> torch.Tensor:
    """Group-wise (`group` inputs a scale) absmax int4 (-7..7) of w (in,
    out), dequantised."""
    w = w.float()
    i, o = w.shape[-2:]
    g = min(group, i)
    wg = w.reshape(*w.shape[:-2], i // g, g, o)
    scale = wg.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / 7.0
    return (torch.clamp(torch.round(wg / scale), -7, 7) * scale).reshape(w.shape)


LAYER_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def prepare(params: dict, layer_bits: Optional[int] = None) -> dict:
    """The reference's weights: f32 copies, the layer matrices quantised
    and dequantised when `layer_bits` is 8 or 4."""
    lp = params["llama"]
    layers = {}
    for k, w in lp["layers"].items():
        if k in LAYER_KEYS and layer_bits == 8:
            layers[k] = quant_int8(w)
        elif k in LAYER_KEYS and layer_bits == 4:
            layers[k] = quant_int4(w)
        else:
            layers[k] = w.float()
    return {"embed": lp["embed"].float(), "layers": layers,
            "final_norm": lp["final_norm"].float(),
            "audio_linear": {k: v.float() for k, v in params["audio_linear"].items()},
            "distribution_linear": {k: v.float()
                                    for k, v in params["distribution_linear"].items()}}


class Model:
    """Reference forward over one sequence at a time (no padding, no cache)."""

    def __init__(self, s: dict, weights: dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.s, self.w, self.precision = s, weights, precision

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        if self.precision == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        y = x @ w
        return y if b is None else y + b

    def rms(self, x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.s["rms_eps"]) * scale

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (t, heads, hd), rotate-half layout."""
        hd = x.shape[-1]
        inv = 1.0 / (self.s["rope_theta"] ** (
            torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd))
        ang = pos.float()[:, None] * inv[None]
        cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
        sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
        rot = torch.cat([-x[..., hd // 2:], x[..., :hd // 2]], -1)
        return x * cos + rot * sin

    def embed(self, ids: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        """[text ids][audio frames] -> (t, hidden)."""
        al = self.w["audio_linear"]
        text = self.w["embed"][ids]
        audio = self.linear(frames.float(), al["w"], al["b"])
        return torch.cat([text, audio], 0)

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        """(t, hidden) -> the final-normed hidden states (t, hidden)."""
        s, lw = self.s, self.w["layers"]
        t = x.shape[0]
        nq, nkv, hd = s["heads"], s["kv_heads"], s["head_dim"]
        pos = torch.arange(t, device=x.device)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        for li in range(s["layers"]):
            h = self.rms(x, lw["attn_norm"][li])
            q = self.rope(self.linear(h, lw["wq"][li]).view(t, nq, hd), pos)
            k = self.rope(self.linear(h, lw["wk"][li]).view(t, nkv, hd), pos)
            v = self.linear(h, lw["wv"][li]).view(t, nkv, hd)
            k = k.repeat_interleave(nq // nkv, dim=1)
            v = v.repeat_interleave(nq // nkv, dim=1)
            att = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
            att = att.masked_fill(~causal, float("-inf")).softmax(-1)
            o = torch.einsum("hqk,khd->qhd", att, v).reshape(t, nq * hd)
            x = x + self.linear(o, lw["wo"][li])
            h = self.rms(x, lw["mlp_norm"][li])
            g = self.linear(h, lw["wg"][li])
            u = self.linear(h, lw["wu"][li])
            x = x + self.linear(F.silu(g) * u, lw["wd"][li])
        return self.rms(x, self.w["final_norm"])

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Hidden states -> the next frame's mean (t, latent)."""
        dl = self.w["distribution_linear"]
        x = F.gelu(self.linear(h, dl["w0"], dl["b0"]), approximate="none")
        return self.linear(x, dl["w2"], dl["b2"])

    @torch.no_grad()
    def served_means(self, ids: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        """The means a server should have put out for the prompt `ids` when
        it fed back `frames` (F, d): (F, d), mean j predicted after ids and
        frames[:j]."""
        n = ids.shape[0]
        h = self.hidden(self.embed(ids, frames[:-1]))
        return self.head(h[n - 1:n - 1 + len(frames)])

    def row_loss(self, ids: torch.Tensor, latents: torch.Tensor,
                 noise: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One training row: [ids][latents + sigma * noise] -> the summed
        audio KL over its target frames and its end-frame KL (each KL
        summed over the latent and divided by its size)."""
        s = self.s
        n, T = ids.shape[0], latents.shape[0]
        noised = latents + s["sigma"] * noise
        h = self.hidden(self.embed(ids, noised))
        mean = self.head(h[n - 1:n + T])  # targets n-1 .. n+T-2, the end at n+T-1
        labels = torch.cat([latents, torch.ones_like(latents[:1])], 0)
        kl = ((mean - labels) ** 2 / (2 * s["sigma"] ** 2)).sum(-1) / s["latent"]
        return {"audio": kl[:T].sum(), "end": kl[T]}


def microbatch_loss(model: Model, rows: Sequence[dict], end_weight: float,
                    audio_weight: float = 1.0, scale: float = 1.0,
                    block: int = 4) -> float:
    """The loss of one microbatch (masked means over its rows, as the
    program's loss defines them: the audio KL over its target frames, the
    end KL over its rows), back-propagated times `scale` into the weights'
    .grad, a block of rows at a time so the activations fit. -> the
    microbatch's total loss."""
    n_target = sum(int(r["latents"].shape[0]) for r in rows)
    n_end = len(rows)
    total = 0.0
    for i in range(0, len(rows), block):
        part = torch.zeros((), device=rows[0]["latents"].device)
        for r in rows[i:i + block]:
            out = model.row_loss(r["ids"], r["latents"], r["noise"])
            part = part + audio_weight * out["audio"] / n_target \
                + end_weight * out["end"] / n_end
        (part * scale).backward()
        total += float(part.detach())
    return total
