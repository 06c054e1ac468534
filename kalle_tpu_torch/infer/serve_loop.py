"""Continuous-batching serving loop over the KV-cached decoder (port of
kalle_tpu/infer/serve_loop.py:39-642).

A fixed batch of B rows decodes one frame a step; a row whose request
finished is refilled with a new prompt while the others keep decoding.
  * `decode_step` steps every row one frame. Each row writes its K/V at
    its own cache slot (`length`) and carries its own RoPE position.
  * `prefill` runs one left-padded prompt (padded to a length bucket)
    through the backbone with a fresh single-row cache; `insert` splices
    the row's cache and last hidden state into a free batch row.
  * the host loop admits pending prompts into free rows, steps, and
    harvests rows whose end detector fired (KL(pred || N(1, e)) / d below
    the threshold once min_frames are out) or that reached max_frames.
Semantics match infer/generate.py: the last emitted frame is discarded,
and sigma rows carry their SAMPLED latents.

The state lives on the device and is updated in place (the JAX package
donates its buffers to the same effect). In each decode layer:
  * with a bf16 or f32 KV cache, K1 runs in its sideband mode: it reads
    the cache BEFORE this step's write, with this step's K/V column beside
    it, and the column is then written to each row's slot in one indexed
    write on the same stream;
  * with an int8 KV cache, the quantised column is written first and K1's
    int8 mode reads it (the sideband takes no int8 cache, as in JAX).
Every t=1 step goes through K1; per-channel int8 layer weights stream
through K2/K3 (the fused decode layout's wqkv in one K2 launch, its wgu
through K3's fused mode), and dense and group-wise (int4) ones take
`maybe_matmul` (llama._qkv / llama._proj / llama._mlp).

`decode_until` is a host loop that reads one flag a step (the JAX package
runs it as a device `while_loop`). Sampling draws from a `torch.Generator`
seeded from `seed`; it gives other numbers than `jax.random`, so parity
with JAX is held with greedy=True.

Not ported yet: `state_pspecs`/`shard_state` and the `mesh` argument
(multi-GPU serving), which raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.config import LlasaConfig, torch_dtype
from ..models.lm import llama, llasa
from ..ops.kernels.decode_attention import decode_attention_cached
from .generate import _head_step


@dataclass
class ServeState:
    k: torch.Tensor                   # (L, B, nkv, hd, C) transposed keys
    v: torch.Tensor                   # (L, B, nkv, C, hd)
    # int8-KV mode (cfg.llama.kv_cache_dtype == "int8"): k/v int8 plus
    # per-(token, head) scales, as in llama.KVCache
    k_scale: Optional[torch.Tensor]   # (L, B, nkv, 1, C) f32 or None
    v_scale: Optional[torch.Tensor]
    valid: torch.Tensor               # (B, C) bool: attendable cache slots
    length: torch.Tensor              # (B,) int64: next write slot per row
    pos: torch.Tensor                 # (B,) int64: next local RoPE position
    last_hidden: torch.Tensor         # (B, 1, h)
    means: torch.Tensor               # (B, max_frames, d)
    logs: torch.Tensor                # (B, max_frames, d)
    samples: torch.Tensor             # (B, max_frames, d)
    n_frames: torch.Tensor            # (B,) int64
    done: torch.Tensor                # (B,) bool
    active: torch.Tensor              # (B,) bool: the row holds a live request


def init_state(cfg: LlasaConfig, batch_size: int, cache_len: int, max_frames: int,
               device="cuda") -> ServeState:
    lcfg = cfg.llama
    dt = torch_dtype(lcfg.dtype)
    cache = llama.KVCache.zeros(lcfg, batch_size, cache_len, device=device)
    d = cfg.latent_dim

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ServeState(
        k=cache.k, v=cache.v, k_scale=cache.k_scale, v_scale=cache.v_scale,
        valid=zeros(batch_size, cache_len, dtype=torch.bool),
        length=zeros(batch_size, dtype=torch.long),
        pos=zeros(batch_size, dtype=torch.long),
        last_hidden=zeros(batch_size, 1, lcfg.hidden_size),
        means=zeros(batch_size, max_frames, d),
        logs=zeros(batch_size, max_frames, d),
        samples=zeros(batch_size, max_frames, d),
        n_frames=zeros(batch_size, dtype=torch.long),
        done=zeros(batch_size, dtype=torch.bool),
        active=zeros(batch_size, dtype=torch.bool),
    )


# ---------------------------------------------------------------------------
# prefill + insert
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params: dict, cfg: LlasaConfig, ids: torch.Tensor, mask: torch.Tensor):
    """LEFT-padded (1, bucket) prompt -> (row cache, last hidden (1, 1, h),
    n_tokens (1,))."""
    lcfg = cfg.llama
    b, tp = ids.shape
    embeds = llama.embed_tokens(params["llama"], ids, lcfg)
    embeds = embeds * mask[..., None].to(embeds.dtype)
    n_tokens = mask.sum(dim=1)
    positions = (torch.arange(tp, device=ids.device)[None, :]
                 - (tp - n_tokens)[:, None]).clamp_min(0)
    cache = llama.KVCache.zeros(lcfg, b, tp, device=ids.device)
    hidden, cache = llama.forward_with_cache(params["llama"], lcfg, embeds, cache,
                                             attention_mask=mask.bool(), positions=positions)
    return cache, hidden[:, -1:, :], n_tokens


def insert(state: ServeState, row: int, cache: llama.KVCache, hidden: torch.Tensor,
           mask: torch.Tensor, n_tokens: torch.Tensor) -> None:
    """Splice a prefilled request into batch row `row`, in place. The prompt
    occupies slots [0, bucket); generation continues at slot `bucket`."""
    bucket = cache.max_len
    state.k[:, row, ..., :bucket] = cache.k[:, 0]
    state.v[:, row, :, :bucket] = cache.v[:, 0]
    if state.k_scale is not None:
        state.k_scale[:, row, ..., :bucket] = cache.k_scale[:, 0]
        state.v_scale[:, row, ..., :bucket] = cache.v_scale[:, 0]
    state.valid[row] = False
    state.valid[row, :bucket] = mask[0].bool()
    state.length[row] = bucket
    state.pos[row] = n_tokens[0]
    state.last_hidden[row] = hidden[0].to(state.last_hidden.dtype)
    for buf in (state.means, state.logs, state.samples):
        buf[row] = 0
    state.n_frames[row] = 0
    state.done[row] = False
    state.active[row] = True


# ---------------------------------------------------------------------------
# decode step (per-row slots)
# ---------------------------------------------------------------------------

def _decode_layer(cfg, x: torch.Tensor, lp: dict, cos, sin, state: ServeState, li: int,
                  mask: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """x (B, 1, h) through layer `li`, writing each row's new K/V at its own
    slot `state.length` of the layer-stacked cache, in place. `mask` (B, C)
    is the cache's validity: before this step's column for the sideband,
    after it for an int8 cache; `live` (B,) marks the rows whose column
    counts. Rows that are not live write their slot too, harmlessly: the
    slot is masked for them and their length stays."""
    dt = x.dtype
    B = x.shape[0]
    nq, hd = cfg.num_heads, cfg.head_dim
    rows = torch.arange(B, device=x.device)
    slot = state.length

    q, k, v = llama._qkv(cfg, llama.rms_norm(x, lp["attn_norm"].to(dt), cfg.rms_norm_eps),
                         lp, True)
    q, k = llama.apply_rope(q, cos, sin), llama.apply_rope(k, cos, sin)

    if state.k_scale is not None:  # int8 KV: write the quantised column, then read it
        kq, ks = llama._quantize_kv(k)
        vq, vs = llama._quantize_kv(v)
        state.k_scale[li, rows, :, 0, slot] = ks[:, 0, :, 0]
        state.v_scale[li, rows, :, 0, slot] = vs[:, 0, :, 0]
        state.k[li, rows, :, :, slot] = kq[:, 0]
        state.v[li, rows, :, slot, :] = vq[:, 0]
        attn = decode_attention_cached(q[:, 0], state.k, state.v, li, mask,
                                       state.k_scale, state.v_scale)
    else:  # the sideband reads the cache before this step's write
        kn = k[:, 0].to(state.k.dtype).contiguous()
        vn = v[:, 0].to(state.v.dtype).contiguous()
        attn = decode_attention_cached(q[:, 0], state.k, state.v, li, mask,
                                       k_new=kn, v_new=vn, new_valid=live)
        state.k[li, rows, :, :, slot] = kn
        state.v[li, rows, :, slot, :] = vn

    x = x + llama._proj(attn.reshape(B, 1, nq * hd), lp["wo"], True)
    return x + llama._mlp(llama.rms_norm(x, lp["mlp_norm"].to(dt), cfg.rms_norm_eps),
                          lp, True)


@torch.no_grad()
def decode_step(params: dict, state: ServeState, cfg: LlasaConfig,
                generator: Optional[torch.Generator], greedy: bool = False) -> None:
    """One frame for every live row, in place; finished and empty rows are
    frozen."""
    lcfg = cfg.llama
    dt = torch_dtype(lcfg.dtype)
    B, max_frames = state.means.shape[:2]
    rows = torch.arange(B, device=state.done.device)

    live = state.active & ~state.done
    mean, logs, sample = _head_step(cfg, params, state.last_hidden, generator, greedy)
    kl = llasa.end_kl(cfg, mean, torch.exp(logs.float()))[:, 0]
    fi = state.n_frames.clamp_max(max_frames - 1)
    sel = live[:, None]
    for buf, new in ((state.means, mean), (state.logs, logs), (state.samples, sample)):
        buf[rows, fi] = torch.where(sel, new[:, 0].to(buf.dtype), buf[rows, fi])
    newly_done = ((kl < cfg.end_kl_threshold) & (state.n_frames >= cfg.min_frames)) \
        | (state.n_frames + 1 >= max_frames)
    state.n_frames += live.long()
    state.done |= live & newly_done

    # next-token forward for the live rows
    x = llasa.audio_proj(params, sample, dt)
    cos, sin = llama.rope_cos_sin(lcfg, state.pos[:, None])
    int8 = state.k_scale is not None
    if int8:  # K1's int8 mode reads the column it writes: mark it first
        state.valid[rows, state.length] |= live
    for li, lp in enumerate(llama.layer_params(params["llama"]["layers"])):
        x = _decode_layer(lcfg, x, lp, cos, sin, state, li, state.valid, live)
    x = llama.rms_norm(x, params["llama"]["final_norm"].to(dt), lcfg.rms_norm_eps)

    if not int8:
        state.valid[rows, state.length] |= live
    state.last_hidden.copy_(torch.where(live[:, None, None], x, state.last_hidden))
    state.length += live.long()
    state.pos += live.long()


def decode_until(params: dict, state: ServeState, cfg: LlasaConfig,
                 generator: Optional[torch.Generator], max_steps: int,
                 greedy: bool = False) -> int:
    """Decode steps until some row completes (the host must harvest it), no
    row is live, or `max_steps` elapse; returns the number of steps. One
    device-to-host flag read a step."""
    n = 0
    while n < max_steps:
        stop = (state.active & state.done).any() | ~(state.active & ~state.done).any()
        if bool(stop):
            break
        decode_step(params, state, cfg, generator, greedy)
        n += 1
    return n


# ---------------------------------------------------------------------------
# host loop
# ---------------------------------------------------------------------------

class Completion(NamedTuple):
    index: int                 # position in the submitted prompt sequence
    means: np.ndarray          # (n, d)
    log_scales: np.ndarray     # (n, d)
    samples: np.ndarray        # (n, d)
    n_frames: int              # valid frames (last frame discarded)
    steps_waited: int          # decode steps from admission to completion


class Chunk(NamedTuple):
    """New frames of one request (streaming mode). The consumer decodes
    them through the codec and appends to the request's wav stream
    (serve/web.wav_chunk_header sends a header with no fixed length)."""
    index: int                 # request index
    means: np.ndarray          # (k, d) frames since the last chunk
    samples: np.ndarray        # (k, d)
    start_frame: int           # offset of means[0] in the full stream
    final: bool                # True on the request's last chunk


def _frame_windows(means: torch.Tensor, samples: torch.Tensor, starts: np.ndarray,
                   n: int):
    """Row r's frames [starts[r], starts[r] + n) of both buffers, fetched to
    the host as f32: O(B x n x d) a sync instead of the full buffers.
    Callers keep starts[r] + n <= max_frames."""
    idx = torch.as_tensor(starts, device=means.device)[:, None] \
        + torch.arange(n, device=means.device)
    rows = torch.arange(means.shape[0], device=means.device)[:, None]
    both = torch.stack([means[rows, idx], samples[rows, idx]]).float().cpu().numpy()
    return both[0], both[1]


class ContinuousBatcher:
    """Admit prompts into free rows of a persistent decode batch. Entry
    points run on `device` ("cuda" unless the caller asks for the CPU); the
    params must be there."""

    def __init__(self, params: dict, cfg: LlasaConfig, batch_size: int = 8,
                 max_frames: int = 200,
                 prompt_buckets: Sequence[int] = (16, 32, 64, 128),
                 seed: int = 0, greedy: bool = False, mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError("multi-GPU serving (mesh=) is not ported")
        self.greedy = greedy
        self.params = params
        self.cfg = cfg
        self.B = batch_size
        self.max_frames = max_frames
        self.buckets = tuple(sorted(prompt_buckets))
        self.device = torch.device(device)
        # every row's slot stays below C: a row writes at most at
        # bucket + max_frames (the JAX package rounds to 128 for its kernel)
        cache_len = -(-(self.buckets[-1] + max_frames + 1) // 128) * 128
        self.state = init_state(cfg, batch_size, cache_len, max_frames, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.row_req: List[Optional[int]] = [None] * batch_size
        self.row_admit_step: List[int] = [0] * batch_size
        self.step_count = 0

    def _bucket(self, n: int) -> int:
        for bk in self.buckets:
            if bk >= n:
                return bk
        raise ValueError(f"prompt length {n} exceeds largest bucket {self.buckets[-1]}")

    def _admit(self, row: int, req_idx: int, ids: np.ndarray) -> None:
        bk = self._bucket(len(ids))
        buf = np.zeros((1, bk), np.int64)
        msk = np.zeros((1, bk), np.int64)
        buf[0, bk - len(ids):] = ids
        msk[0, bk - len(ids):] = 1
        tbuf = torch.as_tensor(buf, device=self.device)
        tmsk = torch.as_tensor(msk, device=self.device)
        cache, hidden, n_tokens = prefill(self.params, self.cfg, tbuf, tmsk)
        insert(self.state, row, cache, hidden, tmsk, n_tokens)
        self.row_req[row] = req_idx
        self.row_admit_step[row] = self.step_count

    def _free_rows(self) -> List[int]:
        active = self.state.active.cpu().numpy()
        return [r for r in range(self.B) if not active[r]]

    def _step(self, max_steps: int) -> None:
        self.step_count += decode_until(self.params, self.state, self.cfg, self.generator,
                                        max_steps=max_steps, greedy=self.greedy)

    def _harvest(self) -> List[Completion]:
        """Pull finished rows off the device and free them."""
        s = self.state
        finished, n_emitted = torch.stack([(s.active & s.done).long(),
                                           s.n_frames]).cpu().numpy()
        out = []
        for r in np.flatnonzero(finished):
            n = max(int(n_emitted[r]) - 1, 0)  # the last frame is discarded
            frames = torch.stack([s.means[r, :n], s.logs[r, :n], s.samples[r, :n]])
            m, lg, sm = frames.float().cpu().numpy()
            out.append(Completion(index=self.row_req[r], means=m, log_scales=lg,
                                  samples=sm, n_frames=n,
                                  steps_waited=self.step_count - self.row_admit_step[r]))
            s.active[r] = False
            self.row_req[r] = None
        return out

    def poll_chunks(self, emitted: Dict[int, int], window: int) -> List[Chunk]:
        """Chunk events for every live row with frames beyond `emitted`
        (request index -> frames already streamed; updated in place). The
        fetch is a per-row window of `window` frames (`_frame_windows`), so
        callers that sync at least every `window` steps pay O(new frames) a
        sync; a row that outran the window widens that call's fetch."""
        s = self.state
        n_frames = s.n_frames.cpu().numpy()
        done, active = torch.stack([s.done, s.active]).cpu().numpy()
        rows = []  # (row, request index, lo, avail)
        for r in range(self.B):
            idx = self.row_req[r]
            if idx is None or not active[r]:
                continue
            # a live row streams all but its last emitted frame (it may be
            # the discarded one); a done row the same n - 1
            avail = max(int(n_frames[r]) - 1, 0)
            lo = emitted.get(idx, 0)
            if avail > lo:
                rows.append((r, idx, lo, avail))
        if not rows:
            return []
        need = max(avail - lo for _, _, lo, avail in rows)
        # whole multiples of `window`, at most max_frames
        n = min(-(-need // window) * window, self.max_frames)
        starts = np.zeros((self.B,), np.int64)
        for r, _, lo, _ in rows:
            starts[r] = min(lo, self.max_frames - n)
        w_means, w_samples = _frame_windows(s.means, s.samples, starts, n)
        out = []
        for r, idx, lo, avail in rows:
            es = int(starts[r])
            out.append(Chunk(index=idx, means=w_means[r, lo - es:avail - es],
                             samples=w_samples[r, lo - es:avail - es],
                             start_frame=lo, final=bool(done[r])))
            emitted[idx] = avail
        return out

    def run_iter(self, prompts: Iterable[np.ndarray]):
        """prompts: int token-id arrays. Yields each Completion the moment
        its row finishes (completion order; .index maps back)."""
        pending = list(enumerate(prompts))
        pending.reverse()  # pop() takes them in submission order
        n_total, n_done = len(pending), 0
        while n_done < n_total:
            free = self._free_rows()
            while pending and free:
                idx, ids = pending.pop()
                self._admit(free.pop(0), idx, np.asarray(ids, np.int64))
            self._step(self.max_frames + 1)
            for c in self._harvest():
                n_done += 1
                yield c

    def run(self, prompts: Iterable[np.ndarray]) -> List[Completion]:
        return list(self.run_iter(prompts))

    def serve(self, prompts: Sequence[np.ndarray],
              arrivals: Optional[Sequence[float]] = None,
              chunk_frames: int = 0, clock=None, sleep=None):
        """Open-loop serving: request i becomes admittable at `arrivals[i]`
        seconds after the call (None: all at 0, closed loop). With
        chunk_frames > 0 the host syncs every chunk_frames decode steps and
        streams Chunk events for the live rows, so the first audio comes at
        the first chunk, not at the completion.

        Yields ("chunk", Chunk) and ("done", Completion). `clock`/`sleep`
        default to time.monotonic/time.sleep; a fake clock needs a fake
        sleep, or waits for a future arrival sleep real seconds."""
        clock = clock or time.monotonic
        sleep = sleep or time.sleep
        t0 = clock()
        arr = list(arrivals) if arrivals is not None else [0.0] * len(prompts)
        order = sorted(range(len(prompts)), key=lambda i: arr[i])
        pending = [(i, np.asarray(prompts[i], np.int64)) for i in order]
        pending.reverse()  # pop() takes them in arrival order
        emitted: Dict[int, int] = {}
        n_done, n_total = 0, len(prompts)
        sync_steps = chunk_frames if chunk_frames > 0 else self.max_frames + 1

        while n_done < n_total:
            now = clock() - t0
            free = self._free_rows()
            while pending and free and arr[pending[-1][0]] <= now:
                idx, ids = pending.pop()
                self._admit(free.pop(0), idx, ids)
                emitted[idx] = 0
            if not bool(self.state.active.any()):
                if not pending:
                    break  # nothing live, nothing waiting
                sleep(max(0.0, arr[pending[-1][0]] - (clock() - t0)))
                continue
            self._step(sync_steps)
            if chunk_frames > 0:
                for ch in self.poll_chunks(emitted, window=chunk_frames):
                    yield ("chunk", ch)
            for c in self._harvest():
                n_done += 1
                if chunk_frames > 0 and emitted.get(c.index, 0) < c.n_frames:
                    lo = emitted[c.index]
                    yield ("chunk", Chunk(index=c.index, means=c.means[lo:],
                                          samples=c.samples[lo:], start_frame=lo,
                                          final=True))
                    emitted[c.index] = c.n_frames
                yield ("done", c)
