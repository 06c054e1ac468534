"""One-command experiment chain of the port (counterpart of
tools/run_experiment.py): train -> checkpoint -> reload -> synthesize the
test set -> score, in one process, writing `experiment.json` with the JAX
tool's keys and pass/fail gates.

  1. fabricate a dataset: synthetic spoken rows (data/synth_speech.py)
     encoded through a frozen SigmaVAE (briefly pretrained on the render
     bank, recon only) -> latent .npy + wav + jsonl; optionally train the
     CTC ASR through the codec channel (the WER arm)
  2. train the LM through `train.trainer.Trainer` (torch checkpoints)
  3. reload the checkpoint into a fresh state
  4. `InferTools.infer_jsonl` over the rows: {utt}.txt, {utt}---copysyn.wav,
     {utt}---gen.wav
  5. score: the latent gate, the CTC WER, the trained speaker embedder's
     margin and speaker similarity, the prompt-clone gate and the
     end-detection gate

    python -m kalle_tpu_torch.tools.run_experiment --tiny --device cpu   (CPU smoke)
    python -m kalle_tpu_torch.tools.run_experiment --tiny                (on the card)

Runs on the card unless --device says otherwise; the flags, defaults and
JSON keys are the JAX tool's, with --device in place of --platform and
--seed added. The
line before the last gives the generate loop's steps, and the last line
the hand-written kernels' launch counts (empty on the CPU). The
random draws are the port's (torch generators), so numbers differ from the
JAX tool's run for run; the gates are the same.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

import numpy as np
import torch


def pretrain_codec(cfg, params, steps: int, batch: int = 4, clip_seconds: float = 1.0,
                   lr: float = 1e-3, seed: int = 0, tiny: bool = False):
    """Brief recon-only pretraining of the frozen codec on the synthetic
    render bank (the JAX tool's `pretrain_codec`): the codec trainer's
    generator step with the GAN off, MRSTFT (+ L1 off tiny) and KL, AdamW
    (0.8, 0.99) under a cosine decay to 2%. Trains `params` in place, on
    their device. Returns (params, holdout SNR in dB)."""
    from ..bridge import tree_leaves, tree_map
    from ..data import synth_speech as sl
    from ..models.codecs import sigmavae as sv
    from ..train import codec_trainer as ct
    from ..train.optim import cosine_decay

    dev = tree_leaves(params)[0].device
    rng_np = np.random.default_rng(seed)
    T = int(cfg.sample_rate * clip_seconds)
    T -= T % cfg.hop

    def make_clip(i, seed_off=0):
        text = sl.random_sentence(rng_np)
        while len(sl.render(text, cfg.sample_rate, speaker=i % 4, seed=seed_off + i)) < T:
            text += " " + sl.random_sentence(rng_np)
        return sl.render(text, cfg.sample_rate, speaker=i % 4, seed=seed_off + i)[:T]

    bank = torch.from_numpy(np.stack([make_clip(i) for i in range(8 * batch)])[:, None, :]
                            ).to(dev)
    gen_tx = ct.CodecOptimizer(lr=lr, betas=(0.8, 0.99), schedule=cosine_decay(lr, steps, 0.02))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt, sched = gen_tx.build(leaves)
    # recon only: no discriminator, so no discriminator optimizer
    state = ct.CodecTrainState(gen_params=params, disc_params={}, gen_opt=opt, disc_opt=None,
                               gen_sched=sched, disc_sched=None)
    res = ((512, 128, 512), (128, 32, 128)) if tiny else None
    weights = ct.LossWeights(mrstft=1.0, l1=0.0 if tiny else 0.1, mse=0.0, adv=0.0, fm=0.0,
                             kl=1e-4)
    generator = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(steps):
        idx = torch.from_numpy(rng_np.choice(bank.shape[0], batch, replace=False)).to(dev)
        ct.generator_step(state, "sigma", cfg, None, weights, bank[idx], generator,
                          gan_on=False, resolutions=res)
    trained = tree_map(lambda t: t.detach(), state.gen_params)

    # holdout SNR: one render the pretrain never saw, mean-latent round trip
    hold = make_clip(97, seed_off=10_000)
    with torch.no_grad():
        x_t = torch.from_numpy(hold[None, None]).to(dev)
        rec = sv.decode(trained, cfg, sv.encode(trained, cfg, x_t)).float().cpu().numpy()
    n = min(rec.shape[-1], hold.shape[-1])
    x = hold[:n]
    e = rec[0, 0, :n] - x
    snr = 10.0 * np.log10(np.mean(x * x) / (np.mean(e * e) + 1e-12))
    return trained, float(snr)


def fabricate_dataset(codec, data_dir: str, n_rows: int, seconds: float, seed: int = 0):
    """Spoken rows -> frozen-codec latents (.npy) + wavs + jsonl (the JAX
    tool's `fabricate_dataset`: the same texts, renders and files)."""
    from ..data import synth_speech as sl
    from ..utils.audio import write_wav

    os.makedirs(data_dir, exist_ok=True)
    sr = codec.sample_rate
    rng = np.random.default_rng(seed)
    T = int(sr * seconds)
    # nominal char budget with ~22% headroom for the renderer's duration
    # jitter; re-render shorter on the rare overshoot
    n_chars = max(int(seconds / sl.CHAR_SECONDS * 0.78), 3)
    rows = []
    for i in range(n_rows):
        text = ""
        while len(text) < n_chars:
            text = (text + " " + sl.random_sentence(rng)).strip()
        text = text[:n_chars].strip()
        clip = sl.render(text, sr, speaker=i % 4, seed=seed * 1000 + i)
        while len(clip) > T and len(text) > 3:
            text = text[:-1].strip()
            clip = sl.render(text, sr, speaker=i % 4, seed=seed * 1000 + i)
        clip = np.pad(clip, (0, T - len(clip)))
        with torch.no_grad():
            mean = codec.encode_audio(clip[None])[0]
        utt = f"utt{i:03d}"
        vae = os.path.join(data_dir, f"{utt}.npy")
        wav = os.path.join(data_dir, f"{utt}.wav")
        np.save(vae, mean.astype(np.float32))  # (T, d) sigma layout
        write_wav(wav, clip[None], sr)
        rows.append({"id": utt, "caption": text, "vae": vae, "speech": wav,
                     "speaker": i % 4})
    meta = os.path.join(data_dir, "meta.jsonl")
    with open(meta, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return meta, rows


def _ids(tokenizer, text: str, dev) -> torch.Tensor:
    from ..data.tokens import build_prompt_ids

    return torch.tensor([build_prompt_ids(tokenizer, text)], device=dev)


def _gt_latents(row) -> np.ndarray:
    gt = np.load(row["vae"])
    return gt[0] if gt.ndim == 3 else gt


def latent_gate(params, cfg, tokenizer, rows, max_frames: int) -> float:
    """Greedy decode per row; the mean over rows of the MSE of generated
    vs ground-truth latent means over the overlapping frames, relative to
    the ground truth's variance (an overfit model reproduces its training
    latents)."""
    from ..infer.generate import generate

    dev = params["audio_linear"]["w"].device
    errs = []
    for row in rows:
        gt = _gt_latents(row)
        ids = _ids(tokenizer, row["caption"], dev)
        res = generate(params, cfg, ids, torch.ones_like(ids, dtype=torch.int32),
                       torch.Generator(device=dev).manual_seed(7), max_frames=max_frames,
                       end_kl_threshold=-1.0, greedy=True)
        pred = res.means[0].float().cpu().numpy()
        n = min(len(gt), pred.shape[0])
        err = float(np.mean((pred[:n] - gt[:n]) ** 2))
        errs.append(err / (float(np.var(gt[:n])) + 1e-9))
    return float(np.mean(errs))


def prompt_clone_gate(params, cfg, tokenizer, codec, rows, out_dir, embed_fn,
                      max_frames: int):
    """Voice-cloning acceptance: generation conditioned on the first half of
    each row's ground-truth latents must land closer to its own prompt than
    to the other rows' (latent fingerprints: per-dim mean and std over time,
    each pool centred). The decoded wavs' sims through `embed_fn` are
    returned beside. -> (lat_pos, lat_neg, audio_pos, audio_neg)."""
    from ..infer.generate import generate
    from ..utils.audio import write_wav

    os.makedirs(out_dir, exist_ok=True)
    dev = params["audio_linear"]["w"].device

    def fp(lat):
        return np.concatenate([lat.mean(axis=0), lat.std(axis=0)])

    prompt_paths, gen_paths, fp_p, fp_g = [], [], [], []
    for row in rows:
        gt = _gt_latents(row)
        half = max(len(gt) // 2, 1)
        ids = _ids(tokenizer, row["caption"], dev)
        res = generate(params, cfg, ids, torch.ones_like(ids, dtype=torch.int32),
                       torch.Generator(device=dev).manual_seed(13), max_frames=max_frames,
                       end_kl_threshold=-1.0, greedy=True,
                       prompt_latents=torch.from_numpy(gt[None, :half]).float().to(dev))
        n = max(int(res.n_frames[0]) - 1, 1)
        lat = res.means[0, :n].float().cpu().numpy()
        fp_p.append(fp(gt[:half].astype(np.float32)))
        fp_g.append(fp(lat))
        gen = codec.decode_latents(lat[None])[0]
        prm = codec.decode_latents(gt[None, :half].astype(np.float32))[0]
        gp = os.path.join(out_dir, row["id"] + "---promptgen.wav")
        pp = os.path.join(out_dir, row["id"] + "---prompt.wav")
        write_wav(gp, gen, codec.sample_rate)
        write_wav(pp, prm, codec.sample_rate)
        prompt_paths.append(pp)
        gen_paths.append(gp)

    emb_p = [embed_fn(p) for p in prompt_paths]
    emb_g = [embed_fn(p) for p in gen_paths]

    def cos(a, b):
        return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))

    def pos_neg(ps, gs):
        # centre each pool: raw fingerprints share a large common component
        ps = [p - np.mean(ps, axis=0) for p in ps]
        gs = [g - np.mean(gs, axis=0) for g in gs]
        n = len(rows)
        pos = [cos(ps[i], gs[i]) for i in range(n)]
        neg = [cos(ps[i], gs[j]) for i in range(n) for j in range(n) if j != i]
        return float(np.mean(pos)), (float(np.mean(neg)) if neg else 0.0)

    lat_pos, lat_neg = pos_neg(fp_p, fp_g)
    aud_pos, aud_neg = pos_neg(emb_p, emb_g)
    return lat_pos, lat_neg, aud_pos, aud_neg


def end_detection_gate(rows, tokenizer, steps: int, tol: int, seed: int = 0, device="cuda"):
    """End-detection accuracy on a head whose detector fires (the sigma
    head's end-KL floor, ~1.21, sits above the 0.5 threshold): a small
    stableaudio-head LM trained on the fabricated latents (labels
    mean || 0.5, end loss weight 1), then greedy generation's stop frame
    against each row's length. -> (share of rows within `tol` frames, mean
    absolute frame error)."""
    from ..core.config import LlamaConfig, LlasaConfig, TrainConfig
    from ..data.collate import Item, collate
    from ..data.tokens import build_prompt_ids
    from ..infer.generate import generate
    from ..models.lm import llasa
    from ..train.step import make_train_state, train_step
    from ..train.trainer import device_batch

    dev = torch.device(device)
    d = np.load(rows[0]["vae"]).shape[-1]
    cfg = LlasaConfig(llama=LlamaConfig.tiny(vocab_size=300), latent_dim=d,
                      audio_proj_dim=64, head_variant="stableaudio")
    tcfg = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=steps, end_loss_weight=1.0)

    items, gt_lens = [], []
    for row in rows:
        lat = _gt_latents(row).astype(np.float32)
        # bound the sequence: the gate tests the stop detector, which is
        # length independent
        lat = lat[::max(len(lat) // 200, 1)]
        ids = np.asarray(build_prompt_ids(tokenizer, row["caption"]), np.int32)
        dist = np.concatenate([lat, 0.5 * np.ones_like(lat)], axis=-1)
        items.append(Item(input_ids=ids, audio_latents=lat, audio_distribution=dist))
        gt_lens.append(len(lat))
    batch = device_batch(collate(items, pad_token_id=tokenizer.pad_token_id), dev)

    params = llasa.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    state = make_train_state(params, tcfg)
    for _ in range(steps):
        train_step(state, cfg, tcfg, batch, seed=1)
    errs = []
    for row, gt_len in zip(rows, gt_lens):
        ids = _ids(tokenizer, row["caption"], dev)
        res = generate(state.params, cfg, ids, torch.ones_like(ids, dtype=torch.int32),
                       torch.Generator(device=dev).manual_seed(21), max_frames=gt_len + 8,
                       greedy=True)
        # n_frames counts the end-distribution frame too (discard-last)
        n_valid = max(int(res.n_frames[0]) - 1, 0)
        errs.append(abs(n_valid - gt_len))
    return float(np.mean([e <= tol for e in errs])), float(np.mean(errs))


def tiny_experiment(exp, steps: int):
    """The --tiny operating point, self-consistent at sigma 0.1 (model
    noising, sampling, copysyn, codec pretrain), 8 kHz and hop 20: the tiny
    LM in `exp` and the codec's config. -> (exp, codec_cfg)"""
    from ..core.config import LlamaConfig, LlasaConfig
    from ..models.codecs import sigmavae

    model = LlasaConfig(llama=LlamaConfig.tiny(vocab_size=300), latent_dim=8,
                        audio_proj_dim=64, head_variant="sigma", sigma=0.1)
    codec_cfg = sigmavae.SigmaVAEConfig(latent_dim=8, sample_rate=8000, strides=(4, 5),
                                        channels=(24, 48), blocks_per_stage=1,
                                        fused_blocks=False, sigma=0.1)
    train = dataclasses.replace(exp.train, lr=3e-3, warmup_steps=5, save_interval=steps,
                                log_interval=10)
    return dataclasses.replace(exp, model=model, train=train,
                               project_name=exp.project_name + "-tiny"), codec_cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default="configs/sigma_overfit.yaml")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model + tiny codec (CPU smoke / pytest)")
    ap.add_argument("--steps", type=int, default=None,
                    help="train steps (default: 200 flagship, 40 tiny)")
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--exp-dir", default="")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--latent-gate", type=float, default=1.0,
                    help="pass threshold on relative latent MSE")
    ap.add_argument("--loss-drop", type=float, default=0.5,
                    help="required final/first audio-loss ratio")
    ap.add_argument("--asr-lang", default="",
                    help="run the Whisper/Paraformer WER pipeline (en|zh); those need "
                         "downloaded weights, which the port does not load, so the arm "
                         "reports that it was skipped")
    ap.add_argument("--skip-wer", action="store_true",
                    help="skip the self-contained CTC WER gate")
    ap.add_argument("--wer-copysyn-gate", type=float, default=25.0,
                    help="max WER%% for codec round-trip outputs")
    ap.add_argument("--wer-gen-gate", type=float, default=40.0,
                    help="max WER%% for LM-generated outputs")
    ap.add_argument("--ctc-steps", type=int, default=None,
                    help="CTC ASR training steps (default 2500)")
    ap.add_argument("--codec-steps", type=int, default=None,
                    help="recon-only pretrain steps for the frozen codec "
                         "(default 1200 tiny / 2000 full; 0 = random-init)")
    ap.add_argument("--spk-steps", type=int, default=350,
                    help="speaker-classification training steps for the ECAPA "
                         "embedder (0 = random-init ECAPA, no margin gate)")
    ap.add_argument("--spk-margin", type=float, default=0.15,
                    help="required heldout pos-neg cosine margin")
    ap.add_argument("--end-steps", type=int, default=None,
                    help="train steps for the end-detection arm (default 150)")
    ap.add_argument("--end-tol", type=int, default=2,
                    help="end-detection pass tolerance in frames")
    ap.add_argument("--end-acc", type=float, default=0.75,
                    help="required fraction of rows stopping within --end-tol frames")
    ap.add_argument("--seed", type=int, default=0,
                    help="offset of the seeds of the frozen codec (init, pretraining), "
                         "the LM (init, batch order, noise) and the end-detection arm's "
                         "init; the dataset's texts and the evaluators keep theirs; 0 "
                         "keeps every seed as the JAX tool has it (an addition to its "
                         "flags)")
    args = ap.parse_args(argv)

    from ..bridge import tree_map
    from ..core.checkpoint import CheckpointManager
    from ..core.config import load_experiment_config
    from ..data.collate import Item, collate
    from ..data.tokens import build_prompt_ids, build_tokenizer
    from ..eval import harness
    from ..infer import generate as gen_mod
    from ..infer.pipeline import Codec, InferTools
    from ..models.codecs import sigmavae
    from ..models.lm import llasa
    from ..ops.kernels import _build
    from ..train.step import loss_fn, make_train_state
    from ..train.trainer import Trainer, device_batch
    from .common import device

    dev = device(args.device)
    t0 = time.time()
    steps0 = gen_mod.decode_steps
    exp = load_experiment_config(args.config)
    steps = args.steps or (40 if args.tiny else 200)
    if args.tiny:
        exp, codec_cfg = tiny_experiment(exp, steps)
    else:
        codec_cfg = sigmavae.SigmaVAEConfig(latent_dim=exp.model.latent_dim)
        exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                                 save_interval=steps))
    if args.exp_dir:
        exp = dataclasses.replace(exp, exp_dir=args.exp_dir)
    if args.seed:
        exp = dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, seed=exp.train.seed + args.seed))

    run_dir = os.path.join(exp.exp_dir, exp.project_name)
    if os.path.exists(run_dir):
        shutil.rmtree(run_dir)  # a fresh run: no stale checkpoint to resume
    os.makedirs(run_dir, exist_ok=True)

    # ---- stage 1: frozen codec (pretrained stand-in) + dataset ----
    codec_params = sigmavae.init_params(
        codec_cfg, torch.Generator(device=dev).manual_seed(123 + args.seed), dev)
    codec_steps = (1200 if args.tiny else 2000) if args.codec_steps is None \
        else args.codec_steps
    codec_snr = None
    if codec_steps > 0:
        t_cp = time.time()
        codec_params, codec_snr = pretrain_codec(codec_cfg, codec_params, steps=codec_steps,
                                                 clip_seconds=min(args.seconds, 1.0),
                                                 seed=args.seed, tiny=args.tiny)
        print(f"[1a] frozen-codec pretrain: {codec_steps} recon steps, "
              f"holdout SNR {codec_snr:.1f} dB, {time.time() - t_cp:.1f}s")
    codec = Codec("sigma", codec_cfg, codec_params)
    data_dir = os.path.join(run_dir, "data")
    meta, rows = fabricate_dataset(codec, data_dir, args.rows, args.seconds)
    exp = dataclasses.replace(exp, data=dataclasses.replace(exp.data, meta_path=meta))
    frames_per_row = int(args.seconds * codec_cfg.sample_rate) // codec_cfg.hop
    max_frames = args.max_frames or frames_per_row + 8
    print(f"[1/5] dataset: {len(rows)} rows, {frames_per_row} frames/row, "
          f"codec hop {codec_cfg.hop} @ {codec_cfg.sample_rate} Hz")

    # ---- stage 1b: the CTC ASR, trained through the codec channel ----
    transcriber = None
    if not args.skip_wer:
        from ..data import synth_speech as sl_mod
        from ..eval import ctc_asr
        from ..utils.audio import read_wav

        t_ctc = time.time()
        ctc_cfg = ctc_asr.CTCConfig.for_sample_rate(codec_cfg.sample_rate, tiny=args.tiny)
        chan_rng = np.random.default_rng(4242)

        def codec_channel(wav, noise_scale=1.0):
            # the deployment channel: copysyn and sigma-head generation decode
            # SAMPLED latents; noise_scale > 1 covers a sampled rollout's wobble
            n = len(wav)
            q = codec_cfg.hop * 100
            wav = np.pad(wav, (0, -n % q))
            lat = codec.encode_audio(wav[None])
            if noise_scale > 0:
                lat = lat + noise_scale * codec_cfg.sigma * \
                    chan_rng.standard_normal(lat.shape).astype(np.float32)
            return codec.decode_latents(lat)[0, 0][:n]

        rng_txt = np.random.default_rng(99)
        extra_texts = [sl_mod.random_sentence(rng_txt) for _ in range(24)]
        ctc_texts = [r["caption"] for r in rows] + extra_texts
        ctc_steps = args.ctc_steps or 2500
        pairs = []
        for r in rows:
            wav = read_wav(r["speech"])[0][0].astype(np.float32)
            pairs += [(r["caption"], wav)] + \
                [(r["caption"], codec_channel(wav)) for _ in range(4)] + \
                [(r["caption"], codec_channel(wav, 1.5)) for _ in range(2)] + \
                [(r["caption"], codec_channel(wav, 2.0)) for _ in range(2)]
        ctc_params, ctc_curve = ctc_asr.train_ctc(
            ctc_cfg, ctc_texts, n_speakers=4, n_render=3, steps=ctc_steps, batch=16, lr=2e-3,
            seed=11, channel=codec_channel, channel_prob=0.7, extra_pairs=pairs, device=dev)
        transcriber = ctc_asr.make_ctc_transcriber(ctc_params, ctc_cfg)
        print(f"[1b] CTC ASR trained through the codec channel: {ctc_steps} steps, "
              f"loss {ctc_curve[-1]:.4f}, {time.time() - t_ctc:.1f}s")

    # ---- stage 2: train ----
    tokenizer = build_tokenizer(exp.tokenizer_path or None)
    trainer = Trainer(exp, tokenizer, device=dev)
    t_train = time.time()
    metrics = trainer.fit(max_steps=steps)
    train_s = time.time() - t_train
    last_loss = metrics.get("audio_loss", float("nan"))
    total_loss = metrics.get("total_loss", float("nan"))
    steps_per_s = steps / max(train_s, 1e-9)
    print(f"[2/5] trained {steps} steps in {train_s:.1f}s ({steps_per_s:.2f} steps/s), "
          f"audio_loss {last_loss:.4f}")

    # first-loss reference: the fresh init's loss on the first two rows
    items = []
    for r in rows[:min(2, len(rows))]:
        lat = np.load(r["vae"]).astype(np.float32)
        ids = np.asarray(build_prompt_ids(tokenizer, r["caption"]), np.int32)
        items.append(Item(input_ids=ids, audio_latents=lat, audio_distribution=lat.copy()))
    probe = device_batch(collate(items, pad_token_id=tokenizer.pad_token_id), dev)
    init_params = llasa.init_params(exp.model,
                                    torch.Generator(device=dev).manual_seed(exp.train.seed), dev)
    with torch.no_grad():
        first = float(loss_fn(init_params, exp.model, exp.train, probe,
                              torch.Generator(device=dev).manual_seed(0))[1]["audio_loss"])

    # ---- stage 3: checkpoint round trip ----
    template = make_train_state(tree_map(lambda t: t.clone(), init_params), exp.train)
    ckpt = CheckpointManager(os.path.join(exp.output_dir, "torch"))
    restored, ck_step = ckpt.restore(template)
    if ck_step != steps:
        raise RuntimeError(f"checkpoint step {ck_step} != {steps}")
    params = tree_map(lambda t: t.detach(), restored.params)
    diff = float((params["audio_linear"]["w"].float()
                  - init_params["audio_linear"]["w"].float()).abs().mean())
    if not diff > 0:
        raise RuntimeError("restored params identical to the fresh init")
    print(f"[3/5] checkpoint step {ck_step} restored (mean |delta| vs init {diff:.2e})")

    # ---- stage 4: synthesize the test set ----
    t_syn = time.time()
    tools = InferTools(exp.model, params, tokenizer, codec,
                       output_root=os.path.join(run_dir, "inference_results"),
                       version=exp.project_name, ckpt_name=f"step{ck_step}", timestamp=False)
    written = tools.infer_jsonl(rows, max_frames=max_frames, batch_size=min(4, len(rows)))
    syn_s = time.time() - t_syn
    gen_wavs = [p for p in written if p.endswith("---gen.wav")]
    copysyn_wavs = [p for p in written if p.endswith("---copysyn.wav")]
    rtf = syn_s / max(args.seconds * len(gen_wavs), 1e-9)
    print(f"[4/5] synthesized {len(gen_wavs)} gen + {len(copysyn_wavs)} copysyn wavs in "
          f"{syn_s:.1f}s -> {tools.output_dir}")

    # ---- stage 5: score ----
    rel_mse = latent_gate(params, exp.model, tokenizer, rows, max_frames)
    meta_items = [harness.MetaItem(r["id"], r["caption"], r["speech"], r["caption"])
                  for r in rows]
    spk_margin_pos = spk_margin_neg = None
    if args.spk_steps > 0:
        from ..eval import speaker_embedder as se

        t_spk = time.time()
        spk_cfg = dataclasses.replace(
            se.SpeakerTrainConfig.tiny() if args.tiny else se.SpeakerTrainConfig(),
            sample_rate=min(16000, codec_cfg.sample_rate), steps=args.spk_steps)
        spk_params, spk_ecfg, _ = se.train_speaker_embedder(spk_cfg, device=dev)
        spk_margin_pos, spk_margin_neg = se.margin(spk_params, spk_ecfg, spk_cfg)
        embedder = se.make_trained_embedder(spk_params, spk_ecfg, spk_cfg)
        print(f"      speaker embedder: {args.spk_steps} steps {time.time() - t_spk:.1f}s, "
              f"heldout margin {spk_margin_pos:.3f} pos / {spk_margin_neg:.3f} neg")
    else:
        from ..models.conditioning import ecapa as ecapa_mod

        # the mel frontend emits 80 mels: in_channels stays 80 in tiny mode
        ecfg = ecapa_mod.EcapaConfig(in_channels=80, channels=16, embd_dim=12, scale=4,
                                     attn_bottleneck=8, pooled_channels=48) \
            if args.tiny else ecapa_mod.EcapaConfig()
        embedder = harness.make_ecapa_embedder(
            ecapa_mod.init_params(ecfg, torch.Generator(device=dev).manual_seed(5), dev),
            ecfg, sample_rate=min(16000, codec_cfg.sample_rate))
    spk_sim = harness.speaker_similarity(tools.output_dir, meta_items, embedder)

    spec_embed = harness.make_spectral_embedder(sample_rate=min(16000, codec_cfg.sample_rate),
                                                device=dev)
    pos_sim, neg_sim, aud_pos, aud_neg = prompt_clone_gate(
        params, exp.model, tokenizer, codec, rows, os.path.join(run_dir, "prompt_gate"),
        spec_embed, max_frames)
    end_acc, end_mae = end_detection_gate(rows, tokenizer, steps=args.end_steps or 150,
                                          tol=args.end_tol, seed=args.seed, device=dev)

    meta_lst = os.path.join(run_dir, "meta.lst")
    with open(meta_lst, "w") as f:
        for r in rows:
            f.write(f"{r['id']}|{r['caption']}|{r['speech']}|{r['caption']}\n")

    # self-contained WER at the language's atomic token level (each char of
    # the tone-coded language is one acoustic unit, as CJK chars are)
    wer_copysyn = wer_gen = None
    if transcriber is not None:
        def chars(s):
            return " ".join("_" if c == " " else c for c in s.strip())

        meta_char = os.path.join(run_dir, "meta_chars.lst")
        with open(meta_char, "w") as f:
            for r in rows:
                f.write(f"{r['id']}|{r['caption']}|{r['speech']}|{chars(r['caption'])}\n")

        def char_transcriber(path):
            return chars(transcriber(path))

        wer_copysyn = harness.wer_pipeline("en", tools.output_dir, meta_char,
                                           transcriber=char_transcriber,
                                           gen_suffix="---copysyn.wav")
        wer_gen = harness.wer_pipeline("en", tools.output_dir, meta_char,
                                       transcriber=char_transcriber, gen_suffix="---gen.wav")
        print(f"      WER copysyn {wer_copysyn:.2f}% (gate < {args.wer_copysyn_gate}), "
              f"gen {wer_gen:.2f}% (gate < {args.wer_gen_gate})")

    wer = None
    if args.asr_lang:
        try:
            wer = harness.wer_pipeline(args.asr_lang, tools.output_dir, meta_lst)
        except ValueError as e:  # make_transcriber: no built-in back-end
            print(f"      real-ASR WER skipped: {e}")

    loss_ratio = last_loss / max(first, 1e-9)
    gates = {
        "loss_drop": bool(loss_ratio < args.loss_drop),
        "latent_gate": bool(rel_mse < args.latent_gate),
        "checkpoint_roundtrip": True,
        "all_wavs_written": bool(len(gen_wavs) == len(rows)
                                 and len(copysyn_wavs) == len(rows)),
        "prompt_clone": bool(pos_sim > neg_sim),
        "end_detection": bool(end_acc >= args.end_acc),
    }
    if wer_copysyn is not None:
        gates["wer_copysyn"] = bool(wer_copysyn < args.wer_copysyn_gate)
        gates["wer_gen"] = bool(wer_gen < args.wer_gen_gate)
    if spk_margin_pos is not None:
        gates["speaker_margin"] = bool(spk_margin_pos - spk_margin_neg > args.spk_margin)
    result = {
        "config": args.config,
        "tiny": args.tiny,
        "steps": steps,
        "rows": len(rows),
        "train": {"first_audio_loss": first, "final_audio_loss": last_loss,
                  "final_total_loss": total_loss, "loss_ratio": loss_ratio,
                  "steps_per_s": steps_per_s},
        "checkpoint": {"step": ck_step, "delta_vs_init": diff},
        "synthesis": {"n_gen": len(gen_wavs), "n_copysyn": len(copysyn_wavs),
                      "wall_s": syn_s, "rtf_incl_compile": rtf,
                      "output_dir": tools.output_dir},
        "quality": {"codec_pretrain_snr_db": codec_snr,
                    "speaker_margin_pos": spk_margin_pos,
                    "speaker_margin_neg": spk_margin_neg,
                    "latent_rel_mse": rel_mse, "speaker_sim": spk_sim,
                    "prompt_clone_sim": pos_sim,
                    "prompt_clone_neg_sim": neg_sim,
                    "prompt_clone_audio_sim": aud_pos,
                    "prompt_clone_audio_neg_sim": aud_neg,
                    "end_detection_acc": end_acc,
                    "end_detection_mae_frames": end_mae,
                    "wer_copysyn": wer_copysyn,
                    "wer_gen": wer_gen,
                    "wer": wer},
        "gates": gates,
        "ok": all(gates.values()),
        "total_wall_s": time.time() - t0,
    }
    out_path = os.path.join(run_dir, "experiment.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(f"[5/5] latent rel-MSE {rel_mse:.4f} (gate < {args.latent_gate}), "
          f"loss {first:.3f} -> {last_loss:.3f} "
          f"(ratio {loss_ratio:.3f} gate < {args.loss_drop}), spk-sim {spk_sim:.3f}, "
          f"clone-sim {pos_sim:.3f} vs neg {neg_sim:.3f}, "
          f"end-acc {end_acc:.2f} (mae {end_mae:.1f} fr)")
    print(f"experiment.json -> {out_path}  ok={result['ok']}")
    print(f"decode steps {gen_mod.decode_steps - steps0}")
    print("kernel launches " + json.dumps(_build.launches()))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
