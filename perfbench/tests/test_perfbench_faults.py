"""Whole runs of each driver at a tiny size on the CPU (the harness's look
for a card skipped): sound, they come out correct; with the timed path
broken underneath in each way the cell can break, `correct` comes out
false; and the control (the reference one precision step down, in the
program's place) reads far above the program."""
import re

import pytest
import torch

from perfbench import harness
from perfbench.drivers import stream, synth, train
from perfbench.tests import tiny


def _report_correct(run, outcome) -> bool:
    import json

    spec = {"workloads": [{"name": run.cell}], "end_to_end": [
        {"name": k, "unit": "s"} for k in outcome.end_to_end] + [
        {"name": "setup_s", "unit": "s"}], "per_layer": []}
    line = harness.report(spec, {"name": run.cell}, run, outcome,
                          {"platform": "cpu", "kind": "cpu", "count": 1,
                           "memory_peak_bytes": None})
    return json.loads(line)["correct"]


def _readings(notes, what):
    line = next(n for n in notes if n.startswith(what))
    return {k: float(v) for k, v in re.findall(r"(\w+_gap) (\S+)", line)}


def test_stream_sound_and_control():
    run = tiny.stream_run(controls=True)
    out = stream.run(run)
    assert out.failed == 0 and out.attempted > 0
    assert _report_correct(run, out)
    ctl = _readings(out.notes, "control readings")
    for k, c in out.checks.items():
        assert ctl[k] > 3 * c["value"] and ctl[k] > c["limit"]


def _altered_head(orig, rows=slice(0, 1)):
    def head(cfg, params, hidden, generator, greedy=False, rows_=None):
        mean, logs, sample = orig(cfg, params, hidden, generator, greedy, rows_)
        mean = mean.clone()
        mean[rows] += 0.5  # the frames altered where they are produced
        return mean, logs, sample
    return head


def _frozen_step(orig):
    def step(params, state, cfg, generator, greedy=False, tp=None, noise_rows=None):
        keep = state.last_hidden.clone()
        orig(params, state, cfg, generator, greedy, tp, noise_rows)
        state.last_hidden.copy_(keep)  # the step hands back its state unchanged
    return step


@pytest.mark.parametrize("fault", ["altered_frame", "unchanged_step"])
def test_stream_fault_is_caught(monkeypatch, fault):
    from kalle_tpu_torch.infer import serve_loop

    if fault == "altered_frame":
        monkeypatch.setattr(serve_loop, "_head_step", _altered_head(serve_loop._head_step))
    else:
        monkeypatch.setattr(serve_loop, "decode_step", _frozen_step(serve_loop.decode_step))
    run = tiny.stream_run()
    out = stream.run(run)
    assert not _report_correct(run, out)


def test_synth_sound_and_control():
    run = tiny.synth_run(controls=True)
    out = synth.run(run)
    assert out.attempted > 0 and _report_correct(run, out)
    ctl = _readings(out.notes, "control readings")
    for k, c in out.checks.items():
        assert ctl[k] > 3 * c["value"] and ctl[k] > c["limit"]


def _frozen_forward(orig):
    def forward(params, cfg, embeds, cache, *a, **k):
        hidden, cache = orig(params, cfg, embeds, cache, *a, **k)
        if embeds.shape[1] == 1:  # a decode step hands back the hidden it was given
            hidden = forward.last
        forward.last = hidden
        return hidden, cache
    forward.last = None
    return forward


@pytest.mark.parametrize("fault", ["altered_frame", "unchanged_step"])
def test_synth_fault_is_caught(monkeypatch, fault):
    from kalle_tpu_torch.infer import generate as gen_mod

    if fault == "altered_frame":
        # every row's: the check samples a few rows of the batch
        monkeypatch.setattr(gen_mod, "_head_step",
                            _altered_head(gen_mod._head_step, slice(None)))
    else:
        monkeypatch.setattr(gen_mod.llama, "forward_with_cache",
                            _frozen_forward(gen_mod.llama.forward_with_cache))
    run = tiny.synth_run()
    out = synth.run(run)
    assert not _report_correct(run, out)


def test_train_sound_and_control():
    run = tiny.train_run(controls=True)
    out = train.run(run)
    assert _report_correct(run, out)
    for what in ("control readings", "half_batch readings", "unchanged-state readings"):
        r = _readings(out.notes, what)
        assert any(r[k] > 3 * c["value"] and r[k] > c["limit"]
                   for k, c in out.checks.items()), (what, r)


def _unchanged_state(orig):
    def step(state, *a, **k):
        keep = [p.detach().clone() for p in state.optimizer.param_groups[0]["params"]]
        m = orig(state, *a, **k)
        with torch.no_grad():
            for p, v in zip(state.optimizer.param_groups[0]["params"], keep):
                p.copy_(v)
        return m
    return step


def _half_batch(orig):
    def loss(params, cfg, tcfg, batch, *a, **k):
        b = batch["input_ids"].shape[0]
        half = {key: v[:max(1, b // 2)] for key, v in batch.items()}
        return orig(params, cfg, tcfg, half, *a, **k)
    return loss


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_train_fault_is_caught(monkeypatch, fault):
    from kalle_tpu_torch.train import step as step_mod
    from kalle_tpu_torch.train import trainer as trainer_mod

    if fault == "unchanged_state":
        monkeypatch.setattr(trainer_mod, "train_step", _unchanged_state(trainer_mod.train_step))
    else:
        monkeypatch.setattr(step_mod, "loss_fn", _half_batch(step_mod.loss_fn))
    run = tiny.train_run()
    out = train.run(run)
    assert not _report_correct(run, out)


@pytest.mark.cuda
def test_tiny_cells_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for make, drv in ((tiny.stream_run, stream), (tiny.synth_run, synth),
                      (tiny.train_run, train)):
        run = make()
        run.device = "cuda"
        out = drv.run(run)
        assert out.failed == 0 and out.checks
