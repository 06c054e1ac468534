"""The traffic is a function of the seed: the same seed gives the same
inputs, every seed the same sets of sizes and arrival gaps."""

import numpy as np
import pytest

from perfbench import served
from perfbench.common import exponential_ppf, lognormal_int_ppf, quantile_set, sub_seed
from perfbench.drivers import stream, train
from perfbench.tests import tiny

BIG = 2 ** 31 + 12345


def test_stream_schedule_is_the_seeds():
    tr = tiny.stream_run().traffic
    a, b = stream.schedule(tr, BIG, 5.0), stream.schedule(tr, BIG, 5.0)
    assert [(r.due, r.text, r.segment) for r in a] == [(r.due, r.text, r.segment) for r in b]
    c = stream.schedule(tr, BIG + 1, 5.0)
    assert [r.text for r in a] != [r.text for r in c]


def test_stream_schedule_same_sets_other_order():
    tr = tiny.stream_run().traffic
    a, c = stream.schedule(tr, 3, 5.0), stream.schedule(tr, 4, 5.0)
    for seg in ("ramp", "window", "tail"):
        ga = [r for r in a if r.segment == seg]
        gc = [r for r in c if r.segment == seg]
        assert len(ga) == len(gc) == round(tr["rate_per_s"] * {"ramp": tr["ramp_s"],
                                                               "window": 5.0,
                                                               "tail": tr["tail_s"]}[seg])
    assert sorted(len(r.text) for r in a) == sorted(len(r.text) for r in c)
    gaps = lambda rs: sorted(np.diff([0.0] + [r.due for r in rs]).round(9))  # noqa: E731
    assert gaps(a) == gaps(c)
    lo, hi = tr["text_chars"]
    assert all(lo <= len(r.text) <= hi and r.text == " ".join(r.text.split()) for r in a)


def test_prompt_ids_match_the_program():
    from kalle_tpu_torch.data.tokens import ByteTokenizer, build_prompt_ids
    from kalle_tpu_torch.serve.web import normalize_text

    tok = ByteTokenizer(base_vocab=32768)
    for r in stream.schedule(tiny.stream_run().traffic, 9, 3.0)[:20]:
        want = build_prompt_ids(tok, normalize_text(r.text))
        assert served.prompt_ids(r.text, 32768).tolist() == want


def test_quantile_sets():
    g = quantile_set(1000, exponential_ppf(4.0))
    assert abs(np.mean(g) - 0.25) < 0.01 and min(g) > 0
    n = quantile_set(1000, lognormal_int_ppf(20, 120))
    assert min(n) >= 20 and max(n) <= 120 and 40 < np.median(n) < 60
    assert sub_seed(BIG, 1) != sub_seed(BIG, 2) and 0 <= sub_seed(2 ** 40, 3) < 2 ** 63


def test_train_rows_are_the_seeds():
    tr = tiny.train_run().traffic
    a, b, c = train.make_rows(tr, BIG), train.make_rows(tr, BIG), train.make_rows(tr, BIG + 1)
    assert a == b and a != c
    assert sorted(r["frames"] for r in a) == sorted(r["frames"] for r in c)
    la, lb = train.latents(a, BIG, 8), train.latents(a, BIG, 8)
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("epochs", [1, 3])
def test_plan_follows_the_program_loader(tmp_path, epochs):
    """The steps the harness plans are the microbatches the program's
    dataset, token-budget batcher and accumulation make."""
    from kalle_tpu_torch.data.collate import stack_microbatches
    from kalle_tpu_torch.data.datasets import OfflineLatentDataset, PrefetchLoader
    from kalle_tpu_torch.data.tokens import ByteTokenizer

    tr = tiny.train_run().traffic
    rows = train.make_rows(tr, 5)
    meta = train.write_dataset(str(tmp_path), rows, train.latents(rows, 5, 8))
    tok = ByteTokenizer(base_vocab=300)
    ds = OfflineLatentDataset(meta, tok, seed=7)
    loader = PrefetchLoader(ds, tok.pad_token_id, max_token_length=tr["max_token_length"],
                            batch_size=tr["batch_size"], buckets=tr["length_buckets"],
                            num_workers=1, prefetch=8)
    got, buf = [], []
    try:
        for e in range(epochs):
            for b in loader.epoch_iter(e):
                buf.append(b)
                if len(buf) == tr["grad_accum"]:
                    got.append(buf)
                    buf = []
    finally:
        loader.close()
    steps = train.plan(rows, tr, len(got))
    assert len(steps) == len(got) > 0
    for st, batches in zip(steps, got):
        for mb, b in zip(st, batches):
            assert b["ids_mask"].sum(1).tolist() == [rows[i]["ids"] for i in mb]
            assert b["audio_mask"].sum(1).tolist() == [rows[i]["frames"] for i in mb]
        stacked = stack_microbatches(batches, tok.pad_token_id)
        assert stacked["input_ids"].shape[1:] == train.padded_shape(
            rows, st, tuple(tr["length_buckets"]))
