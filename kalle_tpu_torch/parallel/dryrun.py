"""Multi-process CPU dryrun of data parallelism, and the spawn harness it
and the tests share (counterpart of tools/multihost_dryrun.py).

    python -m kalle_tpu_torch.parallel.dryrun [--processes 2] [--plant-mismatch]

The parent computes one train step's loss and gradient norms on one
process over the global batch of the JAX tool (4 rows of 6 text ids and
10 sigma frames, a tiny sigma model from seed 3). It then spawns
`--processes` gloo ranks at dp = processes, each fed its rows, runs the
same step through the dp layout, and holds each rank's loss, global
gradient norm and first 8 leaves' gradient norms against its own (2e-4
relative, the JAX tool's bar). It prints a JSON verdict and exits 1 on a
mismatch. --plant-mismatch feeds the last rank the first rank's rows (a
wrong shard), to show that the comparison catches it.

`spawn(fn, world_size, *args)` runs fn(rank, world_size, *args) in fresh
processes (the spawn start method, one torch thread each) joined by a
gloo group through a per-run `file://` store (no TCP port to collide on
between parallel test workers). It returns the ranks' results in rank
order; it joins every child with a deadline, kills them all when it
passes or a rank fails, and raises the failing rank's traceback.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import queue
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist

ROWS, SEQ, AUDIO_T, DIM = 4, 6, 10, 8
REL_TOL = 2e-4


def _child(rank: int, world: int, store: str, fn: Callable, args: tuple, out,
           timeout_s: float) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        result = fn(rank, world, *args)
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 — sent to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args, timeout_s: float = 300.0) -> List:
    """fn(rank, world_size, *args) on `world_size` gloo ranks; their results
    by rank. Raises on a rank's exception, a rank that dies, or the
    deadline (every child is killed first)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="kalle_spawn_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        out = ctx.Queue()
        procs = [ctx.Process(target=_child, args=(r, world_size, store, fn, args, out,
                                                  timeout_s), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        results = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < world_size:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawned ranks did not finish in {timeout_s} s "
                                       f"(done: {sorted(results)})")
                try:
                    rank, ok, payload = out.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} died with exit code "
                                           f"{procs[dead[0]].exitcode}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                results[rank] = payload
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world_size)]


# ---------------------------------------------------------------------------
# the dryrun
# ---------------------------------------------------------------------------

def global_batch() -> dict:
    """The JAX tool's batch (tools/multihost_dryrun.py:33-52): text span [0,
    SEQ), audio span [SEQ, SEQ + AUDIO_T), collated."""
    from ..data.collate import Item, collate

    rng = np.random.default_rng(7)
    items = []
    for _ in range(ROWS):
        ids = rng.integers(1, 250, SEQ).astype(np.int32)
        lat = rng.normal(size=(AUDIO_T, DIM)).astype(np.float32)
        items.append(Item(input_ids=ids, audio_latents=lat, audio_distribution=lat.copy()))
    batch = collate(items, pad_token_id=0)
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def _model():
    from ..core.config import LlamaConfig, LlasaConfig, TrainConfig

    cfg = LlasaConfig(llama=LlamaConfig.tiny(vocab_size=300), latent_dim=DIM,
                      audio_proj_dim=64, head_variant="sigma")
    return cfg, TrainConfig(lr=1e-3, warmup_steps=1, total_steps=2, log_grad_norm=True)


def _step_summary(batch: dict, mesh=None) -> dict:
    """One train step (the sigma head's noise drawn from the step's
    generator) -> the loss, the global gradient norm and the first 8
    leaves' gradient norms (full leaves, gathered under a mesh)."""
    from ..bridge import tree_leaves
    from ..models.lm import llasa
    from ..parallel.mesh import param_layout, spec_leaves
    from ..train.step import make_train_state, train_step

    cfg, tcfg = _model()
    params = llasa.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    layout = None if mesh is None else param_layout(params, mesh)
    state = make_train_state(params if layout is None else layout.shard(params), tcfg,
                             layout)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["input_ids"] = tb["input_ids"].long()
    m = train_step(state, cfg, tcfg, tb)
    grads = [p.grad for p in tree_leaves(state.params)]
    if layout is not None:
        grads = [layout.gather_leaf(g, s) for g, s in zip(grads, spec_leaves(layout.specs))]
    return {"loss": float(m["total_loss"]), "grad_norm": float(m["grad_norm"]),
            "leaf_norms": [float(torch.linalg.vector_norm(g.double())) for g in grads[:8]]}


def _rank(rank: int, world: int, plant: bool) -> dict:
    from ..parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh(dp=world, device_type="cpu")
    local = shard_batch(global_batch(), mesh)
    if plant and rank == world - 1:  # a wrong shard: the first rank's rows
        local = {k: v[:ROWS // world] for k, v in global_batch().items()}
    return {"rank": rank, "dp": mesh.size("dp"), **_step_summary(local, mesh)}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / (abs(b) + 1e-9)


def run(processes: int = 2, plant: bool = False, timeout_s: float = 300.0) -> dict:
    torch.set_num_threads(1)
    ref = _step_summary(global_batch())
    ranks = spawn(_rank, processes, plant, timeout_s=timeout_s)
    checks = []
    for r in ranks:
        c = {"rank": r["rank"], "dp": r["dp"], "rel_dloss": _rel(r["loss"], ref["loss"]),
             "rel_dgrad_norm": _rel(r["grad_norm"], ref["grad_norm"]),
             "max_rel_dleaf_norm": max(_rel(a, b) for a, b in
                                       zip(r["leaf_norms"], ref["leaf_norms"]))}
        c["ok"] = (r["dp"] == processes and c["rel_dloss"] < REL_TOL
                   and c["rel_dgrad_norm"] < REL_TOL and c["max_rel_dleaf_norm"] < REL_TOL)
        checks.append(c)
    return {"ok": all(c["ok"] for c in checks), "processes": processes,
            "planted_mismatch": plant, "tolerance": REL_TOL, "reference": ref,
            "ranks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--plant-mismatch", action="store_true")
    args = ap.parse_args(argv)
    verdict = run(args.processes, args.plant_mismatch)
    print(json.dumps(verdict))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
