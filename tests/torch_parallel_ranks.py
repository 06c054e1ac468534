"""Rank bodies of the port's multi-process CPU tests (tests/test_torch_parallel_*,
_pipeline_*, _serve_tp, _multihost), run on gloo ranks by
kalle_tpu_torch.parallel.dryrun.spawn. Imports no JAX: the test process
computes the JAX references and the single-process port's, and hands the
ranks numpy params and batches. Each body runs several cases on one spawn
and returns numpy results (full tensors, gathered) from rank 0; the other
ranks return what the tests check for agreement."""
import numpy as np
import torch

from kalle_tpu_torch import bridge
from kalle_tpu_torch.data import collate
from kalle_tpu_torch.models.lm import llama, llasa
from kalle_tpu_torch.parallel.mesh import make_mesh, param_layout, shard_batch, spec_leaves
from kalle_tpu_torch.train import step


def items(shapes, seed, d=8, dist_dim=16):
    """collate Items of (text ids, frames) shapes: random ids and latents,
    a mean||scale distribution of dist_dim (d for the sigma head)."""
    rng = np.random.default_rng(seed)
    out = []
    for n_ids, n_frames in shapes:
        dist = np.concatenate([rng.normal(size=(n_frames, dist_dim // 2)),
                               rng.uniform(0.5, 1.5, (n_frames, dist_dim // 2))], -1)
        out.append(collate.Item(
            input_ids=rng.integers(0, 300, n_ids).astype(np.int32),
            audio_latents=rng.normal(size=(n_frames, d)).astype(np.float32),
            audio_distribution=dist.astype(np.float32)))
    return out


def batch(shapes, seed, **kw) -> dict:
    """The collated numpy arrays of `items(shapes, seed)` at bucket 32."""
    b = collate.collate(items(shapes, seed, **kw), 0, buckets=(32,))
    return {k: v for k, v in b.items() if isinstance(v, np.ndarray)}


def against_single(got: dict, case: dict) -> dict:
    """Hold a parallel run's results against `run_train` on one process:
    losses rtol 1e-5, gradients rtol 1e-5 / atol 1e-7 (f32 sums in
    another order), params rtol / atol 2e-5. -> the single-process run."""
    ref = run_train(case, None)
    for m, mr in zip(got["metrics"], ref["metrics"]):
        for k in ("total_loss", "audio_loss", "end_loss"):
            np.testing.assert_allclose(m[k], mr[k], rtol=1e-5, err_msg=k)
    for a, b in zip(got["grads"], ref["grads"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    for a, b in zip(got.get("params", []), ref["params"]):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
    return ref


def paths(tree, prefix="") -> list:
    """The "a/b/c" path of every leaf of a nested dict, in tree_leaves order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in paths(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


def to_torch(batch: dict) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()
           if isinstance(v, np.ndarray)}
    out["input_ids"] = out["input_ids"].long()
    return out


def _setup(case: dict, mesh):
    """(full-or-sharded params, layout or None)."""
    params = bridge.params_from_jax(case["params"], device="cpu")
    if mesh is None:
        return params, None
    layout = param_layout(params, mesh, fsdp=case.get("fsdp", False),
                          pp=mesh.size("pp") > 1)
    return layout.shard(params), layout


def _full(leaves, layout):
    if layout is None:
        return [x.detach().numpy() for x in leaves]
    return [layout.gather_leaf(x.detach(), s).numpy()
            for x, s in zip(leaves, spec_leaves(layout.specs))]


def run_train(case: dict, mesh=None) -> dict:
    """`case["batches"]` (global numpy batches, (A, B, ...) under
    accumulation) through train_step: per-step metrics, the params after
    and the last step's gradients (full), and the numel of every local
    leaf and of its AdamW moments."""
    cfg, tcfg = case["cfg"], case["tcfg"]
    params, layout = _setup(case, mesh)
    state = step.make_train_state(params, tcfg, layout)
    accum = tcfg.gradient_accumulation_steps > 1
    metrics = []
    for b in case["batches"]:
        local = b if mesh is None else shard_batch(b, mesh, leading_accum=accum)
        m = step.train_step(state, cfg, tcfg, to_torch(local), seed=case.get("seed", 0))
        metrics.append({k: float(v) for k, v in m.items()})
    leaves = bridge.tree_leaves(state.params)
    return {"metrics": metrics, "params": _full(leaves, layout),
            "grads": _full([p.grad for p in leaves], layout),
            "numel": [p.numel() for p in leaves],
            "moment_numel": [[v.numel() for v in state.optimizer.state[p].values() if v.dim()]
                             for p in leaves]}


def run_forward(case: dict, mesh=None) -> dict:
    """The Llama backbone's final hidden states over the embedded batch."""
    cfg = case["cfg"]
    params, layout = _setup(case, mesh)
    batch = to_torch(case["batches"][0])
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    with torch.no_grad():
        x, am, _ = llasa.embed_inputs(params, cfg, batch,
                                      generator=torch.Generator().manual_seed(0))
        h = llama.forward(params["llama"], cfg.llama, x, am, layout=layout)
    return {"hidden": h.numpy()}


def run_1f1b(case: dict, mesh) -> dict:
    """The 1F1B loss of one batch and its gradients (summed over dp), with
    the most stage inputs a rank held at once."""
    cfg, tcfg = case["cfg"], case["tcfg"]
    params, layout = _setup(case, mesh)
    leaves = bridge.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    stats = {}
    batch = to_torch(shard_batch(case["batches"][0], mesh))
    loss, m = step._loss_1f1b(params, cfg, tcfg, batch, None, None, False, layout, stats)
    loss.backward()
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    total = layout.sum_data(torch.stack(list(m.values())).detach())
    metrics = {k: float(v) for k, v in zip(m, total)}
    layout.sync_grads(params)
    return {"metrics": [metrics], "grads": _full([p.grad for p in leaves], layout),
            "max_live": stats["max_live"], "stages": mesh.size("pp")}


def run_serve(case: dict, mesh=None) -> dict:
    """The ContinuousBatcher ("batcher") or `generate` ("generate") on the
    case's params (quantized to case["bits"] first, the decode layout
    fused after sharding when case["fused"]), with the layer specs."""
    from kalle_tpu_torch.infer.generate import generate
    from kalle_tpu_torch.infer.serve_loop import ContinuousBatcher
    from kalle_tpu_torch.ops.quant import fuse_decode_params, quantize_llama_params

    cfg = case["cfg"]
    params = bridge.params_from_jax(case["params"], device="cpu")
    if case.get("bits"):
        params = quantize_llama_params(params, bits=case["bits"])
    specs = None
    if mesh is not None:
        layout = param_layout(params, mesh)
        params, specs = layout.shard(params), layout.layer_specs
    if case.get("fused"):
        params = fuse_decode_params(params)
    if case["kind"] == "generate":
        ids, mask = (torch.from_numpy(a) for a in case["prompts"])
        out = generate(params, cfg, ids.long(), mask.long(), max_frames=case["max_frames"],
                       end_kl_threshold=-1.0, greedy=True, mesh=mesh)
        return {"means": out.means.numpy(), "n_frames": out.n_frames.numpy(), "specs": specs}
    cb = ContinuousBatcher(params, cfg, batch_size=case.get("batch", 2),
                           max_frames=case["max_frames"], prompt_buckets=(8, 16),
                           greedy=case.get("greedy", True), seed=1, mesh=mesh, device="cpu")
    done = {c.index: (c.means, c.n_frames, c.steps_waited) for c in cb.run(case["prompts"])}
    return {"completions": done, "specs": specs}


RUNNERS = {"train": run_train, "forward": run_forward, "1f1b": run_1f1b,
           "batcher": run_serve, "generate": run_serve}


def cases(rank: int, world: int, todo: list) -> list:
    """Run every case on its own mesh (case["mesh"]: make_mesh's sizes)."""
    out = []
    for case in todo:
        mesh = make_mesh(device_type="cpu", **case["mesh"])
        r = RUNNERS[case.get("kind", "train")](case, mesh)
        keep = ("metrics", "max_live", "stages", "numel", "moment_numel", "completions",
                "n_frames", "hidden")
        out.append(r if rank == 0 else {k: v for k, v in r.items() if k in keep})
    return out


def trainer(rank: int, world: int, exp) -> dict:
    """Trainer.fit for 2 steps on the spawned group (the trainer builds its
    mesh from exp.train): the metric history, the rank's data shard, the
    mesh, which files it wrote, and (rank 0) the gathered params."""
    from kalle_tpu_torch.data.tokens import build_tokenizer
    from kalle_tpu_torch.parallel.mesh import data_shard
    from kalle_tpu_torch.train.trainer import Trainer

    tr = Trainer(exp, build_tokenizer(), device="cpu")
    tr.fit(max_steps=2)
    params = bridge.params_to_numpy(tr.state.state_dict()["params"])
    return {"history": tr.history, "shard": data_shard(tr.mesh), "mesh": tr.mesh.shape,
            "main": tr.main, "params": params if rank == 0 else None,
            "writes_metrics": tr.metrics is not None}


def mesh_checks(rank, world, params_np):
    """make_mesh, gather(shard(p)), the collectives and the shape check
    (tests/test_torch_parallel_mesh.py)."""
    import torch.distributed as dist

    from kalle_tpu_torch.parallel import collectives, mesh, multihost

    out = {}
    m = mesh.make_mesh(dp=2, tp=2, device_type="cpu")
    out["axes"] = (m.axis_names, m.shape, m.coords())
    params = bridge.params_from_jax(params_np, device="cpu")
    for name, kw, mm in (("plain", {}, m), ("fsdp", {"fsdp": True}, m),
                         ("pp", {"pp": True}, mesh.make_mesh(dp=2, pp=2, device_type="cpu"))):
        lay = mesh.param_layout(params, mm, **kw)
        back = mesh.gather_params(mesh.shard_params(params, mm, **kw), lay)
        out[name] = all(torch.equal(a, b) for a, b in
                        zip(bridge.tree_leaves(back), bridge.tree_leaves(params)))

    tp, dp = m.group("tp"), m.group("dp")
    r = float(dist.get_rank() + 1)
    x = torch.full((2, 3), r, requires_grad=True)
    y = collectives.copy_to(x, tp)                      # f: identity, then all-reduce back
    (y * r).sum().backward()
    out["f"] = (torch.equal(y, x), x.grad[0, 0].item())
    x.grad = None
    y = collectives.reduce_from(x * 1.0, tp)            # g: all-reduce, identity back
    (y * r).sum().backward()
    out["g"] = (y[0, 0].item(), x.grad[0, 0].item())
    x.grad = None
    y = collectives.all_gather(x, 1, dp)                # along dim 1; back: reduce-scatter
    (y * torch.arange(6.0)).sum().backward()
    out["gather"] = (y.tolist(), x.grad.tolist())

    multihost.host_local_to_global({"a": torch.zeros(2, 3)}, m)
    try:
        multihost.host_local_to_global({"a": torch.zeros(2 + m.rank("dp"), 3)}, m)
        out["mismatch"] = "no error"
    except ValueError as e:
        out["mismatch"] = str(e)
    errs = []
    for kw in ({"dp": 3, "tp": 2, "device_type": "cpu"},
               {"dp": 2, "tp": 2, "sp": 2, "pp": 2, "device_type": "cpu"},
               {"dp": 2, "tp": 2, "device_type": "cuda"}):
        try:
            mesh.make_mesh(**kw)
            errs.append(None)
        except (ValueError, RuntimeError) as e:
            errs.append(type(e).__name__)
    out["errors"] = errs
    return out


def fail(rank: int, world: int, how: str):
    """The last rank raises ("raise") or dies ("exit"); every other rank,
    and with "hang" every rank, sleeps until the harness kills it."""
    import os
    import time

    if rank == world - 1 and how == "raise":
        raise ValueError("a planted failure on the last rank")
    if rank == world - 1 and how == "exit":
        os._exit(3)
    time.sleep(600)
