"""The port's mesh and layouts (kalle_tpu_torch/parallel/mesh.py) against the
JAX package's (kalle_tpu/parallel/mesh.py) on the CPU:

  * the layout table, prune_spec and the quantized-scale rule equal JAX's;
  * every rank's block of every Llama layer leaf (f32, int8, int4; plain,
    fsdp, pp) equals the shard JAX's `shard_params` places on the device
    at the same mesh coordinates (8 virtual CPU devices), bit for bit;
  * shard_batch keeps the rows JAX's `shard_batch` places there;
  * on 4 gloo ranks (one spawn): make_mesh's axes and errors,
    gather_params inverting shard_params, the differentiable collectives'
    forward and backward against their definitions (exact), and
    host_local_to_global's shape check.
"""
import types

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from kalle_tpu.core.config import LlasaConfig as JLlasaConfig
from kalle_tpu.models.lm import llasa as jllasa
from kalle_tpu.ops import quant as jquant
from kalle_tpu.parallel import mesh as jmesh
from kalle_tpu_torch import bridge
from kalle_tpu_torch.parallel import mesh
from kalle_tpu_torch.parallel.dryrun import spawn


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fake_mesh(sizes, coords):
    """What the pure layout functions read of a mesh."""
    return types.SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes),
                                 coords=lambda: dict(coords),
                                 size=lambda a: sizes.get(a, 1),
                                 rank=lambda a: coords.get(a, 0))


def _jspec(p):
    return tuple(p)


def _tree_specs_equal(port, ref):
    if isinstance(ref, dict):
        assert port.keys() == ref.keys()
        for k in ref:
            _tree_specs_equal(port[k], ref[k])
    else:
        assert port == _jspec(ref), (port, ref)


@pytest.mark.parametrize("fsdp,pp", [(False, False), (True, False), (False, True)])
def test_param_pspecs_match_jax(fsdp, pp):
    _tree_specs_equal(mesh.param_pspecs(fsdp=fsdp, pp=pp),
                      jmesh.param_pspecs(None, fsdp=fsdp, pp=pp))


def test_prune_and_scale_specs_match_jax():
    P = jax.sharding.PartitionSpec
    specs = [P(None, "tp"), P(("tp", "dp"), None), P("pp", None, ("tp", "dp")),
             P(None, ("dp",)), P("sp", "dp", None)]
    for names in ({"dp", "tp"}, {"dp"}, {"tp"}, {"dp", "pp", "tp"}, set()):
        for s in specs:
            assert mesh.prune_spec(tuple(s), names) == tuple(jmesh.prune_spec(s, names))
    for s in specs:
        for nd in (len(s), len(s) - 1):
            assert mesh._quant_scale_spec(tuple(s), nd) == tuple(
                jmesh._quant_scale_spec(s, nd))
    with pytest.raises(ValueError, match="fsdp"):
        mesh.param_pspecs(fsdp=True, pp=True)


@pytest.fixture(scope="module")
def tiny():
    cfg = JLlasaConfig.tiny(head_variant="stableaudio")
    return cfg, jllasa.init_params(cfg, jax.random.key(0))


def _np(a):
    a = np.asarray(a)
    return a.astype(np.int8) if a.dtype.name == "int4" else a


LAYOUTS = [  # (mesh sizes in JAX's axis order, fsdp, pp)
    ((("dp", 2), ("tp", 2)), False, False),
    ((("dp", 4), ("tp", 2)), False, False),
    ((("dp", 2), ("tp", 2)), True, False),
    ((("dp", 2), ("tp", 4)), True, False),
    ((("dp", 2), ("pp", 2), ("tp", 2)), False, True),
    ((("dp", 4), ("pp", 2)), False, True),
]


@pytest.mark.parametrize("sizes,fsdp,pp,bits", [
    (sizes, fsdp, pp, bits) for sizes, fsdp, pp in LAYOUTS
    for bits in ((None,) if fsdp else (None, 8, 4))])  # fsdp shards the f32 training tree
def test_layer_shards_match_jax(tiny, sizes, fsdp, pp, bits):
    cfg, jp = tiny
    if bits:
        jp = jquant.quantize_llama_params(jp, bits=bits)
    names = tuple(a for a, _ in sizes)
    shape = tuple(n for _, n in sizes)
    jm = jmesh.make_mesh(**dict(sizes), devices=jax.devices()[:int(np.prod(shape))])
    assert tuple(jm.axis_names) == names
    with jax.sharding.set_mesh(jm):
        sharded = jmesh.shard_params(jp, jm, fsdp=fsdp, pp=pp)
    port = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    specs = mesh.leaf_specs(port, dict(sizes), fsdp=fsdp, pp=pp)
    layers, jlayers = port["llama"]["layers"], sharded["llama"]["layers"]
    for dev_idx in np.ndindex(*shape):
        coords = dict(zip(names, dev_idx))
        dev = jm.devices[dev_idx]
        for key, w in layers.items():
            parts = w.items() if isinstance(w, dict) else [(None, w)]
            for sub, x in parts:
                jarr = jlayers[key] if sub is None else jlayers[key][sub]
                spec = specs["llama"]["layers"][key] if sub is None else \
                    specs["llama"]["layers"][key][sub]
                want = next(_np(s.data) for s in jarr.addressable_shards if s.device == dev)
                got = mesh.shard_leaf(x, spec, dict(sizes), coords).numpy()
                np.testing.assert_array_equal(got, want, err_msg=f"{key}/{sub} at {coords}")
    # the port replicates the embedding and the heads
    assert specs["llama"]["embed"] == (None, None)
    assert specs["distribution_linear"]["w0"] == (None, None)


def test_quantized_scales_and_divisibility(tiny):
    cfg, jp = tiny
    port = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    from kalle_tpu_torch.ops.quant import fuse_decode_params, quantize_llama_params

    sizes = {"dp": 2, "tp": 2}
    s8 = mesh.leaf_specs(quantize_llama_params(port, bits=8), sizes)["llama"]["layers"]
    assert s8["wq"] == {"q": (None, None, "tp"), "scale": (None, "tp")}  # follows its columns
    assert s8["wo"] == {"q": (None, "tp", None), "scale": (None, None)}  # kept whole
    s4 = mesh.leaf_specs(quantize_llama_params(port, bits=4), sizes)["llama"]["layers"]
    assert s4["wq"] == {"q": (None, None, "tp"), "scale": (None, None, "tp")}
    # in=64 < 128: one group over wo's rows, which cannot split over tp
    assert s4["wo"] == {"q": (None, "tp", None), "scale": (None, None, None)}
    # two groups over rows split four ways cannot follow their rows
    wide = {"llama": {"layers": {"wo": {"q": torch.zeros(1, 256, 8, dtype=torch.int8),
                                        "scale": torch.ones(1, 2, 8)}}}}
    with pytest.raises(ValueError, match="groups"):
        mesh.leaf_specs(wide, {"tp": 4})
    with pytest.raises(ValueError, match="fuse"):
        mesh.leaf_specs(fuse_decode_params(port), sizes)
    with pytest.raises(ValueError, match="stages"):
        mesh.leaf_specs(port, {"dp": 1, "pp": 4}, pp=True)  # 2 layers, 4 stages


@pytest.mark.parametrize("leading_accum", [False, True])
def test_shard_batch_matches_jax(leading_accum):
    rng = np.random.default_rng(0)
    shape = (3, 8, 6) if leading_accum else (8, 6)
    batch = {"input_ids": rng.integers(0, 100, shape).astype(np.int32),
             "audio_latents": rng.normal(size=shape + (4,)).astype(np.float32),
             "raw_texts": ["x"] * 8}
    jm = jmesh.make_mesh(dp=4, tp=2)
    ref = jmesh.shard_batch({k: v for k, v in batch.items() if k != "raw_texts"}, jm,
                            leading_accum=leading_accum)
    for dev_idx in np.ndindex(4, 2):
        fake = _fake_mesh({"dp": 4, "tp": 2}, dict(zip(("dp", "tp"), dev_idx)))
        got = mesh.shard_batch(batch, fake, leading_accum=leading_accum)
        assert got["raw_texts"] is batch["raw_texts"]
        for k in ("input_ids", "audio_latents"):
            want = next(np.asarray(s.data) for s in ref[k].addressable_shards
                        if s.device == jm.devices[dev_idx])
            np.testing.assert_array_equal(got[k], want)
    with pytest.raises(ValueError, match="dp=3"):
        mesh.shard_batch(batch, _fake_mesh({"dp": 3}, {"dp": 0}), leading_accum)


def test_one_dp_rank_runs_no_dp_collective(tiny):
    """On a mesh whose dp axis has one rank (a tp-only deployment, with
    fsdp), the fsdp gathers at use and the dp gradient bucket are skipped:
    the layer's weights come back as they are and the gradients untouched,
    and no dp group is asked for."""
    _, jp = tiny
    port = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    sizes = {"dp": 1, "tp": 2}
    fake = _fake_mesh(sizes, {"dp": 0, "tp": 0})
    fake.group = lambda a: pytest.fail(f"the {a} group was asked for")
    lay = mesh.Layout(fake, mesh.leaf_specs(port, sizes, fsdp=True), fsdp=True)
    lp = {k: w[0] for k, w in port["llama"]["layers"].items()}
    assert lay.use_layer(lp) is lp
    leaves = bridge.tree_leaves(port)
    for p in leaves:
        p.grad = torch.ones_like(p)
    lay.sync_grads(port)
    assert all(bool((p.grad == 1).all()) for p in leaves)


# ------------------------------------------------------ 4 gloo ranks ------


@pytest.fixture(scope="module")
def four_ranks(tiny):
    _, jp = tiny
    return spawn(R.mesh_checks, 4, jax.tree.map(np.asarray, jp), timeout_s=300)


def test_make_mesh_axes_and_refusals(four_ranks):
    for rank, out in enumerate(four_ranks):
        names, shape, coords = out["axes"]
        assert names == ("dp", "tp") and shape == {"dp": 2, "tp": 2}
        assert coords == {"dp": rank // 2, "tp": rank % 2}  # tp innermost
        # 3x2 != 4 ranks; sp with pp; a cuda mesh on a host without cards
        assert out["errors"] == ["ValueError", "ValueError", "RuntimeError"]


def test_gather_inverts_shard(four_ranks):
    for out in four_ranks:
        assert out["plain"] and out["fsdp"] and out["pp"]


def test_collectives_forward_and_backward(four_ranks):
    """Ranks r = 1..4 (tp pairs {1, 2} and {3, 4}; dp pairs {1, 3}, {2, 4}),
    x = r everywhere, loss = sum(r * y): f's gradient is the tp sum of r, g's
    value the tp sum of x and its gradient r, the gather's gradient the dp
    sum of the weights over this rank's block."""
    for rank, out in enumerate(four_ranks):
        r = rank + 1
        tp_sum = 3.0 if r <= 2 else 7.0
        assert out["f"] == (True, tp_sum)
        assert out["g"] == (tp_sum, float(r))
        dp_peer = r + 2 if r <= 2 else r - 2
        first = (min(r, dp_peer), max(r, dp_peer))
        assert out["gather"][0] == [[float(first[0])] * 3 + [float(first[1])] * 3] * 2
        block = [0, 1, 2] if r == first[0] else [3, 4, 5]
        assert out["gather"][1] == [[2.0 * b for b in block]] * 2


def test_host_local_to_global_checks_shapes(four_ranks):
    for out in four_ranks:
        assert "dp ranks hold shapes" in out["mismatch"]
