"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes the main path does not reach (C not a multiple of
128, T not a multiple of the time tile, M not a multiple of 16 and above
64, f32 and int8 caches, K1's sideband, K1 at 16 heads a group and hd 256,
dense bf16 weights, K2 split over K at M 1..130, K2/K3 with f32
activations, ConvNeXt widths outside the decoder's and mlp_ratio 3; flash
attention at t 128 to 512 with fully masked rows, f32 and bf16, K5's
tensor-core instance at every head dim), one flash train_step against the
plain path, and whole paths on the card against the CPU: `generate` on the
tiny f32 config (dense and int8 weights) and at batch 72, the tiny codec
in bf16, and the continuous batcher. Needs an NVIDIA GPU and nvcc; skipped elsewhere. On
the card (this file imports no JAX, so no conftest):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from kalle_tpu_torch.ops.kernels import _build
from kalle_tpu_torch.ops.kernels import convnext_block as k4
from kalle_tpu_torch.ops.kernels import decode_attention as k1
from kalle_tpu_torch.ops.kernels import flash_attention as k567
from kalle_tpu_torch.ops.kernels import qmm as k23

pytestmark = pytest.mark.cuda

BF = torch.bfloat16


@pytest.fixture
def g():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref, tol):
    assert got.dtype == ref.dtype
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,c,int8", [(BF, 200, False), (torch.float32, 136, False),
                                          (BF, 384, True), (torch.float32, 128, True)])
def test_decode_attention(g, dtype, c, int8):
    L, b, nq, nkv, hd = 2, 3, 8, 2, 64
    q = torch.randn(b, nq, hd, generator=g, device="cuda").to(dtype)
    kt = torch.randn(L, b, nkv, hd, c, generator=g, device="cuda").to(dtype)
    v = torch.randn(L, b, nkv, c, hd, generator=g, device="cuda").to(dtype)
    mask = torch.rand(b, c, generator=g, device="cuda") > 0.3
    mask[:, 0] = True
    mask[1, 128:] = False  # a fully masked trailing tile
    ks = vs = None
    if int8:
        ks = kt.float().abs().amax(3, keepdim=True) / 127
        vs = v.float().abs().amax(4, keepdim=True) / 127
        kt = torch.round(kt.float() / ks).to(torch.int8)
        v = torch.round(v.float() / vs).to(torch.int8)
        vs = vs.transpose(-1, -2).contiguous()
    before = _build.launches().get(k1.NAME, 0)
    got = k1.decode_attention_cached(q, kt, v, 1, mask, ks, vs)
    assert _build.launches().get(k1.NAME, 0) == before + 1
    _close(got, k1.decode_attention_plain(q, kt, v, 1, mask, ks, vs),
           2e-2 if dtype == BF else 1e-4)


@pytest.mark.parametrize("dtype,c", [(BF, 384), (torch.float32, 200), (BF, 128)])
def test_decode_attention_sideband(g, dtype, c):
    """The serving mode: the new column joins the softmax where new_valid
    is set; row 2 has no valid key before this step, row 3 none and a dead
    column."""
    L, b, nq, nkv, hd = 2, 5, 32, 8, 64
    q = torch.randn(b, nq, hd, generator=g, device="cuda").to(dtype)
    kt = torch.randn(L, b, nkv, hd, c, generator=g, device="cuda").to(dtype)
    v = torch.randn(L, b, nkv, c, hd, generator=g, device="cuda").to(dtype)
    kn, vn = (torch.randn(b, nkv, hd, generator=g, device="cuda").to(dtype) for _ in range(2))
    mask = torch.rand(b, c, generator=g, device="cuda") > 0.3
    mask[2:4] = False
    live = torch.tensor([True, False, True, False, True], device="cuda")
    before = _build.launches().get(k1.NAME_SIDEBAND, 0)
    got = k1.decode_attention_cached(q, kt, v, 1, mask, k_new=kn, v_new=vn, new_valid=live)
    assert _build.launches().get(k1.NAME_SIDEBAND, 0) == before + 1
    _close(got, k1.decode_attention_plain(q, kt, v, 1, mask, k_new=kn, v_new=vn,
                                          new_valid=live), 2e-2 if dtype == BF else 1e-4)


@pytest.mark.parametrize("m,k,n,int8", [(5, 128, 96, True), (32, 2048, 512, True),
                                        (40, 256, 64, False), (64, 512, 128, True),
                                        (72, 256, 128, True), (130, 128, 64, False)])
def test_qmm(g, m, k, n, int8):
    w = torch.randn(k, n, generator=g, device="cuda") * 0.05
    scale = None
    if int8:
        scale = w.abs().amax(0) / 127
        w = torch.round(w / scale).to(torch.int8)
    else:
        w = w.to(BF)
    x = torch.randn(m, k, generator=g, device="cuda").to(BF)
    before = _build.launches().get(k23.NAME_QMM, 0)
    got, ref = k23.qmm(x, w, scale), k23.qmm_plain(x, w, scale)
    assert _build.launches().get(k23.NAME_QMM, 0) == before + 1  # one launch at any M
    assert float((got.float() - ref.float()).abs().max() / ref.float().abs().max()) < 1e-2


@pytest.mark.parametrize("m,h,f,int8", [(3, 256, 128, True), (32, 512, 1024, True),
                                        (17, 256, 192, False), (72, 512, 256, True),
                                        (3, 64, 128, True), (100, 320, 64, False)])
def test_fused_mlp(g, m, h, f, int8):
    def weight(*shape):
        w = torch.randn(*shape, generator=g, device="cuda") * 0.05
        if not int8:
            return w.to(BF)
        s = w.abs().amax(0) / 127
        return {"q": torch.round(w / s).to(torch.int8), "scale": s}

    ws = weight(h, f), weight(h, f), weight(f, h)
    x = torch.randn(m, h, generator=g, device="cuda").to(BF)
    before = _build.launches().get(k23.NAME_MLP, 0)
    got, ref = k23.fused_mlp(x, *ws), k23.fused_mlp_plain(x, *ws)
    assert _build.launches().get(k23.NAME_MLP, 0) == before + 1
    assert float((got.float() - ref.float()).abs().max() / ref.float().abs().max()) < 1e-2


@pytest.mark.parametrize("m", [1, 8, 17, 32, 72, 130])
@pytest.mark.parametrize("int8", [True, False])
def test_qmm_split_k_rows(g, m, int8):
    """K2's tensor-core kernel where it splits K over a cluster (K 2048,
    N 512: wk/wv's shape) at the serving batches and ragged ones, rows past
    M masked in the kernel: 1e-2 relative, one launch a call."""
    k, n = 2048, 512
    w = torch.randn(k, n, generator=g, device="cuda") * 0.02
    scale = None
    if int8:
        scale = w.abs().amax(0) / 127
        w = torch.round(w / scale).to(torch.int8)
    else:
        w = w.to(BF)
    x = torch.randn(m, k, generator=g, device="cuda").to(BF)
    before = _build.launches().get(k23.NAME_QMM, 0)
    got, ref = k23.qmm(x, w, scale), k23.qmm_plain(x, w, scale)
    assert _build.launches().get(k23.NAME_QMM, 0) == before + 1
    assert got.shape == (m, n) and got.dtype == BF
    assert float((got.float() - ref.float()).abs().max() / ref.float().abs().max()) < 1e-2
    assert torch.equal(k23.qmm(x, w, scale), got)  # no atomics: the same bits again


@pytest.mark.parametrize("m,k,n,int8", [(3, 64, 32, True), (9, 256, 96, False),
                                        (70, 128, 64, True)])
def test_qmm_f32_activations(g, m, k, n, int8):
    """K2's f32 mode (C3): f32 x with int8 or f32 weights, full f32 products."""
    w = torch.randn(k, n, generator=g, device="cuda") * 0.05
    scale = None
    if int8:
        scale = w.abs().amax(0) / 127
        w = torch.round(w / scale).to(torch.int8)
    x = torch.randn(m, k, generator=g, device="cuda")
    before = _build.launches().get(k23.NAME_QMM, 0)
    got = k23.qmm(x, w, scale)
    assert _build.launches().get(k23.NAME_QMM, 0) == before + 1
    _close(got, k23.qmm_plain(x, w, scale), 1e-4)


@pytest.mark.parametrize("m,h,f,int8", [(3, 64, 128, True), (17, 128, 192, False)])
def test_fused_mlp_f32_activations(g, m, h, f, int8):
    """K3's f32 mode (C3): h stays f32 (x's dtype), as in fused_mlp_plain."""
    def weight(*shape):
        w = torch.randn(*shape, generator=g, device="cuda") * 0.05
        if not int8:
            return w
        s = w.abs().amax(0) / 127
        return {"q": torch.round(w / s).to(torch.int8), "scale": s}

    ws = weight(h, f), weight(h, f), weight(f, h)
    x = torch.randn(m, h, generator=g, device="cuda")
    before = _build.launches().get(k23.NAME_MLP, 0)
    got = k23.fused_mlp(x, *ws)
    assert _build.launches().get(k23.NAME_MLP, 0) == before + 1
    _close(got, k23.fused_mlp_plain(x, *ws), 1e-4)


@pytest.mark.parametrize("dtype,mode", [(BF, "base"), (torch.float32, "base"),
                                        (BF, "int8"), (torch.float32, "int8"),
                                        (BF, "sideband"), (torch.float32, "sideband")])
def test_decode_attention_wide_group_hd256(g, dtype, mode):
    """K1 at C3's shape: 16 query heads a KV head (two chunks of 8 in the
    grid) and hd 256 (tiles of 64 columns), B 2, nq 32, nkv 2, C 128, in
    each mode, against the plain version."""
    L, b, nq, nkv, hd, c = 2, 2, 32, 2, 256, 128
    q = torch.randn(b, nq, hd, generator=g, device="cuda").to(dtype)
    kt = torch.randn(L, b, nkv, hd, c, generator=g, device="cuda").to(dtype)
    v = torch.randn(L, b, nkv, c, hd, generator=g, device="cuda").to(dtype)
    mask = torch.rand(b, c, generator=g, device="cuda") > 0.3
    mask[:, 0] = True
    kw = {}
    if mode == "int8":
        ks = kt.float().abs().amax(3, keepdim=True) / 127
        vs = v.float().abs().amax(4, keepdim=True) / 127
        kt = torch.round(kt.float() / ks).to(torch.int8)
        v = torch.round(v.float() / vs).to(torch.int8)
        kw = dict(k_scale=ks, v_scale=vs.transpose(-1, -2).contiguous())
    elif mode == "sideband":
        kn, vn = (torch.randn(b, nkv, hd, generator=g, device="cuda").to(dtype)
                  for _ in range(2))
        kw = dict(k_new=kn, v_new=vn, new_valid=torch.tensor([True, False], device="cuda"))
    name = k1.NAME_SIDEBAND if mode == "sideband" else k1.NAME
    before = _build.launches().get(name, 0)
    got = k1.decode_attention_cached(q, kt, v, 1, mask, **kw)
    assert _build.launches().get(name, 0) == before + 1
    _close(got, k1.decode_attention_plain(q, kt, v, 1, mask, **kw),
           2e-2 if dtype == BF else 1e-4)


@pytest.mark.parametrize("c,t,ratio", [(16, 45, 2), (64, 100, 2), (128, 33, 2), (512, 70, 2),
                                       (4, 33, 2), (8, 20, 2), (48, 50, 2), (64, 40, 3)])
def test_convnext_block(g, c, t, ratio):
    """The tensor-core instances (C 16..512, H = 2C) and the generic one
    (other C, mlp_ratio 3)."""
    h = ratio * c

    def u(*shape, bound=1.0):
        return ((torch.rand(*shape, generator=g, device="cuda") * 2 - 1) * bound).to(BF)

    args = (u(c) + 1, u(7, 1, c, bound=0.4), u(c, bound=0.4), u(1, c, 2 * h, bound=c ** -0.5),
            u(2 * h, bound=c ** -0.5), u(1, h, c, bound=h ** -0.5), u(c, bound=h ** -0.5))
    x = torch.randn(2, t, c, generator=g, device="cuda").to(BF)
    _close(k4.convnext_block(x, *args), k4.convnext_block_plain(x, *args), 2e-2)


def test_wrappers_raise_on_what_the_kernels_do_not_take(g):
    x = torch.randn(4, 100, device="cuda").to(BF)
    with pytest.raises(ValueError):  # K % 64 != 0
        k23.qmm(x, torch.zeros(100, 64, dtype=torch.int8, device="cuda"))
    q = torch.zeros(1, 128, 4, 48, dtype=BF, device="cuda")
    pad = torch.ones(1, 128, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):  # hd=48 has no kernel
        k567.flash_fwd(q, q[:, :, :2], q[:, :, :2], pad)
    q = torch.zeros(1, 128, 4, 64, dtype=torch.float16, device="cuda")
    with pytest.raises(ValueError):  # fp16
        k567.flash_fwd(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous(), pad)
    q = torch.zeros(1, 128, 3, 64, dtype=BF, device="cuda")
    with pytest.raises(ValueError):  # 3 query heads over 2 KV heads
        k567.flash_fwd(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous(), pad)
    with pytest.raises(ValueError):  # f32 x: the kernel is bf16
        z = torch.zeros(48, dtype=BF, device="cuda")
        k4.convnext_block(torch.zeros(1, 8, 48, device="cuda"), z,
                          torch.zeros(7, 1, 48, dtype=BF, device="cuda"), z,
                          torch.zeros(1, 48, 192, dtype=BF, device="cuda"),
                          torch.zeros(192, dtype=BF, device="cuda"),
                          torch.zeros(1, 96, 48, dtype=BF, device="cuda"), z)
    with pytest.raises(ValueError):  # up_w of another hidden width than down_w
        k4.convnext_block(torch.zeros(1, 8, 48, dtype=BF, device="cuda"), z,
                          torch.zeros(7, 1, 48, dtype=BF, device="cuda"), z,
                          torch.zeros(1, 48, 96, dtype=BF, device="cuda"),
                          torch.zeros(96, dtype=BF, device="cuda"),
                          torch.zeros(1, 96, 48, dtype=BF, device="cuda"), z)
    with pytest.raises(ValueError, match="hd <= 256"):  # hd 320: no instance
        k1.decode_attention_cached(torch.zeros(2, 4, 320, dtype=BF, device="cuda"),
                                   torch.zeros(1, 2, 2, 320, 128, dtype=BF, device="cuda"),
                                   torch.zeros(1, 2, 2, 128, 320, dtype=BF, device="cuda"),
                                   0, torch.ones(2, 128, dtype=torch.bool, device="cuda"))
    kn = torch.zeros(4, 2, 64, dtype=BF, device="cuda")
    with pytest.raises(ValueError):  # no sideband with an int8 cache
        s = torch.ones(1, 4, 2, 1, 128, device="cuda")
        k1.decode_attention_cached(torch.zeros(4, 8, 64, dtype=BF, device="cuda"),
                                   torch.zeros(1, 4, 2, 64, 128, dtype=torch.int8, device="cuda"),
                                   torch.zeros(1, 4, 2, 128, 64, dtype=torch.int8, device="cuda"),
                                   0, torch.ones(4, 128, dtype=torch.bool, device="cuda"), s, s,
                                   k_new=kn, v_new=kn,
                                   new_valid=torch.ones(4, dtype=torch.bool, device="cuda"))


@pytest.mark.parametrize("dtype,b,t,nq,nkv,hd", [(torch.float32, 3, 128, 4, 2, 32),
                                                 (BF, 4, 384, 8, 2, 128)])
def test_flash_attention(g, dtype, b, t, nq, nkv, hd):
    q, do = (torch.randn(b, t, nq, hd, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, t, nkv, hd, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    pad = torch.ones(b, t, dtype=torch.int32, device="cuda")
    pad[0, t - 50:] = 0
    pad[1, :70] = 0  # queries 0..69 see no valid key
    pad[2] = 0       # no valid key at all
    tol = 2e-2 if dtype == BF else 1e-4
    o, lse = k567.flash_fwd(q, k, v, pad)
    o_ref, lse_ref = k567.flash_attention_fwd_plain(q, k, v, pad)
    _close(o, o_ref, tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    delta = k567.attention_delta(o_ref, do)
    _close(k567.flash_bwd_dq(q, k, v, pad, do, lse_ref, delta),
           k567.flash_bwd_dq_plain(q, k, v, pad, do, lse_ref, delta), tol)
    for got, ref in zip(k567.flash_bwd_dkv(q, k, v, pad, do, lse_ref, delta),
                        k567.flash_bwd_dkv_plain(q, k, v, pad, do, lse_ref, delta)):
        _close(got, ref, tol)


@pytest.mark.parametrize("t", [128, 512])
@pytest.mark.parametrize("hd", k567.HEAD_DIMS)
def test_flash_fwd_bf16_tensor_cores(g, hd, t):
    """K5's bf16 instance (mma.sync) at every head dim: ragged right
    padding, a left-padded row, a row with no valid key. O 2e-2, LSE 1e-3
    abs / 1e-4 rel, the dead rows identical (LSE -1e30, O 0)."""
    b, nq, nkv = 4, 4, 2
    q = torch.randn(b, t, nq, hd, generator=g, device="cuda").to(BF)
    k, v = (torch.randn(b, t, nkv, hd, generator=g, device="cuda").to(BF) for _ in range(2))
    pad = torch.ones(b, t, dtype=torch.int32, device="cuda")
    pad[0, t - 37:] = 0
    pad[1, :70] = 0  # queries 0..69 see no valid key
    pad[2] = 0       # no valid key at all
    before = _build.launches().get(k567.NAME_FWD, 0)
    o, lse = k567.flash_fwd(q, k, v, pad)
    assert _build.launches().get(k567.NAME_FWD, 0) == before + 1
    o_ref, lse_ref = k567.flash_attention_fwd_plain(q, k, v, pad)
    _close(o, o_ref, 2e-2)
    dead = lse_ref <= k567.NEG / 2
    assert torch.equal(lse <= k567.NEG / 2, dead) and torch.equal(lse[dead], lse_ref[dead])
    assert torch.all(o[2] == 0) and torch.all(o[1, :70] == 0)
    torch.testing.assert_close(lse[~dead], lse_ref[~dead], atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_flash_train_step_matches_plain(g, remat):
    """One train_step of a tiny bf16 model through K5-K7 (recomputed in the
    backward under remat) against the same step through the plain versions
    (CPU), from the same weights."""
    import numpy as np

    from kalle_tpu_torch.bridge import tree_leaves, tree_map
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig, TrainConfig
    from kalle_tpu_torch.data.collate import Item, collate
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.train.step import make_train_state, train_step

    cfg = LlasaConfig(llama=LlamaConfig(vocab_size=300, hidden_size=128,
                                        intermediate_size=256, num_layers=2, num_heads=4,
                                        num_kv_heads=2, head_dim=32, remat=remat != "none",
                                        remat_policy=remat),
                      latent_dim=16, audio_proj_dim=128, head_variant="stableaudio")
    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    items = [Item(input_ids=rng.integers(0, 300, n).astype(np.int32),
                  audio_latents=rng.normal(size=(f, 16)).astype(np.float32),
                  audio_distribution=np.concatenate(
                      [rng.normal(size=(f, 16)), rng.uniform(0.5, 1.5, (f, 16))],
                      -1).astype(np.float32)) for n, f in ((9, 100), (20, 108))]
    np_batch = collate(items, 0, buckets=(128,))
    out = []
    for dev in ("cpu", "cuda"):
        state = make_train_state(tree_map(lambda t: t.clone().to(dev), params), tcfg)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()
                 if isinstance(v, np.ndarray)}
        before = _build.launches().get(k567.NAME_FWD, 0)
        m = train_step(state, cfg, tcfg, batch, use_flash=True)
        if dev == "cuda":  # K5 once a layer, and again in the backward under remat
            assert _build.launches().get(k567.NAME_FWD, 0) - before == (2 if remat == "none" else 4)
        out.append((float(m["total_loss"]), [p.grad.cpu() for p in tree_leaves(state.params)]))
    (lc, gc), (lg, gg) = out
    assert abs(lg - lc) <= 1e-2 * abs(lc)
    for a, b in zip(gg, gc):  # bf16 compute: 5% of each gradient's largest entry
        assert float((a - b).abs().max()) <= 5e-2 * float(b.abs().max()) + 1e-6


def _small_bf16_int8_llasa(b_vocab=300):
    """A model whose widths the kernels take (hidden 256, heads 4/2 of 64),
    bf16 with int8 layer weights, random weights from a seed, on the CPU."""
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.core.config import LlamaConfig, LlasaConfig
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    llama = LlamaConfig(vocab_size=b_vocab, hidden_size=256, intermediate_size=512,
                        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64)
    cfg = LlasaConfig(llama=llama, latent_dim=64, audio_proj_dim=256)
    params = llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, quantize_llama_params(tree_map(lambda t: t.to(BF), params))


def _generate_both(cfg, params, ids, mask, max_frames):
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.infer.generate import generate

    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        out[dev] = generate(p, cfg, ids.to(dev), mask.to(dev), max_frames=max_frames,
                            greedy=True)
    return out["cpu"], out["cuda"]


def test_generate_tiny_f32_on_card(g):
    """LlamaConfig.tiny() in f32 with dense weights: the decode matmuls take
    maybe_matmul (dense weights never go to K2/K3), attention K1 in f32;
    the card agrees with the CPU to f32 rounding (matmuls in full f32)."""
    from kalle_tpu_torch.core.config import LlasaConfig
    from kalle_tpu_torch.models.lm import llasa

    cfg = LlasaConfig.tiny()
    params = llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ids = torch.randint(0, 300, (3, 9), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, :4] = 0
    before = _build.launches()
    ref, got = _generate_both(cfg, params, ids, mask, 8)
    assert _build.launches().get(k1.NAME, 0) - before.get(k1.NAME, 0) == 2 * 8
    assert _build.launches().get(k23.NAME_QMM, 0) == before.get(k23.NAME_QMM, 0)
    assert torch.equal(got.n_frames.cpu(), ref.n_frames)
    torch.testing.assert_close(got.means.cpu(), ref.means, atol=1e-4, rtol=1e-3)


def test_generate_tiny_f32_int8_on_card(g):
    """quantize_llama_params(LlamaConfig.tiny()) in f32 (C3): int8 weights
    with f32 activations go to K2/K3's f32 mode on the card, attention to
    K1 in f32; the card agrees with the CPU's plain versions at 1e-4."""
    from kalle_tpu_torch.core.config import LlasaConfig
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    cfg = LlasaConfig.tiny()
    params = quantize_llama_params(llasa.init_params(cfg, torch.Generator().manual_seed(0),
                                                     "cpu"))
    ids = torch.randint(0, 300, (3, 9), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, :4] = 0
    before = _build.launches()
    ref, got = _generate_both(cfg, params, ids, mask, 8)
    after = _build.launches()
    for name, n in ((k23.NAME_QMM, 4 * 2 * 8), (k23.NAME_MLP, 2 * 8), (k1.NAME, 2 * 8)):
        assert after.get(name, 0) - before.get(name, 0) == n
    assert torch.equal(got.n_frames.cpu(), ref.n_frames)
    torch.testing.assert_close(got.means.cpu(), ref.means, atol=1e-4, rtol=1e-4)


def test_generate_batch72_on_card(g):
    """Batch 72 (two 64-row tiles of K2/K3) in bf16 with int8 weights; the
    card agrees with the CPU's plain versions to bf16 tolerance (5e-2, as
    chip_smoke's small-input check)."""
    cfg, params = _small_bf16_int8_llasa()
    ids = torch.randint(0, 300, (72, 9), generator=torch.Generator().manual_seed(2))
    mask = torch.ones_like(ids)
    mask[::5, :3] = 0
    before = _build.launches().get(k23.NAME_MLP, 0)
    ref, got = _generate_both(cfg, params, ids, mask, 6)
    assert _build.launches().get(k23.NAME_MLP, 0) - before == 2 * 6
    assert torch.equal(got.n_frames.cpu(), ref.n_frames)
    assert float((got.means.cpu().float() - ref.means.float()).abs().max()) <= 5e-2


@pytest.mark.parametrize("mlp_ratio", [2, 3])
def test_tiny_codec_bf16_on_card(g, mlp_ratio):
    """SigmaVAEConfig.tiny() (channels 4, 8) in bf16: every residual block
    goes through K4's generic instance on the card; the wav agrees with
    the plain path on the CPU to bf16 tolerance."""
    import dataclasses

    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.infer.pipeline import Codec
    from kalle_tpu_torch.models.codecs import sigmavae

    vcfg = dataclasses.replace(sigmavae.SigmaVAEConfig.tiny(), mlp_ratio=mlp_ratio)
    codec = Codec.random_init("sigma", torch.Generator().manual_seed(3), "cpu", cfg=vcfg)
    codec.astype(BF)
    z = torch.randn(2, 12, vcfg.latent_dim, generator=torch.Generator().manual_seed(4)).to(BF)
    ref = sigmavae.decode(codec.params, vcfg, z)
    before = _build.launches().get(k4.NAME, 0)
    got = sigmavae.decode(tree_map(lambda t: t.cuda(), codec.params), vcfg, z.cuda())
    assert _build.launches().get(k4.NAME, 0) - before == len(vcfg.strides) * vcfg.blocks_per_stage
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert float((got.cpu().float() - ref.float()).abs().max()) <= 5e-2


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_continuous_batcher_on_card(g, kv):
    """Greedy continuous batching on the card (K1 sideband or int8 mode,
    K2, K3) against the same batcher on the CPU: five prompts on two rows,
    so freed rows are refilled."""
    import dataclasses

    import numpy as np

    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.infer.serve_loop import ContinuousBatcher

    cfg, params = _small_bf16_int8_llasa()
    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, kv_cache_dtype=kv))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 300, n) for n in (5, 20, 9, 14, 3)]
    out = {}
    for dev in ("cpu", "cuda"):
        cb = ContinuousBatcher(tree_map(lambda t: t.to(dev), params), cfg, batch_size=2,
                               max_frames=6, prompt_buckets=(8, 32), greedy=True, device=dev)
        before = _build.launches()
        out[dev] = {c.index: c for c in cb.run(prompts)}
        if dev == "cuda":
            name = k1.NAME_SIDEBAND if kv == "bfloat16" else k1.NAME
            assert _build.launches().get(name, 0) - before.get(name, 0) == 2 * cb.step_count
    for i in range(len(prompts)):
        a, b = out["cuda"][i], out["cpu"][i]
        assert a.n_frames == b.n_frames == 5 and a.steps_waited == b.steps_waited
        assert float(np.abs(a.means - b.means).max()) <= 5e-2
