"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes the main path does not reach (C not a multiple of
128, T not a multiple of the time tile, M not a multiple of 16 and above
64, f32 and int8 caches, K1's sideband, K1 at 16 heads a group and hd 256,
dense bf16 weights, K2 split over K at M 1..130, K2/K3 with f32
activations, K3's tensor-core kernel at M 1..72 with int8 and bf16
weights (reruns bit-identical), K3's fused mode (wg | wu as one (H, 2F)
matrix) bit-identical to the unfused call, K2 on the fused wq|wk|wv in
one launch, K4's tensor-core instances at C 16..512
and T 1..300 (reruns bit-identical, no look-ahead), ConvNeXt widths
outside the decoder's and mlp_ratio 3; K1's tensor-core kernel at batch 1, 8
and 32 on its edge cases (reruns bit-identical) and at ragged C, hd and
groups; flash
attention at t 128 to 512 with fully masked rows, f32 and bf16, K5's,
K6's and K7's tensor-core instances at every head dim, K6/K7 also at t 200
and GQA groups 1, 4 and 8 with their dead rows exactly 0 and reruns
bit-identical), one flash train_step against the
plain path, and whole paths on the card against the CPU: `generate` on the
tiny f32 config (dense, int8, fused and int4 weights) and at batch 72, the tiny codec
in bf16, the continuous batcher, the tiny Oobleck and mel-VAE codecs in f32 (TF32
off; no kernel of the port: cuDNN convs), and `cfg_generate` v1/v2 of the tiny f32
int8 model (K1-K3 in both branches); K4 raising under autograd, and a bf16 sigma codec's
generator step (0 K4 launches, nonzero encoder gradients) beside its encode under no_grad
(K4 in every block); tensor-parallel shard shapes (parallel/tp_probe.py) at
tp 2 and 4 on a reduced width. Needs an NVIDIA GPU and nvcc; skipped elsewhere. On
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


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("mode", ["base", "sideband"])
@pytest.mark.parametrize("b", [1, 8, 32])
def test_decode_attention_tensor_cores(g, b, mode, hd):
    """K1's tensor-core kernel at batch 1, 8 and 32 (the cluster split
    active), cache 256, 32 query / 8 KV heads, bf16, rows cycling through
    `decode_probe.edge_case_mask`'s cases (a masked leading tile, a valid
    range inside one block's share, no valid key, left-pad holes, all
    valid, only the new column): against the plain version, reruns
    bit-identical, one launch a call."""
    from kalle_tpu_torch.ops.kernels.decode_probe import edge_case_mask

    L, nq, nkv, c = 2, 32, 8, 256
    q = torch.randn(b, nq, hd, generator=g, device="cuda").to(BF)
    kt = torch.randn(L, b, nkv, hd, c, generator=g, device="cuda").to(BF)
    v = torch.randn(L, b, nkv, c, hd, generator=g, device="cuda").to(BF)
    mask, live = edge_case_mask(b, c)
    kw = {}
    if mode == "sideband":
        kn, vn = (torch.randn(b, nkv, hd, generator=g, device="cuda").to(BF) for _ in range(2))
        kw = dict(k_new=kn, v_new=vn, new_valid=live)
    assert k1.decode_attention_plan(b, nkv, nq // nkv, hd, c)["cluster"] >= 1
    name = k1.NAME_SIDEBAND if mode == "sideband" else k1.NAME
    before = _build.launches().get(name, 0)
    got = k1.decode_attention_cached(q, kt, v, 1, mask, **kw)
    again = k1.decode_attention_cached(q, kt, v, 1, mask, **kw)
    assert _build.launches().get(name, 0) == before + 2
    assert torch.equal(got, again)
    _close(got, k1.decode_attention_plain(q, kt, v, 1, mask, **kw), 2e-2)


@pytest.mark.parametrize("c,hd,nq,nkv", [(203, 64, 8, 2), (256, 40, 8, 2), (130, 36, 8, 2),
                                         (300, 100, 4, 2), (256, 64, 32, 2), (96, 64, 3, 1),
                                         (128, 16, 6, 2), (1000, 64, 8, 1), (203, 33, 8, 2)])
@pytest.mark.parametrize("mode", ["base", "sideband"])
def test_decode_attention_tensor_cores_ragged(g, c, hd, nq, nkv, mode):
    """K1's tensor-core kernel where its copies are not whole: C not a
    multiple of 8 (plain loads of K), hd not a multiple of 16 (zero-padded
    to the mma's depth) or of 8 (plain loads of V) or odd (q read a
    half-word at a time), hd 100 on the hd-128
    instance, 16 query heads a KV head (two chunks of 8), groups of 3 and
    1, a long cache; the edge cases' rows; f32 and int8 caches still take
    the first port's kernel."""
    from kalle_tpu_torch.ops.kernels.decode_probe import edge_case_mask

    L, b = 2, 6
    q = torch.randn(b, nq, hd, generator=g, device="cuda").to(BF)
    kt = torch.randn(L, b, nkv, hd, c, generator=g, device="cuda").to(BF)
    v = torch.randn(L, b, nkv, c, hd, generator=g, device="cuda").to(BF)
    mask, live = edge_case_mask(b, c)
    kw = {}
    if mode == "sideband":
        kn, vn = (torch.randn(b, nkv, hd, generator=g, device="cuda").to(BF) for _ in range(2))
        kw = dict(k_new=kn, v_new=vn, new_valid=live)
    assert k1.decode_attention_plan(b, nkv, nq // nkv, hd, c)["cluster"] >= 1
    assert k1.decode_attention_plan(b, nkv, nq // nkv, hd, c, torch.float32)["cluster"] == 0
    assert k1.decode_attention_plan(b, nkv, nq // nkv, hd, c, kv_int8=True)["cluster"] == 0
    got = k1.decode_attention_cached(q, kt, v, 1, mask, **kw)
    assert torch.equal(got, k1.decode_attention_cached(q, kt, v, 1, mask, **kw))
    _close(got, k1.decode_attention_plain(q, kt, v, 1, mask, **kw), 2e-2)


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


@pytest.mark.parametrize("h,f", [(2048, 8192), (256, 512)])
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("m", [1, 8, 13, 32, 64, 72])
def test_fused_mlp_tensor_cores(g, m, int8, h, f):
    """K3's bf16 tensor-core kernel at the flagship's widths (clusters of
    blocks, a second kernel summing them) and at small ones, at the serving
    batches, ragged row counts (rows past M zeroed in the kernel) and two
    row tiles: 1e-2 relative, one launch counted a call, and a rerun
    bit-identical (no atomics)."""
    def weight(*shape):
        w = torch.randn(*shape, generator=g, device="cuda") * 0.02
        if not int8:
            return w.to(BF)
        s = w.abs().amax(0) / 127
        return {"q": torch.round(w / s).to(torch.int8), "scale": s}

    ws = weight(h, f), weight(h, f), weight(f, h)
    x = torch.randn(m, h, generator=g, device="cuda").to(BF)
    before = _build.launches().get(k23.NAME_MLP, 0)
    got = k23.fused_mlp(x, *ws)
    assert _build.launches().get(k23.NAME_MLP, 0) == before + 1
    ref = k23.fused_mlp_plain(x, *ws)
    assert got.shape == (m, h) and got.dtype == BF
    assert float((got.float() - ref.float()).abs().max() / ref.float().abs().max()) < 1e-2
    assert torch.equal(k23.fused_mlp(x, *ws), got)


@pytest.mark.parametrize("h,f", [(2048, 8192), (256, 512)])
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("m", [1, 8, 32, 72])
def test_fused_mlp_fused_mode_equals_unfused(g, m, dtype, int8, h, f):
    """K3's fused mode (wg | wu as one (H, 2F) matrix, the decode layout of
    fuse_decode_params) gives the unfused call's bits on the same weights:
    the same plan, only the weight copies' addresses differ. Counted as
    fused_mlp_gu, one launch a call."""
    def weight(*shape):
        w = torch.randn(*shape, generator=g, device="cuda") * 0.02
        if not int8:
            return w.to(dtype)
        s = w.abs().amax(0) / 127
        return {"q": torch.round(w / s).to(torch.int8), "scale": s}

    wg, wu, wd = weight(h, f), weight(h, f), weight(f, h)
    wgu = ({"q": torch.cat([wg["q"], wu["q"]], 1), "scale": torch.cat([wg["scale"], wu["scale"]])}
           if int8 else torch.cat([wg, wu], 1))
    x = torch.randn(m, h, generator=g, device="cuda").to(dtype)
    before = _build.launches().get(k23.NAME_MLP_GU, 0)
    got = k23.fused_mlp(x, wgu, None, wd)
    assert _build.launches().get(k23.NAME_MLP_GU, 0) == before + 1
    assert torch.equal(got, k23.fused_mlp(x, wg, wu, wd))
    ref = k23.fused_mlp_plain(x, wgu, None, wd)
    assert float((got.float() - ref.float()).abs().max() / ref.float().abs().max()) < 1e-2


@pytest.mark.parametrize("m", [1, 8, 32, 72])
def test_qmm_wqkv_one_launch(g, m):
    """K2 on the fused wq|wk|wv (N 3072: N % 32 == 0, the split-K plan of
    any N) in one launch against the three separate launches, bf16."""
    h = 2048
    ws = []
    for n in (2048, 512, 512):
        w = torch.randn(h, n, generator=g, device="cuda") * 0.02
        s = w.abs().amax(0) / 127
        ws.append((torch.round(w / s).to(torch.int8), s))
    q = torch.cat([w for w, _ in ws], 1)
    s = torch.cat([s for _, s in ws])
    x = torch.randn(m, h, generator=g, device="cuda").to(BF)
    before = _build.launches().get(k23.NAME_QMM, 0)
    got = k23.qmm(x, q, s)
    assert _build.launches().get(k23.NAME_QMM, 0) == before + 1
    ref = torch.cat([k23.qmm(x, w, sc) for w, sc in ws], 1)
    _close(got, ref, 2e-2)
    _close(got, k23.qmm_plain(x, q, s), 2e-2)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("t", [1, 7, 100, 300])
@pytest.mark.parametrize("c", [16, 32, 64, 128, 256, 512])
def test_convnext_block_tensor_cores(g, c, t, b):
    """K4's tensor-core instances at every width they take (H = 2C): T 1
    and 7 (shorter than a tile, 7 barely past the causal halo), 100 and 300
    (ragged tiles, several tiles a row); 2e-2 abs + 2e-2 rel against the
    plain version, one launch counted, a rerun bit-identical; at T 7,
    changing x at t >= 5 leaves out[:, :5] bit-identical (no look-ahead)."""
    h = 2 * c

    def u(*shape, bound=1.0):
        return ((torch.rand(*shape, generator=g, device="cuda") * 2 - 1) * bound).to(BF)

    args = (u(c) + 1, u(7, 1, c, bound=0.4), u(c, bound=0.4), u(1, c, 2 * h, bound=c ** -0.5),
            u(2 * h, bound=c ** -0.5), u(1, h, c, bound=h ** -0.5), u(c, bound=h ** -0.5))
    x = torch.randn(b, t, c, generator=g, device="cuda").to(BF)
    before = _build.launches().get(k4.NAME, 0)
    got = k4.convnext_block(x, *args)
    assert _build.launches().get(k4.NAME, 0) == before + 1
    _close(got, k4.convnext_block_plain(x, *args), 2e-2)
    assert torch.equal(k4.convnext_block(x, *args), got)
    if t == 7:
        x2 = x.clone()
        x2[:, 5:] = torch.randn(b, 2, c, generator=g, device="cuda").to(BF)
        assert torch.equal(k4.convnext_block(x2, *args)[:, :5], got[:, :5])


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


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("t", [128, 200, 512])
@pytest.mark.parametrize("hd", k567.HEAD_DIMS)
def test_flash_bwd_bf16_tensor_cores(g, hd, t, group):
    """K6's and K7's bf16 instances (mma.sync) at every head dim, called
    directly (t 200 is not a multiple of the 64-row tiles), GQA groups 1, 4
    and 8: ragged right padding, a left-padded row, a row with no valid
    key. dQ, dK, dV 2e-2 abs + 2e-2 rel of the plain versions; the dead
    rows (queries with no valid key, padded keys) exactly 0; one launch
    counted a call; a rerun bit-identical."""
    b, nkv = 4, 2
    nq = nkv * group
    q, do = (torch.randn(b, t, nq, hd, generator=g, device="cuda").to(BF) for _ in range(2))
    k, v = (torch.randn(b, t, nkv, hd, generator=g, device="cuda").to(BF) for _ in range(2))
    pad = torch.ones(b, t, dtype=torch.int32, device="cuda")
    pad[0, t - 37:] = 0
    pad[1, :70] = 0  # queries 0..69 see no valid key
    pad[2] = 0       # no valid key at all
    o, lse = k567.flash_attention_fwd_plain(q, k, v, pad)
    delta = k567.attention_delta(o, do)
    args = (q, k, v, pad, do, lse, delta)
    counts = _build.launches()
    dq = k567.flash_bwd_dq(*args)
    dk, dv = k567.flash_bwd_dkv(*args)
    after = _build.launches()
    assert after.get(k567.NAME_DQ, 0) == counts.get(k567.NAME_DQ, 0) + 1
    assert after.get(k567.NAME_DKV, 0) == counts.get(k567.NAME_DKV, 0) + 1
    _close(dq, k567.flash_bwd_dq_plain(*args), 2e-2)
    for got, ref in zip((dk, dv), k567.flash_bwd_dkv_plain(*args)):
        _close(got, ref, 2e-2)
    assert torch.all(dq[2] == 0) and torch.all(dq[1, :70] == 0)
    for x in (dk, dv):
        assert torch.all(x[2] == 0) and torch.all(x[1, :70] == 0)
        assert torch.all(x[0, t - 37:] == 0)
    assert torch.equal(k567.flash_bwd_dq(*args), dq)
    dk2, dv2 = k567.flash_bwd_dkv(*args)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


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


@pytest.mark.parametrize("layout", ["int8_fused", "dense_fused", "int4", "int4_fused"])
def test_generate_tiny_f32_fused_and_int4_on_card(g, layout):
    """The fused decode layout and int4 weights on the card against the
    CPU (f32, 1e-4): fused int8 decodes through one K2 launch for wqkv and
    one for wo, and K3's fused mode; dense and int4 weights take the plain
    matmuls (no K2/K3 launch), attention K1."""
    from kalle_tpu_torch.core.config import LlasaConfig
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.quant import fuse_decode_params, quantize_llama_params

    cfg = LlasaConfig.tiny()
    params = llasa.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if layout.startswith("int"):
        params = quantize_llama_params(params, bits=4 if "4" in layout else 8, group=32)
    if layout.endswith("fused"):
        params = fuse_decode_params(params)
    ids = torch.randint(0, 300, (3, 9), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, :4] = 0
    before = _build.launches()
    ref, got = _generate_both(cfg, params, ids, mask, 8)
    after = _build.launches()
    k2k3 = layout == "int8_fused"
    for name, n in ((k23.NAME_QMM, 2 * 2 * 8 if k2k3 else 0), (k23.NAME_MLP, 0),
                    (k23.NAME_MLP_GU, 2 * 8 if k2k3 else 0), (k1.NAME, 2 * 8)):
        assert after.get(name, 0) - before.get(name, 0) == n, name
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


@pytest.fixture
def no_tf32(monkeypatch):
    """f32 convolutions and matmuls at full precision on the card."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.mark.parametrize("kind", ["stableaudio", "melvae"])
def test_tiny_codecs_f32_on_card(g, no_tf32, kind):
    """A tiny Oobleck and MelVAEConfig.tiny() in f32 on the card (cuDNN
    convs, no kernel of the port) against the CPU: encode, decode and, for
    the mel-VAE, both flow directions (1e-4 of max |ref|)."""
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.infer.pipeline import Codec
    from kalle_tpu_torch.models.codecs import melvae, oobleck

    if kind == "stableaudio":
        cfg = oobleck.OobleckConfig(channels=8, latent_dim=8, encoder_out_dim=16,
                                    c_mults=(1, 2, 4), strides=(2, 4, 4))
    else:
        cfg = melvae.MelVAEConfig.tiny()
    cpu = Codec.random_init(kind, torch.Generator().manual_seed(5), "cpu", cfg=cfg)
    card = Codec(kind, cfg, tree_map(lambda t: t.cuda(), cpu.params))
    gen = torch.Generator().manual_seed(6)
    spf = cpu.samples_per_frame
    wav = 0.3 * torch.randn(2, 2 if kind == "stableaudio" else 1, 12 * spf, generator=gen)
    lat = torch.randn(2, 12, cfg.latent_dim, generator=gen)
    pairs = [(card.encode_audio(wav), cpu.encode_audio(wav)),
             (card.decode_latents(lat), cpu.decode_latents(lat))]
    if kind == "melvae":
        for f in card.params["flows"] + cpu.params["flows"]:  # not the identity
            f["post"]["w"].fill_(0.05)
        z = lat.transpose(1, 2)
        for rev in (False, True):
            pairs.append((melvae.flow(card.params, cfg, z.cuda(), rev).cpu().numpy(),
                          melvae.flow(cpu.params, cfg, z, rev).numpy()))
        pairs.append((card.decode_latents(lat, flow_reverse=True),
                      cpu.decode_latents(lat, flow_reverse=True)))
    for got, ref in pairs:
        assert got.shape == ref.shape
        assert abs(got - ref).max() <= 1e-4 * max(1.0, abs(ref).max())


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_cfg_generate_tiny_f32_int8_on_card(g, variant):
    """cfg_generate of the tiny f32 model with int8 layer weights on the
    card (K1, K2, K3 in both branches every step) against the CPU, the same
    injected noise on both sides (1e-4)."""
    from kalle_tpu_torch.bridge import tree_map
    from kalle_tpu_torch.core.config import LlasaConfig
    from kalle_tpu_torch.infer.cfg import cfg_generate
    from kalle_tpu_torch.models.lm import llasa
    from kalle_tpu_torch.ops.quant import quantize_llama_params

    cfg = LlasaConfig.tiny(head_variant="melvae")
    params = quantize_llama_params(llasa.init_params(cfg, torch.Generator().manual_seed(0),
                                                     "cpu"))
    ids = torch.randint(0, 300, (1, 9), generator=torch.Generator().manual_seed(1))
    noise = torch.randn(1, 8, cfg.latent_dim, generator=torch.Generator().manual_seed(2))
    out = {}
    for dev in ("cpu", "cuda"):
        before = _build.launches()
        out[dev] = cfg_generate(tree_map(lambda t: t.to(dev), params), cfg, ids.to(dev),
                                max_frames=8, cfg_variant=variant, end_kl_threshold=0.0,
                                noise=noise.to(dev))
        after = _build.launches()
    for name, n in ((k23.NAME_QMM, 2 * 4 * 2 * 8), (k23.NAME_MLP, 2 * 2 * 8),
                    (k1.NAME, 2 * 2 * 8)):
        assert after.get(name, 0) - before.get(name, 0) == n
    ref, got = out["cpu"], out["cuda"]
    assert torch.equal(got.n_frames.cpu(), ref.n_frames)
    torch.testing.assert_close(got.samples.cpu(), ref.samples, atol=1e-4, rtol=1e-4)


def test_convnext_block_raises_under_autograd(g):
    """K4 has no backward: on inputs that require a gradient, with autograd
    recording, the wrapper raises instead of returning a detached output;
    under no_grad the same inputs launch K4."""
    c = 64
    r = lambda *s: (0.3 * torch.randn(*s, generator=g, device="cuda")).to(BF)
    args = [1 + r(c), r(7, 1, c), r(c), r(1, c, 4 * c), r(4 * c), r(1, 2 * c, c), r(c)]
    x = r(2, 40, c).requires_grad_(True)
    before = _build.launches().get(k4.NAME, 0)
    with pytest.raises(RuntimeError, match="no backward"):
        k4.convnext_block(x, *args)
    with torch.no_grad():
        k4.convnext_block(x, *args)
    assert _build.launches().get(k4.NAME, 0) - before == 1


def test_sigma_bf16_generator_step_on_card(g):
    """A bf16 sigma codec's generator step on the card runs its residual
    blocks unfused (0 K4 launches) and gives the encoder nonzero gradients;
    its inference encode under no_grad still takes K4 in every block."""
    from kalle_tpu_torch.bridge import tree_leaves, tree_map
    from kalle_tpu_torch.models.codecs import discriminators as disc
    from kalle_tpu_torch.models.codecs import sigmavae
    from kalle_tpu_torch.train import codec_trainer as ct

    cfg = sigmavae.SigmaVAEConfig(latent_dim=16, strides=(2, 2), channels=(16, 32),
                                  blocks_per_stage=1)
    dcfg = disc.DiscriminatorConfig.tiny()
    gen = tree_map(lambda t: t.to(BF), sigmavae.init_params(cfg, g, "cuda"))
    dp = tree_map(lambda t: t.to(BF), disc.init_params(dcfg, g, "cuda"))
    tx = ct.make_codec_optimizer(1e-3)
    st = ct.make_state(gen, dp, tx, tx)
    wav = (0.3 * torch.randn(2, 1, 2048, generator=g, device="cuda")).to(BF)
    _build.reset_launches()
    wav_hat, kl = ct._reconstruct("sigma", cfg, st.gen_params, wav, g)
    enc = tree_leaves(st.gen_params["encoder"])
    grads = torch.autograd.grad(wav_hat.float().pow(2).mean() + kl.float(), enc)
    assert sum(float(x.float().abs().sum()) for x in grads) > 0
    st, m = ct.generator_step(st, "sigma", cfg, dcfg, ct.LossWeights(), wav, g,
                              resolutions=((256, 64, 256),))
    assert all(torch.isfinite(v.float()) for v in m.values())
    assert _build.launches().get(k4.NAME, 0) == 0
    with torch.no_grad():
        sigmavae.encode(st.gen_params, cfg, wav)
    assert _build.launches().get(k4.NAME, 0) == len(cfg.strides) * cfg.blocks_per_stage


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_shard_shapes(g, tp):
    """parallel/tp_probe.check at a reduced width (hidden 512, 8 query / 4
    KV heads of 64, FFN 1024): each tp rank's decode halves through K1-K3
    (int8, separate and fused) and its training attention through K5-K7,
    every kernel against its plain version, the launches exact, and the
    partials summed over the ranks against the unsharded layer (2e-2 of
    the largest magnitude; chip_smoke phase 10(b) runs full width)."""
    import dataclasses

    from kalle_tpu_torch.core.config import LlamaConfig
    from kalle_tpu_torch.parallel import tp_probe

    cfg = dataclasses.replace(LlamaConfig(hidden_size=512, intermediate_size=1024, num_heads=8,
                                          num_kv_heads=4, head_dim=64, num_layers=1),
                              dtype="bfloat16")
    errs = tp_probe.check(cfg, tp, batch=8, cache_len=256, train_batch=2, train_t=256, g=g)
    assert max(errs.values()) <= tp_probe.TOL


def test_native_host_library_at_phase11_sizes(g, tmp_path):
    """The native alignment and batch .npy reader on the card's host at
    chip_smoke phase 11(f)'s sizes (200 pairs; 64 latent files of (1, 300..439,
    64) f32), against the Python alignment and np.load, with seconds."""
    import time

    import numpy as np

    from kalle_tpu_torch.eval import wer
    from kalle_tpu_torch.native import host

    assert host.have_compiler(), "the card's host has g++ (nvcc needs it)"
    host.get_lib()  # the build at first use, outside the timing
    rng = np.random.default_rng(0)
    pairs = [([str(x) for x in rng.integers(0, 30, rng.integers(20, 120))],
              [str(x) for x in rng.integers(0, 30, rng.integers(20, 120))]) for _ in range(200)]
    t0 = time.perf_counter()
    native = [host.align_tokens(r, h) for r, h in pairs]
    t1 = time.perf_counter()
    assert native == [wer._align_python(r, h) for r, h in pairs]
    t2 = time.perf_counter()
    paths = []
    for i in range(64):
        p = str(tmp_path / f"lat{i}.npy")
        np.save(p, rng.normal(size=(1, int(rng.integers(300, 440)), 64)).astype(np.float32))
        paths.append(p)
    t3 = time.perf_counter()
    got = host.load_npy_batch(paths)
    t4 = time.perf_counter()
    assert all(a.tobytes() == np.load(p).tobytes() for a, p in zip(got, paths))
    print(f"native align_s {t1 - t0:.4f} python_s {t2 - t1:.4f} load_npy_batch_s {t4 - t3:.4f}")


def test_latency_bench_flagship_batch1(g):
    """latency_bench at batch 1 on the flagship (bf16, the bf16 SigmaVAE):
    K1 every decode step of every layer, K4 in every codec block, no K2/K3."""
    from kalle_tpu_torch.tools import latency_bench

    _build.reset_launches()
    ttfa, rtf = latency_bench.main(["--batch", "1", "--iters", "2", "--chunk-frames", "8",
                                    "--max-frames", "16"])
    torch.cuda.synchronize()
    got = _build.launches()
    frames, decodes = 8 + 16 + 2 * 8 + 1 * 16, 2 + 2 + 1
    assert got.get("decode_attention", 0) == 16 * frames
    assert got.get("convnext_block", 0) == 10 * decodes
    assert not got.get("qmm") and not got.get("fused_mlp")
    assert 0 < ttfa["value"] <= ttfa["p95"] and rtf["value"] > 0
