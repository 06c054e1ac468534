"""The arithmetic of K1's bf16 tensor-core kernel
(kalle_tpu_torch/csrc/decode_attention.cu, `tc::decode_mma`), written out
as a torch function: the tiles of 32 cache columns that hold no valid
column skipped (a row with no valid key walks them all), the valid tiles
split in order over S blocks of a cluster and each block's over its 4
warps, each warp an online softmax in f32 with P rounded to bf16 before
P.V, the warps' partials merged in order, then the blocks' in rank order,
the sideband column merged last in f32. It is held against the JAX
package's Pallas kernel `decode_attention_cached` in interpret mode
(kalle_tpu/ops/pallas/decode_attention.py: its single-block path at cache
256, its online path at 384) and against the port's plain version, on the
same bf16 inputs, at the tolerance the card holds the kernel to (2e-2 abs
+ 2e-2 rel, chip_smoke.py and tests/test_torch_cuda.py), at cluster sizes
1, 2 and 4. The rows are the card's edge cases
(`decode_probe.edge_case_mask`): a masked leading tile, a valid range
inside one block's share, no valid key (base and sideband with the new
column not counted), left-pad holes, every column valid, and only the new
column counted."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.ops.pallas.decode_attention import decode_attention_cached as jax_kernel
from kalle_tpu_torch.ops.attention import NEG_INF
from kalle_tpu_torch.ops.kernels.decode_attention import decode_attention_plain
from kalle_tpu_torch.ops.kernels.decode_probe import edge_case_mask

TOL = dict(atol=2e-2, rtol=2e-2)
TC, WARPS = 32, 4
B, L, LI, NQ, NKV = 6, 2, 1, 8, 2
CASES = ("masked leading tile", "inside one share", "no valid key", "left-pad holes",
         "all valid", "only the new column")
SHAPES = {"hd64_c256": (64, 256), "hd128_c256": (128, 256), "hd64_c384": (64, 384)}
MODES = ("base", "sideband")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(hd, c, seed=0):
    """bf16 q, stacked K^T and V, the sideband column, and the edge-case
    mask and new_valid."""
    rng = np.random.default_rng(seed)

    def bf(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)

    q, kt, v = bf(B, NQ, hd), bf(L, B, NKV, hd, c), bf(L, B, NKV, c, hd)
    kn, vn = bf(B, NKV, hd), bf(B, NKV, hd)
    mask, live = edge_case_mask(B, c, device="cpu")
    return q, kt, v, kn, vn, mask, live


def _stream(q, k, v, mask, tiles, scale):
    """One warp: q (g, hd), k (hd, C), v (C, hd) in f32; its tiles in turn."""
    g, c = q.shape[0], k.shape[1]
    m, l, acc = torch.full((g,), NEG_INF), torch.zeros(g), torch.zeros(g, q.shape[1])
    for t in tiles:
        cols = slice(t * TC, min((t + 1) * TC, c))
        s = torch.where(mask[cols], (q @ k[:, cols]) * scale, NEG_INF)
        m_new = torch.maximum(m, s.amax(1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        l = l * corr + p.sum(1)
        acc = acc * corr[:, None] + p.to(torch.bfloat16).float() @ v[cols]
        m = m_new
    return m, l, acc


def _merge(parts):
    """Partials (m, l, acc) merged in order."""
    top = parts[0][0]
    for m, _, _ in parts[1:]:
        top = torch.maximum(top, m)
    f = [torch.exp(m - top) for m, _, _ in parts]
    return (top, sum(fi * l for fi, (_, l, _) in zip(f, parts)),
            sum(fi[:, None] * a for fi, (_, _, a) in zip(f, parts)))


def kernel_rounding(q, kt, v, li, mask, s_blocks, k_new=None, v_new=None, new_valid=None):
    """K1's tensor-core arithmetic at cluster size `s_blocks` -> (B, nq, hd)
    in q's dtype."""
    b, nq, hd = q.shape
    k, vv = kt[li].float(), v[li].float()
    nkv, c = k.shape[1], k.shape[3]
    qg = q.float().reshape(b, nkv, nq // nkv, hd)
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd)))
    ntiles = -(-c // TC)
    side = k_new is not None
    out = torch.empty(b, nkv, nq // nkv, hd)
    for i in range(b):
        tiles = [t for t in range(ntiles) if bool(mask[i, t * TC:(t + 1) * TC].any())]
        if not tiles and not (side and bool(new_valid[i])):
            tiles = list(range(ntiles))  # no valid key: every column, uniformly
        n = len(tiles)
        for h in range(nkv):
            blocks = []
            for r in range(s_blocks):
                lo, hi = r * n // s_blocks, (r + 1) * n // s_blocks
                blocks.append(_merge([
                    _stream(qg[i, h], k[i, h], vv[i, h], mask[i],
                            [tiles[j] for j in range(lo + w, hi, WARPS)], scale)
                    for w in range(WARPS)]))
            m, l, acc = _merge(blocks)
            if side:
                sn = (qg[i, h] @ k_new[i, h].float()) * scale
                sn = torch.where(new_valid[i], sn, torch.tensor(NEG_INF))
                m2 = torch.maximum(m, sn)
                corr, p = torch.exp(m - m2), torch.exp(sn - m2)
                l = l * corr + p
                acc = acc * corr[:, None] + p[:, None] * v_new[i, h].float()
            out[i, h] = acc / l.clamp_min(1e-30)[:, None]
    return out.reshape(b, nq, hd).to(q.dtype)


_JAX = {}


def _jax_out(shape, mode):
    """The JAX kernel in interpret mode, once per shape and mode."""
    if (shape, mode) not in _JAX:
        q, kt, v, kn, vn, mask, live = _inputs(*SHAPES[shape])
        a = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
        kw = {} if mode == "base" else dict(k_new=a(kn), v_new=a(vn),
                                            new_valid=jnp.asarray(live.numpy()))
        out = jax_kernel(a(q), a(kt), a(v), LI, jnp.asarray(mask.numpy()), interpret=True, **kw)
        _JAX[shape, mode] = np.asarray(out.astype(jnp.float32))
    return _JAX[shape, mode]


def _check(got, ref):
    for row in range(B):
        np.testing.assert_allclose(got[row], ref[row], err_msg=f"row {row}: {CASES[row % 6]}",
                                   **TOL)


def _emulated(shape, mode, s_blocks):
    q, kt, v, kn, vn, mask, live = _inputs(*SHAPES[shape])
    side = {} if mode == "base" else dict(k_new=kn, v_new=vn, new_valid=live)
    got = kernel_rounding(q, kt, v, LI, mask, s_blocks, **side)
    return got.float().numpy(), (q, kt, v, mask, side)


@pytest.mark.parametrize("s_blocks", [1, 2, 4])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_rounding_matches_jax_kernel(shape, mode, s_blocks):
    got, _ = _emulated(shape, mode, s_blocks)
    _check(got, _jax_out(shape, mode))


@pytest.mark.parametrize("s_blocks", [1, 2, 4])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_rounding_matches_plain(shape, mode, s_blocks):
    """The plain version the card compares the kernel with (f32 inside, one
    rounding at the output) agrees with the kernel's arithmetic too."""
    got, (q, kt, v, mask, side) = _emulated(shape, mode, s_blocks)
    _check(got, decode_attention_plain(q, kt, v, LI, mask, **side).float().numpy())


def test_skip_and_split_cover_every_valid_column():
    """The tiles the emulation walks: every valid column lies in one walked
    tile, each walked tile goes to exactly one warp of one block, and a row
    with no valid key (and no counted new column) walks every tile."""
    _, _, _, _, _, mask, live = _inputs(64, 256)
    for i in range(B):
        ntiles = 256 // TC
        tiles = [t for t in range(ntiles) if bool(mask[i, t * TC:(t + 1) * TC].any())]
        assert all(c // TC in tiles for c in torch.nonzero(mask[i]).flatten().tolist())
        if CASES[i] in ("no valid key", "only the new column"):
            assert tiles == []
        for s_blocks in (1, 2, 4):
            n = len(tiles)
            walked = sorted(j for r in range(s_blocks) for w in range(WARPS)
                            for j in range(r * n // s_blocks + w, (r + 1) * n // s_blocks, WARPS))
            assert walked == list(range(n))
    assert CASES[5] == "only the new column" and bool(live[5]) and not bool(live[2])
