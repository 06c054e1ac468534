"""The rounding of K4's bf16 tensor-core instances
(kalle_tpu_torch/csrc/convnext_block.cu, `convnext_tc_kernel`), written
out as a torch function: RMSNorm and the causal depthwise conv in f32, the
filtered rows h rounded to bf16 before the up product, the GEGLU output a
rounded to bf16 before the down product, both products accumulated in f32,
and one rounding of the output. It is held against the JAX package's Pallas
kernel `fused_convnext_block` in interpret mode
(kalle_tpu/ops/pallas/convnext_block.py, f32 products) and against the
port's plain version, on the same bf16 inputs, at the tolerance the card
holds the kernel to (2e-2 abs + 2e-2 rel, chip_smoke.py and
tests/test_torch_cuda.py). The card itself is checked there; this shows on
the CPU that the two rounding points fit the tolerance at the decoder's
C 64 (two time blocks, so the JAX kernel's causal carry runs) and C 512."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kalle_tpu.ops.pallas.convnext_block import fused_convnext_block
from kalle_tpu_torch.ops.kernels.convnext_block import K, convnext_block_plain

TOL = dict(atol=2e-2, rtol=2e-2)
EPS = 1e-6

# (B, C, T, the JAX kernel's block_t)
CASES = {"c64_t256": (2, 64, 256, 128), "c512_t128": (2, 512, 128, 128)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(b, c, t, seed=0):
    """bf16 x (B, T, C) and one block's params at sigmavae.init_params'
    scale (uniform +-1/sqrt(fan_in); the norm scale near its init of 1)."""
    rng = np.random.default_rng(seed)
    h = 2 * c

    def uni(bound, *shape):
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))

    params = (1 + uni(0.1, c), uni(1 / math.sqrt(K), K, 1, c), uni(1 / math.sqrt(K), c),
              uni(1 / math.sqrt(c), 1, c, 2 * h), uni(1 / math.sqrt(c), 2 * h),
              uni(1 / math.sqrt(h), 1, h, c), uni(1 / math.sqrt(h), c))
    x = torch.from_numpy(rng.normal(size=(b, t, c)).astype(np.float32))
    return x.to(torch.bfloat16), [p.to(torch.bfloat16) for p in params]


def kernel_rounding(x, norm, dw_w, dw_b, up_w, up_b, down_w, down_b, eps=EPS):
    """out (bf16) with the kernel's rounding points: h and a to bf16."""
    t, c = x.shape[1], x.shape[2]
    xf = x.float()
    xn = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * norm.float()
    xp = F.pad(xn, (0, 0, K - 1, 0))
    dww = dw_w.float().reshape(K, c)
    h = sum(xp[:, j: j + t] * dww[j] for j in range(K)) + dw_b.float()
    h = h.to(torch.bfloat16).float()
    u = h @ up_w.float()[0] + up_b.float()
    v, g = u.chunk(2, dim=-1)
    a = (v * F.gelu(g, approximate="tanh")).to(torch.bfloat16).float()
    return (xf + (a @ down_w.float()[0] + down_b.float())).to(torch.bfloat16)


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("case", CASES)
def test_rounding_matches_jax_kernel(case):
    b, c, t, block_t = CASES[case]
    x, params = _inputs(b, c, t)
    ref = fused_convnext_block(_jax(x), *map(_jax, params), block_t=block_t, eps=EPS,
                               interpret=True)
    got = kernel_rounding(x, *params)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               **TOL)


@pytest.mark.parametrize("case", CASES)
def test_rounding_matches_plain(case):
    """The plain version the card compares the kernel with (f32 inside, one
    rounding at the output) agrees with the kernel's rounding too."""
    b, c, t, _ = CASES[case]
    x, params = _inputs(b, c, t, seed=1)
    got = kernel_rounding(x, *params)
    ref = convnext_block_plain(x, *params, eps=EPS)
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), **TOL)
