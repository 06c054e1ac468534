"""The codec ops of the port against the JAX package, f32 on the CPU at odd
and even lengths, within 1e-5: conv_transpose1d, the weight-import helpers
and the snake activations (ops/conv.py), the alias-free resamplers
(ops/alias_free.py), and the STFT, mel filterbank and mel spectrogram
(ops/mel.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kalle_tpu.ops import alias_free as jaf
from kalle_tpu.ops import conv as jconv
from kalle_tpu.ops import mel as jmel
from kalle_tpu_torch.ops import alias_free, conv, mel

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got: torch.Tensor, ref, tol=TOL):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.numpy(), ref, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("t", [9, 16])
@pytest.mark.parametrize("stride,k,padding", [(2, 5, 1), (4, 8, 2), (5, 10, 0), (3, 7, 2)])
def test_conv_transpose1d(t, stride, k, padding):
    rng = np.random.default_rng(t * 10 + stride)
    x = rng.normal(size=(2, t, 6)).astype(np.float32)
    w = rng.normal(size=(k, 6, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    ref = jconv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, padding)
    got = conv.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                stride, padding)
    _close(got, ref)


@pytest.mark.parametrize("dilation", [1, 3])
def test_conv1d_dilation(dilation):
    rng = np.random.default_rng(dilation)
    x = rng.normal(size=(2, 13, 4)).astype(np.float32)
    w = rng.normal(size=(7, 4, 3)).astype(np.float32)
    ref = jconv.conv1d(jnp.asarray(x), jnp.asarray(w), padding=3 * dilation, dilation=dilation)
    got = conv.conv1d(torch.from_numpy(x), torch.from_numpy(w), padding=3 * dilation,
                      dilation=dilation)
    _close(got, ref)


@pytest.mark.parametrize("dim_keep", [0, 1])
def test_weight_helpers(dim_keep):
    rng = np.random.default_rng(dim_keep)
    v = rng.normal(size=(6, 4, 5)).astype(np.float32)
    v[1] = 0.0  # a zero slice hits the 1e-12 floor
    g = rng.normal(size=(6, 1, 1) if dim_keep == 0 else (1, 4, 1)).astype(np.float32)
    np.testing.assert_array_equal(conv.fold_weight_norm(v, g, dim_keep),
                                  jconv.fold_weight_norm(v, g, dim_keep))
    np.testing.assert_array_equal(conv.torch_conv_weight(v), jconv.torch_conv_weight(v))
    np.testing.assert_array_equal(conv.torch_conv_transpose_weight(v),
                                  jconv.torch_conv_transpose_weight(v))


@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snakes(logscale, dtype):
    rng = np.random.default_rng(int(logscale))
    x = (3 * rng.normal(size=(2, 11, 6))).astype(np.float32)
    a = (0.5 * rng.normal(size=(6,))).astype(np.float32)
    bt = (0.5 * rng.normal(size=(6,))).astype(np.float32)
    if not logscale:
        a, bt = np.abs(a) + 0.5, np.abs(bt) + 0.5
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(tdt)
    ref_b = jconv.snake_beta(jx, jnp.asarray(a), jnp.asarray(bt), logscale)
    got_b = conv.snake_beta(tx, torch.from_numpy(a), torch.from_numpy(bt), logscale)
    ref_s = jconv.snake(jx, jnp.asarray(a), logscale)
    got_s = conv.snake(tx, torch.from_numpy(a), logscale)
    assert got_b.dtype == tdt and got_s.dtype == tdt
    tol = TOL if dtype == "float32" else 1e-2  # one bf16 ulp of the cast back
    _close(got_b.float(), np.asarray(ref_b, np.float32), tol)
    _close(got_s.float(), np.asarray(ref_s, np.float32), tol)


def test_kaiser_filter():
    for args in [(0.25, 0.3, 12), (0.5, 0.6, 12), (0.2, 0.1, 7), (0.0, 0.3, 6)]:
        np.testing.assert_array_equal(alias_free.kaiser_sinc_filter1d(*args),
                                      jaf.kaiser_sinc_filter1d(*args))


@pytest.mark.parametrize("t", [15, 32])
@pytest.mark.parametrize("ratio", [2, 3])
def test_resamplers(t, ratio):
    rng = np.random.default_rng(t + ratio)
    x = rng.normal(size=(2, t, 5)).astype(np.float32)
    up = alias_free.upsample1d(torch.from_numpy(x), ratio)
    _close(up, jaf.upsample1d(jnp.asarray(x), ratio))
    assert up.shape[1] == t * ratio
    _close(alias_free.downsample1d(torch.from_numpy(x), ratio),
           jaf.downsample1d(jnp.asarray(x), ratio))


@pytest.mark.parametrize("t", [15, 32])
def test_alias_free_act(t):
    rng = np.random.default_rng(t)
    x = rng.normal(size=(2, t, 5)).astype(np.float32)
    a = rng.normal(size=(5,)).astype(np.float32)
    ref = jaf.alias_free_act(jnp.asarray(x), lambda y: jconv.snake_beta(y, a, a))
    ta = torch.from_numpy(a)
    got = alias_free.alias_free_act(torch.from_numpy(x), lambda y: conv.snake_beta(y, ta, ta))
    _close(got, ref)


def test_mel_filterbank():
    for args in [(513, 80, 16000, 0.0, 8000.0), (257, 40, 22050, 50.0, None)]:
        np.testing.assert_allclose(mel.mel_filterbank(*args), jmel.mel_filterbank(*args),
                                   atol=0, rtol=0)
    np.testing.assert_array_equal(mel.hann_window(400), jmel.hann_window(400))


@pytest.mark.parametrize("n", [4001, 4096])
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_stft_mag(n, power):
    audio = np.random.default_rng(n).normal(size=(2, n)).astype(np.float32)
    ref = jmel.stft_mag(jnp.asarray(audio), n_fft=256, hop_length=64, win_length=200,
                        power=power)
    got = mel.stft_mag(torch.from_numpy(audio), n_fft=256, hop_length=64, win_length=200,
                       power=power)
    _close(got, ref)


@pytest.mark.parametrize("n", [8001, 8192])
def test_mel_spectrogram(n):
    audio = (0.3 * np.random.default_rng(n).normal(size=(2, 1, n))).astype(np.float32)
    ref = jmel.mel_spectrogram(jnp.asarray(audio))
    got = mel.mel_spectrogram(torch.from_numpy(audio))
    assert tuple(got.shape) == (2, 1, 80, 1 + n // 256)
    _close(got, ref)
    _close(mel.dynamic_range_compression(got), jmel.dynamic_range_compression(ref))


@pytest.mark.parametrize("t,target", [(7, 20), (30, 20), (20, 20)])
def test_modify_vector(t, target):
    m = np.random.default_rng(t).normal(size=(2, 4, t)).astype(np.float32)
    np.testing.assert_array_equal(mel.modify_vector(torch.from_numpy(m), target).numpy(),
                                  np.asarray(jmel.modify_vector(jnp.asarray(m), target)))
