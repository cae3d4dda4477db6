"""Kernel 4's wrapper, ``flash_prefill_attention``, on the CPU: the K/V
layouts it takes and the ones it refuses.

The kernel reads K and V where they lie (``k_cache[l, :, :pos0 + T]``, a
layer of a cache, rows ``hd`` apart, any head stride); on CPU tensors the
wrapper runs its plain twin over the same views, so a view must give
exactly what a contiguous copy gives.  Layout and configuration errors
raise on either device.  One JAX call holds the view's result against the
JAX kernel (interpret mode) at the JAX suite's bf16 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clusterfusion_tpu.ops.flash_prefill import \
    flash_prefill_attention as j_flash
from clusterfusion_tpu_torch.config import KernelConfig
from clusterfusion_tpu_torch.models.convert import tensor_from_numpy
from clusterfusion_tpu_torch.ops.flash_prefill import flash_prefill_attention


def _bf16(a):
    return tensor_from_numpy(np.asarray(jnp.asarray(a, jnp.bfloat16)),
                             device="cpu")


def _cache_view(kv, S, hd, cap, seed, layer=1, layers=3):
    """Layer ``layer`` of a [layers, kv, cap, hd] cache, its first S rows:
    a strided view (head stride cap * hd), NaN in every row past S."""
    rng = np.random.RandomState(seed)
    buf = torch.full((layers, kv, cap, hd), float("nan"), dtype=torch.bfloat16)
    buf[layer, :, :S] = _bf16(rng.randn(kv, S, hd))
    return buf[layer, :, :S]


@pytest.mark.parametrize("kv,T,g,hd,q_offset", [
    (2, 19, 1, 128, 0),
    (2, 7, 4, 64, 13),
    (2, 1, 8, 128, 30),
])
def test_strided_cache_view_equals_contiguous_copy(kv, T, g, hd, q_offset):
    S = q_offset + T
    k = _cache_view(kv, S, hd, cap=S + 16, seed=1)
    v = _cache_view(kv, S, hd, cap=S + 16, seed=2)
    assert not k.is_contiguous() and k.stride(1) == hd
    q = _bf16(np.random.RandomState(0).randn(kv, T, g, hd))
    out = flash_prefill_attention(q, k, v, q_offset=q_offset)
    assert bool(torch.isfinite(out.float()).all())
    assert torch.equal(out, flash_prefill_attention(
        q, k.contiguous(), v.contiguous(), q_offset=q_offset))


def test_strided_cache_view_matches_jax():
    kv, T, g, hd, q_offset = 2, 24, 2, 128, 40
    S = q_offset + T
    k = _cache_view(kv, S, hd, cap=S + 8, seed=3)
    v = _cache_view(kv, S, hd, cap=S + 8, seed=4)
    q = _bf16(np.random.RandomState(5).randn(kv, T, g, hd))
    out = flash_prefill_attention(q, k, v, q_offset=q_offset)

    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    jo = j_flash(j(q), j(k), j(v), q_offset=q_offset, block_q=16,
                 block_k=32)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jo, np.float32),
                               atol=3e-2, rtol=5e-2)


def _layouts(kv, S, hd):
    wide = torch.zeros(kv, S, 2 * hd, dtype=torch.bfloat16)
    return {
        # rows 2 hd apart
        "row_stride": wide[:, :, :hd],
        # hd not contiguous
        "transposed": torch.zeros(kv, hd, S, dtype=torch.bfloat16
                                  ).transpose(1, 2),
        # every other row of a cache
        "every_other_row": torch.zeros(kv, 2 * S, hd,
                                       dtype=torch.bfloat16)[:, ::2],
    }


@pytest.mark.parametrize("layout", ["row_stride", "transposed",
                                    "every_other_row"])
@pytest.mark.parametrize("which", ["k", "v"])
def test_refuses_kv_rows_not_hd_apart(layout, which):
    kv, T, hd = 2, 8, 128
    q = torch.zeros(kv, T, 1, hd, dtype=torch.bfloat16)
    good = torch.zeros(kv, T, hd, dtype=torch.bfloat16)
    bad = _layouts(kv, T, hd)[layout]
    k, v = (bad, good) if which == "k" else (good, bad)
    with pytest.raises(ValueError, match="rows must be"):
        flash_prefill_attention(q, k, v)


@pytest.mark.parametrize("rows", [0, 32, 96, 256])
def test_refuses_block_rows_outside_64_128(rows):
    q = torch.zeros(1, 4, 1, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="prefill_block_rows"):
        flash_prefill_attention(q, k, k,
                                kcfg=KernelConfig(prefill_block_rows=rows))


@pytest.mark.parametrize("rows", [64, 128])
def test_takes_block_rows_64_and_128(rows):
    rng = np.random.RandomState(6)
    q = _bf16(rng.randn(2, 9, 2, 64))
    k = _bf16(rng.randn(2, 9, 64))
    out = flash_prefill_attention(q, k, k,
                                  kcfg=KernelConfig(prefill_block_rows=rows))
    assert torch.equal(out, flash_prefill_attention(q, k, k))


def test_default_block_rows_is_two_warpgroups():
    assert KernelConfig().prefill_block_rows == 128
