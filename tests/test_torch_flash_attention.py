"""The port's flash attention forward against the JAX package's.

On the CPU, ``flash_attention`` runs its plain PyTorch version; it is held
against the Pallas kernel in interpreter mode.  The CUDA kernel itself is
held against that plain version by tests/test_torch_cuda.py (skipped
without a GPU) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu.ops.pallas.flash_attention import _flash_impl
from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(b, tq, tk, h, d, dv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, tk, h, d), dtype=np.float32)
    v = rng.standard_normal((b, tk, h, dv), dtype=np.float32)
    kv_mask = rng.random((b, tk)) > 0.3
    q_mask = rng.random((b, tq)) > 0.2
    return q, k, v, kv_mask, q_mask


def _jax_flash(q, k, v, kv_mask=None, q_mask=None, kv_logical_len=None):
    out, lse = jax.jit(
        lambda q, k, v, km, qm: _flash_impl(
            q, k, v, km, qm, 128, 128, True, need_lse=True,
            kv_logical_len=kv_logical_len,
        )
    )(q, k, v, None if kv_mask is None else jnp.asarray(kv_mask),
      None if q_mask is None else jnp.asarray(q_mask))
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize(
    "b,tq,tk,h,d,dv",
    [
        (2, 64, 300, 2, 32, 32),  # self-attend head width, ragged Tk
        (1, 40, 200, 1, 41, 41),  # odd width
        (1, 64, 700, 1, 322, 322),  # flow encoder width
        (1, 300, 64, 1, 512, 512),  # flow decoder width, long Q
    ],
)
def test_reference_matches_pallas(b, tq, tk, h, d, dv):
    q, k, v, _, _ = _inputs(b, tq, tk, h, d, dv, seed=d)
    want, want_lse = _jax_flash(q, k, v)
    got, got_lse = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        return_lse=True,
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, **TOL)


def test_reference_masks_and_lse_match_pallas():
    q, k, v, kv_mask, q_mask = _inputs(3, 50, 333, 2, 41, 24, seed=7)
    kv_mask[1] = False  # every key of batch 1 masked -> rows exactly 0
    want, want_lse = _jax_flash(q, k, v, kv_mask, q_mask, kv_logical_len=300)
    got, got_lse = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=torch.from_numpy(kv_mask), q_mask=torch.from_numpy(q_mask),
        kv_logical_len=300, return_lse=True,
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(got.numpy()[1] == 0.0)
    assert np.all(got.numpy()[~q_mask] == 0.0)
    assert np.array_equal(np.isinf(got_lse.numpy()), np.isinf(want_lse))
    assert np.all(np.isinf(got_lse.numpy()[1]))
    finite = np.isfinite(want_lse)
    np.testing.assert_allclose(got_lse.numpy()[finite], want_lse[finite], **TOL)


def test_reference_chunking_is_exact():
    """Chunking over query rows does not change the result."""
    q, k, v, kv_mask, q_mask = _inputs(2, 37, 90, 3, 16, 8, seed=3)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    kw = dict(kv_mask=torch.from_numpy(kv_mask), q_mask=torch.from_numpy(q_mask),
              return_lse=True)
    whole = fa.flash_attention_reference(*args, **kw)
    chunked = fa.flash_attention_reference(*args, max_chunk_elems=2 * 3 * 90 * 5, **kw)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_call_does_not_count_a_launch():
    q, k, v, _, _ = _inputs(1, 8, 16, 1, 8, 8, seed=0)
    before = fa.LAUNCHES
    fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert fa.LAUNCHES == before


def test_shape_checks_raise():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 5, 2, 7), torch.zeros(1, 5, 2, 8))
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 5, 2, 8), torch.zeros(1, 6, 2, 8))
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, kv_mask=torch.ones(1, 3, dtype=torch.bool))
