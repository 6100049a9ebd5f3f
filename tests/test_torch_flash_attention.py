"""The port's flash attention, forward and backward, against the JAX
package's.

On the CPU, ``flash_attention`` runs its plain PyTorch versions (of K1
forward, of K2 and K3 backward); they are held against the Pallas kernels
in interpreter mode, the gradients through ``jax.grad`` with
``pallas_backward=True``.  The CUDA kernels themselves are held against
those plain versions by tests/test_torch_cuda.py (skipped without a GPU)
and by ``chip_smoke.py``.
"""

import math
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu.ops.pallas.flash_attention import (
    _flash_impl,
    _pallas_attention_bwd,
    flash_attention as jax_flash_attention,
)
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
        (1, 70, 300, 1, 704, 704),  # multimodal encoder width
        (2, 40, 129, 1, 704, 512),  # a 704-wide Q with narrower values
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


@pytest.mark.parametrize("num_splits", [1, 3])
def test_wide_reference_masks_and_lse_match_pallas(num_splits):
    """K1's plain version at the multimodal encoder's head width (d = dv =
    704) with kv_mask, q_mask, kv_logical_len, an all-masked batch entry and
    the lse, unsplit and walking the keys in 3 ranges, against the Pallas
    kernel in interpreter mode."""
    q, k, v, kv_mask, q_mask = _inputs(2, 50, 333, 1, 704, 704, seed=704)
    kv_mask[1] = False
    want, want_lse = _jax_flash(q, k, v, kv_mask, q_mask, kv_logical_len=300)
    got, got_lse = fa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=torch.from_numpy(kv_mask), q_mask=torch.from_numpy(q_mask),
        kv_logical_len=300, return_lse=True, num_splits=num_splits,
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(got.numpy()[1] == 0.0) and np.all(got.numpy()[~q_mask] == 0.0)
    assert np.array_equal(np.isinf(got_lse.numpy()), np.isinf(want_lse))
    finite = np.isfinite(want_lse)
    np.testing.assert_allclose(got_lse.numpy()[finite], want_lse[finite], **TOL)


def test_longkv_shape_reference_matches_pallas():
    """K1's plain version at the long-KV route's shape class, few query rows
    (a lone last tile of 1) against many keys, one head 261 wide (which the
    bf16 kernel takes on the card from 4,224 keys on), walking the keys in
    2 ranges and merging as the route's split grid does, against the Pallas
    kernel in interpreter mode: kv_mask, q_mask, kv_logical_len, an
    all-masked batch entry (rows exactly 0, lse +inf) and the lse."""
    q, k, v, kv_mask, q_mask = _inputs(2, 129, 1000, 1, 261, 261, seed=261)
    kv_mask[1] = False
    want, want_lse = _jax_flash(q, k, v, kv_mask, q_mask, kv_logical_len=990)
    got, got_lse = fa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=torch.from_numpy(kv_mask), q_mask=torch.from_numpy(q_mask),
        kv_logical_len=990, return_lse=True, num_splits=2,
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(got.numpy()[1] == 0.0) and np.all(got.numpy()[~q_mask] == 0.0)
    assert np.all(np.isinf(got_lse.numpy()[1]))
    assert np.array_equal(np.isinf(got_lse.numpy()), np.isinf(want_lse))
    finite = np.isfinite(want_lse)
    np.testing.assert_allclose(got_lse.numpy()[finite], want_lse[finite], **TOL)


def test_longq_shape_reference_matches_pallas():
    """K1's plain version at the long-Q route's shape class, many query rows
    (a ragged last tile of 44 rows) over a short key range, d = 264 with dv
    = 300 (the bf16 kernel takes 257 to 512 wide from 8,448 query rows on),
    against the Pallas kernel in interpreter mode: kv_mask, q_mask,
    kv_logical_len short of the keys, an all-masked batch entry (rows
    exactly 0, lse +inf) and the lse."""
    q, k, v, kv_mask, q_mask = _inputs(2, 300, 70, 1, 264, 300, seed=300)
    kv_mask[1] = False
    want, want_lse = _jax_flash(q, k, v, kv_mask, q_mask, kv_logical_len=67)
    got, got_lse = fa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=torch.from_numpy(kv_mask), q_mask=torch.from_numpy(q_mask),
        kv_logical_len=67, return_lse=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(got.numpy()[1] == 0.0) and np.all(got.numpy()[~q_mask] == 0.0)
    assert np.all(np.isinf(got_lse.numpy()[1]))
    assert np.array_equal(np.isinf(got_lse.numpy()), np.isinf(want_lse))
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


# The split-KV path: 3 batch entries, 430 keys of which the first 420 count
# (7 tiles of 64, the last one ragged), tile 1 (keys 64..127) masked
# everywhere, and every key of the last entry masked.
SPLIT_CASE = dict(b=3, tq=50, tk=430, h=2, d=41, dv=24, kv_logical_len=420)


@pytest.fixture(scope="module")
def split_case():
    c = SPLIT_CASE
    q, k, v, kv_mask, q_mask = _inputs(c["b"], c["tq"], c["tk"], c["h"], c["d"], c["dv"], 17)
    kv_mask[:, 64:128] = False
    kv_mask[-1] = False
    want = _jax_flash(q, k, v, kv_mask, q_mask, kv_logical_len=c["kv_logical_len"])
    args = [torch.from_numpy(x) for x in (q, k, v)]
    kw = dict(kv_mask=torch.from_numpy(kv_mask), q_mask=torch.from_numpy(q_mask),
              kv_logical_len=c["kv_logical_len"], return_lse=True)
    return args, kw, want


@pytest.mark.parametrize("num_splits", [1, 2, 3, 7])
def test_split_reference_matches_pallas(split_case, num_splits):
    """The plain K1 walking the keys in 1, 2, 3 or 7 tile ranges and merging
    the partials, against the Pallas kernel in interpreter mode and against
    the unsplit plain version; split 1 of 7 has every key masked."""
    args, kw, (want, want_lse) = split_case
    assert fa._split_bounds(SPLIT_CASE["kv_logical_len"], num_splits)[0] == num_splits
    got, got_lse = fa.flash_attention_reference(*args, num_splits=num_splits, **kw)
    whole, whole_lse = fa.flash_attention_reference(*args, **kw)
    for out, lse in ((want, want_lse), (whole.numpy(), whole_lse.numpy())):
        np.testing.assert_allclose(got.numpy(), out, **TOL)
        assert np.array_equal(np.isinf(got_lse.numpy()), np.isinf(lse))
        finite = np.isfinite(lse)
        np.testing.assert_allclose(got_lse.numpy()[finite], lse[finite], **TOL)
    assert np.all(got.numpy()[-1] == 0.0) and np.all(np.isinf(got_lse.numpy()[-1]))
    assert np.all(got.numpy()[~kw["q_mask"].numpy()] == 0.0)


def test_merge_partials_drops_masked_splits():
    """A split with l = 0 (m = -inf) leaves the merge unchanged; a row with
    every split masked gives 0 and lse +inf."""
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.standard_normal((3, 4, 5), dtype=np.float32))
    m = torch.from_numpy(rng.standard_normal((3, 4, 1), dtype=np.float32))
    l = torch.from_numpy(rng.uniform(0.5, 2.0, (3, 4, 1)).astype(np.float32))
    out, lse = fa.merge_partials(o, m, l)
    o2 = torch.cat([o, torch.full((1, 4, 5), 7.0)])
    m2 = torch.cat([m, torch.full((1, 4, 1), -math.inf)])
    l2 = torch.cat([l, torch.zeros(1, 4, 1)])
    out2, lse2 = fa.merge_partials(o2, m2, l2)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    torch.testing.assert_close(lse2, lse, rtol=0, atol=0)
    want = (o * torch.exp(m)).sum(0) / (l * torch.exp(m)).sum(0)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    dead, dead_lse = fa.merge_partials(o2[3:], m2[3:], l2[3:])
    assert torch.all(dead == 0) and torch.all(torch.isinf(dead_lse))


@pytest.mark.parametrize(
    "b,tq,h,tk,want_splits",
    [(1, 2048, 1, 182528, 8), (6, 2048, 1, 182528, 2), (1, 182528, 1, 2048, 1),
     (6, 182528, 1, 2048, 1), (1, 2048, 16, 2048, 1), (6, 2048, 16, 2048, 1),
     (2, 100, 2, 777, 1), (1, 64, 1, 0, 1)],
)
def test_split_plan(b, tq, h, tk, want_splits):
    """The flow sites: the encoder's short grid splits its keys (at least
    about two blocks per SM at batch 1), the full grids do not; no split is
    empty and the ranges cover every key tile."""
    splits, per = fa._split_plan(b, tq, h, tk)
    assert splits == want_splits and splits >= 1
    tiles = -(-tk // fa.BLOCK_K)
    assert (splits - 1) * per < tiles <= splits * per or tiles == 0
    blocks = -(-tq // fa.BLOCK_Q) * h * b * splits
    if (b, tk) == (1, 182528):
        assert blocks >= 256 >= fa.NUM_SMS
    if splits == 1:
        assert blocks >= 2 * fa.NUM_SMS or tiles < 2 * fa.MIN_SPLIT_TILES


def test_launch_plan_routes_by_dtype():
    q = torch.zeros(1, 2048, 1, 322, dtype=torch.bfloat16)
    k = torch.zeros(1, 182528, 1, 322, dtype=torch.bfloat16)
    plan = fa.launch_plan(q, k, k)
    assert plan == dict(route="sm90_longkv", splits=4, tiles_per_split=713, col_chunks=1,
                        blocks=128, cuda_launches=5, loader="copy", copies=("q", "k", "v"))
    plan = fa.launch_plan(q, k, k, num_splits=8)
    assert plan == dict(route="sm90_wgmma", splits=8, tiles_per_split=357, col_chunks=1,
                        blocks=256, cuda_launches=2, loader="cp.async4")
    plan = fa.launch_plan(q.float(), k.float(), k.float(), num_splits=1)
    assert (plan["route"], plan["splits"], plan["cuda_launches"]) == ("cuda_cores", 1, 1)


@pytest.mark.parametrize(
    "dtype,b,tq,dv,want",
    [(torch.bfloat16, 1, 784, 704, dict(splits=10, tiles_per_split=82, col_chunks=1,
                                        blocks=130, cuda_launches=2)),
     (torch.float32, 1, 784, 704, dict(splits=10, tiles_per_split=82, col_chunks=2,
                                       blocks=260, cuda_launches=2)),
     (torch.bfloat16, 2, 784, 704, dict(splits=5, tiles_per_split=163, col_chunks=1,
                                        blocks=130, cuda_launches=2)),
     (torch.bfloat16, 1, 784, 512, dict(splits=10, tiles_per_split=82, col_chunks=1,
                                        blocks=130, cuda_launches=2)),
     (torch.bfloat16, 16, 784, 704, dict(splits=1, tiles_per_split=815, col_chunks=1,
                                         blocks=208, cuda_launches=1))],
)
def test_wide_launch_plan(dtype, b, tq, dv, want):
    """The multimodal encoder (784 latents x 52,097 keys, one head of 704):
    bf16 takes the long-KV route, whose blocks hold all the value columns,
    its keys split for one wave (13 query blocks at batch 1 take 10 key
    splits, 130 blocks on 132 SMs; a batch of 16 no split, 208 blocks), TMA
    and no copy; fp32 splits the value columns in two chunks above 512, and
    its key splits count the chunks' blocks (10 splits, 260 blocks)."""
    q = torch.empty(b, tq, 1, 704, dtype=dtype, device="meta")
    k = torch.empty(b, 52097, 1, 704, dtype=dtype, device="meta")
    v = torch.empty(b, 52097, 1, dv, dtype=dtype, device="meta")
    plan = fa.launch_plan(q, k, v)
    if dtype == torch.bfloat16:
        assert plan == dict(route="sm90_longkv", loader="tma", copies=(), **want)
        assert fa._longkv_dq_split_plan(b, tq, 1, 52097) == (
            want["splits"], want["tiles_per_split"])
    else:
        assert plan == dict(route="cuda_cores", loader="elements", **want)
        assert fa._split_plan(b, tq, 1, 52097, fa._col_chunks(dv)) == (
            want["splits"], want["tiles_per_split"])
    tiles = -(-52097 // fa.BLOCK_K)
    assert (want["splits"] - 1) * want["tiles_per_split"] < tiles
    assert tiles <= want["splits"] * want["tiles_per_split"]
    assert [fa._col_chunks(w) for w in (1, 322, 512, 513, 704)] == [1, 1, 1, 2, 2]


# The self-attend's batches in chip_smoke.py: a flow request's 6 tiles, one
# tile, and phase R's microbatches of the 6 tiles (M = 2, 3, 6).
SELF_ATTEND_BATCHES = (1, 2, 3, 6)


@pytest.mark.parametrize("b", SELF_ATTEND_BATCHES)
def test_narrow_route_at_the_self_attend(b):
    """The flow self-attend (B, 2048 queries, 2048 keys, 16 heads of 32)
    takes the narrow-head kernel at every batch the card runs it at: one
    launch, no key split, no merge, 16 blocks of 128 rows a head and batch
    entry, 16-byte copies of its 64-byte rows."""
    q = torch.empty(b, 2048, 16, 32, dtype=torch.bfloat16, device="meta")
    plan = fa.launch_plan(q, q, q)
    assert plan == dict(route="sm90_narrow", splits=1, tiles_per_split=32, col_chunks=1,
                        blocks=16 * 16 * b, cuda_launches=1, loader="cp.async16")
    # the rows of [B, T, 3, H, D] qkv storage (q, k, v views) are aligned too
    qkv = torch.empty(b, 2048, 3, 16, 32, dtype=torch.bfloat16, device="meta")
    assert fa.launch_plan(*qkv.unbind(2)) == plan


@pytest.mark.parametrize(
    "dtype,d,dv,num_splits,route",
    [(torch.bfloat16, 16, 16, None, "sm90_narrow"), (torch.bfloat16, 41, 64, None, "sm90_narrow"),
     (torch.bfloat16, 64, 64, None, "sm90_narrow"), (torch.bfloat16, 64, 32, None, "sm90_narrow"),
     (torch.bfloat16, 65, 64, None, "sm90_wgmma"), (torch.bfloat16, 32, 72, None, "sm90_wgmma"),
     (torch.bfloat16, 32, 32, 1, "sm90_wgmma"), (torch.bfloat16, 41, 64, 2, "sm90_wgmma"),
     (torch.float32, 32, 32, None, "cuda_cores")],
)
def test_narrow_route_by_width(dtype, d, dv, num_splits, route):
    """bf16 calls whose Dqk and Dv are both at most NARROW_HEAD_DIM take the
    narrow route, which never splits its keys; wider heads, fp32 and a
    forced split count take the split-KV kernels."""
    b, tq, tk, h = 2, 100, 777, 2
    q = torch.empty(b, tq, h, d, dtype=dtype, device="meta")
    k = torch.empty(b, tk, h, d, dtype=dtype, device="meta")
    v = torch.empty(b, tk, h, dv, dtype=dtype, device="meta")
    plan = fa.launch_plan(q, k, v, kv_logical_len=tk - 50, num_splits=num_splits)
    assert plan["route"] == route
    if route == "sm90_narrow":
        assert (plan["splits"], plan["tiles_per_split"], plan["cuda_launches"]) == (1, 12, 1)
        assert plan["blocks"] == -(-tq // fa.NARROW_BLOCK_Q) * h * b
    else:
        assert plan["blocks"] == -(-tq // fa.BLOCK_Q) * h * b * plan["splits"]


@pytest.mark.parametrize(
    "width,offset,loader,own",
    [(261, 0, "realign", "realign"), (322, 0, "cp.async4", "cp.async4"),
     (322, 1, "realign", "cp.async4"), (264, 0, "cp.async16", "cp.async16"),
     (264, 1, "realign", "cp.async16"), (264, 2, "cp.async4", "cp.async16"),
     (264, 4, "cp.async8", "cp.async16"), (512, 3, "copy2", "cp.async16"),
     (704, 0, "cp.async16", "cp.async16"), (79, 0, "copy2", "copy2"),
     (600, 1, "realign", "cp.async16"), (41, 0, "realign", "realign"),
     (32, 0, "cp.async16", "cp.async16"), (32, 4, "realign", "cp.async16"),
     (32, 8, "cp.async16", "cp.async16")],
)
def test_loader_by_row_alignment(width, offset, loader, own):
    """How the bf16 kernels bring rows into shared memory, by the alignment
    that address, strides and row width all allow: the wgmma route copies
    them with cp.async of 16, 8 or 4 bytes and realigns rows aligned to 2
    bytes only (the pixel encoder's 261 wide, 522-byte rows; odd offsets),
    or copies them 2 bytes at a time where the covering chunks do not fit
    the tile (79 wide, an odd offset view of 512); the narrow route copies
    16-byte rows and realigns any other (41 wide, a view ``offset`` elements
    into its storage).  ``own`` is the loader of the contiguous tensor; a
    call takes the least of its operands'.  fp32 calls load elements."""
    b, t, h = 2, 24, 2
    buf = torch.zeros(b * t * h * width + offset, dtype=torch.bfloat16)
    x = buf[offset:].view(b, t, h, width)
    y = torch.zeros(b, t, h, width, dtype=torch.bfloat16)
    assert fa.launch_plan(x, y, y)["loader"] == loader
    assert fa.launch_plan(y, y, x)["loader"] == loader
    assert fa.launch_plan(y, y, y)["loader"] == own
    meta = torch.empty(b * t * h * width + offset, dtype=torch.bfloat16, device="meta")
    xm = meta[offset:].view(b, t, h, width)
    assert fa.launch_plan(xm, xm, xm)["loader"] == loader
    assert fa.launch_plan(x.float(), y.float(), y.float())["loader"] == "elements"
    # a [.., W + pad] buffer seen as [.., :W]: the strides are 16-byte
    # multiples, and the row width decides
    padded = torch.zeros(b, t, h, -(-width // 8) * 8 + 8, dtype=torch.bfloat16)[..., :width]
    assert fa.launch_plan(padded, padded, padded)["loader"] == own


@pytest.mark.parametrize(
    "b,tq,tk,h,d,dv,masked",
    [(2, 100, 777, 2, 32, 32, True),  # chip_smoke.py's masked narrow case
     (1, 130, 300, 4, 16, 16, False), (2, 70, 129, 2, 64, 64, True),
     (3, 65, 200, 3, 64, 32, True)],
)
def test_narrow_reference_matches_pallas(b, tq, tk, h, d, dv, masked):
    """K1's plain version at the narrow route's widths (the kernel is held
    against it on the card), with kv_mask, q_mask, kv_logical_len, an
    all-masked batch entry and the lse, against the Pallas kernel."""
    q, k, v, kv_mask, q_mask = _inputs(b, tq, tk, h, d, dv, seed=100 + d)
    kw, jkw = {}, {}
    if masked:
        kv_mask[-1] = False
        jkw = dict(kv_mask=kv_mask, q_mask=q_mask, kv_logical_len=tk - 50)
        kw = dict(kv_mask=torch.from_numpy(kv_mask), q_mask=torch.from_numpy(q_mask),
                  kv_logical_len=tk - 50)
    want, want_lse = _jax_flash(q, k, v, **jkw)
    got, got_lse = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), return_lse=True, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.array_equal(np.isinf(got_lse.numpy()), np.isinf(want_lse))
    finite = np.isfinite(want_lse)
    np.testing.assert_allclose(got_lse.numpy()[finite], want_lse[finite], **TOL)
    if masked:
        assert np.all(got.numpy()[-1] == 0.0) and np.all(got.numpy()[~q_mask] == 0.0)


def test_kernel_width_limits_raise_before_a_launch():
    """K1 and K2/K3 take head widths up to 704: a call above a kernel's own
    limit raises ValueError, naming it, before any launch (the check comes
    first, so tensors on the meta device show it here)."""
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    assert (fa.MAX_HEAD_DIM_FWD, fa.MAX_HEAD_DIM_BWD) == (704, 704)
    wide = torch.empty(1, 8, 1, 705, device="meta")
    with pytest.raises(ValueError, match="K1.* 1 to 704"):
        fa._flash_attention_cuda(wide, wide, wide, q_mask=None, kv_mask=None,
                                 softmax_scale=None, kv_logical_len=None, return_lse=False)
    x = torch.empty(1, 8, 1, 704, device="meta")
    with pytest.raises(ValueError, match="run on CUDA"):  # 704 passes the width check
        fa._flash_attention_cuda(x, x, x, q_mask=None, kv_mask=None, softmax_scale=None,
                                 kv_logical_len=None, return_lse=False)
    out, lse = torch.empty(1, 8, 705, device="meta"), torch.empty(1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="K2/K3.* 1 to 704"):
        fa._flash_attention_backward_cuda(wide, wide, wide, out, lse, out)
    out = torch.empty(1, 8, 704, device="meta")
    with pytest.raises(ValueError, match="run on CUDA"):  # 704 passes the width check
        fa._flash_attention_backward_cuda(x, x, x, out, lse, out)
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == before


def test_library_names_hash_the_headers(tmp_path, monkeypatch):
    """Each kernel library's name changes with its source and with any
    csrc/*.cuh header, so a header edit never leaves a stale library."""
    for name in os.listdir(fa._CSRC):
        shutil.copy(os.path.join(fa._CSRC, name), tmp_path / name)
    monkeypatch.setattr(fa, "_CSRC", str(tmp_path))
    before = fa.library_paths()
    assert set(before) == {"fwd", "fwd_sm90", "fwd_narrow", "fwd_longkv", "fwd_longq", "bwd",
                           "bwd_sm90", "bwd_narrow", "bwd_longkv"}
    assert os.path.basename(before["bwd_sm90"]).startswith("flash_attention_bwd_sm90_")
    with open(tmp_path / "sm90.cuh", "a") as f:
        f.write("// edited\n")
    after = fa.library_paths()
    assert all(after[name] != before[name] for name in before)
    with open(tmp_path / "flash_attention_bwd.cu", "a") as f:
        f.write("// edited\n")
    again = fa.library_paths()
    assert again["bwd"] != after["bwd"] and again["fwd"] == after["fwd"]
    assert again["bwd_sm90"] == after["bwd_sm90"]


# (B, Tq, Tk, H, D, Dv, kv_logical_len): the flow widths (32, 322, 512), a
# ragged one (41 with Dv 24) and the multimodal encoder's 704 (masked with
# kv_logical_len, and a 704-wide Q with Dv 512), at short lengths.
GRAD_CASES = [
    (2, 64, 300, 2, 32, 32, None),
    (3, 50, 333, 2, 41, 24, 300),
    (2, 40, 150, 1, 322, 322, 140),
    (2, 70, 64, 1, 512, 512, None),
    (2, 70, 300, 1, 704, 704, None),
    (2, 50, 333, 1, 704, 704, 300),
    (2, 40, 129, 1, 704, 512, 120),
]


def _jax_grads(q, k, v, g, kv_mask, q_mask, kv_logical_len):
    def loss(q, k, v):
        out = jax_flash_attention(
            q, k, v, kv_mask=jnp.asarray(kv_mask), q_mask=jnp.asarray(q_mask),
            block_q=32, block_k=64, interpret=True, pallas_backward=True,
            kv_logical_len=kv_logical_len,
        )
        return jnp.sum(out * g)

    return [np.asarray(x) for x in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]


def _port_grads(q, k, v, g, fn=fa.flash_attention, **kw):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, **kw)
    out.backward(torch.from_numpy(g))
    return [x.grad.numpy() for x in leaves]


def _grads_against_pallas(b, tq, tk, h, d, dv, kv_logical_len):
    """The autograd Function's backward on the CPU against jax.grad through
    the Pallas sweeps, with masks, kv_logical_len and a batch entry whose
    keys are all masked: within TOL, exact zeros on wiped rows, that entry's
    keys and tail keys, and no launch counted."""
    q, k, v, kv_mask, q_mask = _inputs(b, tq, tk, h, d, dv, seed=d + tk)
    kv_mask[-1] = False
    g = np.random.default_rng(d).standard_normal((b, tq, h * dv), dtype=np.float32)
    want = _jax_grads(q, k, v, g, kv_mask, q_mask, kv_logical_len)
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_NARROW)
    got = _port_grads(q, k, v, g, kv_mask=torch.from_numpy(kv_mask),
                      q_mask=torch.from_numpy(q_mask), kv_logical_len=kv_logical_len)
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ,
            fa.LAUNCHES_BWD_NARROW) == before
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, y, err_msg=name, **TOL)
        assert np.abs(y).max() > 0, name
    dq, dk, dv_ = got
    assert np.all(dq[-1] == 0.0) and np.all(dq[~q_mask] == 0.0)
    assert np.all(dk[-1] == 0.0) and np.all(dv_[-1] == 0.0)
    if kv_logical_len is not None:
        assert np.all(dk[:, kv_logical_len:] == 0.0)
        assert np.all(dv_[:, kv_logical_len:] == 0.0)


@pytest.mark.parametrize("b,tq,tk,h,d,dv,kv_logical_len", GRAD_CASES)
def test_backward_matches_pallas(b, tq, tk, h, d, dv, kv_logical_len):
    """The autograd Function's backward (the plain version of K2 and K3 on
    the CPU) against jax.grad through the Pallas dKV/dQ sweeps, with masks,
    kv_logical_len and a batch entry whose keys are all masked."""
    _grads_against_pallas(b, tq, tk, h, d, dv, kv_logical_len)


# The backward's narrow route (bf16, Dqk and Dv at most 64), whose kernels
# are held against the plain backward on the card: 16, 32 (16 heads), the
# 41-wide rows that take the realigning loader, 64 with Dv 32 and 32 with
# Dv 64, each with kv_logical_len, Tq and Tk not multiples of 64.
NARROW_GRAD_CASES = [
    (2, 70, 150, 2, 16, 16, 140),
    (2, 40, 100, 16, 32, 32, 97),
    (2, 70, 150, 2, 41, 41, 141),
    (3, 65, 130, 3, 64, 32, 120),
    (2, 50, 90, 2, 32, 64, 80),
]


@pytest.mark.parametrize("b,tq,tk,h,d,dv,kv_logical_len", NARROW_GRAD_CASES)
def test_narrow_backward_matches_pallas(b, tq, tk, h, d, dv, kv_logical_len):
    """The plain backward at the narrow route's widths (which the bf16
    kernels take on the card) against jax.grad through the Pallas sweeps in
    interpreter mode: masks, kv_logical_len, an all-masked entry, exact
    zeros on wiped rows and tail keys."""
    shapes = [torch.empty(b, t, h, w, dtype=torch.bfloat16, device="meta")
              for t, w in ((tq, d), (tk, d), (tk, dv))]
    assert fa.backward_plan(*shapes, kv_logical_len=kv_logical_len)["route"] == "sm90_narrow"
    _grads_against_pallas(b, tq, tk, h, d, dv, kv_logical_len)


def test_longkv_shape_backward_matches_pallas():
    """The plain backward at the long-KV route's shape class, few query
    rows against many keys one head 261 wide (which the bf16 kernels take
    on the card from 4,224 keys on), against jax.grad through the Pallas
    sweeps in interpreter mode: masks, kv_logical_len, an all-masked entry,
    exact zeros on wiped rows and tail keys."""
    _grads_against_pallas(2, 130, 700, 1, 261, 261, 690)


@pytest.mark.parametrize(
    "b,tq,tk,h,d,dv,masked",
    [(2, 37, 90, 3, 16, 8, True), (1, 64, 700, 1, 322, 322, False)],
)
def test_backward_reference_matches_autograd(b, tq, tk, h, d, dv, masked):
    """The plain backward against torch.autograd through the plain forward."""
    q, k, v, kv_mask, q_mask = _inputs(b, tq, tk, h, d, dv, seed=tq)
    g = np.random.default_rng(1).standard_normal((b, tq, h * dv), dtype=np.float32)
    kw = {}
    if masked:
        kv_mask[0] = False
        kw = dict(kv_mask=torch.from_numpy(kv_mask), q_mask=torch.from_numpy(q_mask),
                  kv_logical_len=tk - 7)
    want = _port_grads(q, k, v, g, fn=fa.flash_attention_reference, **kw)
    got = _port_grads(q, k, v, g, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6, err_msg=name)


def test_backward_reference_chunking():
    """Chunking over query rows changes only the order of the dk/dv sums."""
    q, k, v, kv_mask, q_mask = _inputs(2, 37, 90, 3, 16, 8, seed=5)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    kw = dict(kv_mask=torch.from_numpy(kv_mask), q_mask=torch.from_numpy(q_mask))
    out, lse = fa.flash_attention_reference(*args, return_lse=True, **kw)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    whole = fa.flash_attention_backward_reference(*args, out, lse, g, **kw)
    chunked = fa.flash_attention_backward_reference(
        *args, out, lse, g, max_chunk_elems=2 * 3 * 90 * 5, **kw)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_lse_under_gradient_is_not_differentiable():
    q, k, v, _, _ = _inputs(1, 8, 16, 2, 8, 8, seed=0)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    assert out.requires_grad and not lse.requires_grad
    want = fa.flash_attention_reference(q.detach(), k.detach(), v.detach(),
                                        return_lse=True)
    torch.testing.assert_close(out.detach(), want[0], rtol=0, atol=0)
    torch.testing.assert_close(lse, want[1], rtol=0, atol=0)


# The split backward: 420 query rows and keys (7 tiles of 64 each, the last
# ragged), 430 keys of which the first 420 count, key tile 1 masked
# everywhere, and every key of the last batch entry masked.
BWD_SPLIT_CASE = dict(b=2, tq=420, tk=430, h=2, d=41, dv=24, kv_logical_len=420)


@pytest.fixture(scope="module")
def bwd_split_case():
    c = BWD_SPLIT_CASE
    q, k, v, kv_mask, q_mask = _inputs(c["b"], c["tq"], c["tk"], c["h"], c["d"], c["dv"], 23)
    kv_mask[:, 64:128] = False
    kv_mask[-1] = False
    out, lse = _jax_flash(q, k, v, kv_mask, q_mask, kv_logical_len=c["kv_logical_len"])
    g = np.random.default_rng(24).standard_normal(out.shape, dtype=np.float32)
    want = jax.jit(lambda *a: _pallas_attention_bwd(
        *a, block_q=32, block_k=64, interpret=True,
        kv_logical_len=c["kv_logical_len"]))(
        q, k, v, jnp.asarray(kv_mask), jnp.asarray(q_mask), out, lse, g)
    args = [torch.from_numpy(np.array(x)) for x in (q, k, v, out, lse, g)]
    kw = dict(kv_mask=torch.from_numpy(kv_mask), q_mask=torch.from_numpy(q_mask),
              kv_logical_len=c["kv_logical_len"])
    return args, kw, [np.asarray(x) for x in want]


@pytest.mark.parametrize("num_splits", [1, 2, 3, 7])
def test_split_backward_reference_matches_pallas(bwd_split_case, num_splits):
    """The plain backward summing dk/dv over 1, 2, 3 or 7 query ranges and
    dq over as many key ranges, in order, against `_pallas_attention_bwd`
    in interpreter mode and against the unsplit plain version; key range 1
    of 7 is masked everywhere."""
    args, kw, want = bwd_split_case
    for length in (BWD_SPLIT_CASE["tq"], BWD_SPLIT_CASE["kv_logical_len"]):
        assert fa._split_bounds(length, num_splits)[0] == num_splits
    got = fa.flash_attention_backward_reference(*args, num_splits=num_splits, **kw)
    whole = fa.flash_attention_backward_reference(*args, **kw)
    for name, x, y, z in zip(("dq", "dk", "dv"), got, want, whole):
        np.testing.assert_allclose(x.numpy(), y, err_msg=name, **TOL)
        np.testing.assert_allclose(x.numpy(), z.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
        assert np.abs(y).max() > 0, name
    dq, dk, dv_ = (x.numpy() for x in got)
    assert np.all(dq[-1] == 0.0) and np.all(dq[~kw["q_mask"].numpy()] == 0.0)
    tail = BWD_SPLIT_CASE["kv_logical_len"]
    assert np.all(dk[:, tail:] == 0.0) and np.all(dv_[:, tail:] == 0.0)
    assert np.all(dk[:, 64:128] == 0.0) and np.all(dv_[:, 64:128] == 0.0)


@pytest.mark.parametrize(
    "site,b,tq,h,tk,d,route,dkv_splits,dkv_blocks,dq_splits,dq_blocks",
    [("decoder", 1, 182528, 1, 2048, 512, "sm90_wgmma", 8, 512, 1, 2852),
     ("encoder", 1, 2048, 1, 182528, 322, "sm90_wgmma", 1, 5704, 8, 256),
     ("decoder", 6, 182528, 1, 2048, 512, "sm90_wgmma", 2, 768, 1, 17112),
     ("encoder", 6, 2048, 1, 182528, 322, "sm90_wgmma", 1, 34224, 2, 384),
     ("self", 1, 2048, 16, 2048, 32, "sm90_narrow", 1, 256, 1, 256),
     ("masked", 2, 100, 2, 777, 41, "sm90_narrow", 1, 28, 1, 4),
     ("cls_pixel", 8, 512, 1, 50176, 261, "sm90_longkv", 1, 132, 2, 128),
     ("cls_1x1conv", 8, 512, 1, 50176, 512, "sm90_longkv", 1, 132, 2, 128)],
)
def test_backward_split_plan(site, b, tq, h, tk, d, route, dkv_splits, dkv_blocks, dq_splits,
                             dq_blocks):
    """The flow sites at batch 1: K2 splits the decoder's query rows (64
    key blocks of 32 on 132 SMs), K3 the encoder's keys (the wgmma K1's
    plan: 32 query blocks); at 6 tiles 2 splits each; the full grids take
    one split; K2 and K3 stay on the wgmma kernels at both flow sites (K1
    takes the long-KV and long-Q routes there), and the self-attend and a
    41-wide case take the narrow route (blocks of 128 keys or query rows),
    which never splits and agrees with the plans that find no split.  The
    classification encoders at the training batch of 8 (512 latents over
    50,176 pixels, d = 261 and 512) take the long-KV route: K2 one launch of
    132 persistent blocks over 8 x 1,568 blocks of 32 keys, after copies of
    q, dO, k and v into aligned rows at d = 261; K3 2 key splits of 64 query
    tiles (128 blocks, one wave), reading K2's copies.  No range is empty
    and the ranges cover every tile."""
    q = torch.empty(b, tq, h, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, tk, h, d, dtype=torch.bfloat16, device="meta")
    plan = fa.backward_plan(q, k, k)
    assert plan["route"] == route
    dq_plan = fa._split_plan
    if route == "sm90_longkv":
        copies = ("q", "dout", "k", "v") if d == 261 else ()
        assert (plan["dkv"]["items"], plan["dkv"]["loader"], plan["dkv"]["copies"]) == (
            -(-tk // fa.LONGKV_BLOCK_K) * h * b, "copy" if d == 261 else "tma", copies)
        assert (plan["dq"]["loader"], plan["dq"]["copies"]) == (plan["dkv"]["loader"], copies)
        assert "cluster" not in plan["dkv"] and "cluster" not in plan["dq"]
        dq_plan = fa._longkv_dq_split_plan
    assert fa._dkv_split_plan(b, tq, h, tk) == (plan["dkv"]["splits"],
                                               plan["dkv"]["tiles_per_split"])
    assert dq_plan(b, tq, h, tk) == (plan["dq"]["splits"], plan["dq"]["tiles_per_split"])
    for kernel, splits, blocks, length in (("dkv", dkv_splits, dkv_blocks, tq),
                                           ("dq", dq_splits, dq_blocks, tk)):
        got = plan[kernel]
        assert (got["splits"], got["blocks"]) == (splits, blocks), (kernel, got)
        # K2 launches the copies into aligned rows; K3 reads K2's
        own = got.get("copies", ()) if kernel == "dkv" else ()
        assert got["cuda_launches"] == 1 + (splits > 1) + len(own)
        tiles = -(-length // fa.BLOCK_K)
        assert (splits - 1) * got["tiles_per_split"] < tiles <= splits * got["tiles_per_split"]


@pytest.mark.parametrize(
    "b,tq,tk,h,d,dv,dtype,num_splits,route",
    [(8, 512, 50176, 1, 261, 261, torch.bfloat16, None, "sm90_longkv"),
     (2, 512, 50176, 1, 512, 512, torch.bfloat16, None, "sm90_longkv"),  # phase 17's batch
     (8, 512, 50176, 1, 261, 261, torch.float32, None, "cuda_cores"),
     (8, 512, 50176, 1, 261, 261, torch.bfloat16, 1, "sm90_wgmma"),  # a forced split count
     # 9 query tiles: K1's long-KV route takes up to 32, K2's and K3's up to 8
     (8, 513, 50176, 1, 261, 261, torch.bfloat16, None, ("sm90_longkv", "sm90_wgmma")),
     (8, 512, 4223, 1, 512, 512, torch.bfloat16, None, "sm90_wgmma"),  # fewer keys than 132 x 32
     (1, 77, 4224, 3, 300, 264, torch.bfloat16, None, "sm90_longkv"),
     (8, 512, 50176, 1, 256, 256, torch.bfloat16, None, "sm90_wgmma"),  # 64 keys a wgmma block
     (2, 100, 8000, 1, 64, 257, torch.bfloat16, None, "sm90_longkv"),
     (8, 512, 50176, 1, 513, 513, torch.bfloat16, None, "sm90_longkv"),
     (1, 784, 52097, 1, 704, 704, torch.bfloat16, None, "sm90_longkv"),  # the multimodal encoder
     (1, 784, 52097, 1, 704, 704, torch.bfloat16, 10, "sm90_wgmma"),  # a forced split count
     (1, 784, 52097, 1, 704, 704, torch.float32, None, "cuda_cores"),
     (1, 1025, 52097, 1, 704, 704, torch.bfloat16, None, "sm90_wgmma"),  # 17 query tiles
     (1, 1024, 4224, 1, 704, 704, torch.bfloat16, None, "sm90_longkv"),
     (1, 784, 4223, 1, 704, 704, torch.bfloat16, None, "sm90_wgmma"),  # fewer keys than 132 x 32
     (2, 100, 8000, 1, 704, 512, torch.bfloat16, None, "sm90_longkv"),
     (2, 100, 8000, 1, 64, 704, torch.bfloat16, None, "sm90_longkv"),
     (2, 100, 8000, 1, 705, 705, torch.bfloat16, None, "sm90_wgmma"),  # past the widest head
     (2, 100, 777, 1, 704, 704, torch.bfloat16, None, "sm90_wgmma"),  # short-KV wide cases
     (2, 100, 257, 1, 704, 512, torch.bfloat16, None, "sm90_wgmma"),
     # the flow encoder at batch 1 and 6: K1 long-KV, K2 and K3 wgmma
     (1, 2048, 182528, 1, 322, 322, torch.bfloat16, None, ("sm90_longkv", "sm90_wgmma")),
     (6, 2048, 182528, 1, 322, 322, torch.bfloat16, None, ("sm90_longkv", "sm90_wgmma")),
     (1, 2049, 182528, 1, 322, 322, torch.bfloat16, None, "sm90_wgmma"),  # 33 query tiles
     (1, 2048, 4223, 1, 322, 322, torch.bfloat16, None, "sm90_wgmma"),  # fewer keys
     (1, 2048, 182528, 1, 322, 322, torch.bfloat16, 4, "sm90_wgmma"),  # a forced split count
     (1, 2048, 182528, 1, 322, 322, torch.float32, None, "cuda_cores"),
     (1, 2048, 182528, 1, 256, 256, torch.bfloat16, None, "sm90_wgmma"),  # 64 keys a K2 block
     (1, 2048, 182528, 1, 513, 513, torch.bfloat16, None, "sm90_wgmma"),  # 513: 16 tiles at most
     # the flow decoder at batch 1 and 6: K1 long-Q, K2 and K3 wgmma
     (1, 182528, 2048, 1, 512, 512, torch.bfloat16, None, ("sm90_longq", "sm90_wgmma")),
     (6, 182528, 2048, 1, 512, 512, torch.bfloat16, None, ("sm90_longq", "sm90_wgmma")),
     (2, 100, 8000, 2, 48, 48, torch.bfloat16, None, "sm90_narrow")],
)
def test_longkv_route_by_shape(b, tq, tk, h, d, dv, dtype, num_splits, route):
    """bf16 calls over at least 4,224 keys whose wider head is 257 to 512
    wide with at most 512 query rows (K1: 2,048, the flow encoder's 32
    query tiles), or 513 to 704 wide with at most 1,024 (the multimodal
    encoder), take the long-KV K1, K2 and K3 (K1's key splits by
    ``_longkv_fwd_split_plan``, K3's by ``_longkv_dq_split_plan``, K1 and K2
    on the same loader, K2 and K3 on the same copies, no column chunks); a
    forced split count, fp32, more query rows, fewer keys and other widths
    keep their routes, K1's and the backward's alike; the flow decoder's K1
    takes the long-Q route (``route`` a pair: K1's, the backward's)."""
    q = torch.empty(b, tq, h, d, dtype=dtype, device="meta")
    k = torch.empty(b, tk, h, d, dtype=dtype, device="meta")
    v = torch.empty(b, tk, h, dv, dtype=dtype, device="meta")
    plan = fa.backward_plan(q, k, v, num_splits=num_splits)
    forward = fa.launch_plan(q, k, v, num_splits=num_splits)
    fwd_route, route = route if isinstance(route, tuple) else (route, route)
    assert plan["route"] == route and forward["route"] == fwd_route
    k1_copies = tuple(name for name, t in zip("qkv", (q, k, v)) if not fa._tma_rows(t))
    if fwd_route == "sm90_longkv":
        splits, per = fa._longkv_fwd_split_plan(b, tq, h, tk, max(d, dv))
        assert forward == dict(
            route=fwd_route, splits=splits, tiles_per_split=per, col_chunks=1,
            blocks=-(-tq // 64) * h * b * splits,
            cuda_launches=1 + (splits > 1) + len(k1_copies),
            loader=fa._longkv_loader(k, v), copies=k1_copies)
    if route == "sm90_longkv":
        items = -(-tk // 32) * h * b
        copies, loader = fa._longkv_copies(q, k, v), fa._longkv_loader(k, v)
        assert plan["dkv"] == dict(splits=1, tiles_per_split=-(-tq // 64), col_chunks=1,
                                   blocks=min(items, fa.NUM_SMS), cuda_launches=1 + len(copies),
                                   items=items, loader=loader, copies=copies)
        splits, per = fa._longkv_dq_split_plan(b, tq, h, tk)
        assert plan["dq"] == dict(
            splits=splits, tiles_per_split=per, col_chunks=1, blocks=-(-tq // 64) * h * b * splits,
            cuda_launches=1 + (splits > 1), loader=loader, copies=copies)
        assert plan["dq"]["blocks"] <= fa.NUM_SMS
        assert forward["loader"] == loader
        if tq <= fa.LONGKV_MAX_Q:  # one wave: K1's and K3's plans agree
            assert (forward["splits"], forward["blocks"]) == (splits, plan["dq"]["blocks"])


_QKV = ("q", "k", "v")


@pytest.mark.parametrize(
    "b,tq,tk,h,d,dv,dtype,num_splits,target,offset,route,splits,blocks,copies",
    [(b, 512, 50176, 1, w, w, torch.bfloat16, None, None, 0, "sm90_longkv", splits, 128,
      _QKV if w == 261 else ())
     for w in (261, 512) for b, splits in ((16, 1), (8, 2), (4, 4), (2, 8), (1, 16))]
    + [(2, 129, 4301, 1, 261, 261, torch.bfloat16, None, None, 0, "sm90_longkv", 8, 48, _QKV),
       (3, 65, 4451, 2, 512, 512, torch.bfloat16, None, None, 0, "sm90_longkv", 8, 96, ()),
       (2, 100, 8000, 1, 512, 512, torch.bfloat16, None, "k", 1, "sm90_longkv", 14, 56, ("k",)),
       (2, 100, 8000, 1, 512, 512, torch.bfloat16, None, "q", 3, "sm90_longkv", 14, 56, ("q",)),
       (2, 100, 8000, 1, 512, 512, torch.bfloat16, None, "all", 8, "sm90_longkv", 14, 56, ()),
       (16, 512, 50176, 1, 512, 512, torch.bfloat16, 1, None, 0, "sm90_wgmma", 1, 128, None),
       (16, 512, 50176, 1, 512, 512, torch.float32, None, None, 0, "cuda_cores", 1, 128, None),
       # 9 query tiles: 11 key splits, 6 whole waves
       (8, 513, 50176, 1, 261, 261, torch.bfloat16, None, None, 0, "sm90_longkv", 11, 792,
        _QKV),
       (8, 512, 4223, 1, 512, 512, torch.bfloat16, None, None, 0, "sm90_wgmma", 4, 256, None),
       (8, 512, 50176, 1, 256, 256, torch.bfloat16, None, None, 0, "sm90_wgmma", 4, 256, None),
       (1, 784, 52097, 1, 704, 704, torch.bfloat16, None, None, 0, "sm90_longkv", 10, 130,
        ()),  # the multimodal encoder
       (2, 784, 52097, 1, 704, 704, torch.bfloat16, None, "v", 4, "sm90_longkv", 5, 130,
        ("v",)),
       (1, 784, 52097, 1, 704, 704, torch.bfloat16, 10, None, 0, "sm90_wgmma", 10, 260, None),
       (1, 1025, 52097, 1, 704, 704, torch.bfloat16, None, None, 0, "sm90_wgmma", 7, 238,
        None),
       # the flow encoder at batch 1 and 6 (16 whole waves), its 644-byte rows
       # copied; a forced split count, fp32, 33 query tiles
       (1, 2048, 182528, 1, 322, 322, torch.bfloat16, None, None, 0, "sm90_longkv", 4, 128,
        _QKV),
       (6, 2048, 182528, 1, 322, 322, torch.bfloat16, None, None, 0, "sm90_longkv", 11, 2112,
        _QKV),
       (1, 2048, 182528, 1, 322, 322, torch.bfloat16, 8, None, 0, "sm90_wgmma", 8, 256, None),
       (1, 2048, 182528, 1, 322, 322, torch.float32, None, None, 0, "cuda_cores", 8, 256,
        None),
       (1, 2049, 182528, 1, 322, 322, torch.bfloat16, None, None, 0, "sm90_wgmma", 8, 264,
        None),
       # the flow decoder at batch 1 and 6: the long-Q route, 132 blocks
       (1, 182528, 2048, 1, 512, 512, torch.bfloat16, None, None, 0, "sm90_longq", 1, 132,
        ()),
       (6, 182528, 2048, 1, 512, 512, torch.bfloat16, None, None, 0, "sm90_longq", 1, 132,
        ()),
       (1, 182528, 2048, 1, 512, 512, torch.bfloat16, 1, None, 0, "sm90_wgmma", 1, 2852,
        None),  # a forced split count
       (1, 182528, 2048, 1, 512, 512, torch.float32, None, None, 0, "cuda_cores", 1, 2852,
        None),
       # the long-Q route's edges: 8,448 query rows (132 tiles) and up to 8,192
       # keys, ragged last tiles, offset views copied into aligned rows
       (1, 8447, 2048, 1, 512, 512, torch.bfloat16, None, None, 0, "sm90_wgmma", 1, 132, None),
       (1, 8448, 8192, 1, 512, 512, torch.bfloat16, None, None, 0, "sm90_longq", 1, 132, ()),
       (1, 8448, 8193, 1, 512, 512, torch.bfloat16, None, None, 0, "sm90_wgmma", 1, 132, None),
       (1, 8448, 2048, 1, 256, 256, torch.bfloat16, None, None, 0, "sm90_wgmma", 1, 132, None),
       (1, 8448, 2048, 1, 513, 513, torch.bfloat16, None, None, 0, "sm90_wgmma", 1, 264, None),
       (2, 8500, 777, 1, 512, 512, torch.bfloat16, None, None, 0, "sm90_longq", 1, 132, ()),
       (2, 9000, 130, 1, 264, 512, torch.bfloat16, None, "q", 1, "sm90_longq", 1, 132,
        ("q",)),
       (2, 8600, 2100, 2, 300, 264, torch.bfloat16, None, "all", 3, "sm90_longq", 1, 132,
        _QKV),
       (1, 2048, 2048, 16, 32, 32, torch.bfloat16, None, None, 0, "sm90_narrow", 1, 256,
        None)],  # the flow self-attend
)
def test_longkv_forward_plan(b, tq, tk, h, d, dv, dtype, num_splits, target, offset, route,
                             splits, blocks, copies):
    """bf16 K1 calls over at least 4,224 keys whose wider head is 257 to
    512 wide with at most 512 query rows (the classification encoders at the
    served batch, the training batch and the server's buckets), or 513 to
    704 wide with at most 1,024 (the multimodal encoder), take the long-KV
    route: 64 query rows a block (a lone last tile, as 129 and 784 rows
    give), the keys split by ``_longkv_dq_split_plan`` so that all blocks
    run in one wave, a merge after a split, every operand by TMA, each first
    copied into 16-byte aligned rows where its rows are not aligned (the
    pixel encoder's 522-byte rows; offset views: ``target`` seen ``offset``
    elements into its storage), one launch a copy.  A forced split count,
    fp32, more query rows, fewer keys and other widths keep their routes.
    The flow encoder's 32 query tiles take the long-KV route too (K1 only),
    its keys split for one wave or for whole waves, whichever ends sooner
    (``_longkv_fwd_split_plan``: 4 splits at batch 1, 11 at its 6 tiles,
    2,112 blocks), after copies of its 644-byte rows.  bf16 K1 calls of at least 8,448 query rows over at most 8,192
    keys at 257 to 512 columns (the flow decoder) take the long-Q route:
    persistent blocks, one an SM, one key split, no merge."""
    views = {}
    for name, t, w in (("q", tq, d), ("k", tk, d), ("v", tk, dv)):
        shift = offset if target in ("all", name) else 0
        storage = torch.empty(b * t * h * w + shift, dtype=dtype, device="meta")
        views[name] = storage[shift:].view(b, t, h, w)
    plan = fa.launch_plan(views["q"], views["k"], views["v"], num_splits=num_splits)
    assert (plan["route"], plan["splits"], plan["blocks"]) == (route, splits, blocks)
    if route == "sm90_longq":
        assert plan == dict(route=route, splits=1, tiles_per_split=-(-tk // fa.BLOCK_K),
                            col_chunks=1, blocks=blocks, cuda_launches=1 + len(copies),
                            loader=fa._longkv_loader(views["k"], views["v"]), copies=copies)
        assert blocks == min(-(-tq // fa.BLOCK_Q) * h * b, fa.NUM_SMS)
        assert plan["loader"] == ("copy" if {"k", "v"} & set(copies) else "tma")
        return
    if route != "sm90_longkv":
        assert "copies" not in plan
        return
    per = -(-tk // fa.BLOCK_K // splits)
    assert plan == dict(route=route, splits=splits, tiles_per_split=per, col_chunks=1,
                        blocks=blocks, cuda_launches=1 + (splits > 1) + len(copies),
                        loader=fa._longkv_loader(views["k"], views["v"]), copies=copies)
    assert plan["loader"] == ("copy" if {"k", "v"} & set(copies) else "tma")
    assert (splits, per) == fa._longkv_fwd_split_plan(b, tq, h, tk, max(d, dv))
    assert blocks <= fa.NUM_SMS or blocks % fa.NUM_SMS == 0  # whole waves


@pytest.mark.parametrize(
    "width,offset,target,loader,copies",
    [(261, 0, "all", "copy", ("q", "dout", "k", "v")),
     (261, 1, "all", "copy", ("q", "dout", "k", "v")),
     (261, 3, "k", "copy", ("q", "dout", "k", "v")), (264, 0, "all", "tma", ()),
     (264, 1, "q", "tma", ("q",)), (264, 4, "v", "copy", ("v",)), (512, 0, "all", "tma", ()),
     (512, 1, "q", "tma", ("q",)), (512, 1, "k", "copy", ("k",)), (512, 2, "v", "copy", ("v",)),
     (384, 3, "k", "copy", ("k",)), (320, 0, "all", "tma", ()),
     (311, 0, "all", "copy", ("q", "dout", "k", "v")),
     (322, 0, "all", "copy", ("q", "dout", "k", "v"))],
)
def test_backward_loader_by_row_alignment(width, offset, target, loader, copies):
    """How the long-KV K2 and K3 bring rows into shared memory: every
    operand by TMA, each copied into 16-byte aligned rows first where its
    rows are not aligned (the pixel encoder's 522-byte rows, offset views;
    dO contiguous, rows Dv wide); K3 reads K2's copies.  ``target`` is the
    operand seen ``offset`` elements into its storage."""
    b, tq, tk, h = 2, 100, 8000, 1
    views = {}
    for name, t in (("q", tq), ("k", tk), ("v", tk)):
        shift = offset if target in ("all", name) else 0
        storage = torch.empty(b * t * h * width + shift, dtype=torch.bfloat16, device="meta")
        views[name] = storage[shift:].view(b, t, h, width)
    plan = fa.backward_plan(views["q"], views["k"], views["v"])
    assert plan["route"] == "sm90_longkv"
    assert plan["dkv"]["loader"] == fa._longkv_loader(views["k"], views["v"]) == loader
    assert plan["dkv"]["copies"] == copies
    assert plan["dkv"]["cuda_launches"] == 1 + len(copies)
    assert (plan["dq"]["loader"], plan["dq"]["copies"]) == (loader, copies)
    # a [.., W + pad] buffer seen as [.., :W]: 16-byte strides, which TMA
    # takes whatever the width
    padded = torch.empty(b, tk, h, -(-width // 8) * 8 + 8, dtype=torch.bfloat16,
                         device="meta")[..., :width]
    assert fa._longkv_loader(padded, padded) == "tma"
    assert fa._longkv_copies(padded[:, :tq], padded, padded) == (
        () if width % 8 == 0 else ("dout",))


@pytest.mark.parametrize(
    "b,tq,tk,width,target,offset,splits,per,blocks,loader,copies,launches",
    [(8, 512, 50176, 261, None, 0, 2, 392, 128, "copy", ("q", "dout", "k", "v"), 2),
     (8, 512, 50176, 512, None, 0, 2, 392, 128, "tma", (), 2),
     (2, 129, 8000, 300, None, 0, 14, 9, 84, "copy", ("q", "dout", "k", "v"), 2),  # lone tile
     (1, 64, 50176, 512, None, 0, 98, 8, 98, "tma", (), 2),  # one tile
     (2, 100, 8000, 512, "k", 1, 14, 9, 56, "copy", ("k",), 2),
     (2, 100, 8000, 264, "v", 2, 14, 9, 56, "copy", ("v",), 2),
     (2, 100, 8000, 264, "q", 1, 14, 9, 56, "tma", ("q",), 2),
     (1, 784, 52097, 704, None, 0, 10, 82, 130, "tma", (), 2),  # the multimodal encoder
     (2, 129, 4301, 704, None, 0, 8, 9, 48, "tma", (), 2),  # lone tile at 704
     (2, 100, 8000, 704, "k", 1, 14, 9, 56, "copy", ("k",), 2),
     # off the route: the flow encoder, the short-KV wide cases, a forced split
     (1, 2048, 182528, 322, None, 0, 8, 357, 256, None, None, 2),
     (2, 100, 777, 704, None, 0, 1, 13, 8, None, None, 1),
     (2, 100, 257, 704, None, 0, 1, 5, 8, None, None, 1),
     (1, 784, 52097, 704, "forced", 0, 10, 82, 260, None, None, 2)],
)
def test_longkv_dq_plan(b, tq, tk, width, target, offset, splits, per, blocks, loader, copies,
                        launches):
    """The long-KV K3's plan: 64 query rows a block (a lone last tile, as
    129 rows give, and a single tile), the keys split as far as one wave of
    132 blocks allows at 8 tiles of 64 keys a split or more (the multimodal
    encoder: 13 query tiles, 10 splits, 130 blocks, no column chunks); every
    operand by TMA, from K2's copies in 16-byte aligned rows where its rows
    are not aligned (the pixel encoder's 522-byte rows, offset views), so
    ``cuda_launches`` counts the kernel and the sum.  ``target`` is the
    operand seen ``offset`` elements into its storage.  The flow encoder,
    the short-KV 704-wide cases and a forced split count (``loader`` None)
    keep the wgmma K3: its split plan, dQ in column chunks of 352 above 512
    columns."""
    views = {}
    for name, t in (("q", tq), ("k", tk), ("v", tk)):
        shift = offset if name == target else 0
        storage = torch.empty(b * t * width + shift, dtype=torch.bfloat16, device="meta")
        views[name] = storage[shift:].view(b, t, 1, width)
    if loader is None:
        forced = 10 if target == "forced" else None
        plan = fa.backward_plan(views["q"], views["k"], views["v"], num_splits=forced)
        chunks = -(-width // fa.WIDE_DQ_CHUNK) if width > fa.COL_CHUNK else 1
        assert plan["route"] == "sm90_wgmma"
        assert (plan["dq"]["splits"], plan["dq"]["tiles_per_split"], plan["dq"]["blocks"],
                plan["dq"]["col_chunks"], plan["dq"]["cuda_launches"]) == (
            splits, per, blocks, chunks, launches)
        assert "loader" not in plan["dq"] and "copies" not in plan["dkv"]
        return
    plan = fa.backward_plan(views["q"], views["k"], views["v"])
    assert plan["route"] == "sm90_longkv"
    got = plan["dq"]
    assert (got["splits"], got["tiles_per_split"], got["blocks"]) == (splits, per, blocks)
    assert got["col_chunks"] == 1
    assert (got["loader"], got["copies"], got["cuda_launches"]) == (loader, copies, launches)
    assert plan["dkv"]["copies"] == copies
    tiles = -(-tk // fa.BLOCK_K)
    assert (splits - 1) * per < tiles <= splits * per
    assert blocks <= fa.NUM_SMS


def test_backward_plan_routes_by_dtype():
    """bf16 takes the wgmma kernels and their split plans (or forced split
    counts), or at head widths up to 64 the narrow kernels; fp32 the
    CUDA-core kernels, which never split."""
    q = torch.empty(1, 182528, 1, 512, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, 2048, 1, 512, dtype=torch.bfloat16, device="meta")
    plan = fa.backward_plan(q, k, k)
    assert plan == dict(
        route="sm90_wgmma",
        dkv=dict(splits=8, tiles_per_split=357, col_chunks=1, blocks=512, cuda_launches=2),
        dq=dict(splits=1, tiles_per_split=32, col_chunks=1, blocks=2852, cuda_launches=1))
    forced = fa.backward_plan(q, k, k, num_splits=3)
    assert (forced["dkv"]["splits"], forced["dq"]["splits"]) == (3, 3)
    assert forced["dq"]["cuda_launches"] == 2
    plan = fa.backward_plan(q.float(), k.float(), k.float())
    assert plan["route"] == "cuda_cores"
    assert all(plan[x]["splits"] == 1 and plan[x]["cuda_launches"] == 1 for x in ("dkv", "dq"))
    assert (plan["dkv"]["blocks"], plan["dq"]["blocks"]) == (64, 2852)
    narrow = torch.empty(1, 2048, 16, 32, dtype=torch.bfloat16, device="meta")
    assert fa.backward_plan(narrow, narrow, narrow)["route"] == "sm90_narrow"
    assert fa.backward_plan(narrow.float(), narrow.float(), narrow.float())["route"] == (
        "cuda_cores")


@pytest.mark.parametrize(
    "b,tq,tk,h,d,dv,num_splits,want",
    [(1, 2048, 2048, 16, 32, 32, None,
      ("sm90_narrow", dict(splits=1, tiles_per_split=32, col_chunks=1, blocks=256,
                           cuda_launches=1),
       dict(splits=1, tiles_per_split=32, col_chunks=1, blocks=256, cuda_launches=1))),
     (2, 2048, 2048, 16, 32, 32, None,
      ("sm90_narrow", dict(splits=1, tiles_per_split=32, col_chunks=1, blocks=512,
                           cuda_launches=1),
       dict(splits=1, tiles_per_split=32, col_chunks=1, blocks=512, cuda_launches=1))),
     (2, 100, 777, 2, 41, 64, None,
      ("sm90_narrow", dict(splits=1, tiles_per_split=2, col_chunks=1, blocks=28,
                           cuda_launches=1),
       dict(splits=1, tiles_per_split=13, col_chunks=1, blocks=4, cuda_launches=1))),
     (2, 100, 777, 2, 16, 16, None, ("sm90_narrow", None, None)),
     (2, 100, 777, 2, 64, 64, None, ("sm90_narrow", None, None)),
     (2, 100, 777, 2, 65, 64, None, ("sm90_wgmma", None, None)),
     (2, 100, 777, 2, 32, 72, None, ("sm90_wgmma", None, None)),
     (1, 2048, 2048, 16, 32, 32, 1, ("sm90_wgmma", None, None)),
     (2, 100, 777, 2, 41, 64, 2, ("sm90_wgmma", None, None))],
)
def test_narrow_backward_plan(b, tq, tk, h, d, dv, num_splits, want):
    """bf16 backwards whose Dqk and Dv are both at most 64 take the narrow
    route: one launch each, no split, K2 a block per 128 keys walking the
    query tiles, K3 a block per 128 query rows walking the key tiles below
    kv_logical_len (here 770 at the 41-wide case); a wider head or a forced
    split count takes the wgmma kernels and fp32 the CUDA-core ones."""
    q = torch.empty(b, tq, h, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, tk, h, d, dtype=torch.bfloat16, device="meta")
    v = torch.empty(b, tk, h, dv, dtype=torch.bfloat16, device="meta")
    kv_len = tk - 7 if tk == 777 else None
    plan = fa.backward_plan(q, k, v, kv_logical_len=kv_len, num_splits=num_splits)
    route, dkv, dq = want
    assert plan["route"] == route
    if dkv is not None:
        assert (plan["dkv"], plan["dq"]) == (dkv, dq)
    if route == "sm90_wgmma" and num_splits is not None:
        assert plan["dkv"]["splits"] == plan["dq"]["splits"] == num_splits
    fp32 = fa.backward_plan(q.float(), k.float(), v.float(), kv_logical_len=kv_len)
    assert fp32["route"] == "cuda_cores"


def test_cpu_backward_counts_no_launch():
    """A backward on CPU tensors runs the plain version: no K2, K3 or
    narrow-route launch is counted, though bf16 inputs at these widths take
    the narrow route on the card."""
    q, k, v, kv_mask, _ = _inputs(1, 40, 70, 2, 32, 32, seed=9)
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    assert fa.backward_plan(*args)["route"] == "sm90_narrow"
    out, lse = fa.flash_attention(*args, return_lse=True)
    before = (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_NARROW)
    grads = fa.flash_attention_backward(*args, out, lse, torch.ones_like(out),
                                        kv_mask=torch.from_numpy(kv_mask))
    assert (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_NARROW) == before
    assert all(torch.isfinite(g.float()).all() for g in grads)


# The multimodal encoder, (B, Tq, Tk, H, D, Dv) = (1, 784, 52097, 1, 704, 704).
MM_SITE = (1, 784, 52097, 1, 704, 704)


@pytest.mark.parametrize(
    "dtype,dkv,dq",
    [(torch.bfloat16,
      dict(splits=1, tiles_per_split=13, col_chunks=1, blocks=132, cuda_launches=1, items=1629,
           loader="tma", copies=()),
      dict(splits=10, tiles_per_split=82, col_chunks=1, blocks=130, cuda_launches=2,
           loader="tma", copies=())),
     (torch.float32,
      dict(splits=1, tiles_per_split=13, col_chunks=2, blocks=3258, cuda_launches=1),
      dict(splits=1, tiles_per_split=815, col_chunks=2, blocks=26, cuda_launches=1))],
)
def test_backward_plan_at_the_multimodal_encoder(dtype, dkv, dq):
    """K2 and K3 at d = dv = 704: in bf16 the long-KV route, K2 in 132
    persistent blocks over 1,629 items of 32 keys, K3 over the keys split
    as K1 splits them at this site (13 query tiles: 10 splits, 130 blocks,
    no column chunks, and the sum), both by TMA with no copy; the fp32 K2
    splits the dK and dV columns in two, and neither fp32 kernel splits its
    walk.  K1's plan there is the long-KV route's with the same 10 key
    splits and 130 blocks (the wgmma kernel's grid, forced to 10 splits,
    has two value-column chunks, 260 blocks), and a forced split count keeps
    the wgmma K2 (16 keys a block) and K3 (dQ in two column chunks of
    352)."""
    b, tq, tk, h, d, dv = MM_SITE
    q = torch.empty(b, tq, h, d, dtype=dtype, device="meta")
    k = torch.empty(b, tk, h, d, dtype=dtype, device="meta")
    v = torch.empty(b, tk, h, dv, dtype=dtype, device="meta")
    plan = fa.backward_plan(q, k, v)
    assert plan == dict(route="sm90_longkv" if dtype == torch.bfloat16 else "cuda_cores",
                        dkv=dkv, dq=dq)
    if dtype == torch.bfloat16:
        assert fa._longkv_dq_split_plan(b, tq, h, tk) == (10, 82) == fa._split_plan(
            b, tq, h, tk, fa._col_chunks(dv))
        assert fa.launch_plan(q, k, v) == dict(
            route="sm90_longkv", splits=10, tiles_per_split=82, col_chunks=1, blocks=130,
            cuda_launches=2, loader="tma", copies=())
        assert fa.launch_plan(q, k, v, num_splits=10) == dict(
            route="sm90_wgmma", splits=10, tiles_per_split=82, col_chunks=2, blocks=260,
            cuda_launches=2, loader="cp.async16")
    forced = fa.backward_plan(q, k, v, num_splits=1)
    assert forced["dq"]["cuda_launches"] == 1 and forced["dq"]["col_chunks"] == 2
    if dtype == torch.bfloat16:
        assert forced["route"] == "sm90_wgmma" and forced["dkv"]["blocks"] == 3257


@pytest.mark.parametrize(
    "d,dv,dq_chunks,fp32_dkv_chunks,dkv_keys",
    [(512, 512, 1, 1, 32), (704, 704, 2, 2, 16), (704, 512, 2, 2, 16),
     (600, 600, 2, 2, 16), (512, 704, 2, 2, 16), (64, 704, 1, 2, 16), (256, 256, 1, 1, 64)],
)
def test_backward_column_chunks(d, dv, dq_chunks, fp32_dkv_chunks, dkv_keys):
    """Up to 512 columns nothing is chunked; above, K3 takes ceil(d / 352)
    dQ-column chunks on the wgmma and fp32 routes, the fp32 K2 two chunks of
    dK and dV columns, and the wgmma K2 16 keys a block.  On the long-KV
    route (over at least 4,224 keys, no forced split; from 257 columns) the
    bf16 K2 keeps 32 keys an item at every width and neither kernel chunks
    its columns."""
    shape = dict(b=2, tq=100, tk=1000, h=1)
    plans = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.empty(shape["b"], shape["tq"], 1, d, dtype=dtype, device="meta")
        k = torch.empty(shape["b"], shape["tk"], 1, d, dtype=dtype, device="meta")
        v = torch.empty(shape["b"], shape["tk"], 1, dv, dtype=dtype, device="meta")
        plans[dtype] = fa.backward_plan(q, k, v, num_splits=1)
    bf16, fp32 = plans[torch.bfloat16], plans[torch.float32]
    assert bf16["dq"]["col_chunks"] == fp32["dq"]["col_chunks"] == dq_chunks
    assert bf16["dkv"]["col_chunks"] == 1
    assert fp32["dkv"]["col_chunks"] == fp32_dkv_chunks
    assert bf16["dkv"]["blocks"] == -(-shape["tk"] // dkv_keys) * shape["b"]
    assert bf16["dq"]["blocks"] == fp32["dq"]["blocks"] == 2 * 2 * dq_chunks
    tk = 8000
    q = torch.empty(shape["b"], shape["tq"], 1, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(shape["b"], tk, 1, d, dtype=torch.bfloat16, device="meta")
    v = torch.empty(shape["b"], tk, 1, dv, dtype=torch.bfloat16, device="meta")
    plan = fa.backward_plan(q, k, v)
    if max(d, dv) >= fa.LONGKV_MIN_WIDTH:
        assert plan["route"] == "sm90_longkv"
        assert plan["dkv"]["items"] == -(-tk // fa.LONGKV_BLOCK_K) * shape["b"]
        assert plan["dkv"]["col_chunks"] == plan["dq"]["col_chunks"] == 1
    else:
        assert plan["route"] == "sm90_wgmma"
        assert plan["dkv"]["blocks"] == -(-tk // dkv_keys) * shape["b"]


def test_wide_longkv_shape_backward_matches_pallas():
    """The plain backward at the long-KV route's wider shape class, few
    query rows (a lone last tile of 2) against many keys, one head 704 wide
    (the multimodal encoder's, which the bf16 kernels take on the card from
    4,224 keys on), against jax.grad through the Pallas sweeps in
    interpreter mode: masks, kv_logical_len, an all-masked entry, exact
    zeros on wiped rows and tail keys."""
    _grads_against_pallas(2, 130, 700, 1, 704, 704, 690)
