"""The port's CUDA kernels on the card (skipped without a GPU).

This file imports no JAX, so it also runs where JAX is absent: there, run
it without the suite's conftest (which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The kernels (K1 forward and K2/K3 backward, each on both routes: the bf16
wgmma kernels with their split grids, merge and sum, and the fp32 CUDA-core
kernels; all three also at head widths up to 704, and on the bf16
narrow-head route at widths up to 64) are held against their plain PyTorch
versions, which the CPU tests hold against the JAX package;
K1 also at the classification encoders' widths (261 and 512) over 50,176
keys, K2 and K3 at those widths (masked small cases, and a few thousand
keys; K1's, K2's and K3's long-KV route over 4,231 to 4,451 keys, at 704
too and at the multimodal encoder itself, masked, K2's and K3's realigned
views and K1's offset views bit for bit, K1's op and an exported site
against the direct launch),
reduced-depth classification and language models on the card
against the same models on the CPU, and one training step of each tiny
classifier and of the tiny MLM on the card with its launches counted.
The serving stack on the card: K1's torch.library op bit for bit against
the direct launch, an export of the tiny pixel classifier whose graph holds
the op at every site, and K1 at the server's buckets 1, 2 and 4 over 50,176
keys.  The data path on the card: ``prefetch_to_device`` against direct
copies while the consumer allocates and frees, an async save taken before an
in-place update, the tiny flow model trained from files, interrupted and
resumed, against the uninterrupted run, and the tiny multimodal model
trained from a clip tree.  The rest of training: the tiny flow model under
``dots_saveable`` against full remat, and dropout under remat with a CUDA
generator.  The rest of the single-card surface: ``ImagePostprocessor``'s
types on the card against the CPU, ``compiled_memory_stats`` and
``hbm_headroom`` (a fit, and an out-of-memory verdict that leaves the
allocator usable), and ``op_stats`` finding K1's kernel in a trace.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from perceiverio_pytorch_tpu_torch import config
from perceiverio_pytorch_tpu_torch.examples import train_classification, train_mlm
from perceiverio_pytorch_tpu_torch.models.classification import ClassificationPerceiver, PrepType
from perceiverio_pytorch_tpu_torch.models.flow import FlowInference, FlowPerceiver
from perceiverio_pytorch_tpu_torch.models.language import LanguagePerceiver
from perceiverio_pytorch_tpu_torch.models.multimodal import MultiModalPerceiver
from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
from perceiverio_pytorch_tpu_torch.training import (
    Trainer,
    build_optimizer,
    flow_endpoint_error,
    multimodal_autoencode_loss,
)

torch.set_num_threads(1)
SMALL = dict(img_size=(16, 24), num_latents=8, num_latent_channels=32,
             num_self_attends_per_block=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, tq, tk, h, d, dv, seed, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((b, tq, h, d), dtype=np.float32),
              rng.standard_normal((b, tk, h, d), dtype=np.float32),
              rng.standard_normal((b, tk, h, dv), dtype=np.float32),
              rng.random((b, tk)) > 0.3, rng.random((b, tq)) > 0.2)
    return [torch.from_numpy(a).to(device) for a in arrays]


def _check(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "b,tq,tk,h,d,dv", [(2, 100, 777, 2, 41, 64), (1, 130, 300, 1, 322, 322),
                       (1, 70, 129, 1, 512, 512), (1, 256, 256, 16, 32, 32),
                       (3, 65, 64, 3, 200, 100), (2, 70, 300, 1, 512, 300)],
)
def test_kernel_matches_reference(cuda, dtype, tol, b, tq, tk, h, d, dv):
    q, k, v, kv_mask, q_mask = _inputs(b, tq, tk, h, d, dv, 1, cuda)
    kv_mask[-1] = False  # every row of the last batch entry is all-masked
    q, k, v = (x.to(dtype) for x in (q, k, v))
    kw = dict(kv_mask=kv_mask, q_mask=q_mask, kv_logical_len=tk - 3, return_lse=True)
    before = fa.LAUNCHES
    got, got_lse = fa.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES == before + 1
    want, want_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, tq, h * dv)
    _check(got, want, tol)
    assert torch.all(got.view(b, tq, -1)[~q_mask] == 0)
    assert torch.all(got[-1] == 0)
    assert torch.equal(torch.isinf(got_lse), torch.isinf(want_lse))
    finite = torch.isfinite(want_lse)
    torch.testing.assert_close(got_lse[finite], want_lse[finite], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_takes_strided_inputs(cuda):
    """[B, H, T, D] storage seen as [B, T, H, D]: strides, not copies."""
    q, k, v, _, _ = _inputs(2, 90, 150, 3, 48, 48, 2, cuda)
    qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    assert not qs.is_contiguous()
    _check(fa.flash_attention(qs, ks, vs), fa.flash_attention_reference(q, k, v), 1e-4)


def _split_call(q, k, v, kw, num_splits):
    return fa._flash_attention_cuda(
        q, k, v, q_mask=kw.get("q_mask"), kv_mask=kw.get("kv_mask"), softmax_scale=None,
        kv_logical_len=kw.get("kv_logical_len"), return_lse=True, num_splits=num_splits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_forced_split_counts_agree(cuda, dtype, tol):
    """1, 2 and the most splits (one key tile each) against each other and
    the plain version, with masks, a ragged Tk and an all-masked entry."""
    b, tq, tk = 2, 100, 777
    q, k, v, kv_mask, q_mask = _inputs(b, tq, tk, 2, 41, 64, 3, cuda)
    kv_mask[-1] = False
    q, k, v = (x.to(dtype) for x in (q, k, v))
    kw = dict(kv_mask=kv_mask, q_mask=q_mask, kv_logical_len=tk - 50)
    want, want_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                                  return_lse=True, **kw)
    results = {}
    for splits in (1, 2, 64):
        merges = fa.LAUNCHES_MERGE
        results[splits] = _split_call(q, k, v, kw, splits)
        assert fa.LAUNCHES_MERGE == merges + (splits > 1)
    torch.cuda.synchronize()
    assert fa.launch_plan(q, k, v, kv_logical_len=tk - 50, num_splits=64)["splits"] == 12
    for splits, (out, lse) in results.items():
        _check(out, results[1][0], tol)
        _check(out, want, 2e-2 if dtype == torch.bfloat16 else 1e-4)
        assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
        finite = torch.isfinite(want_lse)
        torch.testing.assert_close(lse[finite], want_lse[finite], rtol=1e-5, atol=1e-5)
        assert torch.all(out[-1] == 0) and torch.all(out.view(b, tq, -1)[~q_mask] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic(cuda, dtype):
    """Two calls on the same inputs are equal bit for bit, split or not."""
    q, k, v, kv_mask, q_mask = _inputs(1, 130, 2000, 1, 322, 322, 4, cuda)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    kw = dict(kv_mask=kv_mask, q_mask=q_mask)
    for splits in (None, 1, 5):
        first = _split_call(q, k, v, kw, splits)
        second = _split_call(q, k, v, kw, splits)
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_bf16_kernel_takes_unaligned_strided_inputs(cuda):
    """d = 41 in [B, H, T, D] storage seen as [B, T, H, D]: rows 82 bytes
    apart, not 16-byte aligned, read by the sm90 kernel as they are."""
    q, k, v, _, _ = _inputs(2, 90, 300, 3, 41, 41, 6, cuda)
    q, k, v = (x.to(torch.bfloat16).transpose(1, 2).contiguous().transpose(1, 2)
               for x in (q, k, v))
    assert not q.is_contiguous() and q.stride(1) * 2 % 16 != 0
    _check(fa.flash_attention(q, k, v),
           fa.flash_attention_reference(q.float(), k.float(), v.float()), 2e-2)


@pytest.mark.cuda
def test_bf16_takes_the_wgmma_route(cuda):
    q, k, v, _, _ = _inputs(1, 2048, 4096, 1, 322, 322, 7, cuda)
    plan = fa.launch_plan(q.to(torch.bfloat16), k, v)
    assert plan["route"] == "sm90_wgmma" and plan["splits"] > 1
    assert fa.launch_plan(q, k, v)["route"] == "cuda_cores"
    before = (fa.LAUNCHES, fa.LAUNCHES_MERGE)
    out = fa.flash_attention(*(x.to(torch.bfloat16) for x in (q, k, v)))
    assert (fa.LAUNCHES, fa.LAUNCHES_MERGE) == (before[0] + 1, before[1] + 1)
    assert out.dtype == torch.bfloat16
    _check(out, fa.flash_attention_reference(q, k, v), 2e-2)


# The narrow route (bf16, Dqk and Dv at most 64): the flow self-attend's
# width, 16 wide, the 41-wide rows that take the realigning loader, 64, and
# unequal widths; 1 to 16 heads; Tq and Tk not multiples of 128.
NARROW_CASES = [(2, 100, 777, 2, 32, 32), (3, 130, 300, 16, 32, 32), (2, 70, 129, 1, 16, 16),
                (2, 100, 777, 2, 41, 64), (1, 200, 333, 3, 64, 64), (2, 65, 190, 4, 64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,dv", NARROW_CASES)
def test_narrow_kernel_matches_reference(cuda, b, tq, tk, h, d, dv):
    """The narrow-head kernel against the plain version: kv_mask, q_mask,
    kv_logical_len, an all-masked batch entry (zeros, lse +inf) and the lse;
    two calls bit for bit; one launch, no merge."""
    q, k, v, kv_mask, q_mask = _inputs(b, tq, tk, h, d, dv, 20 + d, cuda)
    kv_mask[-1] = False
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    kw = dict(kv_mask=kv_mask, q_mask=q_mask, kv_logical_len=tk - 3, return_lse=True)
    assert fa.launch_plan(q, k, v, kv_logical_len=tk - 3)["route"] == "sm90_narrow"
    before = (fa.LAUNCHES, fa.LAUNCHES_MERGE)
    got, got_lse = fa.flash_attention(q, k, v, **kw)
    again, again_lse = fa.flash_attention(q, k, v, **kw)
    assert (fa.LAUNCHES, fa.LAUNCHES_MERGE) == (before[0] + 2, before[1])
    want, want_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got_lse, again_lse)
    _check(got, want, 2e-2)
    assert torch.all(got.view(b, tq, -1)[~q_mask] == 0) and torch.all(got[-1] == 0)
    assert torch.equal(torch.isinf(got_lse), torch.isinf(want_lse))
    finite = torch.isfinite(want_lse)
    torch.testing.assert_close(got_lse[finite], want_lse[finite], rtol=1e-5, atol=1e-5)
    # without masks: the unmasked tiles' path, and the lse
    got, got_lse = fa.flash_attention(q, k, v, return_lse=True)
    want, want_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                                  return_lse=True)
    _check(got, want, 2e-2)
    torch.testing.assert_close(got_lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 41, 64])
def test_narrow_kernel_takes_strided_inputs(cuda, d):
    """[B, H, T, D] storage seen as [B, T, H, D], and q, k, v as views of
    one [B, T, 3, H, D] buffer: strides, not copies, on the narrow route."""
    q, k, v, kv_mask, _ = _inputs(2, 150, 150, 3, d, d, 30 + d, cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    want = fa.flash_attention_reference(q.float(), k.float(), v.float(), kv_mask=kv_mask)
    qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    assert not qs.is_contiguous()
    assert fa.launch_plan(qs, ks, vs)["route"] == "sm90_narrow"
    _check(fa.flash_attention(qs, ks, vs, kv_mask=kv_mask), want, 2e-2)
    qkv = torch.stack([q, k, v], dim=2)
    got = fa.flash_attention(*qkv.unbind(2), kv_mask=kv_mask)
    _check(got, want, 2e-2)


def _realign_views(x, offset):
    """``x`` [B, T, H, W] copied into a NaN-filled buffer at element
    ``offset`` with rows W + 8 apart, and seen as [B, T, H, W]: no row (for
    the odd offsets and widths, no address) is 16-byte aligned, and every
    byte around the rows is NaN."""
    b, t, h, w = x.shape
    buf = torch.full((b * t * h * (w + 8) + 8,), float("nan"), dtype=x.dtype, device=x.device)
    view = buf[offset:offset + b * t * h * (w + 8)].view(b, t, h, w + 8)[..., :w]
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("b,tq,tk,h,d", [(2, 130, 1000, 1, 261), (1, 100, 700, 1, 322),
                                         (2, 130, 700, 2, 79), (2, 130, 700, 3, 41),
                                         (2, 130, 700, 3, 32)])
def test_realigned_rows_match_aligned_rows(cuda, offset, b, tq, tk, h, d):
    """The loaders change only how bytes reach shared memory: unaligned
    views at every offset mod 16 bytes (rows W + 8 apart in a NaN-filled
    buffer; the realigning loader or 4- and 8-byte copies) give the same bits
    as the same values zero-padded to a multiple of 8 columns, which take
    16-byte copies -- on the wgmma route (the pixel encoder's 261, the flow
    encoder's 322, and 79, whose Q and K rows take 2-byte copies) and the
    narrow one."""
    q, k, v, _, _ = _inputs(b, tq, tk, h, d, d, 40 + d, cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    kw = dict(kv_logical_len=tk - 7, softmax_scale=1.0 / d ** 0.5, return_lse=True)
    dpad = -(-d // 8) * 8
    padded = [torch.nn.functional.pad(x, (0, dpad - d)) for x in (q, k, v)]
    views = [_realign_views(x, offset) for x in (q, k, v)]
    assert fa.launch_plan(*padded)["loader"] == "cp.async16"
    plan = fa.launch_plan(*views)
    assert plan["route"] == ("sm90_narrow" if d <= 64 else "sm90_wgmma")
    assert plan["loader"] != "cp.async16" or offset % 8 == 0
    if offset % 2:  # rows aligned to 2 bytes only
        assert plan["loader"] == ("copy2" if d == 79 else "realign")
    want, want_lse = fa.flash_attention(*padded, **kw)
    got, got_lse = fa.flash_attention(*views, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got.view(b, tq, h, d), want.view(b, tq, h, dpad)[..., :d])
    assert torch.equal(got_lse, want_lse)


# Widths above 512 (the value columns split over two grid chunks): the
# multimodal encoder's 704, a ragged 600 (chunks of 304 + 296 in bf16, 320 +
# 280 in fp32), a 704-wide Q with Dv 512 (32-key tiles, one chunk) and with
# Dv 64.
WIDE_CASES = [(2, 70, 300, 1, 704, 704), (2, 130, 129, 1, 704, 704), (2, 65, 200, 2, 600, 600),
              (2, 100, 257, 1, 704, 512), (2, 64, 100, 1, 704, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,tq,tk,h,d,dv", WIDE_CASES)
def test_wide_kernel_matches_reference(cuda, dtype, tol, b, tq, tk, h, d, dv):
    """K1 at head widths up to 704 against its plain version, with masks, a
    ragged Tk, kv_logical_len, an all-masked batch entry and the lse."""
    test_kernel_matches_reference(cuda, dtype, tol, b, tq, tk, h, d, dv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_wide_forced_split_counts_agree(cuda, dtype, tol):
    """d = dv = 704 at 1, 2, 3 and the most splits (one key tile each),
    against each other and the plain version, with masks, a ragged Tk and an
    all-masked entry: the merge takes both column chunks' partials."""
    b, tq, tk = 2, 100, 777
    q, k, v, kv_mask, q_mask = _inputs(b, tq, tk, 1, 704, 704, 11, cuda)
    kv_mask[-1] = False
    q, k, v = (x.to(dtype) for x in (q, k, v))
    kw = dict(kv_mask=kv_mask, q_mask=q_mask, kv_logical_len=tk - 50)
    want, want_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                                  return_lse=True, **kw)
    results = {splits: _split_call(q, k, v, kw, splits) for splits in (1, 2, 3, 64)}
    torch.cuda.synchronize()
    for splits, (out, lse) in results.items():
        _check(out, results[1][0], tol)
        _check(out, want, 2e-2 if dtype == torch.bfloat16 else 1e-4)
        assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
        finite = torch.isfinite(want_lse)
        torch.testing.assert_close(lse[finite], want_lse[finite], rtol=1e-5, atol=1e-5)
        assert torch.all(out[-1] == 0) and torch.all(out.view(b, tq, -1)[~q_mask] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_kernel_is_deterministic(cuda, dtype):
    """At d = dv = 704, two calls are equal bit for bit, at the planned
    splits (which split the keys of this short grid), at 1 and at 5."""
    q, k, v, kv_mask, q_mask = _inputs(1, 130, 3000, 1, 704, 704, 12, cuda)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    assert fa.launch_plan(q, k, v)["splits"] > 1
    kw = dict(kv_mask=kv_mask, q_mask=q_mask)
    for splits in (None, 1, 5):
        first = _split_call(q, k, v, kw, splits)
        second = _split_call(q, k, v, kw, splits)
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [690, 704])
def test_wide_kernel_takes_strided_inputs(cuda, dtype, tol, d):
    """Wide heads in [B, H, T, D] storage seen as [B, T, H, D]; at 690 the
    rows are 1380 bytes apart in bf16, not 16-byte aligned."""
    q, k, v, kv_mask, _ = _inputs(2, 90, 300, 2, d, d, 13, cuda)
    q, k, v = (x.to(dtype).transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    assert not q.is_contiguous()
    _check(fa.flash_attention(q, k, v, kv_mask=kv_mask),
           fa.flash_attention_reference(q.float(), k.float(), v.float(), kv_mask=kv_mask), tol)


@pytest.mark.cuda
def test_backward_refuses_wide_heads(cuda):
    """K2/K3 take head widths up to 704: a 705-wide backward raises before
    it launches anything."""
    q = torch.randn(1, 64, 1, 705, device=cuda)
    out = torch.zeros(1, 64, 705, device=cuda)
    lse = torch.zeros(1, 1, 64, device=cuda)
    before = (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    with pytest.raises(ValueError, match="1 to 704"):
        fa.flash_attention_backward(q, q, q, out, lse, out)
    assert (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == before


@pytest.mark.cuda
def test_kernel_refuses_bad_inputs(cuda):
    x = torch.randn(1, 8, 1, 705, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(x, x, x)
    x = torch.randn(1, 8, 1, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        fa.flash_attention(x, x, x)
    q = torch.randn(1, 8, 1, 32, device=cuda)
    out, lse = fa.flash_attention(q, q, q, return_lse=True)
    with pytest.raises(ValueError):  # lse of the wrong shape
        fa.flash_attention_backward(q, q, q, out, lse[:, :, :4], out)
    with pytest.raises(ValueError):  # a gradient on another device
        fa.flash_attention_backward(q, q, q, out, lse, out.cpu())


def _backward_case(b, tq, tk, h, d, dv, dtype, device, strided=False, wipe_last=True):
    q, k, v, kv_mask, q_mask = _inputs(b, tq, tk, h, d, dv, 5, device)
    if wipe_last:
        kv_mask[-1] = False  # every row of the last batch entry is all-masked
    q, k, v = (x.to(dtype) for x in (q, k, v))
    if strided:  # [B, H, T, D] storage seen as [B, T, H, D]
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    kw = dict(kv_mask=kv_mask, q_mask=q_mask, kv_logical_len=tk - 3)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(6)).to(device, dtype)
    return (q, k, v, out, lse, grad), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "b,tq,tk,h,d,dv", [(2, 100, 777, 2, 41, 64), (2, 130, 300, 1, 322, 322),
                       (2, 70, 129, 1, 512, 512), (2, 256, 256, 16, 32, 32),
                       (3, 65, 64, 3, 200, 100), (3, 50, 333, 2, 41, 24)],
)
def test_backward_kernels_match_reference(cuda, dtype, tol, b, tq, tk, h, d, dv):
    """K2 (dK, dV) and K3 (dQ) against the plain backward, with masks, a
    ragged Tk, kv_logical_len and an all-masked batch entry."""
    args, kw = _backward_case(b, tq, tk, h, d, dv, dtype, cuda)
    before = (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    got = fa.flash_attention_backward(*args, **kw)
    assert (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_backward_reference(*(x.float() for x in args), **kw)
    torch.cuda.synchronize()
    for x, y, x_like in zip(got, want, args[:3]):
        assert x.dtype == dtype and x.shape == x_like.shape
        _check(x, y, tol)
    dq, dk, dv_ = got
    assert torch.all(dq[-1] == 0) and torch.all(dq[~kw["q_mask"]] == 0)
    assert torch.all(dk[:, tk - 3:] == 0) and torch.all(dv_[:, tk - 3:] == 0)


@pytest.mark.cuda
def test_backward_kernels_take_strided_inputs(cuda):
    args, kw = _backward_case(2, 90, 150, 3, 48, 48, torch.float32, cuda, strided=True)
    assert not args[0].is_contiguous()
    got = fa.flash_attention_backward(*args, **kw)
    want = fa.flash_attention_backward_reference(*args, **kw)
    for x, y in zip(got, want):
        _check(x, y, 1e-4)


def _check_backward(got, want, kw, tol, wiped_last=True):
    """Each gradient against the plain backward, and exact zeros on wiped
    rows, keys past kv_len and the all-masked batch entry."""
    for x, y in zip(got, want):
        _check(x, y, tol)
    dq, dk, dv_ = got
    tail = kw["kv_logical_len"]
    assert torch.all(dq[~kw["q_mask"]] == 0)
    assert torch.all(dk[:, tail:] == 0) and torch.all(dv_[:, tail:] == 0)
    if wiped_last:
        assert torch.all(dq[-1] == 0)
        assert torch.all(dk[-1] == 0) and torch.all(dv_[-1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,tq,tk,h,d,dv", [(2, 256, 256, 16, 32, 32), (2, 300, 777, 2, 41, 41),
                       (2, 200, 700, 1, 322, 322), (2, 300, 200, 1, 512, 512)],
)
def test_bf16_backward_forced_splits_agree(cuda, b, tq, tk, h, d, dv):
    """bf16 K2 and K3 at forced split counts 1, 2, 3 and the most (one tile
    a range), each against the plain backward, with masks, a ragged Tk and an
    all-masked entry; a split call launches the sum once per split kernel."""
    args, kw = _backward_case(b, tq, tk, h, d, dv, torch.bfloat16, cuda)
    want = fa.flash_attention_backward_reference(*(x.float() for x in args), **kw)
    for splits in (1, 2, 3, 64):
        plan = fa.backward_plan(*args[:3], kv_logical_len=kw["kv_logical_len"],
                                num_splits=splits)
        before = fa.LAUNCHES_BWD_SUM
        got = fa._flash_attention_backward_cuda(*args, num_splits=splits, **kw)
        torch.cuda.synchronize()
        assert fa.LAUNCHES_BWD_SUM - before == sum(
            plan[x]["cuda_launches"] - 1 for x in ("dkv", "dq"))
        _check_backward(got, want, kw, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,d", [(2, 2048, 4096, 322), (2, 4096, 2048, 512)])
def test_bf16_backward_is_deterministic(cuda, b, tq, tk, d):
    """Two calls on the same inputs are equal bit for bit, at the planned
    splits (K3's keys at the first shape, K2's query rows at the second)
    and at one split, and the two agree."""
    args, kw = _backward_case(b, tq, tk, 1, d, d, torch.bfloat16, cuda)
    plan = fa.backward_plan(*args[:3], kv_logical_len=kw["kv_logical_len"])
    assert max(plan["dkv"]["splits"], plan["dq"]["splits"]) > 1
    results = {}
    for splits in (None, 1):
        first = fa._flash_attention_backward_cuda(*args, num_splits=splits, **kw)
        second = fa._flash_attention_backward_cuda(*args, num_splits=splits, **kw)
        assert all(torch.equal(x, y) for x, y in zip(first, second))
        results[splits] = first
    for x, y in zip(results[None], results[1]):
        _check(x, y, 2e-2)


@pytest.mark.cuda
def test_bf16_backward_takes_unaligned_strided_inputs(cuda):
    """d = 41 in [B, H, T, D] storage seen as [B, T, H, D]: rows 82 bytes
    apart, read by the sm90 kernels as they are."""
    args, kw = _backward_case(2, 90, 300, 3, 41, 41, torch.bfloat16, cuda, strided=True)
    assert not args[0].is_contiguous() and args[0].stride(1) * 2 % 16 != 0
    got = fa.flash_attention_backward(*args, **kw)
    want = fa.flash_attention_backward_reference(*(x.float() for x in args), **kw)
    _check_backward(got, want, kw, 2e-2)


@pytest.mark.cuda
def test_bf16_backward_takes_the_wgmma_route(cuda):
    args, kw = _backward_case(2, 2048, 4096, 1, 322, 322, torch.bfloat16, cuda)
    plan = fa.backward_plan(*args[:3], kv_logical_len=kw["kv_logical_len"])
    assert plan["route"] == "sm90_wgmma" and plan["dq"]["splits"] > 1
    assert fa.backward_plan(*(x.float() for x in args[:3]))["route"] == "cuda_cores"
    before = (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_SUM)
    got = fa.flash_attention_backward(*args, **kw)
    assert (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_SUM) == (
        before[0] + 1, before[1] + 1,
        before[2] + sum(plan[x]["cuda_launches"] - 1 for x in ("dkv", "dq")))
    assert all(x.dtype == torch.bfloat16 for x in got)
    want = fa.flash_attention_backward_reference(*(x.float() for x in args), **kw)
    _check_backward(got, want, kw, 2e-2)


# The backward's narrow route (bf16, Dqk and Dv at most 64): the flow
# self-attend's width (2 and 16 heads), 16 and 64 wide with Dv 32 or 64, the
# 41-wide rows that take the realigning loader, 64 with Dv 32; Tq and Tk not
# multiples of 128.
NARROW_BACKWARD_CASES = [(2, 100, 777, 2, 32, 32), (3, 130, 300, 16, 32, 32),
                         (2, 70, 129, 1, 16, 32), (2, 90, 200, 1, 16, 64),
                         (2, 100, 777, 2, 41, 64), (1, 200, 333, 3, 64, 64),
                         (2, 65, 190, 4, 64, 32)]


def _narrow_launches():
    return (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_NARROW,
            fa.LAUNCHES_BWD_SUM)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,dv", NARROW_BACKWARD_CASES)
def test_narrow_backward_matches_reference(cuda, b, tq, tk, h, d, dv):
    """K2 and K3 on the narrow route against the plain backward, with
    kv_mask, q_mask, kv_logical_len and an all-masked batch entry: exact
    zeros on wiped rows, tail keys and the masked entry; two calls bit for
    bit; one launch each, counted as narrow, no sum.  Then without masks
    (K3's masked tiles: the ragged last one only)."""
    args, kw = _backward_case(b, tq, tk, h, d, dv, torch.bfloat16, cuda)
    plan = fa.backward_plan(*args[:3], kv_logical_len=kw["kv_logical_len"])
    assert plan["route"] == "sm90_narrow"
    assert plan["dkv"]["cuda_launches"] == plan["dq"]["cuda_launches"] == 1
    before = _narrow_launches()
    got = fa.flash_attention_backward(*args, **kw)
    again = fa.flash_attention_backward(*args, **kw)
    assert _narrow_launches() == (before[0] + 2, before[1] + 2, before[2] + 4, before[3])
    want = fa.flash_attention_backward_reference(*(x.float() for x in args), **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for x, x_like in zip(got, args[:3]):
        assert x.dtype == torch.bfloat16 and x.shape == x_like.shape
    _check_backward(got, want, kw, 2e-2)
    q, k, v, _, _, grad = args
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    got = fa.flash_attention_backward(q, k, v, out, lse, grad)
    want = fa.flash_attention_backward_reference(
        *(x.float() for x in (q, k, v, out, lse, grad)))
    for x, y in zip(got, want):
        _check(x, y, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 41, 64])
def test_narrow_backward_takes_strided_inputs(cuda, d):
    """On the narrow route: [B, H, T, D] storage seen as [B, T, H, D], and
    q, k, v as views of one [B, T, 3, H, D] buffer with dO a view of a wider
    gradient buffer (token stride twice its row): strides, not copies; both
    against the plain backward on contiguous copies."""
    b, tq, tk, h = 2, 150, 150, 3
    q, k, v, kv_mask, _ = _inputs(b, tq, tk, h, d, d, 50 + d, cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    out, lse = fa.flash_attention(q, k, v, return_lse=True, kv_mask=kv_mask)
    wide = torch.randn(b, tq, 2 * h * d, generator=torch.Generator().manual_seed(d))
    grad = wide.to(cuda, torch.bfloat16)[..., :h * d]
    want = fa.flash_attention_backward_reference(
        *(x.float() for x in (q, k, v, out, lse, grad)), kv_mask=kv_mask)
    qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    qkv = torch.stack([q, k, v], dim=2)
    for views in ((qs, ks, vs), tuple(qkv.unbind(2))):
        assert not views[0].is_contiguous()
        assert fa.backward_plan(*views)["route"] == "sm90_narrow"
        got = fa.flash_attention_backward(*views, out, lse, grad, kv_mask=kv_mask)
        for x, y in zip(got, want):
            _check(x, y, 2e-2)


@pytest.mark.cuda
def test_narrow_backward_at_the_self_attend(cuda):
    """The flow self-attend (2048 x 2048, 16 heads of 32) at batch 1 and 2:
    K2 and K3 against the plain backward, two calls bit for bit, and against
    the wgmma kernels (a forced split count of 1) within the bf16
    tolerance."""
    for b in (1, 2):
        q, k, v, _, _ = _inputs(b, 2048, 2048, 16, 32, 32, 60 + b, cuda)
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
        grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(b)).to(
            cuda, torch.bfloat16)
        args = (q, k, v, out, lse, grad)
        assert fa.backward_plan(q, k, v)["dkv"]["blocks"] == 256 * b
        got = fa.flash_attention_backward(*args)
        again = fa.flash_attention_backward(*args)
        wgmma = fa._flash_attention_backward_cuda(*args, num_splits=1)
        want = fa.flash_attention_backward_reference(*(x.float() for x in args))
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        for x, y, z in zip(got, want, wgmma):
            _check(x, y, 2e-2)
            _check(x, z.float(), 2e-2)


# K2/K3 above 512: the multimodal encoder's 704 (the bf16 K2 with 16 keys a
# block, K3 over two dQ-column chunks of 352, the fp32 K2 over two chunks of
# dK and dV columns), a ragged 600, a 704-wide Q with Dv 512, and narrower
# Q with Dv 704 (K3 in one chunk of 352, and in two at d = 512).
WIDE_BACKWARD_CASES = [(2, 70, 300, 1, 704, 704), (2, 130, 129, 1, 704, 704),
                       (2, 65, 200, 2, 600, 600), (2, 100, 257, 1, 704, 512),
                       (2, 64, 100, 1, 64, 704), (1, 200, 300, 1, 512, 704)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,tq,tk,h,d,dv", WIDE_BACKWARD_CASES)
def test_wide_backward_kernels_match_reference(cuda, dtype, tol, b, tq, tk, h, d, dv):
    """K2 and K3 at head widths up to 704 against the plain backward, with
    masks, a ragged Tk, kv_logical_len and an all-masked batch entry: exact
    zeros on wiped rows, tail keys and the masked entry."""
    args, kw = _backward_case(b, tq, tk, h, d, dv, dtype, cuda)
    plan = fa.backward_plan(*args[:3], kv_logical_len=kw["kv_logical_len"])
    assert plan["dq"]["col_chunks"] == (-(-d // 352) if max(d, dv) > 512 else 1)
    before = (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    got = fa.flash_attention_backward(*args, **kw)
    assert (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_backward_reference(*(x.float() for x in args), **kw)
    torch.cuda.synchronize()
    for x, x_like in zip(got, args[:3]):
        assert x.dtype == dtype and x.shape == x_like.shape
    _check_backward(got, want, kw, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_wide_backward_unmasked_matches_reference(cuda, dtype, tol):
    """d = dv = 704, no mask, K3's keys split at batch 1 in bf16."""
    q, k, v, _, _ = _inputs(1, 200, 3000, 1, 704, 704, 15, cuda)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(16)).to(cuda, dtype)
    got = fa.flash_attention_backward(q, k, v, out, lse, grad)
    want = fa.flash_attention_backward_reference(
        *(x.float() for x in (q, k, v, out, lse, grad)))
    for x, y in zip(got, want):
        _check(x, y, tol)


@pytest.mark.cuda
def test_wide_bf16_backward_forced_splits_agree(cuda):
    """bf16 K2 and K3 at d = dv = 704 at forced split counts 1, 2, 3 and the
    most, each against the plain backward: the sum takes both dQ-column
    chunks' partials."""
    args, kw = _backward_case(2, 300, 700, 1, 704, 704, torch.bfloat16, cuda)
    want = fa.flash_attention_backward_reference(*(x.float() for x in args), **kw)
    for splits in (1, 2, 3, 64):
        plan = fa.backward_plan(*args[:3], kv_logical_len=kw["kv_logical_len"],
                                num_splits=splits)
        assert plan["dq"]["col_chunks"] == 2 and plan["dkv"]["col_chunks"] == 1
        before = fa.LAUNCHES_BWD_SUM
        got = fa._flash_attention_backward_cuda(*args, num_splits=splits, **kw)
        torch.cuda.synchronize()
        assert fa.LAUNCHES_BWD_SUM - before == sum(
            plan[x]["cuda_launches"] - 1 for x in ("dkv", "dq"))
        _check_backward(got, want, kw, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_backward_is_deterministic(cuda, dtype):
    """At d = dv = 704, two calls are equal bit for bit, at the planned
    splits (bf16: the long-KV route over 5,000 keys, K3's keys split over
    13 query blocks) and at one (bf16: the wgmma kernels)."""
    args, kw = _backward_case(1, 784, 5000, 1, 704, 704, dtype, cuda)
    plan = fa.backward_plan(*args[:3], kv_logical_len=kw["kv_logical_len"])
    assert plan["dq"]["splits"] > 1 if dtype == torch.bfloat16 else plan["dq"]["splits"] == 1
    for splits in (None, 1):
        first = fa._flash_attention_backward_cuda(*args, num_splits=splits, **kw)
        second = fa._flash_attention_backward_cuda(*args, num_splits=splits, **kw)
        assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_autograd_runs_the_three_kernels(cuda):
    args, kw = _backward_case(2, 64, 200, 2, 32, 32, torch.float32, cuda)
    q, k, v = (x.detach().requires_grad_() for x in args[:3])
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    out = fa.flash_attention(q, k, v, **kw)
    out.backward(args[5])
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == tuple(
        n + 1 for n in before)
    want = fa.flash_attention_backward_reference(*args, **kw)
    for x, y in zip((q.grad, k.grad, v.grad), want):
        _check(x, y, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_small_flow_gradients_on_the_card(cuda, remat):
    """Every site through K1/K2/K3 against the dense path's autograd, same
    card and weights."""
    models = {}
    for impl in ("flash", "dense"):
        models[impl] = FlowPerceiver(
            **SMALL, device=cuda, remat=remat, generator=torch.Generator().manual_seed(7),
            policy=dataclasses.replace(config.PARITY, attn_impl=impl))
        weight = models[impl].perceiver._decoder.final_layer.weight
        with torch.no_grad():
            weight.copy_(torch.randn(weight.shape, generator=torch.Generator().manual_seed(8)))
    rng = np.random.default_rng(9)
    img1, img2 = (torch.from_numpy(rng.uniform(-1, 1, (2, 3, 16, 24)).astype(np.float32)).to(cuda)
                  for _ in range(2))
    gt = torch.from_numpy(rng.uniform(-2, 2, (2, 2, 16, 24)).astype(np.float32)).to(cuda)
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    grads = {}
    for impl, model in models.items():
        flow_endpoint_error(model(img1, img2), gt).backward()
        grads[impl] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    # 4 sites forward (+2 self-attends recomputed under remat), 4 backward
    assert (fa.LAUNCHES - before[0], fa.LAUNCHES_BWD_DKV - before[1],
            fa.LAUNCHES_BWD_DQ - before[2]) == (6 if remat else 4, 4, 4)
    assert set(grads["flash"]) == set(grads["dense"])
    for name, want in grads["dense"].items():
        if name.endswith("proj_k.bias"):  # exact gradient 0: rounding noise
            continue
        _check(grads["flash"][name], want, 1e-4)


@pytest.mark.cuda
def test_small_flow_model_on_the_card(cuda):
    """The whole model on the GPU, every site forced through the kernel,
    against the dense path on the same card and weights."""
    flash = FlowPerceiver(**SMALL, device=cuda, generator=torch.Generator().manual_seed(3),
                          policy=dataclasses.replace(config.PARITY, attn_impl="flash"))
    dense = FlowPerceiver(**SMALL, device=cuda, policy=config.PARITY)
    dense.load_state_dict(flash.state_dict())
    weight = flash.perceiver._decoder.final_layer.weight
    with torch.no_grad():  # the zero-initialised projection would hide the decoder
        weight.copy_(torch.randn(weight.shape, generator=torch.Generator().manual_seed(5)))
        dense.perceiver._decoder.final_layer.weight.copy_(weight)
    rng = np.random.default_rng(4)
    img1, img2 = (torch.from_numpy(rng.uniform(-1, 1, (1, 3, 20, 40)).astype(np.float32))
                  for _ in range(2))
    before = fa.LAUNCHES
    got = FlowInference(flash, min_overlap=8, device=cuda)(img1, img2)
    # one batched forward of the 4 tiles: encoder, 2 self-attends, decoder
    assert fa.LAUNCHES == before + 4
    want = FlowInference(dense, min_overlap=8, device=cuda)(img1, img2)
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    _check(got, want, 1e-4)


# A small multimodal model whose input is padded to the published 704
# channels (700 classes + 4): its encoder runs K1 at d = dv = 704.
MM_SMALL = dict(img_size=(16, 16), num_frames=2, num_classes=700, audio_samples_per_frame=128,
                audio_samples_per_patch=16, num_self_attends_per_block=1, num_blocks=1,
                num_latents=8, num_latent_channels=512)


@pytest.mark.cuda
@pytest.mark.parametrize("policy,tol", [(config.PARITY, 1e-4), (config.PERFORMANCE, 2e-2)])
def test_small_multimodal_model_on_the_card(cuda, policy, tol):
    """Every site forced through K1 (the encoder at width 704, the
    self-attend, 4 decoder chunks) against the dense path on the same card
    and weights, in fp32 and in bf16 with the query-pad fold."""
    flash = MultiModalPerceiver(**MM_SMALL, device=cuda, generator=torch.Generator().manual_seed(3),
                                policy=dataclasses.replace(policy, attn_impl="flash"))
    dense = MultiModalPerceiver(**MM_SMALL, device=cuda,
                                policy=dataclasses.replace(policy, attn_impl="dense"))
    dense.load_state_dict(flash.state_dict())
    rng = np.random.default_rng(10)
    images = torch.from_numpy(rng.random((1, 2, 3, 16, 16), dtype=np.float32)).to(cuda)
    audio = torch.from_numpy(rng.uniform(-1, 1, (1, 256, 1)).astype(np.float32)).to(cuda)
    before = fa.LAUNCHES
    with torch.no_grad():
        got = flash(images, audio, n_chunks=4)
        assert fa.LAUNCHES == before + 1 + 1 + 4
        want = dense(images, audio, n_chunks=4)
    for key in ("image", "audio", "label"):
        assert torch.isfinite(got[key]).all()
        _check(got[key], want[key], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_small_multimodal_gradients_on_the_card(cuda, remat):
    """The multimodal loss's gradients with every site forced through
    K1/K2/K3 (the encoder's backward at width 704) against the dense path's
    autograd on the same card and weights, with and without remat."""
    models = {}
    for impl in ("flash", "dense"):
        models[impl] = MultiModalPerceiver(
            **MM_SMALL, remat=remat, device=cuda, generator=torch.Generator().manual_seed(3),
            policy=dataclasses.replace(config.PARITY, attn_impl=impl))
    rng = np.random.default_rng(17)
    images = torch.from_numpy(rng.random((1, 2, 3, 16, 16), dtype=np.float32)).to(cuda)
    audio = torch.from_numpy(rng.uniform(-1, 1, (1, 256, 1)).astype(np.float32)).to(cuda)
    targets = {"image": images, "audio": audio, "label": torch.tensor([5], device=cuda)}
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    grads = {}
    for impl, model in models.items():
        out = model(images, audio, n_chunks=4)
        multimodal_autoencode_loss(out, targets, weights={"label": 0.01}).backward()
        grads[impl] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    # 6 sites (encoder, self-attend, 4 decoder chunks); remat recomputes the
    # self-attend and the 4 chunks' forward in the backward.
    assert (fa.LAUNCHES - before[0], fa.LAUNCHES_BWD_DKV - before[1],
            fa.LAUNCHES_BWD_DQ - before[2]) == (11 if remat else 6, 6, 6)
    assert set(grads["flash"]) == set(grads["dense"])
    for name, want in grads["dense"].items():
        if name.endswith("proj_k.bias"):  # exact gradient 0: rounding noise
            continue
        _check(grads["flash"][name], want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [261, 512])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_at_the_classification_widths(cuda, dtype, tol, d, masked):
    """K1 at d = dv = 261 (the pixel encoder: 522-byte bf16 rows, 2-byte
    loads) and 512 (the 1x1-conv encoder) over 50,176 keys, batch 2 (the key
    splits and their merge), against the plain version."""
    q, k, v, kv_mask, q_mask = _inputs(2, 512, 50176, 1, d, d, 21, cuda)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    kw = dict(kv_mask=kv_mask, q_mask=q_mask, kv_logical_len=50000) if masked else {}
    plan = fa.launch_plan(q, k, v, kv_logical_len=kw.get("kv_logical_len"))
    assert plan["splits"] > 1 and plan["col_chunks"] == 1
    before = (fa.LAUNCHES, fa.LAUNCHES_MERGE)
    got = fa.flash_attention(q, k, v, **kw)
    assert (fa.LAUNCHES - before[0], fa.LAUNCHES_MERGE - before[1]) == (1, 1)
    want = fa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    assert got.shape == (2, 512, d) and torch.isfinite(got).all()
    _check(got, want, tol)
    if masked:
        assert torch.all(got[~q_mask] == 0)


def _small_classifier(prep, policy, device):
    model = ClassificationPerceiver(
        num_classes=10, img_size=(64, 64), prep_type=prep, num_self_attends_per_block=2,
        num_blocks=2, num_latents=64, num_latent_channels=128, policy=policy, device=device,
        generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    for module in model.modules():  # non-trivial BatchNorm statistics
        if isinstance(module, torch.nn.BatchNorm2d):
            with torch.no_grad():
                n = module.num_features
                module.running_mean.copy_(torch.empty(n).uniform_(-0.3, 0.3, generator=gen))
                module.running_var.copy_(torch.empty(n).uniform_(0.5, 1.5, generator=gen))
    return model.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("prep", list(PrepType))
def test_small_classification_model_on_the_card(cuda, prep):
    """A reduced-depth classifier of each PrepType (64x64 images: 4,096
    pixel or 1x1-conv tokens at widths 261 and 512, 256 convnet tokens), its
    encoder forced through K1, on the card against the same weights on the
    CPU (the plain K1); fp32, and bf16 (PERFORMANCE) against the CPU fp32."""
    flash = dataclasses.replace(config.PARITY, attn_impl="flash")
    cpu = _small_classifier(prep, flash, "cpu")
    img = torch.from_numpy(np.random.default_rng(22).standard_normal((2, 3, 64, 64),
                                                                    dtype=np.float32))
    with torch.no_grad():
        want = cpu(img)
        for policy, tol in ((flash, 1e-4),
                            (dataclasses.replace(config.PERFORMANCE, attn_impl="flash"), 5e-2)):
            model = _small_classifier(prep, policy, cuda)
            model.load_state_dict(cpu.state_dict())
            before = fa.LAUNCHES
            got = model(img.to(cuda))
            # the encoder, 2 blocks x 2 self-attends and the one-query decoder
            assert fa.LAUNCHES == before + 6
            assert got.shape == (2, 10) and torch.isfinite(got).all()
            _check(got.cpu(), want, tol)


@pytest.mark.cuda
def test_small_language_model_on_the_card(cuda):
    """The language model at its published widths with 2 self-attends, a
    partial input mask and predict_positions, on the card (dense path, no
    K1) against the same weights on the CPU."""
    kw = dict(num_self_attends_per_block=2, policy=config.PARITY,
              generator=torch.Generator().manual_seed(6))
    cpu = LanguagePerceiver(**kw, device="cpu").eval()
    card = LanguagePerceiver(**kw, device=cuda).eval()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(23)
    ids = torch.from_numpy(rng.integers(0, 262, (2, 2048)))
    mask = torch.from_numpy(np.arange(2048)[None] < np.array([[2048], [1700]]))
    positions = torch.tensor([5, 1800, 100, 2047])
    before = fa.LAUNCHES
    with torch.no_grad():
        want = cpu(ids, mask)
        got = card(ids.to(cuda), mask.to(cuda))
        rows = card(ids.to(cuda), mask.to(cuda), predict_positions=positions.to(cuda))
    assert fa.LAUNCHES == before
    _check(got.cpu(), want, 1e-4)
    _check(rows.cpu(), want[:, positions], 1e-4)


# K2/K3 at the classification encoders' widths: the pixel variant's 261
# (522-byte bf16 rows: 2-byte loads; K2 <16, 6>, K3 <168>) with masks, a
# ragged Tk, kv_logical_len and an all-masked entry, strided too; the
# 1x1-conv variant's 512 unmasked over a few thousand keys.
CLS_BACKWARD_CASES = [(2, 100, 777, 1, 261, 261), (2, 130, 300, 1, 261, 261),
                      (3, 65, 129, 2, 261, 261)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,tq,tk,h,d,dv", CLS_BACKWARD_CASES)
@pytest.mark.parametrize("strided", [False, True])
def test_backward_kernels_at_width_261(cuda, dtype, tol, b, tq, tk, h, d, dv, strided):
    args, kw = _backward_case(b, tq, tk, h, d, dv, dtype, cuda, strided=strided)
    before = (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    got = fa.flash_attention_backward(*args, **kw)
    assert (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_backward_reference(*(x.float() for x in args), **kw)
    torch.cuda.synchronize()
    for x, x_like in zip(got, args[:3]):
        assert x.dtype == dtype and x.shape == x_like.shape
    _check_backward(got, want, kw, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [261, 512])
def test_backward_kernels_at_the_classification_widths_unmasked(cuda, dtype, tol, d):
    """512 latents over 4,096 keys at batch 2, no mask: K3 splits the keys
    in bf16; the bf16 splits against one split."""
    q, k, v, _, _ = _inputs(2, 512, 4096, 1, d, d, 24, cuda)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(25)).to(cuda, dtype)
    plan = fa.backward_plan(q, k, v)
    assert plan["dq"]["splits"] > 1 if dtype == torch.bfloat16 else plan["dq"]["splits"] == 1
    got = fa.flash_attention_backward(q, k, v, out, lse, grad)
    want = fa.flash_attention_backward_reference(
        *(x.float() for x in (q, k, v, out, lse, grad)))
    for x, y in zip(got, want):
        _check(x, y, tol)
    if dtype == torch.bfloat16:
        one = fa._flash_attention_backward_cuda(q, k, v, out, lse, grad, num_splits=1)
        for x, y in zip(got, one):
            _check(x, y, tol)


# The long-KV K1, K2 and K3 (bf16, over at least 4,224 keys, the wider head
# 257 to 512 wide with at most 512 query rows or 513 to 704 wide with at
# most 1,024), with masks, kv_logical_len and an all-masked entry: the pixel
# encoder's 261 (522-byte rows: q, dO, K and V copied into aligned rows)
# with odd Tq and Tk and with a multiple of 8 keys, the 1x1-conv encoder's
# 512 (TMA) over 2 heads, d = 300 with Dv 264 over 3 heads (q and k
# copied); the multimodal encoder's 704 (K1 with rings of 6 K and 10 V
# slots, K2 with 11 Q-ring slots and 4 dO slots, K3 in steps of 16 keys)
# with 129 and 784 query rows, 704 with Dv 512, 512 with Dv 704 and 600 over
# 2 heads (a partial last column chunk).  Tq = 129, 65, 77 and 784 leave a
# lone last query tile (of 1, 1, 13 and 16 rows).
LONGKV_CASES = [(2, 129, 4301, 1, 261, 261), (2, 136, 4400, 1, 261, 261),
                (3, 65, 4451, 2, 512, 512), (2, 77, 4231, 3, 300, 264),
                (2, 129, 4301, 1, 704, 704), (2, 784, 4400, 1, 704, 704),
                (2, 70, 4351, 1, 704, 512), (2, 77, 4231, 1, 512, 704),
                (2, 100, 4250, 2, 600, 600)]
# The multimodal encoder itself (one clip: 784 latents over 52,097 keys, d =
# dv = 704), its one batch entry not wiped.
MM_SITE = (1, 784, 52097, 1, 704, 704)
# K1 alone at the flow encoder's width (644-byte rows, copied into aligned
# rows): 200 query rows, and 1,100 (18 tiles, a last one of 12 rows: past
# the backward's 8 tiles, on K1's long-KV route only), then the flow encoder
# itself (2,048 latents over 182,528 pixels, 4 key splits).
FLOW_ENCODER_CASES = [(2, 200, 4400, 1, 322, 322), (2, 1100, 4400, 1, 322, 322),
                      (1, 2048, 182528, 1, 322, 322)]
# The long-Q K1 (bf16, at least 8,448 query rows over at most 8,192 keys, 257
# to 512 wide): ragged last query tiles (8,500 rows: 52 in the last; 8,600:
# 24; 9,000: 40), d != dv both ways, 2 heads, a key range short of a step
# (130 keys), then the flow decoder itself (182,528 queries over 2,048
# latents, 512 wide).
LONGQ_CASES = [(2, 8500, 777, 1, 512, 512), (2, 8600, 2100, 2, 300, 264),
               (2, 9000, 130, 1, 264, 512), (1, 182528, 2048, 1, 512, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,dv", LONGKV_CASES + [MM_SITE])
def test_longkv_backward_matches_reference(cuda, b, tq, tk, h, d, dv):
    """K2 and K3 on the long-KV route against the plain backward, exact
    zeros on wiped rows, tail keys and the all-masked entry (none at the
    multimodal encoder's one clip), one long-KV launch of each, one copy
    launch for each operand the plan copies into aligned rows (made by K2,
    read by K3 too), K3's sum when it splits the keys, and two calls bit
    for bit."""
    args, kw = _backward_case(b, tq, tk, h, d, dv, torch.bfloat16, cuda, wipe_last=b > 1)
    plan = fa.backward_plan(*args[:3], kv_logical_len=kw["kv_logical_len"])
    copies = plan["dkv"]["copies"]
    splits = plan["dq"]["splits"]
    assert plan["route"] == "sm90_longkv" and plan["dq"]["copies"] == copies
    assert (plan["dkv"]["cuda_launches"] + plan["dq"]["cuda_launches"]
            == 2 + (splits > 1) + len(copies))
    names = ("LAUNCHES_BWD_DKV", "LAUNCHES_BWD_LONGKV", "LAUNCHES_BWD_DQ",
             "LAUNCHES_BWD_DQ_LONGKV", "LAUNCHES_BWD_COPY", "LAUNCHES_BWD_SUM")
    before = [getattr(fa, name) for name in names]
    got = fa.flash_attention_backward(*args, **kw)
    assert [getattr(fa, name) - n for name, n in zip(names, before)] == [
        1, 1, 1, 1, len(copies), int(splits > 1)]
    again = fa.flash_attention_backward(*args, **kw)
    want = fa.flash_attention_backward_reference(*(x.float() for x in args), **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _check_backward(got, want, kw, 2e-2, wiped_last=b > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3, 6])
@pytest.mark.parametrize("d", [261, 512])
def test_longkv_realigned_views_match_contiguous(cuda, offset, d):
    """The long-KV kernels' loaders change only how bytes reach shared
    memory: q, k and v seen ``offset`` elements into NaN-filled buffers
    (rows d + 8 apart, copied into aligned rows first) give dQ, dK and dV
    bit for bit as the contiguous tensors (copied into aligned rows at 261,
    by TMA at 512)."""
    args, kw = _backward_case(2, 136, 4400, 1, d, d, torch.bfloat16, cuda)
    assert fa.backward_plan(*args[:3])["dkv"]["loader"] == ("copy" if d == 261 else "tma")
    q, k, v, out, lse, grad = args
    views = [_realign_views(x, offset) for x in (q, k, v)]
    plan = fa.backward_plan(*views, kv_logical_len=kw["kv_logical_len"])
    assert plan["route"] == "sm90_longkv"
    assert plan["dkv"]["loader"] == "copy" and "k" in plan["dkv"]["copies"]
    assert (plan["dq"]["loader"], plan["dq"]["copies"]) == ("copy", plan["dkv"]["copies"])
    want = fa.flash_attention_backward(*args, **kw)
    got = fa.flash_attention_backward(*views, out, lse, grad, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,dv", [LONGKV_CASES[0], LONGKV_CASES[2], LONGKV_CASES[5]])
def test_longkv_dq_alone_matches_dq_after_dkv(cuda, b, tq, tk, h, d, dv):
    """The long-KV K3 called alone (its own copies of q, dO, k and v where
    their rows are not aligned) gives dQ bit for bit as after K2 (K2's
    copies read), and launches the copies K2 would have made; K3 lets the
    copies go once it is enqueued."""
    args, kw = _backward_case(b, tq, tk, h, d, dv, torch.bfloat16, cuda)
    kwargs = dict(q_mask=kw["q_mask"], kv_mask=kw["kv_mask"], softmax_scale=None,
                  kv_logical_len=kw["kv_logical_len"])
    both = fa.BackwardKernels(*args, **kwargs)
    both.dkv()
    assert set(both._copies) == set(both.plan["dkv"]["copies"])
    both.dq()
    assert both._copies == {}
    alone = fa.BackwardKernels(*args, **kwargs)
    before = fa.LAUNCHES_BWD_COPY
    alone.dq()
    assert fa.LAUNCHES_BWD_COPY - before == len(alone.plan["dq"]["copies"])
    torch.cuda.synchronize()
    assert torch.equal(alone.grad_q, both.grad_q)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,dv", LONGKV_CASES + [MM_SITE] + FLOW_ENCODER_CASES)
def test_longkv_forward_matches_reference(cuda, b, tq, tk, h, d, dv):
    """K1 on the long-KV route against the plain version with kv_mask,
    q_mask, kv_logical_len, an all-masked entry (none at the multimodal
    encoder's one clip) and the lse (lone last query tiles of 1, 1, 13 and
    16 rows): within bf16 TOL, exact zeros on wiped rows, +inf lse where
    every key is masked; one K1 launch on the route, a merge when the keys
    split, one copy launch for each operand the plan copies into aligned
    rows; two calls bit for bit."""
    q, k, v, kv_mask, q_mask = _inputs(b, tq, tk, h, d, dv, 41, cuda)
    if b > 1:
        kv_mask[-1] = False
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    kw = dict(kv_mask=kv_mask, q_mask=q_mask, kv_logical_len=tk - 30, return_lse=True)
    plan = fa.launch_plan(q, k, v, kv_logical_len=tk - 30)
    assert plan["route"] == "sm90_longkv"
    names = ("LAUNCHES", "LAUNCHES_LONGKV", "LAUNCHES_MERGE", "LAUNCHES_FWD_COPY")
    before = [getattr(fa, name) for name in names]
    got, lse = fa.flash_attention(q, k, v, **kw)
    assert [getattr(fa, name) - n for name, n in zip(names, before)] == [
        1, 1, int(plan["splits"] > 1), len(plan["copies"])]
    again, again_lse = fa.flash_attention(q, k, v, **kw)
    want, want_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(lse, again_lse)
    _check(got, want, 2e-2)
    assert torch.all(got.view(b, tq, -1)[~q_mask] == 0)
    assert b == 1 or torch.all(got[-1] == 0)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    finite = torch.isfinite(want_lse)
    torch.testing.assert_close(lse[finite], want_lse[finite], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3, 6])
@pytest.mark.parametrize("d", [261, 512, 322])
def test_longkv_forward_views_match_contiguous(cuda, offset, d):
    """The long-KV K1's copies into aligned rows change only how bytes
    reach shared memory: q, k and v seen ``offset`` elements into NaN-filled
    buffers (rows d + 8 apart, all three copied first) give the output and
    lse bit for bit as the contiguous tensors (copied at 261 and at the flow
    encoder's 322, read by TMA at 512)."""
    q, k, v, _, _ = _inputs(2, 136 if d != 322 else 1100, 4400, 1, d, d, 43, cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    assert fa.launch_plan(q, k, v)["copies"] == (("q", "k", "v") if d % 8 else ())
    views = [_realign_views(x, offset) for x in (q, k, v)]
    plan = fa.launch_plan(*views)
    assert (plan["route"], plan["loader"], plan["copies"]) == (
        "sm90_longkv", "copy", ("q", "k", "v"))
    want, want_lse = fa.flash_attention(q, k, v, return_lse=True)
    got, got_lse = fa.flash_attention(*views, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_lse, want_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("d,route", [(261, "sm90_longkv"), (512, "sm90_longkv"),
                                     (704, "sm90_longkv"), (322, "sm90_longkv"),
                                     (512, "sm90_longq")])
def test_longkv_forward_op_and_artifact_match_the_direct_launch(cuda, d, route):
    """K1's torch.library op through torch.ops and a reloaded export_apply
    artifact of one long-KV site (129 query rows over 4,400 keys; at the
    flow encoder's 322 1,100 rows) or long-Q site (8,500 query rows over
    4,400 keys), batch-polymorphic, called at batches 2 and 3, against the
    direct launch on the same masked inputs: bit for bit, one launch on the
    route each."""
    from perceiverio_pytorch_tpu_torch.serving import export_apply, load_exported

    class Site(torch.nn.Module):
        def forward(self, q, k, v):
            return fa.flash_attention(q, k, v, kv_logical_len=4380)

    tq = 8500 if route == "sm90_longq" else 1100 if d == 322 else 129
    counter = "LAUNCHES_LONGQ" if route == "sm90_longq" else "LAUNCHES_LONGKV"
    q, k, v, kv_mask, q_mask = _inputs(3, tq, 4400, 1, d, d, 44, cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    assert fa.launch_plan(q, k, v)["route"] == route
    before = getattr(fa, counter)
    out, lse = torch.ops.perceiverio_torch.flash_attention_fwd(
        q, k, v, kv_mask, q_mask, None, 4380, True)
    assert getattr(fa, counter) - before == 1
    want = fa._flash_attention_cuda(q, k, v, q_mask=q_mask, kv_mask=kv_mask,
                                    softmax_scale=None, kv_logical_len=4380, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    site = Site().eval()
    serve = load_exported(export_apply(site, {}, q[:2], k[:2], v[:2], batch_polymorphic=True))
    for b in (2, 3):
        with torch.inference_mode():
            before = getattr(fa, counter)
            got = serve({}, q[:b], k[:b], v[:b])
            assert getattr(fa, counter) - before == 1
            direct = site(q[:b], k[:b], v[:b])
        torch.cuda.synchronize()
        assert torch.equal(got, direct)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,dv", LONGQ_CASES)
def test_longq_forward_matches_reference(cuda, b, tq, tk, h, d, dv):
    """K1 on the long-Q route against the plain version with kv_mask,
    q_mask, kv_logical_len, an all-masked entry (none at the flow decoder's
    one batch entry) and the lse: within bf16 TOL, exact zeros on wiped
    rows, +inf lse where every key is masked; one K1 launch on the route, no
    merge, a copy launch for each operand whose rows are not 16-byte aligned
    (q and k at d = 300); two calls bit for bit."""
    q, k, v, kv_mask, q_mask = _inputs(b, tq, tk, h, d, dv, 45, cuda)
    if b > 1:
        kv_mask[-1] = False
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    kv_len = tk - 30 if tk > 1000 else tk - 3
    kw = dict(kv_mask=kv_mask, q_mask=q_mask, kv_logical_len=kv_len, return_lse=True)
    plan = fa.launch_plan(q, k, v, kv_logical_len=kv_len)
    copies = ("q", "k") if d == 300 else ()  # 600-byte rows; 528 are aligned
    assert (plan["route"], plan["splits"], plan["copies"], plan["cuda_launches"]) == (
        "sm90_longq", 1, copies, 1 + len(copies))
    names = ("LAUNCHES", "LAUNCHES_LONGQ", "LAUNCHES_LONGKV", "LAUNCHES_MERGE",
             "LAUNCHES_FWD_COPY")
    before = [getattr(fa, name) for name in names]
    got, lse = fa.flash_attention(q, k, v, **kw)
    assert [getattr(fa, name) - n for name, n in zip(names, before)] == [
        1, 1, 0, 0, len(copies)]
    again, again_lse = fa.flash_attention(q, k, v, **kw)
    want, want_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(lse, again_lse)
    _check(got, want, 2e-2)
    assert torch.all(got.view(b, tq, -1)[~q_mask] == 0)
    assert b == 1 or torch.all(got[-1] == 0)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    finite = torch.isfinite(want_lse)
    torch.testing.assert_close(lse[finite], want_lse[finite], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3, 6])
@pytest.mark.parametrize("d", [300, 512])
def test_longq_forward_views_match_contiguous(cuda, offset, d):
    """The long-Q K1's copies into aligned rows change only how bytes reach
    shared memory: q, k and v seen ``offset`` elements into NaN-filled
    buffers (rows d + 8 apart, all three copied first) give the output and
    lse bit for bit as the contiguous tensors (600-byte rows copied at 300,
    read by TMA at 512)."""
    q, k, v, _, _ = _inputs(2, 8500, 777, 1, d, d, 46, cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    assert fa.launch_plan(q, k, v)["copies"] == (("q", "k", "v") if d % 8 else ())
    views = [_realign_views(x, offset) for x in (q, k, v)]
    plan = fa.launch_plan(*views)
    assert (plan["route"], plan["loader"], plan["copies"]) == (
        "sm90_longq", "copy", ("q", "k", "v"))
    want, want_lse = fa.flash_attention(q, k, v, return_lse=True)
    got, got_lse = fa.flash_attention(*views, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_lse, want_lse)


def _tiny_classifier(prep, impl, device):
    return ClassificationPerceiver(
        num_classes=train_classification.TINY_CLASSES, prep_type=prep,
        **train_classification.TINY, policy=dataclasses.replace(config.PARITY, attn_impl=impl),
        device=device, generator=torch.Generator().manual_seed(5))


@pytest.mark.cuda
@pytest.mark.parametrize("prep", list(PrepType))
def test_tiny_classifier_train_step_on_the_card(cuda, prep):
    """The example's tiny classifier (32x32, one block of 2 self-attends)
    with every site forced through the kernels: the loss's gradients on the
    card against the dense path's on the same card and weights, the convnet's
    running averages against the same step on the CPU, and one Trainer step
    of K1, K2 and K3 at each of the 4 sites."""
    img, labels = (torch.from_numpy(a[:2]) for a in train_classification.synthetic_quadrants(
        2, (32, 32), train_classification.TINY_CLASSES))
    models = {impl: _tiny_classifier(prep, impl, cuda).train() for impl in ("flash", "dense")}
    cpu = _tiny_classifier(prep, "dense", "cpu").train()
    grads = {}
    for impl, model in models.items():
        train_classification.loss_fn(model, img.to(cuda), labels.to(cuda)).backward()
        grads[impl] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    train_classification.loss_fn(cpu, img, labels).backward()
    assert set(grads["flash"]) == set(grads["dense"])
    for name, want in grads["dense"].items():
        if not name.endswith("proj_k.bias"):  # exact gradient 0: rounding noise
            _check(grads["flash"][name], want, 1e-4)
    for name, buf in cpu.named_buffers():
        if "running" in name:
            _check(models["flash"].get_buffer(name).cpu(), buf, 1e-5)
    trainer = Trainer(train_classification.loss_fn, build_optimizer(1e-3), log_every=0)
    state = trainer.init_state(models["flash"])
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    state = trainer.fit(state, [(img.to(cuda), labels.to(cuda))], num_steps=1)
    assert state.step == 1
    assert (fa.LAUNCHES - before[0], fa.LAUNCHES_BWD_DKV - before[1],
            fa.LAUNCHES_BWD_DQ - before[2]) == (4, 4, 4)


@pytest.mark.cuda
def test_tiny_mlm_train_step_on_the_card(cuda, tmp_path):
    """Two steps of the example's tiny MLM on the card (dense path, no
    launch) against the same steps on the CPU: the logged losses and the
    evaluation."""
    logged = {}
    for device in ("cpu", cuda):
        path = tmp_path / f"{torch.device(device).type}.jsonl"
        trainer, state, batches, eval_batches = train_mlm.setup(
            2, batch_size=2, device=device, metrics_path=str(path), log_every=1)
        before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
        trainer.fit(state, batches, num_steps=2, eval_batches=eval_batches)
        assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == before
        with open(path) as f:
            logged[device] = [json.loads(line) for line in f]
    cpu_lines, card_lines = logged["cpu"], logged[cuda]
    assert [x["step"] for x in card_lines] == [x["step"] for x in cpu_lines] == [1, 1, 2, 2]
    for got, want in zip(card_lines, cpu_lines):
        key = "loss" if "loss" in want else "eval_loss"
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("return_lse", [True, False])
def test_op_matches_the_direct_launch_bit_for_bit(cuda, dtype, return_lse):
    """K1's torch.library op, called through torch.ops, against the direct
    launch (``_flash_attention_cuda``) on the same masked inputs: bit for
    bit, one K1 launch each."""
    q, k, v, kv_mask, q_mask = _inputs(2, 100, 777, 2, 41, 64, 31, cuda)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    before = fa.LAUNCHES
    out, lse = torch.ops.perceiverio_torch.flash_attention_fwd(
        q, k, v, kv_mask, q_mask, None, 700, return_lse)
    assert fa.LAUNCHES - before == 1
    want = fa._flash_attention_cuda(q, k, v, q_mask=q_mask, kv_mask=kv_mask,
                                    softmax_scale=None, kv_logical_len=700,
                                    return_lse=return_lse)
    torch.cuda.synchronize()
    if return_lse:
        assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    else:
        assert torch.equal(out, want) and lse.shape == (0,)


@pytest.mark.cuda
def test_export_on_the_card_holds_the_op(cuda):
    """The tiny pixel classifier with every site through K1, exported on the
    card batch-polymorphic: the graph holds the op at each of its 4 sites
    and no parameter; the reloaded artifact launches K1 4 times a call at
    batches 1 and 3 and gives the eager model's logits."""
    import io

    from perceiverio_pytorch_tpu_torch.serving import export_apply, load_exported

    model = _tiny_classifier(PrepType.FOURIER_POS_PIXEL, "flash", cuda).eval()
    weights = model.state_dict()
    blob = export_apply(model, weights, torch.zeros(2, 3, 32, 32, device=cuda),
                        batch_polymorphic=True)
    ep = torch.export.load(io.BytesIO(blob))
    op = torch.ops.perceiverio_torch.flash_attention_fwd.default
    assert sum(n.target is op for n in ep.graph.nodes) == 4
    assert len(ep.state_dict) == 0
    serve = load_exported(blob)
    rng = np.random.default_rng(32)
    for b in (1, 3):
        img = torch.from_numpy(rng.standard_normal((b, 3, 32, 32), dtype=np.float32)).to(cuda)
        with torch.inference_mode():
            before = fa.LAUNCHES
            got = serve(weights, img)
            assert fa.LAUNCHES - before == 4
            want = model(img)
        torch.cuda.synchronize()
        _check(got, want, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [261, 512])
@pytest.mark.parametrize("batch,splits", [(1, 16), (2, 8), (4, 4)])
def test_kernel_at_the_server_buckets(cuda, dtype, tol, d, batch, splits):
    """K1 at the classification encoders at the serving buckets 1, 2 and 4
    (512 latents x 50,176 keys, d = 261 and 512), with its lse, against the
    plain version; the plan's route, splits (bf16: the long-KV route's, 128
    blocks; fp32: the CUDA-core kernel's 33, 16, 8), copies and merge as
    launched."""
    q, k, v, _, _ = _inputs(batch, 512, 50176, 1, d, d, 33, cuda)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    plan = fa.launch_plan(q, k, v)
    longkv = dtype == torch.bfloat16
    copies = len(plan.get("copies", ()))
    assert plan["route"] == ("sm90_longkv" if longkv else "cuda_cores")
    assert plan["splits"] == (splits if longkv else {1: 33, 2: 16, 4: 8}[batch])
    assert plan["cuda_launches"] == 2 + copies and copies == 3 * (longkv and d == 261)
    names = ("LAUNCHES", "LAUNCHES_MERGE", "LAUNCHES_LONGKV", "LAUNCHES_FWD_COPY")
    before = [getattr(fa, name) for name in names]
    got, lse = fa.flash_attention(q, k, v, return_lse=True)
    assert [getattr(fa, name) - n for name, n in zip(names, before)] == [
        1, 1, int(longkv), copies]
    want, want_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                                  return_lse=True)
    torch.cuda.synchronize()
    assert got.shape == (batch, 512, d) and torch.isfinite(got).all()
    _check(got, want, tol)
    assert (lse - want_lse).abs().max().item() <= 1e-4 * (1 + want_lse.abs().max().item())


@pytest.mark.cuda
def test_prefetch_matches_direct_copies_while_the_consumer_allocates(cuda):
    """Batches copied on the side stream equal ``.to("cuda")`` copies of the
    same arrays while the consumer allocates, writes and frees memory
    between them (what would reuse a buffer whose copy is in flight)."""
    from perceiverio_pytorch_tpu_torch.training import prefetch_to_device

    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((4, 1 << 18), dtype=np.float32),
                rng.integers(0, 255, (4, 3, 64, 64), dtype=np.uint8)) for _ in range(24)]
    got = []
    for a, b in prefetch_to_device(iter(batches), 3, device=cuda):
        assert a.device.type == b.device.type == "cuda"
        for _ in range(3):
            scratch = torch.empty((4, 1 << 18), device=cuda)
            scratch.fill_(7.0)
            del scratch
        got.append(((a * 2 + 1).sum(dim=1).cpu(), b.float().mean(dim=(1, 2, 3)).cpu()))
    assert len(got) == len(batches)
    for (ga, gb), (a, b) in zip(got, batches):
        a, b = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
        assert torch.equal(ga, (a * 2 + 1).sum(dim=1).cpu())
        assert torch.equal(gb, b.float().mean(dim=(1, 2, 3)).cpu())


@pytest.mark.cuda
def test_async_save_on_the_card_holds_the_values_before_an_update(cuda, tmp_path):
    """``save`` returns once the card's tensors are copied: an in-place
    update launched right after it (and a train step) does not reach the
    file."""
    from perceiverio_pytorch_tpu_torch.training import (
        AsyncCheckpointWriter,
        restore_train_state,
    )

    model = torch.nn.Sequential(torch.nn.Linear(256, 1024), torch.nn.Linear(1024, 8)).to(cuda)
    trainer = Trainer(lambda m, x: m(x).square().mean(), build_optimizer(1e-2), log_every=0)
    state = trainer.init_state(model)
    x = torch.randn(64, 256, device=cuda)
    state = trainer.fit(state, [(x,)] * 2, num_steps=2)
    want = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    moments = {i: {k: v.cpu().clone() for k, v in e.items()}
               for i, e in state.optimizer.state_dict()["state"].items()}
    with AsyncCheckpointWriter() as writer:
        writer.save_train_state(str(tmp_path / "c"), state)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(-3.0).add_(1.0)
        state = trainer.fit(state, [(x,)], num_steps=3)
    other = trainer.init_state(torch.nn.Sequential(torch.nn.Linear(256, 1024),
                                                   torch.nn.Linear(1024, 8)).to(cuda))
    restore_train_state(str(tmp_path / "c"), other)
    assert other.step == 2 and next(other.model.parameters()).device.type == cuda.type
    for k, v in other.model.state_dict().items():
        assert torch.equal(v.cpu(), want[k]), k
    for i, entry in other.optimizer.state_dict()["state"].items():
        for k, v in entry.items():
            assert torch.equal(v.cpu(), moments[i][k]), (i, k)


@pytest.mark.cuda
def test_tiny_flow_from_files_resumes_bit_for_bit_on_the_card(cuda, tmp_path):
    """The tiny flow example from a file tree on the card (random crops,
    prefetched batches): 6 steps against 3, a checkpoint, and 3 more resumed
    into a model of other weights."""
    from perceiverio_pytorch_tpu_torch.examples import train_flow
    from perceiverio_pytorch_tpu_torch.tools import make_synthetic_data

    make_synthetic_data.make_flow(str(tmp_path), hw=(40, 56), scenes={"train": (2, 5)})
    data = str(tmp_path / "flow_synth" / "train")
    runs = []
    for stop, seed in ((6, 0), (3, 0), (6, 1)):
        trainer, state, batches, eval_batches = train_flow.setup(
            6, device=cuda, metrics_path=None, log_every=0, data_dir=data, prefetch=2,
            checkpoint_dir=None if len(runs) == 0 else str(tmp_path / "ck"),
            checkpoint_every=3, seed=seed)
        runs.append(trainer.fit(state, batches, num_steps=stop, eval_batches=eval_batches,
                                resume=seed == 1))
    want, got = runs[0].model.state_dict(), runs[2].model.state_dict()
    assert runs[2].step == 6
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.cuda
def test_tiny_multimodal_from_clips_on_the_card(cuda, tmp_path):
    """The tiny multimodal example from a clip tree (``VideoClipDataset``:
    OpenCV decode, wav sidecars) on the card, prefetched, with a checkpoint."""
    pytest.importorskip("cv2")
    from perceiverio_pytorch_tpu_torch.examples import train_multimodal
    from perceiverio_pytorch_tpu_torch.tools import make_synthetic_data
    from perceiverio_pytorch_tpu_torch.training import latest_checkpoint

    make_synthetic_data.make_clips(str(tmp_path), n_classes=2, num_frames=2, hw=(16, 16),
                                   samples_per_frame=128, per_class={"train": 2})
    path = tmp_path / "m.jsonl"
    trainer, state, batches = train_multimodal.setup(
        3, device=cuda, metrics_path=str(path), log_every=1, prefetch=2,
        data_dir=str(tmp_path / "kinetics_synth" / "train"),
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3)
    state = trainer.fit(state, batches, num_steps=3)
    assert state.step == 3
    logged = [json.loads(line) for line in path.read_text().splitlines()]
    assert [x["step"] for x in logged] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) for x in logged)
    assert latest_checkpoint(str(tmp_path / "ck")).endswith("step_00000003")


@pytest.mark.cuda
def test_tiny_flow_under_dots_saveable_on_the_card(cuda):
    """The tiny flow model (bf16, remat, every site on the flash kernels)
    under dots_saveable against full remat: gradients bit for bit, and K1
    launched again at each self-attend in the backward under both."""
    grads, launches = {}, {}
    for name in ("dots_saveable", "nothing_saveable"):
        policy = dataclasses.replace(config.PERFORMANCE, attn_impl="flash", remat_policy=name)
        model = FlowPerceiver(**SMALL, policy=policy, remat=True, device="cuda",
                              generator=torch.Generator().manual_seed(0)).train()
        img = torch.rand(1, 3, 16, 24, generator=torch.Generator().manual_seed(1)).cuda()
        before = fa.LAUNCHES
        flow_endpoint_error(model(img, img.flip(-1)), torch.zeros(1, 2, 16, 24, device="cuda")
                            ).backward()
        launches[name] = fa.LAUNCHES - before
        grads[name] = {n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None}
    assert launches["dots_saveable"] == launches["nothing_saveable"] == 4 + 2
    for n, g in grads["nothing_saveable"].items():
        assert torch.equal(grads["dots_saveable"][n], g), n


@pytest.mark.cuda
def test_encoder_dropout_under_remat_on_the_card(cuda):
    """Dropout in every site of a small encoder, its masks from a CUDA
    generator: the gradients with remat equal those without, bit for bit."""
    from perceiverio_pytorch_tpu_torch.core.perceiver import PerceiverEncoder

    x = torch.randn(2, 40, 12, generator=torch.Generator().manual_seed(2)).cuda()
    grads = []
    for remat in (False, True):
        enc = PerceiverEncoder(num_input_channels=12, num_self_attends_per_block=2,
                               num_blocks=2, num_latents=8, num_latent_channels=32,
                               num_self_attend_heads=4, remat=remat, dropout_prob=0.2,
                               dropout_attn_prob=0.2,
                               generator=torch.Generator().manual_seed(0)).cuda().train()
        out = enc(x, enc.latents(x), generator=torch.Generator(device="cuda").manual_seed(3))
        out.square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in enc.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(grads[1][n], g), n


@pytest.mark.cuda
@pytest.mark.parametrize("kw,shape", [
    (dict(postproc_type="conv", n_outputs=3, spatial_upsample=4), (2, 3, 5, 6, 8)),
    (dict(postproc_type="conv", n_outputs=3, spatial_upsample=4, temporal_upsample=2),
     (1, 2, 5, 6, 8)),
    (dict(postproc_type="conv", n_outputs=2, spatial_upsample=2, temporal_upsample=4),
     (1, 2, 5, 6, 8)),
    (dict(postproc_type="conv1x1", n_outputs=3, spatial_upsample=2), (2, 3, 5, 6, 8)),
    (dict(postproc_type="patches", spatial_upsample=2), (2, 3, 5, 6, 8)),
])
def test_image_postprocessor_on_the_card(cuda, kw, shape):
    from perceiverio_pytorch_tpu_torch.io_processors import ImagePostprocessor

    gen = torch.Generator().manual_seed(0)
    module = ImagePostprocessor((8, 8), input_channels=shape[-1], generator=gen, **kw)
    x = torch.randn(shape, generator=gen)
    with torch.no_grad():
        want = module(x)
        got = module.to(cuda)(x.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_compiled_memory_stats_on_the_card(cuda):
    from perceiverio_pytorch_tpu_torch.utils import memory

    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(),
                                torch.nn.Linear(32, 4)).to(cuda)
    x = torch.randn(1024, 16, device=cuda)
    stats = memory.compiled_memory_stats(model, x)
    assert set(stats) == {"argument_bytes", "output_bytes", "temp_bytes", "code_bytes",
                          "peak_bytes"}
    weights = sum(p.numel() * 4 for p in model.parameters())
    assert stats["argument_bytes"] == weights + x.numel() * 4
    assert stats["output_bytes"] == 1024 * 4 * 4 and stats["code_bytes"] == 0
    assert stats["peak_bytes"] >= stats["argument_bytes"] + stats["output_bytes"]


@pytest.mark.cuda
def test_hbm_headroom_on_the_card(cuda):
    from perceiverio_pytorch_tpu_torch.utils import memory

    x = torch.ones(256, device=cuda)
    fits = memory.hbm_headroom(lambda t: t * 2, x)
    assert fits["fits"] and fits["hbm_bytes"] == torch.cuda.get_device_properties(0).total_memory
    over = fits["hbm_bytes"] // 4 + 1  # float32 elements past the card's memory
    verdict = memory.hbm_headroom(lambda t: t.new_empty(over), x)
    assert not verdict["fits"] and verdict["headroom_bytes"] < 0
    assert (x * 2).sum().item() == 512  # the allocator is usable afterwards


@pytest.mark.cuda
def test_op_stats_finds_k1_in_a_trace(cuda, tmp_path):
    from perceiverio_pytorch_tpu_torch.utils import profiling

    q, k, v, _, _ = _inputs(1, 128, 4096, 2, 64, 64, 0, cuda)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
    assert fa.LAUNCHES - launches == 3
    rows = [r for r in profiling.op_stats(str(tmp_path)) if "flash_fwd" in r["op"]]
    assert sum(r["occurrences"] for r in rows) == 3
    assert all(r["type"] == "kernel" and r["total_self_us"] > 0 for r in rows)
