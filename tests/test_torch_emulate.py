"""The port's CUDA kernels, their own C++ source, run on the host by the
test tool ``tests/_emulate`` (one thread per CUDA thread, wgmma read
through its descriptors) and held to their plain PyTorch versions on the
same inputs, made from a seed.

This checks on the CPU what the card's run checks first: index arithmetic,
masks, fragment layouts and the order of copies, barriers and products.
The gradients are held by the chip check's rules: bf16 elements within
1e-3 of the tensor's largest plus 1.6e-2 of their own magnitude (both sides
sum in fp32 and round once to bf16), fp32 within 1e-4 and 1e-3.
"""

import shutil

import pytest
import torch

import _emulate as emulate
from ray_tpu_torch.ops import attention as tattn

BF16_GRAD_RULE = (1e-3, 1.6e-2)
FP32_GRAD_RULE = (1e-4, 1e-3)


@pytest.fixture(scope="module")
def libs():
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the kernels needs g++")
    return {n: emulate.load(n) for n in tattn.KERNELS}


def _within(got, want, rule):
    a, r = rule
    limit = a * float(want.float().abs().max()) + r * want.float().abs()
    share = float(((got.float() - want.float()).abs() / limit).max())
    assert share <= 1.0, share
    return share


def _inputs(B, L, H, Hkv, D, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(B, L, H, D, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, L, Hkv, D, generator=g).to(dtype)
            for _ in range(2))
    return q, k, v, do


def _bwd(lib, q, k, v, o, lse, do, causal, sms=132):
    """ray_flash_bwd as the launchers of a card with ``sms``
    multiprocessors run it."""
    emulate.set_multiprocessors(lib, sms)
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    di = tattn.bwd_di(o, do)
    dq, dk, dv = (torch.full_like(t, float("nan")) for t in (q, k, v))
    rc = lib.ray_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), tattn._DTYPE_CODES[q.dtype], B, Lq, Lk, H, Hkv, D,
        tattn._strides(q, k, v, do, dq, dk, dv), D ** -0.5, int(causal),
        None)
    assert rc == 0
    return dq, dk, dv


BWD_CASES = [  # (B, L, H, Hkv, D, causal, multiprocessors): why
    (1, 200, 4, 2, 64, True, 132),    # ragged; 64-key dK/dV blocks
    (1, 200, 4, 2, 64, True, 1),      # the same with 128-key blocks
    (2, 128, 4, 1, 64, True, 1),      # batch, 4 query heads a kv head
    (1, 130, 2, 1, 128, False, 132),  # D = 128, full mask
    (1, 96, 2, 2, 128, True, 1),      # D = 128, causal, 128-key blocks
    (1, 197, 2, 2, 64, False, 132),   # ViT's: ragged, full mask, H = Hkv
    (1, 197, 2, 2, 64, False, 1),     # the same with 128-key blocks
]


@pytest.mark.parametrize("B,L,H,Hkv,D,causal,sms", BWD_CASES)
def test_bf16_backward_kernels_match_the_plain_version_on_the_host(
        libs, B, L, H, Hkv, D, causal, sms):
    """flash_bwd_dkdv_tc_kernel and flash_bwd_dq_tc_kernel (both dK/dV
    block sizes, chosen by the multiprocessors the launcher sees), a
    strided q, against flash_attention_bwd_plain; a second call gives the
    same bits."""
    q, k, v, do = _inputs(B, L, H, Hkv, D, torch.bfloat16, seed=L + D)
    q = torch.cat([q, q], dim=2)[:, :, H // 2:H // 2 + H]  # strided rows
    o, lse = tattn.flash_attention_plain(q, k, v, causal=causal,
                                         return_lse=True)
    got = _bwd(libs["flash_bwd"], q, k, v, o, lse, do, causal, sms)
    want = tattn.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                           causal=causal)
    for g, w in zip(got, want):
        _within(g, w, BF16_GRAD_RULE)
    again = _bwd(libs["flash_bwd"], q, k, v, o, lse, do, causal, sms)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_fp32_backward_kernels_match_the_plain_version_on_the_host(libs):
    q, k, v, do = _inputs(1, 77, 4, 2, 64, torch.float32, seed=3)
    o, lse = tattn.flash_attention_plain(q, k, v, causal=True,
                                         return_lse=True)
    got = _bwd(libs["flash_bwd"], q, k, v, o, lse, do, True)
    want = tattn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    for g, w in zip(got, want):
        _within(g, w, FP32_GRAD_RULE)


def test_forward_and_stats_kernels_match_their_plain_versions_on_the_host(
        libs):
    """flash_fwd_tc_kernel's output (phase 2's rule) and row log-sum-exp,
    and flash_stats_tc_kernel's o, m and l (phase 9's rule) on a ragged
    visible pattern."""
    q, k, v, _ = _inputs(1, 200, 4, 2, 64, torch.bfloat16, seed=4)
    o = torch.empty_like(q)
    lse = torch.empty(1, 4, 200)
    rc = libs["flash_fwd"].ray_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), 1, 1, 200, 200, 4, 2, 64, tattn._strides(q, k, v, o),
        0.125, 1, None)
    assert rc == 0
    want_o, want_lse = tattn.flash_attention_plain(q, k, v, causal=True,
                                                   return_lse=True)
    _within(o, want_o, (4e-3 / float(want_o.float().abs().max()), 1.6e-2))
    assert float((lse - want_lse).abs().max()) <= 1e-4

    visible = torch.randint(0, 201, (1, 4, 200), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(5))
    visible[:, :, :7] = 0  # rows that see nothing
    so, m, l = (torch.empty(1, 200, 4, 64), torch.empty(1, 4, 200),
                torch.empty(1, 4, 200))
    rc = libs["flash_stats"].ray_flash_stats(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), visible.data_ptr(),
        so.data_ptr(), m.data_ptr(), l.data_ptr(), 1, 1, 200, 200, 4, 2, 64,
        tattn._strides(q, k, v, so, visible.transpose(1, 2)), 0.125, None)
    assert rc == 0
    wo, wm, wl = tattn.flash_attention_stats_plain(q, k, v, visible,
                                                   scale=0.125)
    _within(so, wo, (1e-4 * max(1.0, float(wo.abs().max()))
                     / float(wo.abs().max()), 1e-4))
    _within(l, wl, (1e-4 * max(1.0, float(wl.abs().max()))
                    / float(wl.abs().max()), 1e-4))
    assert float((m - wm).abs().max()) <= 1e-4
    assert bool((m[:, :, :7] == tattn.NEG_INF).all())


@pytest.mark.parametrize("B,L,H,Hkv,D,causal", [
    (1, 197, 2, 2, 64, False),    # ViT's call: ragged, full mask, H = Hkv
    (2, 130, 2, 2, 128, False),   # D = 128, a ragged last key block
])
def test_forward_kernel_masks_ragged_keys_without_causality_on_the_host(
        libs, B, L, H, Hkv, D, causal):
    """flash_fwd_tc_kernel at a length no tile divides with every key
    visible: only the key mask stops the last block's padding; the output
    (phase 2's rule) and the rows' log-sum-exp against the plain version."""
    q, k, v, _ = _inputs(B, L, H, Hkv, D, torch.bfloat16, seed=L + D + 7)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, L)
    rc = libs["flash_fwd"].ray_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), 1, B, L, L, H, Hkv, D, tattn._strides(q, k, v, o),
        D ** -0.5, int(causal), None)
    assert rc == 0
    want_o, want_lse = tattn.flash_attention_plain(q, k, v, causal=causal,
                                                   return_lse=True)
    _within(o, want_o, (4e-3 / float(want_o.float().abs().max()), 1.6e-2))
    assert float((lse - want_lse).abs().max()) <= 1e-4
