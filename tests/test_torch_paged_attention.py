"""The port's ``paged_attention`` (bigdl_tpu_torch/ops/paged_attention.py)
against the JAX package's Pallas kernel run in interpret mode, fp32 and
int8 pools; the plain version of the kernel's split walk and merge at
the split plan's counts, and the plan mirrored from the kernel source.

On the CPU the port's wrappers take their plain PyTorch versions (the
CUDA kernel is held against those same plain versions on the card by
``chip_smoke.py``).  Inputs come from a numpy seed and go through both.
Tolerance: tests/test_paged_attention.py's own, rtol 1e-5 / atol 1e-6,
for both pool types.
"""
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import pallas_kernels as pk
from bigdl_tpu.quant import kv as jax_kvq
from bigdl_tpu_torch import ops

paged = importlib.import_module("bigdl_tpu_torch.ops.paged_attention")

TOL = dict(rtol=1e-5, atol=1e-6)


def _case(rs, bsz, S, P, page_size, n_pages, H=2, hd=8,
          share_first_page=False, quantized=False):
    """tests/test_paged_attention.py ``_case``: row 0 at the minimal
    window position, so its reserved tail pages are fully masked; the
    last row at the final view position.  ``quantized``: int8 pools and
    per-(page row, head) scales drawn as there; the scales come last."""
    q = rs.randn(bsz, S, H, hd).astype(np.float32)
    if quantized:
        kpool = rs.randint(-127, 128, (n_pages, page_size, H, hd)).astype(
            np.int8)
        vpool = rs.randint(-127, 128, (n_pages, page_size, H, hd)).astype(
            np.int8)
        scales = [(0.01 + 0.05 * rs.rand(n_pages, page_size, H)).astype(
            np.float32) for _ in range(2)]
    else:
        kpool = rs.randn(n_pages, page_size, H, hd).astype(np.float32)
        vpool = rs.randn(n_pages, page_size, H, hd).astype(np.float32)
        scales = []
    perm = rs.permutation(n_pages)
    ptab = perm[:bsz * P].reshape(bsz, P)
    if share_first_page:
        ptab[:, 0] = perm[0]
    ptab = ptab.astype(np.int32)
    t_last = np.linspace(S - 1, P * page_size - 1, bsz).round().astype(
        np.int32)
    pos = (t_last[:, None] - (S - 1) + np.arange(S)[None, :]).astype(
        np.int32)
    return (q, kpool, vpool, ptab, pos, *scales)


def _jax_gathered(q, kpool, vpool, ptab, pos, kscale, vscale):
    """tests/test_paged_attention.py ``_ref_attention``, int8 branch: the
    dequantized gathered view, masked softmax, in JAX."""
    bsz, S, H, hd = q.shape
    n_view = ptab.shape[1] * kpool.shape[1]
    kview = jax_kvq.dequantize_view(kpool[ptab], kscale[ptab]).reshape(
        bsz, n_view, H, hd)
    vview = jax_kvq.dequantize_view(vpool[ptab], vscale[ptab]).reshape(
        bsz, n_view, H, hd)
    s = jnp.einsum("bshd,bthd->bhst", q, kview) / np.sqrt(hd)
    mask = jnp.arange(n_view)[None, None, None, :] <= pos[:, None, :, None]
    p = jax.nn.softmax(jnp.where(mask, s, -jnp.inf), axis=-1)
    return jnp.einsum("bhst,bthd->bshd", p, vview)


@pytest.mark.parametrize("ps,P", [(4, 3), (2, 2), (5, 1)])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_matches_pallas_interpret(S, ps, P):
    rs = np.random.RandomState(10 * S + ps)
    args = _case(rs, bsz=3, S=S, P=P, page_size=ps, n_pages=3 * P + 1,
                 share_first_page=(S == 2))
    want = pk.paged_attention(*(jnp.asarray(a) for a in args),
                              interpret=True)
    got = ops.paged_attention(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_never_counts_a_launch():
    ops.reset_launch_counts()
    rs = np.random.RandomState(0)
    for quantized in (False, True):
        args = _case(rs, bsz=2, S=1, P=2, page_size=4, n_pages=5,
                     quantized=quantized)
        ops.paged_attention(*(torch.from_numpy(a) for a in args))
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("S,shared", [(1, False), (3, False), (3, True)],
                         ids=["S1", "S3", "S3-shared-head-page"])
def test_int8_matches_pallas_interpret(S, shared):
    """tests/test_paged_attention.py's ``_case(quantized=True)`` shapes
    (ps 4, P 3, 10 pages): the plain int8 version against the JAX kernel
    in interpret mode and against the JAX gathered-view reference."""
    rs = np.random.RandomState(100 + S)
    args = _case(rs, bsz=3, S=S, P=3, page_size=4, n_pages=10,
                 quantized=True, share_first_page=shared)
    jargs = [jnp.asarray(a) for a in args]
    want = pk.paged_attention(*jargs, interpret=True)
    got = ops.paged_attention(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_gathered(*jargs)),
                               **TOL)
    again = ops.paged_attention_int8(*(torch.from_numpy(a) for a in args))
    assert torch.equal(again, got)


def test_int8_equals_fp32_over_the_dequantized_pools():
    """The int8 plain version is the fp32 one over the pools
    ``quant.kv.dequantize_view`` gives back."""
    rs = np.random.RandomState(7)
    q, kq, vq, ptab, pos, ks, vs = (torch.from_numpy(a) for a in _case(
        rs, bsz=3, S=2, P=3, page_size=5, n_pages=10, quantized=True))
    from bigdl_tpu_torch.quant.kv import dequantize_view
    want = ops.paged_attention(q, dequantize_view(kq, ks),
                               dequantize_view(vq, vs), ptab, pos)
    got = ops.paged_attention(q, kq, vq, ptab, pos, ks, vs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_int8_pools_raise():
    """A mix of int8 and fp32 inputs raises before any attention runs:
    int8 pools without scales, scales with fp32 pools, one int8 pool,
    one scale array, scales of another shape or type."""
    rs = np.random.RandomState(1)
    q, kq, vq, ptab, pos, ks, vs = (torch.from_numpy(a) for a in _case(
        rs, bsz=2, S=1, P=2, page_size=4, n_pages=5, quantized=True))
    kf, vf = kq.float(), vq.float()
    for bad in ((kq, vq, None, None), (kf, vf, ks, vs), (kq, vf, ks, vs),
                (kq, vq, ks, None), (kq, vq, None, vs)):
        with pytest.raises(ValueError, match="int8 pools come with both"):
            ops.paged_attention(q, bad[0], bad[1], ptab, pos, *bad[2:])
    with pytest.raises(ValueError, match="scale shape"):
        ops.paged_attention(q, kq, vq, ptab, pos, ks[:, :2], vs[:, :2])
    with pytest.raises(ValueError, match="scale shape"):
        ops.paged_attention_int8(q, kq, vq, ptab, pos, ks, vs[..., None])
    with pytest.raises(TypeError, match="float32"):
        ops.paged_attention(q, kq, vq, ptab, pos, ks.double(), vs)
    with pytest.raises(ValueError, match="must be int8"):
        ops.paged_attention_int8(q, kf, vf, ptab, pos, None, None)


def test_no_plain_path_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version:
    the wrapper launches its kernel or raises."""
    rs = np.random.RandomState(2)
    for quantized in (False, True):
        args = [torch.from_numpy(a).to("meta") for a in _case(
            rs, bsz=2, S=1, P=2, page_size=4, n_pages=5,
            quantized=quantized)]
        with pytest.raises(ValueError, match="no kernel"):
            ops.paged_attention(*args)


# (P, each row's last position, the plan's split count at B 3, H 2): a
# table too short to split; eight splits whose rows reach into every
# split; eight where row 0's keys all lie in the first split (its other
# seven have no live page); and eight with a row never admitted (pos < 0
# throughout)
SPLIT_CASES = {"one split": (3, [1, 5, 11], 1),
               "several": (32, [115, 120, 127], 8),
               "empty split": (32, [2, 127, 50], 8),
               "dead row": (32, [-1, 127, 60], 8)}


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_and_merge_matches_pallas_interpret(case, quantized):
    """The plain split-and-merge version at the plan's split count (and
    at one split, two, and one page a split) against the JAX kernel in
    interpret mode and the gathered-view plain version, on live rows, in
    S = 2 windows; a row with pos < 0 comes out 0."""
    P, last, want_splits = SPLIT_CASES[case]
    assert paged.split_count(3, 2, P) == want_splits
    rs = np.random.RandomState(len(case) + 10 * quantized)
    args = list(_case(rs, bsz=3, S=2, P=P, page_size=4, n_pages=3 * P + 1,
                      quantized=quantized))
    pos = np.asarray(last)[:, None] - 1 + np.arange(2)[None, :]
    args[4] = np.where(np.asarray(last)[:, None] < 0, -1, pos).astype(
        np.int32)
    per = -(-P // want_splits)
    empty = [k * per > t // 4 for t in last for k in range(want_splits)]
    assert any(empty) == (case in ("empty split", "dead row"))
    want = np.asarray(pk.paged_attention(*(jnp.asarray(a) for a in args),
                                         interpret=True))
    t = [torch.from_numpy(a) for a in args]
    got = paged.paged_attention_split_reference(*t[:5], None, *t[5:])
    live = args[4] >= 0
    np.testing.assert_allclose(got.numpy()[live], want[live], **TOL)
    np.testing.assert_allclose(got.numpy()[live],
                               ops.paged_attention(*t).numpy()[live], **TOL)
    assert not got.numpy()[~live].any()
    for n in (1, 2, P):
        np.testing.assert_allclose(paged.paged_attention_split_reference(
            *t[:5], n, *t[5:]).numpy(), got.numpy(), **TOL)


def test_split_plan_mirrors_the_kernel_source():
    """ops.paged_attention's ``split_count`` is csrc/paged_attention.cu's:
    the same constants and steps, and every split count it gives leaves
    no page range empty by construction."""
    src = (Path(paged.__file__).parents[1] / "csrc"
           / "paged_attention.cu").read_text()
    for line in (f"constexpr int kSms = {paged.SMS};",
                 f"constexpr int kSplitBlocks = {paged.SPLIT_BLOCKS};",
                 f"constexpr int kMinSplitPages = {paged.MIN_SPLIT_PAGES};",
                 f"constexpr int kSplitFromPages = {paged.SPLIT_FROM_PAGES};",
                 "if (P < kSplitFromPages) return 1;",
                 "int n = (kSplitBlocks * kSms + rows - 1) / rows;",
                 "const int most = (P + kMinSplitPages - 1) / kMinSplitPages;",
                 "const int pages = (P + n - 1) / n;",
                 "return (P + pages - 1) / pages;",
                 "dim3(B * H, part.splits)"):
        assert line in src, line
    for b in (1, 3, 8, 16, 64):
        for p in (1, 2, 3, 9, 24, 64, 100):
            n = paged.split_count(b, 4, p)
            per = -(-p // n)
            assert 1 <= n and (n - 1) * per < p <= n * per


# (B, H, P) -> splits: the decode step's width at a full 64-page table
# (the kernel phase), at the 24-page table serving's requests reach and at
# the shortest table that is split, the fixtures' small tables, the
# longest table that is not split, a wider batch, one row, a table of four
# pages and a batch that fills the SMs twice over
SPLIT_PLANS = {(8, 4, 64): 16, (8, 4, 24): 6, (8, 4, 8): 2, (3, 2, 3): 1,
               (3, 2, 9): 3, (3, 2, 32): 8, (3, 2, 7): 1, (16, 8, 64): 5,
               (1, 1, 64): 16, (8, 4, 4): 1, (64, 4, 64): 3}


@pytest.mark.parametrize("shape", list(SPLIT_PLANS))
def test_split_plan_is_pinned(shape):
    assert paged.split_count(*shape) == SPLIT_PLANS[shape]
