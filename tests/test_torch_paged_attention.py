"""The port's ``paged_attention`` (bigdl_tpu_torch/ops/paged_attention.py)
against the JAX package's Pallas kernel run in interpret mode.

On the CPU the port's wrapper takes its plain PyTorch version (the CUDA
kernel is held against that same plain version on the card by
``chip_smoke.py``).  Inputs come from a numpy seed and go through both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import pallas_kernels as pk
from bigdl_tpu_torch import ops

TOL = dict(rtol=1e-5, atol=1e-6)


def _case(rs, bsz, S, P, page_size, n_pages, H=2, hd=8,
          share_first_page=False):
    """tests/test_paged_attention.py ``_case`` (fp32): row 0 at the
    minimal window position, so its reserved tail pages are fully
    masked; the last row at the final view position."""
    q = rs.randn(bsz, S, H, hd).astype(np.float32)
    kpool = rs.randn(n_pages, page_size, H, hd).astype(np.float32)
    vpool = rs.randn(n_pages, page_size, H, hd).astype(np.float32)
    perm = rs.permutation(n_pages)
    ptab = perm[:bsz * P].reshape(bsz, P)
    if share_first_page:
        ptab[:, 0] = perm[0]
    ptab = ptab.astype(np.int32)
    t_last = np.linspace(S - 1, P * page_size - 1, bsz).round().astype(
        np.int32)
    pos = (t_last[:, None] - (S - 1) + np.arange(S)[None, :]).astype(
        np.int32)
    return q, kpool, vpool, ptab, pos


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
    args = _case(rs, bsz=2, S=1, P=2, page_size=4, n_pages=5)
    ops.paged_attention(*(torch.from_numpy(a) for a in args))
    assert set(ops.launch_counts().values()) == {0}


def test_int8_pools_raise():
    rs = np.random.RandomState(1)
    q, kpool, vpool, ptab, pos = (torch.from_numpy(a) for a in _case(
        rs, bsz=2, S=1, P=2, page_size=4, n_pages=5))
    with pytest.raises(NotImplementedError, match="int8"):
        ops.paged_attention(q, kpool.to(torch.int8), vpool.to(torch.int8),
                            ptab, pos)
    scale = torch.ones(kpool.shape[:3])
    with pytest.raises(NotImplementedError, match="int8"):
        ops.paged_attention(q, kpool, vpool, ptab, pos, scale, scale)


def test_no_plain_path_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version:
    the wrapper launches its kernel or raises."""
    rs = np.random.RandomState(2)
    args = [torch.from_numpy(a).to("meta") for a in _case(
        rs, bsz=2, S=1, P=2, page_size=4, n_pages=5)]
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_attention(*args)
