"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: the kernels build with nvcc and run only on an NVIDIA GPU,
so without one these tests skip (a CUDA kernel has no CPU mode; the CPU
tests hold the plain versions to the JAX package instead). Run them on the
card with ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``."""

import pytest
import torch

from deepspeed_tpu_torch.ops import paged_decode_attention as pda
from deepspeed_tpu_torch.ops import paged_multitoken_attention as pma

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2),
                                       (torch.float16, 1e-2)])
@pytest.mark.parametrize("H,KV,D,page", [(16, 16, 64, 16), (16, 8, 64, 16),
                                         (8, 8, 128, 8), (4, 2, 256, 64)])
def test_paged_decode_kernel_matches_plain_version(card, dtype, tol, H, KV, D, page):
    g = torch.Generator(device=card).manual_seed(0)
    B, P, n = 4, 40, 8
    q = torch.randn(B, H, D, generator=g, device=card).to(dtype)
    k = torch.randn(P, KV, page, D, generator=g, device=card).to(dtype)
    v = torch.randn(P, KV, page, D, generator=g, device=card).to(dtype)
    bt = torch.randperm(P - 1, generator=g, device=card)[: B * n].add(1).reshape(B, n).int()
    bt[3] = 0  # an inactive slot on the scratch page
    pos = torch.tensor([0, page - 1, page, n * page + 7], dtype=torch.int32, device=card)
    before = pda.LAUNCHES
    out = pda.paged_decode_attention(q, k, v, bt, pos)
    torch.cuda.synchronize()
    assert pda.LAUNCHES == before + 1
    ref = pda.paged_decode_attention_ref(q.float(), k.float(), v.float(), bt, pos)
    assert (out.float() - ref).abs().max().item() <= tol


def test_paged_decode_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros(2, 4, 32, device=card)  # head dim 32 is not built
    k = torch.zeros(8, 4, 16, 32, device=card)
    bt = torch.ones(2, 2, dtype=torch.int32, device=card)
    pos = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head dim"):
        pda.paged_decode_attention(q, k, k, bt, pos)
    with pytest.raises(TypeError, match="int32"):
        pda.paged_decode_attention(q, k, k, bt.long(), pos)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2),
                                       (torch.float16, 1e-2)])
@pytest.mark.parametrize("T,H,KV,D,page", [(64, 16, 16, 64, 16), (5, 16, 8, 64, 16),
                                           (37, 8, 8, 128, 8), (3, 4, 2, 256, 64)])
def test_paged_multitoken_kernel_matches_plain_version(card, dtype, tol, T, H, KV, D, page):
    g = torch.Generator(device=card).manual_seed(0)
    B, P, n = 4, 48, 8
    q = torch.randn(B, T, H, D, generator=g, device=card).to(dtype)
    k = torch.randn(P, KV, page, D, generator=g, device=card).to(dtype)
    v = torch.randn(P, KV, page, D, generator=g, device=card).to(dtype)
    bt = torch.randperm(P - 1, generator=g, device=card)[: B * n].add(1).reshape(B, n).int()
    bt[3] = 0  # an inactive slot on the scratch page
    base = torch.tensor([0, page - 1, page + 3, n * page - 2], dtype=torch.int32, device=card)
    before = pma.LAUNCHES
    out = pma.paged_multitoken_attention(q, k, v, bt, base)
    torch.cuda.synchronize()
    assert pma.LAUNCHES == before + 1
    ref = pma.paged_multitoken_attention_ref(q.float(), k.float(), v.float(), bt, base)
    assert (out.float() - ref).abs().max().item() <= tol


def test_paged_multitoken_kernel_at_t1_is_the_decode_kernel(card):
    g = torch.Generator(device=card).manual_seed(1)
    B, H, D, page, P, n = 4, 16, 64, 16, 40, 8
    q = torch.randn(B, 1, H, D, generator=g, device=card)
    k = torch.randn(P, H, page, D, generator=g, device=card)
    v = torch.randn(P, H, page, D, generator=g, device=card)
    bt = torch.randperm(P - 1, generator=g, device=card)[: B * n].add(1).reshape(B, n).int()
    base = torch.tensor([0, 15, 16, 100], dtype=torch.int32, device=card)
    mt = pma.paged_multitoken_attention(q, k, v, bt, base)
    st = pda.paged_decode_attention(q[:, 0].contiguous(), k, v, bt, base)
    torch.cuda.synchronize()
    assert (mt[:, 0] - st).abs().max().item() <= 1e-5


def test_paged_multitoken_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros(2, 3, 4, 64, device=card)
    k = torch.zeros(8, 4, 16, 64, device=card)
    bt = torch.ones(2, 2, dtype=torch.int32, device=card)
    base = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="T="):
        pma.paged_multitoken_attention(torch.zeros(2, 1025, 4, 64, device=card), k, k, bt, base)
    with pytest.raises(TypeError, match="int32"):
        pma.paged_multitoken_attention(q, k, k, bt, base.long())
    with pytest.raises(ValueError, match="contiguous"):
        pma.paged_multitoken_attention(
            torch.zeros(2, 4, 3, 64, device=card).transpose(1, 2), k, k, bt, base)
