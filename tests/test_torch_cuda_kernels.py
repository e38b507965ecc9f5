"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: the kernels build with nvcc and run only on an NVIDIA GPU,
so without one these tests skip (a CUDA kernel has no CPU mode; the CPU
tests hold the plain versions to the JAX package instead). Run them on the
card with ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``."""

import pytest
import torch

from deepspeed_tpu_torch.ops import paged_decode_attention as pda
from deepspeed_tpu_torch.ops import paged_multitoken_attention as pma
from deepspeed_tpu_torch.ops.launches import counts

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
    before = pda.LAUNCHES["paged_decode_attention"]
    out = pda.paged_decode_attention(q, k, v, bt, pos)
    torch.cuda.synchronize()
    assert pda.LAUNCHES["paged_decode_attention"] == before + 1
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
    before = pma.LAUNCHES["paged_multitoken_attention"]
    out = pma.paged_multitoken_attention(q, k, v, bt, base)
    torch.cuda.synchronize()
    assert pma.LAUNCHES["paged_multitoken_attention"] == before + 1
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


# ---- flash attention (training path) ---------------------------------------

from deepspeed_tpu_torch.ops import flash_attention as fa  # noqa: E402

FLASH_TOL = {torch.float32: 1e-5, torch.float16: 2e-2, torch.bfloat16: 2e-2}
# max abs error over max |ref|: a systematic error of 5%, or a query tile left
# out of dk/dv, fails at any output scale (about 5e-2), a one-ulp flip of every
# bf16 output passes (about 7e-3)
FLASH_REL_TOL = {torch.float32: 1e-5, torch.float16: 1.5e-2, torch.bfloat16: 1.5e-2}
LSE_REL_TOL = 1e-5


def _flash_inputs(card, B, S, H, KV, D, dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g, device=card).to(dtype)
    k = torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
    v = torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
    do = (torch.randn(B, S, H, D, generator=g, device=card) * 0.1).to(dtype)
    return q, k, v, do


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _scaled_err(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", [
    (2, 256, 4, 4, 64, True, None),
    (1, 384, 8, 2, 128, True, None),
    (1, 128, 2, 2, 256, False, None),
    (2, 384, 4, 4, 64, True, 100),
    (1, 200, 4, 2, 64, True, None),
])
def test_flash_kernels_match_plain_versions(card, dtype, B, S, H, KV, D, causal, window):
    q, k, v, do = _flash_inputs(card, B, S, H, KV, D, dtype)
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, None, window)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, None, window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert fa.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, causal, None, window)
    grads_ref = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, causal, None, window)
    tol, rel_tol = FLASH_TOL[dtype], FLASH_REL_TOL[dtype]
    assert _max_err(o, o_ref) <= tol
    assert _scaled_err(o, o_ref) <= rel_tol
    assert _max_err(lse, lse_ref) <= max(tol, 1e-4)
    assert _scaled_err(lse, lse_ref) <= LSE_REL_TOL
    for got, ref in zip((dq, dk, dv), grads_ref):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert _max_err(got, ref) <= tol
        assert _scaled_err(got, ref) <= rel_tol


def test_flash_autograd_through_qkv_views(card):
    """q, k, v as strided views of one [B, S, 3E] projection, as the GPT-2
    trunk hands them over: no copies, and the grads match the plain path."""
    B, S, H, D = 2, 256, 4, 64
    g = torch.Generator(device=card).manual_seed(3)
    qkv = torch.randn(B, S, 3 * H * D, generator=g, device=card).to(torch.bfloat16)
    qkv.requires_grad_(True)
    do = (torch.randn(B, S, H, D, generator=g, device=card) * 0.1).to(torch.bfloat16)

    def run(x, device_fn):
        q, k, v = (t.unflatten(-1, (H, D)) for t in x.split(H * D, dim=-1))
        return device_fn(q, k, v)

    o = run(qkv, fa.flash)
    (gk,) = torch.autograd.grad(o, qkv, do)
    ref = qkv.detach().float().cpu().requires_grad_(True)
    o_ref = run(ref, fa.flash)  # CPU tensors: the plain versions
    (gr,) = torch.autograd.grad(o_ref, ref, do.float().cpu())
    assert _max_err(o.cpu(), o_ref) <= 2e-2
    assert _max_err(gk.cpu(), gr) <= 2e-2
    assert _scaled_err(o.cpu(), o_ref) <= FLASH_REL_TOL[torch.bfloat16]
    assert _scaled_err(gk.cpu(), gr) <= FLASH_REL_TOL[torch.bfloat16]


def test_flash_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros(1, 128, 2, 32, device=card, dtype=torch.bfloat16)  # head dim 32
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 128, 2, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_fwd(q, q.float(), q)
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention_fwd(torch.zeros(1, 128, 2, 66, device=card)[..., :64], q.float(), q.float())
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.flash_attention(q[:, :100], q[:, :100], q[:, :100])


def _qkv_views(card, B, S, H, KV, D, dtype, seed):
    """q, k, v as strided views of one [B, S, (H + 2 KV) D] projection."""
    g = torch.Generator(device=card).manual_seed(seed)
    qkv = torch.randn(B, S, (H + 2 * KV) * D, generator=g, device=card).to(dtype)
    q, k, v = qkv.split([H * D, KV * D, KV * D], dim=-1)
    return q.unflatten(-1, (H, D)), k.unflatten(-1, (KV, D)), v.unflatten(-1, (KV, D))


def _check_forward(q, k, v, causal=True, window=None):
    o, lse = fa.flash_attention_fwd(q, k, v, causal, None, window)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, causal, None, window)
    tol, rel_tol = FLASH_TOL[q.dtype], FLASH_REL_TOL[q.dtype]
    assert o.shape == o_ref.shape and lse.shape == lse_ref.shape
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert _max_err(o, o_ref) <= tol and _scaled_err(o, o_ref) <= rel_tol
    assert _max_err(lse, lse_ref) <= max(tol, 1e-4) and _scaled_err(lse, lse_ref) <= LSE_REL_TOL
    return o, lse


@pytest.mark.parametrize("S", [1, 63, 127, 129, 1000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_forward_on_qkv_views_at_ragged_lengths(card, S, dtype):
    """The forward's tensor maps read q/k/v through the projection's strides;
    rows past S arrive zero-filled and nothing past S is written."""
    _check_forward(*_qkv_views(card, 2, S, 4, 4, 64, dtype, seed=S))


@pytest.mark.parametrize("B,S,H,KV,D,dtype,causal,window", [
    (2, 512, 4, 4, 64, torch.bfloat16, True, 200),   # a window crossing 128-row tiles
    (1, 640, 2, 2, 64, torch.bfloat16, True, 129),
    (2, 128, 4, 4, 64, torch.bfloat16, False, None),
    (2, 512, 4, 4, 64, torch.bfloat16, False, None),
    (1, 512, 4, 4, 64, torch.float16, False, None),
    (2, 384, 4, 2, 128, torch.bfloat16, True, None),
    (1, 300, 4, 4, 128, torch.float16, False, None),
    (2, 256, 8, 2, 64, torch.bfloat16, True, None),
])
def test_flash_forward_cases(card, B, S, H, KV, D, dtype, causal, window):
    q, k, v, _ = _flash_inputs(card, B, S, H, KV, D, dtype, seed=S + D)
    _check_forward(q, k, v, causal, window)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_forward_repeats_bit_for_bit(card, D):
    q, k, v, _ = _flash_inputs(card, 2, 640, 4, 4, D, torch.bfloat16, seed=7)
    o1, lse1 = fa.flash_attention_fwd(q, k, v)
    o2, lse2 = fa.flash_attention_fwd(q, k, v)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_flash_forward_refuses_strides_a_tensor_map_cannot_take(card):
    q = torch.zeros(2, 128, 2, 64, device=card, dtype=torch.bfloat16)
    kb = torch.zeros(1, 128, 2, 64, device=card, dtype=torch.bfloat16).expand(2, -1, -1, -1)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention_fwd(q, kb, q)
    with pytest.raises(ValueError, match="strides"):  # a row not a multiple of 16 bytes
        fa.flash_attention_fwd(torch.zeros(2, 128, 2, 68, device=card,
                                           dtype=torch.bfloat16)[..., :64], q, q)


def test_causal_attention_on_the_card_runs_the_kernels_or_raises(card):
    from deepspeed_tpu_torch.ops.attention import causal_attention

    q = torch.randn(1, 200, 2, 64, device=card, dtype=torch.bfloat16)
    before = fa.LAUNCHES["flash_attention_fwd"]
    causal_attention(q, q, q)  # a ragged S goes to the kernel too
    assert fa.LAUNCHES["flash_attention_fwd"] == before + 1
    with pytest.raises(ValueError, match="jnp"):
        causal_attention(q, q, q, impl="jnp")


# ---- int8 modes of the paged kernels (serving with int8 KV pages) -----------

from deepspeed_tpu_torch.ops import decode_attention as tda  # noqa: E402
from deepspeed_tpu_torch.ops.quantizer import quantize_kv_pages  # noqa: E402


def _int8_pools(card, P, KV, page, D, g):
    """Pools quantized from random f32 pages; page 1 keeps scale 0 (a
    never-written page) and the scratch page 0 holds garbage codes."""
    kq, ks = quantize_kv_pages(torch.randn(P, KV, page, D, generator=g, device=card))
    vq, vs = quantize_kv_pages(torch.randn(P, KV, page, D, generator=g, device=card))
    scales = torch.stack([ks, vs], dim=-1).contiguous()
    scales[1] = 0.0
    kq[0] = torch.randint(-127, 128, kq[0].shape, generator=g, device=card).to(torch.int8)
    return kq, vq, scales


@pytest.mark.parametrize("qdtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("H,KV,D,page", [(16, 16, 64, 16), (16, 4, 64, 16),
                                         (8, 8, 128, 8), (4, 2, 256, 64)])
def test_int8_paged_decode_kernel_matches_plain_version(card, qdtype, tol, H, KV, D, page):
    g = torch.Generator(device=card).manual_seed(2)
    B, P, n = 4, 40, 8
    q = torch.randn(B, H, D, generator=g, device=card).to(qdtype)
    kq, vq, sc = _int8_pools(card, P, KV, page, D, g)
    bt = torch.randperm(P - 2, generator=g, device=card)[: B * n].add(2).reshape(B, n).int()
    bt[0, 1] = 1  # the fresh page inside slot 0's live range: values 0
    bt[3] = 0  # an inactive slot on the scratch page
    pos = torch.tensor([page + 3, page - 1, 3 * page, n * page + 7], dtype=torch.int32,
                       device=card)
    before = counts(pda.KERNELS)
    out = pda.paged_decode_attention(q, kq, vq, bt, pos, scales=sc)
    torch.cuda.synchronize()
    assert counts(pda.KERNELS) == {"paged_decode_attention": before["paged_decode_attention"],
                                   "paged_decode_attention_int8":
                                   before["paged_decode_attention_int8"] + 1}
    ref = pda.paged_decode_attention_ref(q.float(), kq, vq, bt, pos, scales=sc)
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("qdtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("T,H,KV,D,page", [(64, 16, 16, 64, 16), (5, 16, 4, 64, 16),
                                           (37, 8, 8, 128, 8), (3, 4, 2, 256, 64)])
def test_int8_paged_multitoken_kernel_matches_plain_version(card, qdtype, tol, T, H, KV, D,
                                                            page):
    g = torch.Generator(device=card).manual_seed(3)
    B, P, n = 4, 48, 8
    q = torch.randn(B, T, H, D, generator=g, device=card).to(qdtype)
    kq, vq, sc = _int8_pools(card, P, KV, page, D, g)
    bt = torch.randperm(P - 2, generator=g, device=card)[: B * n].add(2).reshape(B, n).int()
    bt[0, 0] = 1
    bt[3] = 0
    base = torch.tensor([0, page - 1, page + 3, n * page - 2], dtype=torch.int32, device=card)
    before = pma.LAUNCHES["paged_multitoken_attention_int8"]
    out = pma.paged_multitoken_attention(q, kq, vq, bt, base, scales=sc)
    torch.cuda.synchronize()
    assert pma.LAUNCHES["paged_multitoken_attention_int8"] == before + 1
    ref = pma.paged_multitoken_attention_ref(q.float(), kq, vq, bt, base, scales=sc)
    assert (out.float() - ref).abs().max().item() <= tol


def test_int8_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros(2, 4, 64, device=card)
    kq = torch.zeros(8, 4, 16, 64, dtype=torch.int8, device=card)
    bt = torch.ones(2, 2, dtype=torch.int32, device=card)
    pos = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="needs its scales"):
        pda.paged_decode_attention(q, kq, kq, bt, pos)
    with pytest.raises(ValueError, match="float32"):
        pda.paged_decode_attention(q, kq, kq, bt, pos,
                                   scales=torch.zeros(8, 4, 2, device=card).half())
    with pytest.raises(TypeError, match="int8"):
        pda.paged_decode_attention(q, kq.float(), kq.float(), bt, pos,
                                   scales=torch.zeros(8, 4, 2, device=card))


# ---- contiguous decode attention (offline generate) -------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2),
                                       (torch.float16, 1e-2)])
@pytest.mark.parametrize("B,S,H,KV,D,pos", [(8, 256, 16, 16, 64, 137), (2, 4096, 8, 8, 64, 4095),
                                            (3, 64, 8, 2, 128, 0), (2, 300, 4, 4, 256, 299)])
def test_decode_kernel_matches_plain_version(card, dtype, tol, B, S, H, KV, D, pos):
    g = torch.Generator(device=card).manual_seed(4)
    q = torch.randn(B, H, D, generator=g, device=card).to(dtype)
    # a layer's strided slice of a stacked [L, B, S, KV, D] cache; rows
    # past pos hold huge values the kernel must never read
    k = torch.randn(2, B, S, KV, D, generator=g, device=card).to(dtype)
    v = torch.randn(2, B, S, KV, D, generator=g, device=card).to(dtype)
    k[:, :, pos + 1:], v[:, :, pos + 1:] = 1e4, -1e4
    before = tda.LAUNCHES["decode_attention"]
    out = tda.decode_attention(q, k[1], v[1], _dpos(pos, card))
    torch.cuda.synchronize()
    assert tda.LAUNCHES["decode_attention"] == before + 1
    ref = tda.decode_attention_ref(q.float(), k[1].float(), v[1].float(), pos)
    assert (out.float() - ref).abs().max().item() <= tol


def _dpos(pos, card):
    """``pos`` as the kernel reads it: int32 ``[1]`` on the card."""
    return torch.full((1,), pos, dtype=torch.int32, device=card)


def _decode_check(card, B, S, H, KV, D, pos, dtype=torch.bfloat16, seed=5):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(B, H, D, generator=g, device=card).to(dtype)
    k = torch.randn(3, B, S, KV, D, generator=g, device=card).to(dtype)
    v = torch.randn(3, B, S, KV, D, generator=g, device=card).to(dtype)
    k[:, :, pos + 1:], v[:, :, pos + 1:] = 1e4, -1e4
    out = tda.decode_attention(q, k[2], v[2], _dpos(pos, card))  # the layer slice, strided
    torch.cuda.synchronize()
    ref = tda.decode_attention_ref(q.float(), k[2].float(), v[2].float(), pos)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert (out.float() - ref).abs().max().item() <= tol
    assert ((out.float() - ref).abs().max() / ref.abs().max()).item() <= tol
    return q, k[2], v[2], out


@pytest.mark.parametrize("B,S,H,KV", [(8, 256, 16, 16), (2, 1024, 16, 4), (1, 600, 8, 1),
                                      (2, 2048, 16, 16)])
def test_decode_kernel_at_every_split_edge(card, B, S, H, KV):
    """pos on both sides of every chunk edge the planner draws (from Smax
    alone: chunks past pos are empty), pos 0 and Smax - 1, every 37th row,
    against the plain version, garbage past pos."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    positions = {0, S - 1} | set(range(1, S, 37))
    _, _, splits, chunk = tda.kernel_plan(B, H, KV, 64, 2, S, sms)
    for e in range(1, splits + 1):
        positions.update({min(e * chunk - 1, S - 1), min(e * chunk, S - 1)})
    for pos in sorted(positions):
        _decode_check(card, B, S, H, KV, 64, pos)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_long_cache_and_repeat(card, dtype):
    """Smax 8192 at its last row (64 chunks), twice: the merge runs in a
    fixed order, so the two outputs agree bit for bit."""
    q, k, v, out = _decode_check(card, 2, 8192, 8, 8, 64, 8191, dtype)
    again = tda.decode_attention(q, k, v, _dpos(8191, card))
    assert torch.equal(out, again)


def test_decode_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros(2, 4, 32, device=card)  # head dim 32 is not built
    k = torch.zeros(2, 16, 4, 32, device=card)
    pos = _dpos(3, card)
    with pytest.raises(ValueError, match="head dim"):
        tda.decode_attention(q, k, k, pos)
    q, k = torch.zeros(2, 4, 64, device=card), torch.zeros(2, 16, 4, 64, device=card)
    for bad in (3, pos.long(), pos.cpu(), torch.zeros(2, dtype=torch.int32, device=card)):
        with pytest.raises(TypeError, match="int32 tensor"):
            tda.decode_attention(q, k, k, bad)
    with pytest.raises(ValueError, match="unit-stride"):
        tda.decode_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3), k, pos)
    with pytest.raises(ValueError, match="jnp"):
        from deepspeed_tpu_torch.ops.attention import cached_attention

        cached_attention(q, k, k, 3, impl="jnp")


def test_decode_kernel_reads_pos_on_the_device(card):
    """One launch captured in a CUDA graph, replayed with pos rewritten in
    place: each replay attends rows 0..pos, as the plain version does (a
    long cache, so most of the Smax-planned chunks are empty)."""
    g = torch.Generator(device=card).manual_seed(6)
    q = torch.randn(2, 16, 64, generator=g, device=card).bfloat16()
    k = torch.randn(2, 2048, 16, 64, generator=g, device=card).bfloat16()
    v = torch.randn(2, 2048, 16, 64, generator=g, device=card).bfloat16()
    pos = _dpos(0, card)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        tda.decode_attention(q, k, v, pos)  # warm-up: the split scratch of s
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        out = tda.decode_attention(q, k, v, pos)
    for p in (0, 1, 255, 256, 1000, 2047, 7):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        ref = tda.decode_attention_ref(q.float(), k.float(), v.float(), p)
        assert (out.float() - ref).abs().max().item() <= 1e-2, p


# ---- captured programs against eager ----------------------------------------

def _eager(on):
    from deepspeed_tpu_torch.utils import graphs

    prev, graphs._EAGER = graphs._EAGER, on
    return prev


def test_captured_generate_matches_eager(card):
    """gpt2 (12 layers, D64) bf16, B2, prompts of 20 and 17 tokens (one 32
    bucket): captured graphs and the same programs run eagerly give the same
    tokens; under replay the decode kernel's count is exactly n_layer x
    (new - 1) a call and uniform_rows' one a token when sampling."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.ops import prng
    from deepspeed_tpu_torch.utils import graphs

    cap = dtt.init_inference("gpt2", seed=0)
    ids = np.random.RandomState(0).randint(0, 50257, (2, 20)).astype(np.int32)
    L, new = cap.model_config.n_layer, 16
    for kw in ({}, {"temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 2}):
        prev = _eager(True)
        try:
            eager = dtt.init_inference(cap.model_config, params=cap.params)
            want = {n: eager.generate(ids[:, :n], max_new_tokens=new, **kw) for n in (20, 17)}
        finally:
            graphs._EAGER = prev
        for n in (20, 17, 20):  # warm-up, capture, replay
            tda.LAUNCHES["decode_attention"] = 0
            prng.LAUNCHES["threefry_uniform_rows"] = 0
            got = cap.generate(ids[:, :n], max_new_tokens=new, **kw)
            np.testing.assert_array_equal(got, want[n])
            assert tda.LAUNCHES["decode_attention"] == L * (new - 1)
            assert prng.LAUNCHES["threefry_uniform_rows"] == (new if kw else 0)
    entries = list(cap._generate_cache.values())
    assert len(entries) == 2 and all(p.graph is not None for e in entries for p in e.programs)


def test_captured_generate_outlives_the_caches_it_read(card):
    """A captured sampled generate reads the temperature divisor (a cached
    device scalar) and, over a 536-row cache, the decode kernel's split
    scratch by address. Its graph holds both, so clearing the scalar cache,
    replacing the scratch with a larger one and allocating junk over what
    was given back changes no token of the next replay."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.ops import prng
    from deepspeed_tpu_torch.utils import graphs

    eng = dtt.init_inference("gpt2", seed=0)
    ids = np.random.RandomState(3).randint(0, 50257, (2, 300)).astype(np.int32)
    kw = {"temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 2}
    want = [eng.generate(ids, max_new_tokens=24, **kw) for _ in range(2)]  # warm-up, capture
    np.testing.assert_array_equal(want[0], want[1])
    (entry,) = eng._generate_cache.values()
    assert all(p.graph is not None for p in entry.programs)
    assert tda.kernel_plan(2, 12, 12, 64, 2, 512 + 24, tda._sm_count(card))[2] > 1  # split
    prng.device_scalar.cache_clear()
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = graphs.capture_stream(dev)
    old = tda._PARTIALS[dev, stream.cuda_stream]
    with torch.cuda.stream(stream):
        # 5 chunks of B8 H16 D256: 165,120 floats of partials, more than
        # the generate's scratch holds
        q = torch.randn(8, 16, 256, device=card, dtype=torch.bfloat16)
        kv = torch.randn(8, 8192, 16, 256, device=card, dtype=torch.bfloat16)
        tda.decode_attention(q, kv, kv, _dpos(8191, card))
    torch.cuda.synchronize()
    assert tda._PARTIALS[dev, stream.cuda_stream] is not old  # replaced by a larger one
    del old
    junk = [torch.full((n,), float("nan"), device=card) for n in (1,) * 4096 + (1 << 22,) * 8]
    got = eng.generate(ids, max_new_tokens=24, **kw)
    del junk
    np.testing.assert_array_equal(got, want[0])


def test_captured_serving_decode_matches_eager(card):
    """The default serving section at gpt2 bf16: captured and eager streams
    identical, the paged decode kernel launched n_layer x decode steps on
    both, the program set JAX's (prefill + decode), both captured."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.utils import graphs

    eng = dtt.init_inference("gpt2", seed=0)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 50257, int(n)) for n in rs.randint(4, 60, 6)]
    runs = {}
    for side in ("eager", "captured"):
        prev = _eager(side == "eager")
        try:
            srv = eng.serve({"max_slots": 4})
        finally:
            graphs._EAGER = prev
        reqs = [srv.submit(p, max_new_tokens=12, seed=i) for i, p in enumerate(prompts)]
        pda.LAUNCHES["paged_decode_attention"] = 0
        srv.run()
        srv.check_no_leaks()
        steps = srv.stats()["decode_steps"]
        assert pda.LAUNCHES["paged_decode_attention"] == eng.model_config.n_layer * steps
        assert len(srv.executables) == srv.expected_executables == 2
        assert all((p.graph is not None) == (side == "captured") for p in srv.executables)
        runs[side] = ([list(r.tokens) for r in reqs], pda.LAUNCHES["paged_decode_attention"])
    assert runs["captured"] == runs["eager"]


# ---- block-sparse attention (forward, dq, dk/dv) ----------------------------

import numpy as np  # noqa: E402

from deepspeed_tpu_torch.ops import block_sparse_attention as bsa  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import (  # noqa: E402
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    VariableSparsityConfig,
)


def _bs_config(kind, H, blk, causal):
    attention = "unidirectional" if causal else "bidirectional"
    if kind == "fixed":
        return FixedSparsityConfig(num_heads=H, block=blk, num_local_blocks=4, attention=attention)
    if kind == "bigbird":
        return BigBirdSparsityConfig(num_heads=H, block=blk, different_layout_per_head=True,
                                     num_random_blocks=2, attention=attention)
    if kind == "bslongformer":
        return BSLongformerSparsityConfig(num_heads=H, block=blk, attention=attention)
    if kind == "variable":
        return VariableSparsityConfig(num_heads=H, block=blk, num_random_blocks=1,
                                      local_window_blocks=[2, 3], global_block_indices=[1],
                                      attention=attention)
    return DenseSparsityConfig(num_heads=H, block=blk)


def _bs_check(q, k, v, do, lists, causal):
    """The three kernels against their plain versions on the same inputs."""
    before = counts(bsa.KERNELS)
    o, lse = bsa.block_sparse_attention_fwd(q, k, v, lists, causal)
    dq, dk, dv = bsa.block_sparse_attention_bwd(q, k, v, o, lse, do, lists, causal)
    torch.cuda.synchronize()
    assert all(bsa.LAUNCHES[n] == before[n] + 1 for n in bsa.KERNELS)
    o_ref, lse_ref = bsa.block_sparse_attention_fwd_ref(q, k, v, lists, causal)
    grads_ref = bsa.block_sparse_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, lists, causal)
    rel_tol = FLASH_REL_TOL[q.dtype]
    assert _scaled_err(o, o_ref) <= rel_tol
    poison = lse_ref == 1e30
    assert torch.equal(lse == 1e30, poison)
    assert _scaled_err(lse[~poison], lse_ref[~poison]) <= LSE_REL_TOL
    for got, ref in zip((dq, dk, dv), grads_ref):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert _scaled_err(got, ref) <= rel_tol
    return o, (dq, dk, dv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kind,B,S,H,D,blk,causal", [
    ("fixed", 2, 512, 4, 64, 16, False),
    ("fixed", 1, 1024, 4, 64, 64, True),
    ("bigbird", 2, 512, 4, 128, 32, False),
    ("bslongformer", 1, 1024, 2, 128, 128, True),
    ("variable", 1, 512, 4, 64, 32, True),
    ("dense", 1, 256, 2, 64, 64, True),
])
def test_block_sparse_kernels_match_plain_versions(card, dtype, kind, B, S, H, D, blk, causal):
    q, k, v, do = _flash_inputs(card, B, S, H, H, D, dtype, seed=blk + D)
    lists = bsa.index_lists(_bs_config(kind, H, blk, causal), S, card)
    o, _ = _bs_check(q, k, v, do, lists, causal)
    if kind == "dense":  # the dense layout is flash attention
        o_flash, _ = fa.flash_attention_fwd(q, k, v, causal)
        assert _scaled_err(o, o_flash) <= FLASH_REL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sparse_fully_masked_row_gives_zeros(card, dtype):
    """A layout whose first query block lists only a block above the
    diagonal: under the causal rule its rows see nothing, so o, dq and the
    rows' contributions are exactly 0 (and lse is the +1e30 poison)."""
    B, S, H, D, blk = 1, 256, 2, 64, 16
    nb = S // blk
    layout = np.tril(np.ones((H, nb, nb), bool))
    layout[:, 0, 0] = False
    layout[:, 0, 1] = True
    q, k, v, do = _flash_inputs(card, B, S, H, H, D, dtype, seed=5)
    lists = bsa.lists_from_layout(layout, blk, card)
    o, (dq, _, _) = _bs_check(q, k, v, do, lists, True)
    assert float(o[:, :blk].abs().max()) == 0.0 and float(dq[:, :blk].abs().max()) == 0.0


def test_block_sparse_autograd_through_qkv_views(card):
    """GPT-2's q, k, v as strided views of one [B, S, 3E] projection: the
    kernels read them in place, and the grads match the CPU plain path."""
    B, S, H, D = 2, 512, 4, 64
    g = torch.Generator(device=card).manual_seed(3)
    qkv = torch.randn(B, S, 3 * H * D, generator=g, device=card).to(torch.bfloat16)
    qkv.requires_grad_(True)
    do = (torch.randn(B, S, H, D, generator=g, device=card) * 0.1).to(torch.bfloat16)
    cfg = FixedSparsityConfig(num_heads=H, block=64, attention="unidirectional")

    def run(x):
        q, k, v = (t.unflatten(-1, (H, D)) for t in x.split(H * D, dim=-1))
        lists = bsa.index_lists(cfg, S, x.device)
        return bsa.block_sparse(q, k, v, lists, True)

    o = run(qkv)
    (gk,) = torch.autograd.grad(o, qkv, do)
    ref = qkv.detach().float().cpu().requires_grad_(True)
    o_ref = run(ref)  # CPU tensors: the plain versions
    (gr,) = torch.autograd.grad(o_ref, ref, do.float().cpu())
    assert _scaled_err(o.cpu(), o_ref) <= FLASH_REL_TOL[torch.bfloat16]
    assert _scaled_err(gk.cpu(), gr) <= FLASH_REL_TOL[torch.bfloat16]


def test_block_sparse_kernels_refuse_what_they_do_not_take(card):
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention

    q = torch.zeros(1, 256, 2, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block 8"):
        bsa.block_sparse_attention_fwd(
            q, q, q, bsa.index_lists(FixedSparsityConfig(num_heads=2, block=8), 256, card))
    q32 = torch.zeros(1, 256, 2, 32, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        bsa.block_sparse_attention_fwd(
            q32, q32, q32, bsa.index_lists(FixedSparsityConfig(num_heads=2), 256, card))
    with pytest.raises(ValueError, match="jnp"):
        sparse_attention(q, q, q, FixedSparsityConfig(num_heads=2), impl="jnp")


# the backward's TMA + wgmma route (bf16/fp16, D 64/128, blocks 64/128)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kind,B,S,H,D,blk,causal", [
    ("fixed", 2, 1024, 4, 64, 64, False),
    ("fixed", 2, 1024, 4, 128, 64, True),
    ("bslongformer", 1, 2048, 4, 64, 128, True),
    ("bigbird", 2, 1024, 4, 64, 64, True),
    ("fixed", 2, 320, 2, 64, 64, True),  # an odd number of 64-row units a head
])
def test_block_sparse_wgmma_backward_matches_plain_versions(card, dtype, kind, B, S, H, D, blk,
                                                            causal):
    assert bsa.wgmma_route(torch.zeros(1, 1, 1, D, dtype=dtype))
    q, k, v, do = _flash_inputs(card, B, S, H, H, D, dtype, seed=blk + D + S)
    _bs_check(q, k, v, do, bsa.index_lists(_bs_config(kind, H, blk, causal), S, card), causal)


# the TMA + wgmma kernels at blocks of 16 and 32 on grouped units (dk/dv's
# key units; the forward's and dq's query units, one plan for both): against
# the plain versions, and o/lse, dq and dk/dv equal bit for bit over two
# calls
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kind,B,S,H,D,blk,causal", [
    ("fixed", 2, 512, 4, 64, 16, False),        # BERT's default section
    ("fixed", 2, 512, 2, 128, 16, True),
    ("bigbird", 2, 512, 4, 64, 16, False),
    ("variable", 1, 1024, 2, 64, 32, True),
    ("bigbird", 1, 512, 2, 128, 32, True),
    ("fixed", 1, 32, 2, 64, 16, False),         # shorter than one 64-row tile
])
def test_block_sparse_grouped_dkv_matches_plain_versions(card, dtype, kind, B, S, H, D, blk,
                                                         causal):
    q, k, v, do = _flash_inputs(card, B, S, H, H, D, dtype, seed=blk + D + S + 1)
    assert bsa.wgmma_route(q)
    lists = bsa.index_lists(_bs_config(kind, H, blk, causal), S, card)
    o, _ = _bs_check(q, k, v, do, lists, causal)
    o1, lse = bsa.block_sparse_attention_fwd(q, k, v, lists, causal)
    o2, lse2 = bsa.block_sparse_attention_fwd(q, k, v, lists, causal)
    delta = bsa.block_sparse_delta(o, do)
    first = (bsa.block_sparse_attention_dq(q, k, v, do, lse, delta, lists, causal),
             *bsa.block_sparse_attention_dkv(q, k, v, do, lse, delta, lists, causal))
    again = (bsa.block_sparse_attention_dq(q, k, v, do, lse, delta, lists, causal),
             *bsa.block_sparse_attention_dkv(q, k, v, do, lse, delta, lists, causal))
    torch.cuda.synchronize()
    assert torch.equal(o, o1) and torch.equal(o1, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _gpt2_lists(card, H, S):
    from deepspeed_tpu_torch.ops.sparse_attention import from_ds_config
    from deepspeed_tpu_torch.tools.profile_training import GPT2_SPARSE_SECTION

    return bsa.index_lists(from_ds_config(GPT2_SPARSE_SECTION, H), S, card)


def test_block_sparse_gpt2_main_shape_repeats_bit_for_bit(card):
    """Phase 10's GPT-2 shape (B2 S4096 H16 D64 bf16, q/k/v strided views of
    one projection): a key block listed by 61 query blocks, the kernels
    against their plain versions, and dq, dk, dv equal bit for bit over two
    calls; the schedules are built once and kept."""
    B, S, H, D = 2, 4096, 16, 64
    q, k, v = _qkv_views(card, B, S, H, H, D, torch.bfloat16, seed=21)
    do = (torch.randn(B, S, H, D, generator=torch.Generator(device=card).manual_seed(22),
                      device=card) * 0.1).to(torch.bfloat16)
    assert q.stride(1) == 3 * H * D
    lists = _gpt2_lists(card, H, S)
    assert int(lists.qcnt.max()) >= 60
    _bs_check(q, k, v, do, lists, True)
    plans = (lists.bwd_plan("dq", True), lists.bwd_plan("dkv", True))
    o, lse = bsa.block_sparse_attention_fwd(q, k, v, lists, True)
    o2, lse2 = bsa.block_sparse_attention_fwd(q, k, v, lists, True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    delta = bsa.block_sparse_delta(o, do)
    first = (bsa.block_sparse_attention_dq(q, k, v, do, lse, delta, lists, True),
             *bsa.block_sparse_attention_dkv(q, k, v, do, lse, delta, lists, True))
    again = (bsa.block_sparse_attention_dq(q, k, v, do, lse, delta, lists, True),
             *bsa.block_sparse_attention_dkv(q, k, v, do, lse, delta, lists, True))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert lists.bwd_plan("dq", True) is plans[0] and lists.bwd_plan("dkv", True) is plans[1]


# the forward's TMA + wgmma route (bf16/fp16, D 64/128, blocks 64/128) on
# dq's schedule, q/k/v read as views of one projection
@pytest.mark.parametrize("kind,B,S,H,D,blk,causal,dtype", [
    ("fixed", 2, 2048, 4, 64, 128, False, torch.bfloat16),    # blocks of 128, bidirectional
    ("fixed", 2, 1024, 4, 128, 64, True, torch.float16),      # D128, fp16
    ("bslongformer", 1, 2048, 4, 128, 128, True, torch.bfloat16),
    ("bigbird", 2, 1024, 4, 64, 64, False, torch.float16),
    ("variable", 1, 1024, 4, 64, 64, True, torch.bfloat16),
    ("fixed", 2, 320, 2, 64, 64, True, torch.bfloat16),       # an odd number of units a head
])
def test_block_sparse_wgmma_forward_on_qkv_views(card, kind, B, S, H, D, blk, causal, dtype):
    q, k, v = _qkv_views(card, B, S, H, H, D, dtype, seed=S + D + blk)
    assert bsa.wgmma_route(q) and q.stride(1) == 3 * H * D
    lists = bsa.index_lists(_bs_config(kind, H, blk, causal), S, card)
    before = bsa.LAUNCHES["block_sparse_attention_fwd"]
    o, lse = bsa.block_sparse_attention_fwd(q, k, v, lists, causal)
    o2, lse2 = bsa.block_sparse_attention_fwd(q, k, v, lists, causal)
    torch.cuda.synchronize()
    assert bsa.LAUNCHES["block_sparse_attention_fwd"] == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)  # bit for bit
    o_ref, lse_ref = bsa.block_sparse_attention_fwd_ref(q, k, v, lists, causal)
    poison = lse_ref == 1e30
    assert torch.equal(lse == 1e30, poison)
    assert _scaled_err(o, o_ref) <= FLASH_REL_TOL[dtype]
    assert _scaled_err(lse[~poison], lse_ref[~poison]) <= LSE_REL_TOL
    assert lists.bwd_plan("dq", causal) is lists.bwd_plan("dq", causal)


def test_block_sparse_wgmma_fully_masked_row_gives_zeros(card):
    """The custom layout at block 64: the first query block sees nothing
    under the causal rule; its o and dq rows are exactly 0."""
    B, S, H, D, blk = 1, 512, 2, 64, 64
    nb = S // blk
    layout = np.tril(np.ones((H, nb, nb), bool))
    layout[:, 0, 0] = False
    layout[:, 0, 1] = True
    q, k, v, do = _flash_inputs(card, B, S, H, H, D, torch.bfloat16, seed=6)
    o, (dq, _, _) = _bs_check(q, k, v, do, bsa.lists_from_layout(layout, blk, card), True)
    assert float(o[:, :blk].abs().max()) == 0.0 and float(dq[:, :blk].abs().max()) == 0.0


def test_block_sparse_wgmma_refuses_strides_a_tma_map_cannot_take(card):
    """A batch stride of 0 (an expanded tensor): the wgmma route's TMA maps
    refuse it (all three kernels, at blocks of 64 and of 16); autograd hands
    the kernels a contiguous copy."""
    S, H, D = 256, 2, 64
    q, k, v, do = _flash_inputs(card, 1, S, H, H, D, torch.bfloat16, seed=8)
    qe, ke, ve, doe = (x.expand(2, S, H, D) for x in (q, k, v, do))
    for blk in (64, 16):
        lists = bsa.index_lists(FixedSparsityConfig(num_heads=H, block=blk,
                                                    attention="unidirectional"), S, card)
        assert bsa.wgmma_route(qe)
        with pytest.raises(ValueError, match="TMA"):
            bsa.block_sparse_attention_fwd(qe, ke, ve, lists, True)
        o, lse = bsa.block_sparse_attention_fwd(*(x.contiguous() for x in (qe, ke, ve)), lists,
                                                True)
        delta = bsa.block_sparse_delta(o, doe)
        for fn in (bsa.block_sparse_attention_dq, bsa.block_sparse_attention_dkv):
            with pytest.raises(ValueError, match="TMA"):
                fn(qe, ke, ve, doe, lse, delta, lists, True)
        leaves = [x.detach().requires_grad_(True) for x in (qe, ke, ve)]
        grads = torch.autograd.grad(bsa.block_sparse(*leaves, lists, True), leaves, doe)
        ref = bsa.block_sparse_attention_bwd_ref(qe, ke, ve, o, lse, doe, lists, True)
        for got, want in zip(grads, ref):
            assert _scaled_err(got, want) <= FLASH_REL_TOL[torch.bfloat16]


def test_bidirectional_attention_on_the_card(card):
    """BERT's dense encoder attention: an unmasked batch runs the non-causal
    flash kernels, a masked one the plain masked path (no kernel has a mask
    input), and both agree with the CPU's plain version."""
    from deepspeed_tpu_torch.ops.attention import (
        bidirectional_attention,
        bidirectional_attention_ref,
    )

    q, k, v, _ = _flash_inputs(card, 2, 256, 4, 4, 64, torch.bfloat16, seed=9)
    mask = torch.ones(2, 256, dtype=torch.long, device=card)
    mask[1, 200:] = 0
    before = fa.LAUNCHES["flash_attention_fwd"]
    out = bidirectional_attention(q, k, v)
    assert fa.LAUNCHES["flash_attention_fwd"] == before + 1
    masked = bidirectional_attention(q, k, v, mask=mask)
    assert fa.LAUNCHES["flash_attention_fwd"] == before + 1
    cpu = [x.float().cpu() for x in (q, k, v)]
    assert _scaled_err(out.cpu(), bidirectional_attention_ref(*cpu)) <= FLASH_REL_TOL[torch.bfloat16]
    assert _scaled_err(masked.cpu(), bidirectional_attention_ref(*cpu, mask.cpu())) <= \
        FLASH_REL_TOL[torch.bfloat16]
    with pytest.raises(ValueError, match="jnp"):
        bidirectional_attention(q, k, v, impl="jnp")


def test_sparse_bert_on_the_card_matches_the_cpu(card):
    """bert-tiny's width is too narrow for the kernels (D16): a BERT of head
    dim 64 and 2 layers, fp32, block-sparse, on the card against the CPU."""
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy

    cfg = bert.get_config("bert-tiny", n_embd=128, n_head=2, attn_impl="sparse",
                          sparsity_config=FixedSparsityConfig(num_heads=2, block=16))
    tree = params_to_numpy(bert.init_params(cfg, torch.Generator().manual_seed(0)))
    ids = torch.randint(1, cfg.vocab_size, (2, 128), generator=torch.Generator().manual_seed(1))
    before = bsa.LAUNCHES["block_sparse_attention_fwd"]
    h_card, pooled_card = bert.forward(cfg, params_from_numpy(tree, card), ids.to(card))
    assert bsa.LAUNCHES["block_sparse_attention_fwd"] == before + cfg.n_layer
    h_cpu, pooled_cpu = bert.forward(cfg, params_from_numpy(tree, "cpu"), ids)
    assert _max_err(h_card.cpu(), h_cpu) <= 1e-4
    assert _max_err(pooled_card.cpu(), pooled_cpu) <= 1e-4


# ---------------------------------------------------------------------------
# fused AdamW / LAMB (csrc/fused_adam.cu)
# ---------------------------------------------------------------------------

from deepspeed_tpu_torch.ops import fused_adam as tfa  # noqa: E402

# max abs error over max |ref| of p, m, v after the update(s): the kernel
# computes in f32 like the plain version (the same operations; the plain
# version divides by the bias corrections as a multiply by their
# reciprocal on the card, LAMB's norms are double sums in the kernel)
ADAM_REL_TOL = 1e-6


def _opt_case(shapes, card, seed, gdtype=torch.float32, offset=0):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def make(shape, scale=1.0):
        n = int(torch.tensor(shape).prod()) if shape else 1
        base = torch.randn(n + offset, generator=g) * scale
        return base.to(card)[offset:].reshape(shape)

    p = [make(s) for s in shapes]
    gr = [make(s).to(gdtype) for s in shapes]
    m = [make(s, 0.1) for s in shapes]
    v = [make(s, 0.1).abs() for s in shapes]
    return p, gr, m, v


def _clone(ts):
    return [t.clone() for t in ts]


def _rel(got, ref):
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, ref))


@pytest.mark.parametrize("mode", ["decoupled", "l2", "none"])
@pytest.mark.parametrize("shapes,gdtype,offset", [
    ([(3,)], torch.float32, 0), ([(1000,)], torch.float32, 0), ([(8192,)], torch.float32, 0),
    ([(1000,)], torch.float32, 1),                      # unaligned views: the scalar path
    ([(4, 1024, 1024), (1024,), (3,), (65537,)], torch.bfloat16, 0),
    ([(77, 33), (5,)], torch.float16, 0),
])
def test_fused_adam_kernel_matches_plain_version(card, mode, shapes, gdtype, offset):
    p, g, m, v = _opt_case(shapes, card, 0, gdtype, offset)
    wds = [0.1 if len(s) >= 2 else 0.0 for s in shapes]
    ref = [_clone(x) for x in (p, m, v)]
    before = tfa.LAUNCHES["fused_adamw"]
    for step in (1, 2, 3):
        tfa.multi_tensor_adam(p, g, m, v, step, 1e-3, (0.9, 0.95), 1e-8, wds, mode)
        tfa.multi_tensor_adam_ref_(ref[0], g, ref[1], ref[2], step, 1e-3, (0.9, 0.95), 1e-8,
                                   wds, mode)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["fused_adamw"] == before + 3
    for got, want in zip((p, m, v), ref):
        assert _rel(got, want) <= ADAM_REL_TOL


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("steps", [1, 5])
def test_fused_lamb_kernel_matches_plain_version(card, clamp, steps):
    shapes = [(4, 256, 512), (512,), (3,), (2, 70000), (16, 16)]
    p, g, m, v = _opt_case(shapes, card, 1)
    p[4].zero_()  # a zero-norm leaf: trust 1
    bounds = (0.01, 10.0) if clamp else (None, None)
    ref = [_clone(x) for x in (p, m, v)]
    before = tfa.LAUNCHES["fused_lamb"]
    for step in range(1, steps + 1):
        tfa.multi_tensor_lamb(p, g, m, v, step, 1e-2, (0.9, 0.999), 1e-6, [0.01] * 5, *bounds)
        tfa.multi_tensor_lamb_ref_(ref[0], g, ref[1], ref[2], step, 1e-2, (0.9, 0.999), 1e-6,
                                   [0.01] * 5, *bounds)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["fused_lamb"] == before + 2 * steps
    for got, want in zip((p, m, v), ref):
        assert _rel(got, want) <= ADAM_REL_TOL


def test_fused_lamb_kernel_repeats_bit_for_bit(card):
    p, g, m, v = _opt_case([(3, 300000), (7,)], card, 2)
    runs = []
    for _ in range(2):
        pc, mc, vc = _clone(p), _clone(m), _clone(v)
        tfa.multi_tensor_lamb(pc, g, mc, vc, 1, 1e-2, weight_decays=[0.01, 0.01])
        runs.append(pc)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_fused_adam_kernel_splits_long_lists(card):
    """More tensors than a launch takes: one launch per MAX_TENSORS."""
    n = tfa.MAX_TENSORS + 5
    p, g, m, v = _opt_case([(10,)] * n, card, 3)
    ref = [_clone(x) for x in (p, m, v)]
    before = tfa.LAUNCHES["fused_adamw"]
    tfa.multi_tensor_adam(p, g, m, v, 1, 1e-3, weight_decays=[0.1] * n)
    tfa.multi_tensor_adam_ref_(ref[0], g, ref[1], ref[2], 1, 1e-3, weight_decays=[0.1] * n)
    assert tfa.LAUNCHES["fused_adamw"] == before + 2
    assert _rel(p, ref[0]) <= ADAM_REL_TOL


def test_fused_adam_kernel_refuses_what_it_does_not_take(card):
    p, g, m, v = _opt_case([(64, 64)], card, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.multi_tensor_adam([p[0].t()], g, m, v, 1, 1e-3)
    with pytest.raises(TypeError, match="float32"):
        tfa.multi_tensor_adam([p[0].half()], g, m, v, 1, 1e-3)
    with pytest.raises(ValueError, match="on"):
        tfa.multi_tensor_lamb(p, [g[0].cpu()], m, v, 1, 1e-3)


@pytest.mark.parametrize("opt", [
    {"type": "AdamW", "params": {"lr": 3e-3, "betas": [0.9, 0.95], "weight_decay": 0.1}},
    {"type": "Lamb", "params": {"lr": 3e-3, "betas": [0.9, 0.999], "eps": 1e-6,
                                "weight_decay": 0.01}},
])
def test_fp32_training_with_the_fused_update_matches_the_cpu(card, opt):
    """3 fp32 steps of a 2-layer GPT-2 of head dim 64 (the flash kernels'
    width) on the card, updating through the kernel, against the CPU's
    plain versions from the same weights."""
    import numpy as np

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy, tree_leaves

    cfg = gpt2.get_config("gpt2-tiny", n_embd=128, n_head=2)
    tree = params_to_numpy(gpt2.init_params(cfg, torch.Generator().manual_seed(0)))
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "optimizer": opt}
    batch = {"input_ids": np.random.RandomState(1).randint(0, 512, (4, 128)).astype(np.int32)}
    out = {}
    for dev in ("cuda", "cpu"):
        before = counts(tfa.KERNELS)
        eng, *_ = dtt.initialize(model=gpt2.make_module(cfg), config=conf,
                                 model_parameters=params_from_numpy(tree, dev), device=dev)
        losses = [float(eng.train_batch(batch)["loss"]) for _ in range(3)]
        launched = {k: tfa.LAUNCHES[k] - before[k] for k in before}
        out[dev] = losses, params_to_numpy(eng.params), launched
    want = {"fused_adamw": 3, "fused_lamb": 0} if opt["type"] == "AdamW" else \
        {"fused_adamw": 0, "fused_lamb": 6}
    assert out["cuda"][2] == want and out["cpu"][2] == {"fused_adamw": 0, "fused_lamb": 0}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    # parameters: within 1e-5, except where a gradient is near 0 and its
    # card and CPU sums (another order) differ in their last bits, which
    # Adam's first step divides by their own magnitude; such an element
    # moves by at most ~lr a step either way
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in
                           zip(tree_leaves(out["cuda"][1]), tree_leaves(out["cpu"][1]))])
    assert (diff > 1e-5).mean() <= 1e-4 and diff.max() <= 2 * 3 * 3e-3, \
        ((diff > 1e-5).sum(), diff.max())


@pytest.mark.parametrize("policy", ["attn", "dots"])
def test_remat_policies_on_the_card_keep_the_attention_output(card, policy):
    """fp32 GPT-2 of head dim 64: the selective policies' grads equal the
    no-remat grads on the card, and the flash forward launches once a block
    (the backward runs the kept output's backward, no forward again)."""
    import numpy as np

    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy, tree_leaves

    base = gpt2.get_config("gpt2-tiny", n_embd=128, n_head=2)
    tree = params_to_numpy(gpt2.init_params(base, torch.Generator().manual_seed(2)))
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 512, (2, 128))).to(card)
    grads = []
    for cfg in (base, gpt2.get_config("gpt2-tiny", n_embd=128, n_head=2, remat=True,
                                       remat_policy=policy)):
        params = params_from_numpy(tree, card)
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        before = counts(fa.KERNELS)
        loss, _ = gpt2.lm_loss(cfg, params, {"input_ids": ids}, None, True)
        grads.append(torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        launched = {k: fa.LAUNCHES[k] - before[k] for k in before}
        assert launched == {"flash_attention_fwd": cfg.n_layer,
                            "flash_attention_bwd": cfg.n_layer}
    for a, b in zip(*grads):
        assert _max_err(a, b) <= 1e-6


# ---- the flash backward's TMA + wgmma design (bf16/fp16, D 64 and 128) ------

def _check_backward(q, k, v, do, causal=True, window=None):
    """The kernels' dq, dk, dv against the plain backward on the kernels'
    own o and lse, at the tolerances of the forward's checks."""
    o, lse = fa.flash_attention_fwd(q, k, v, causal, None, window)
    before = fa.LAUNCHES["flash_attention_bwd"]
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, None, window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_bwd"] == before + 1
    refs = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, None, window)
    tol, rel_tol = FLASH_TOL[q.dtype], FLASH_REL_TOL[q.dtype]
    for got, ref in zip(grads, refs):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert torch.isfinite(got.float()).all()
        assert _max_err(got, ref) <= tol and _scaled_err(got, ref) <= rel_tol
    return grads


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", [
    (2, 1000, 4, 4, 64, True, None),     # ragged S, causal
    (2, 1088, 4, 2, 64, False, None),    # ragged S, non-causal, GQA
    (2, 640, 4, 4, 64, True, 200),       # a window crossing 128-query tiles
    (1, 512, 16, 4, 64, True, 129),      # GQA H16/KV4 under a window
    (1, 1000, 8, 2, 128, True, None),    # D128: 64-query tiles in dk/dv, 64-key in dq
    (1, 1088, 4, 4, 128, False, None),
    (1, 640, 4, 2, 128, True, 200),
    (1, 64, 2, 2, 64, True, None),       # one tile, mostly padding
])
def test_flash_backward_cases(card, dtype, B, S, H, KV, D, causal, window):
    q, k, v, do = _flash_inputs(card, B, S, H, KV, D, dtype, seed=S + D + H)
    _check_backward(q, k, v, do, causal, window)


@pytest.mark.parametrize("D,KV,causal,S", [(64, 4, True, 1000), (64, 2, False, 1088),
                                           (128, 4, True, 1088), (128, 2, False, 1000)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_backward_through_qkv_views_and_autograd(card, dtype, D, KV, causal, S):
    """q, k, v as strided views of one [B, S, (H + 2 KV) D] projection,
    through ``flash``'s autograd: the grads of the projection match the
    plain path's (CPU tensors) on the same inputs."""
    B, H = 2, 4
    g = torch.Generator(device=card).manual_seed(S + D)
    qkv = torch.randn(B, S, (H + 2 * KV) * D, generator=g, device=card).to(dtype)
    w = (torch.randn(B, S, H, D, generator=g, device=card) * 0.1).to(dtype)

    def run(x):
        q, k, v = x.split([H * D, KV * D, KV * D], dim=-1)
        o = fa.flash(q.unflatten(-1, (H, D)), k.unflatten(-1, (KV, D)),
                     v.unflatten(-1, (KV, D)), causal)
        return (o.float() * w.float()).sum()

    x = qkv.detach().requires_grad_(True)
    (gk,) = torch.autograd.grad(run(x), x)
    xr = qkv.detach().cpu().requires_grad_(True)  # CPU tensors: the plain versions
    w = w.cpu()
    (gr,) = torch.autograd.grad(run(xr), xr)
    assert gk.dtype == dtype and torch.isfinite(gk.float()).all()
    assert _max_err(gk.cpu(), gr) <= FLASH_TOL[dtype]
    assert _scaled_err(gk.cpu(), gr) <= FLASH_REL_TOL[dtype]


@pytest.mark.parametrize("D", [64, 128])
def test_flash_backward_repeats_bit_for_bit(card, D):
    q, k, v, do = _flash_inputs(card, 2, 1000, 8, 2, D, torch.bfloat16, seed=9)
    o, lse = fa.flash_attention_fwd(q, k, v)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_backward_refuses_strides_a_tensor_map_cannot_take(card):
    q, k, v, do = _flash_inputs(card, 2, 128, 2, 2, 64, torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v)
    do_b = do[:1].expand(2, -1, -1, -1)  # a zero batch stride
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention_bwd(q, k, v, o, lse, do_b)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, o, lse[:, :, :64], do)


# ---- the paged decode kernel's split-K design ----------------------------------

def _paged_split_check(card, B, H, KV, D, page, P, n, pos, qdtype, int8, seed):
    """The kernel against its plain version (and, at fp32, bit for bit
    against itself on a second call): pools of random pages (int8: codec
    codes, the second page of slot 0 at scale 0, garbage codes in the
    scratch page), the last slot inactive on scratch."""
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(B, H, D, generator=g, device=card).to(qdtype)
    bt = torch.randperm(P - 2, generator=g, device=card)[: B * n].add(2).reshape(B, n).int()
    bt[B - 1] = 0
    posT = torch.tensor(pos, dtype=torch.int32, device=card)
    if int8:
        kq, vq, sc = _int8_pools(card, P, KV, page, D, g)
        bt[0, 1] = 1
        out = pda.paged_decode_attention(q, kq, vq, bt, posT, scales=sc)
        again = pda.paged_decode_attention(q, kq, vq, bt, posT, scales=sc)
        ref = pda.paged_decode_attention_ref(q.float(), kq, vq, bt, posT, scales=sc)
    else:
        k = torch.randn(P, KV, page, D, generator=g, device=card).to(qdtype)
        v = torch.randn(P, KV, page, D, generator=g, device=card).to(qdtype)
        out = pda.paged_decode_attention(q, k, v, bt, posT)
        again = pda.paged_decode_attention(q, k, v, bt, posT)
        ref = pda.paged_decode_attention_ref(q.float(), k.float(), v.float(), bt, posT)
    torch.cuda.synchronize()
    tol = 1e-5 if qdtype == torch.float32 else 1e-2
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref).abs().max().item() <= tol
    assert torch.equal(out, again)


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,H,KV,n", [(8, 16, 16, 36), (4, 16, 4, 24), (2, 8, 8, 256)])
def test_paged_decode_kernel_at_every_split_edge(card, qdtype, int8, B, H, KV, n):
    """pos at the first and last row of every chunk the plan draws, within
    one page, at the table's last row and past it, slot by slot."""
    D, page = 64, 16
    P = B * n + 2
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    item = 1 if int8 else (4 if qdtype == torch.float32 else 2)
    _, _, splits, chunk = pda.kernel_plan(B, H, KV, D, item, page, n, sms)
    rows = n * page
    edges = sorted({0, 3, page - 1, page, rows - 1, rows + 9}
                   | {e for s in range(1, splits) for e in (s * chunk - 1, s * chunk)})
    live = B - 1  # the last slot is inactive
    for i in range(0, len(edges), live):
        pos = (edges[i:i + live] + [0] * live)[:live] + [0]
        _paged_split_check(card, B, H, KV, D, page, P, n, pos, qdtype, int8, seed=i)


def test_paged_decode_kernel_refuses_a_page_off_the_row_grid(card):
    q = torch.zeros(2, 4, 64, device=card)
    k = torch.zeros(8, 4, 10, 64, device=card)  # page 10: not a multiple of 4
    bt = torch.ones(2, 2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="multiple of 4"):
        pda.paged_decode_attention(q, k, k, bt, torch.zeros(2, dtype=torch.int32, device=card))


# ---- the paged multi-token kernel's tensor-core route -----------------------------

def _mt_case(card, B, T, H, KV, D, page, P, n, qdtype, int8, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(B, T, H, D, generator=g, device=card).to(qdtype)
    bt = torch.randperm(P - 2, generator=g, device=card)[: B * n].add(2).reshape(B, n).int()
    if int8:
        k, v, sc = _int8_pools(card, P, KV, page, D, g)
        bt[0, 1] = 1  # the fresh page inside slot 0's live range: values 0
    else:
        k = torch.randn(P, KV, page, D, generator=g, device=card).to(qdtype)
        v = torch.randn(P, KV, page, D, generator=g, device=card).to(qdtype)
        sc = None
    return q, k, v, sc, bt


def _mt_check(q, k, v, sc, bt, base):
    """The kernel against its plain version, and bit for bit against itself."""
    kw = {} if sc is None else {"scales": sc}
    assert pma.tensor_core_route(q, k)
    out = pma.paged_multitoken_attention(q, k, v, bt, base, **kw)
    again = pma.paged_multitoken_attention(q, k, v, bt, base, **kw)
    torch.cuda.synchronize()
    ref = pma.paged_multitoken_attention_ref(q.float(), k if sc is not None else k.float(),
                                             v if sc is not None else v.float(), bt, base, **kw)
    assert torch.isfinite(out.float()).all()
    assert _max_err(out, ref) <= 1e-2 and _scaled_err(out, ref) <= 1e-2
    assert torch.equal(out, again)
    return out


@pytest.mark.parametrize("int8", [False, True])
def test_paged_multitoken_kernel_at_every_split_edge(card, int8):
    """3b/3c's chunk shape (B1 T64 H16 D64 bf16, page 16, a 36-page table):
    the unit's last query on the first and last row of every chunk the plan
    draws, bases on and off page edges, and past the table."""
    n, page = 36, 16
    q, k, v, sc, bt = _mt_case(card, 1, 64, 16, 16, 64, page, 40, n, torch.bfloat16, int8, 11)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    _, _, units, splits, chunk = pma.kernel_plan(1, 64, 16, 16, page, n, sms)
    assert units * splits >= sms
    bases = sorted({0, 3, 15, 16, 17, n * page - 64, n * page - 40}
                   | {max(0, e - 63) for c in range(1, splits) for e in (c * chunk - 1, c * chunk)})
    for b0 in bases:
        _mt_check(q, k, v, sc, bt, torch.tensor([b0], dtype=torch.int32, device=card))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,T,H,KV,D,page,n", [
    (4, 5, 16, 4, 64, 16, 8),     # a GQA group stacked: 4 heads x 5 tokens a unit
    (2, 16, 16, 8, 64, 8, 24),    # page 8
    (2, 37, 8, 8, 128, 16, 12),   # D128, T off the 16-row grid
    (2, 100, 8, 2, 128, 32, 12),  # two token tiles a head
    (3, 20, 4, 4, 64, 48, 6),     # page 48
])
def test_paged_multitoken_tensor_core_cases(card, int8, qdtype, B, T, H, KV, D, page, n):
    P = B * n + 3
    q, k, v, sc, bt = _mt_case(card, B, T, H, KV, D, page, P, n, qdtype, int8, T + D)
    bt[B - 1] = 0  # an inactive slot on the scratch page
    base = torch.tensor([[0, page - 1, page + 3, n * page - T][i % 4] for i in range(B)],
                        dtype=torch.int32, device=card).clamp_min(0)
    _mt_check(q, k, v, sc, bt, base)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_multitoken_tensor_core_at_t1_is_the_decode_kernel(card, int8):
    B, H, KV, D, page, n = 8, 16, 4, 64, 16, 12
    q, k, v, sc, bt = _mt_case(card, B, 1, H, KV, D, page, 100, n, torch.bfloat16, int8, 9)
    base = torch.tensor([0, 15, 16, 17, 100, 191, 0, 500], dtype=torch.int32, device=card)
    mt = _mt_check(q, k, v, sc, bt, base)
    kw = {} if sc is None else {"scales": sc}
    st = pda.paged_decode_attention(q[:, 0].contiguous(), k, v, bt, base, **kw)
    torch.cuda.synchronize()
    assert _max_err(mt[:, 0], st) <= 1e-2



@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 257, 64), (3, 7)])
def test_threefry_dropout_kernel_is_its_plain_version(card, dtype, rate, shape):
    """The dropout kernel and its backward (the same launch on dy) equal the
    plain version on the card bit for bit: integer bits, one IEEE division."""
    from deepspeed_tpu_torch.ops import dropout, prng

    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(shape, generator=g, device=card).to(dtype).requires_grad_(True)
    key = prng.fold_in(prng.PRNGKey(11), 2)
    y = dropout.dropout(x, key, rate)
    assert torch.equal(y, dropout.dropout_ref(x.detach(), key, rate))
    dy = torch.randn(shape, generator=g, device=card).to(dtype)
    (gx,) = torch.autograd.grad(y, x, dy)
    assert torch.equal(gx, dropout.dropout_ref(dy, key, rate))


@pytest.mark.parametrize("R,n,lo", [(1, 50257 * 2, 0.0), (5, 50257, 1.1754943508222875e-38),
                                    (3, 33, 0.0)])
def test_threefry_uniform_rows_kernel_is_its_plain_version(card, R, n, lo):
    from deepspeed_tpu_torch.ops import prng

    keys = prng.split(prng.PRNGKey(R), R)
    got = prng.uniform_rows_kernel(keys, n, lo, 1.0, card)
    assert torch.equal(got, prng.uniform_rows_ref(keys, n, lo, 1.0, card))


def test_capture_survives_a_dead_program_collected_during_it(card):
    """A captured program whose last reference sits in a young dead cycle
    (a dropped serving replica's), collected while another program
    captures, must not reset its graph inside that capture: the collector
    is off while a capture runs."""
    import gc

    from deepspeed_tpu_torch.utils.graphs import CapturedProgram

    x = torch.zeros(16, device=card)
    dead = CapturedProgram("dead", lambda: x.add_(1), card)
    dead()
    dead()  # the warm-up, then the capture
    assert dead.graph is not None
    owner = [dead]  # the one reference to the program
    del dead
    y = torch.zeros(16, device=card)
    calls = [0]

    def fn():
        calls[0] += 1
        if calls[0] == 2:  # inside the capture
            box = [owner.pop()]
            box.append(box)  # a new cycle holds the program's last reference
            del box
            junk = [[i] for i in range(2000)]  # allocations that run the collector
            assert len(junk) == 2000
        return y + 1

    live = CapturedProgram("live", fn, card)
    live()
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        out = live()
    finally:
        gc.set_threshold(*threshold)
    assert live.graph is not None and not owner
    gc.collect()  # the dead program goes here, outside any capture
    torch.cuda.synchronize()
    assert torch.equal(out, torch.ones(16, device=card))
