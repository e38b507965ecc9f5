"""The port's block-sparse attention on the CPU against the JAX package: the
plain forward (o, lse) and backward (dq, dk, dv) against the Pallas kernels
in interpret mode, the autograd path against ``jax.grad`` of
``sparse_attention(impl="jnp")``, the fully masked row (exact zeros), the
dispatcher's routing (a key mask takes the dense path, ``impl="jnp"`` is
refused for CUDA tensors) and the index-list cache.

Tolerances: the JAX tests' own, 2e-5 for o and lse and 5e-4 for the grads
(the two packages sum in different orders); fp32 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import block_sparse_attention as jbsa
from deepspeed_tpu.ops.sparse_attention import sparse_self_attention as jssa
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention, sparse_attention
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc

O_TOL, GRAD_TOL = 2e-5, 5e-4


def _qkv(B, S, H, D, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(B, S, H, D).astype(np.float32) for _ in range(4))


def _to4(x):
    return jnp.asarray(x).transpose(0, 2, 1, 3)  # [B, H, S, D]


def _configs(H, blk, causal):
    attention = "unidirectional" if causal else "bidirectional"
    return {
        "fixed": dict(cls="FixedSparsityConfig", num_local_blocks=2, attention=attention),
        "bslongformer": dict(cls="BSLongformerSparsityConfig", num_sliding_window_blocks=3,
                             attention=attention),
        "bigbird": dict(cls="BigBirdSparsityConfig", different_layout_per_head=True,
                        num_random_blocks=2, attention=attention),
    }


def _pair(kind, H, blk, causal):
    kw = dict(_configs(H, blk, causal)[kind])
    cls = kw.pop("cls")
    return (getattr(jsc, cls)(num_heads=H, block=blk, **kw),
            getattr(tsc, cls)(num_heads=H, block=blk, **kw))


@pytest.mark.parametrize("kind", ["fixed", "bslongformer", "bigbird"])
@pytest.mark.parametrize("blk", [16, 32])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_versions_match_pallas_interpret(kind, blk, causal):
    B, S, H, D = 2, 128, 2, 32
    q, k, v, do = _qkv(B, S, H, D, seed=blk + causal)
    jcfg, tcfg = _pair(kind, H, blk, causal)
    layout = tcfg.make_layout(S)
    kidx, kcnt, qidx, qcnt = map(jnp.asarray, jbsa.layout_to_index_lists(layout))
    scale = 1.0 / np.sqrt(D)
    o_j, lse_j = jbsa._fwd(_to4(q), _to4(k), _to4(v), kidx, kcnt, scale, causal, blk, True)
    dq_j, dk_j, dv_j = jbsa._bwd(_to4(q), _to4(k), _to4(v), o_j, lse_j, _to4(do), kidx, kcnt,
                                 qidx, qcnt, scale, causal, blk, True)
    lists = tbsa.index_lists(tcfg, S, "cpu")
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o_t, lse_t = tbsa.block_sparse_attention_fwd_ref(tq, tk, tv, lists, causal)
    dq_t, dk_t, dv_t = tbsa.block_sparse_attention_bwd_ref(tq, tk, tv, o_t, lse_t, tdo, lists,
                                                           causal)
    back = lambda x: np.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    np.testing.assert_allclose(o_t.numpy(), back(o_j), atol=O_TOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], atol=O_TOL, rtol=1e-6)
    for got, ref in zip((dq_t, dk_t, dv_t), (dq_j, dk_j, dv_j)):
        np.testing.assert_allclose(got.numpy(), back(ref), atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("blk", [16, 32])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_grad_of_the_dense_path(blk, causal):
    """The dispatcher's default route (the autograd Function, plain
    versions on the CPU) against jax.grad of the masked dense path."""
    B, S, H, D = 1, 128, 4, 16
    q, k, v, _ = _qkv(B, S, H, D, seed=3 + blk)
    jcfg, tcfg = _pair("fixed", H, blk, causal)

    def loss_j(q, k, v):
        return jnp.sum(jssa.sparse_attention(q, k, v, jcfg, causal=causal, impl="jnp") ** 2)

    out_j = jssa.sparse_attention(q, k, v, jcfg, causal=causal, impl="jnp")
    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    before = dict(tbsa.DENSE_CALLS)
    out_t = sparse_attention(tq, tk, tv, tcfg, causal=causal)
    assert tbsa.DENSE_CALLS == before  # the block-sparse route, not the dense one
    g_t = torch.autograd.grad((out_t ** 2).sum(), (tq, tk, tv))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=O_TOL, rtol=0)
    for got, ref in zip(g_t, g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_TOL, rtol=0)


def test_fully_masked_row_gives_zero_output_and_grads():
    """A custom layout whose first query block lists only the block above the
    diagonal: under the causal rule its rows see nothing. o is exactly 0,
    lse is the +1e30 poison, and the rows' grads are exactly 0, as in the
    Pallas kernel and the dense path."""
    B, S, H, D, blk = 1, 64, 1, 16, 16
    q, k, v, do = _qkv(B, S, H, D, seed=7)
    nb = S // blk
    layout = np.zeros((H, nb, nb), bool)
    layout[0, 0, 1] = True
    for i in range(1, nb):
        layout[0, i, : i + 1] = True
    scale = 1.0 / np.sqrt(D)
    kidx, kcnt, qidx, qcnt = map(jnp.asarray, jbsa.layout_to_index_lists(layout))
    o_j, lse_j = jbsa._fwd(_to4(q), _to4(k), _to4(v), kidx, kcnt, scale, True, blk, True)
    grads_j = jbsa._bwd(_to4(q), _to4(k), _to4(v), o_j, lse_j, _to4(do), kidx, kcnt, qidx, qcnt,
                        scale, True, blk, True)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o_t = tbsa.block_sparse_attention(tq, tk, tv, layout, blk, causal=True)
    grads_t = torch.autograd.grad(o_t, (tq, tk, tv), torch.from_numpy(do))
    assert float(o_t.detach()[:, :blk].abs().max()) == 0.0
    assert float(grads_t[0][:, :blk].abs().max()) == 0.0
    lists = tbsa.lists_from_layout(layout, blk, "cpu")
    _, lse_t = tbsa.block_sparse_attention_fwd_ref(tq.detach(), tk.detach(), tv.detach(), lists,
                                                   True)
    assert bool((lse_t[:, :, :blk] == 1e30).all())
    back = lambda x: np.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    np.testing.assert_allclose(o_t.detach().numpy(), back(o_j), atol=O_TOL, rtol=0)
    for got, ref in zip(grads_t, grads_j):
        np.testing.assert_allclose(got.numpy(), back(ref), atol=GRAD_TOL, rtol=0)


def test_dense_layout_equals_full_attention():
    from deepspeed_tpu_torch.ops.attention import bidirectional_attention_ref, causal_attention_ref

    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(1, 64, 2, 16, seed=4))
    cfg = tsc.DenseSparsityConfig(num_heads=2, block=16)
    torch.testing.assert_close(sparse_attention(q, k, v, cfg, causal=True),
                               causal_attention_ref(q, k, v), atol=1e-5, rtol=0)
    torch.testing.assert_close(sparse_attention(q, k, v, cfg, causal=False),
                               bidirectional_attention_ref(q, k, v), atol=1e-5, rtol=0)


def test_key_mask_routes_to_the_dense_path_and_matches_jax():
    B, S, H, D = 2, 64, 2, 16
    q, k, v, _ = _qkv(B, S, H, D, seed=9)
    mask = np.ones((B, S), np.int32)
    mask[1, 40:] = 0
    jcfg, tcfg = _pair("bslongformer", H, 16, False)
    out_j = jssa.sparse_attention(q, k, v, jcfg, key_mask=jnp.asarray(mask), impl="jnp")
    before = tbsa.DENSE_CALLS["sparse_attention_dense"]
    launches = dict(tbsa.LAUNCHES)
    out_t = sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)), tcfg,
                             key_mask=torch.from_numpy(mask))
    assert tbsa.DENSE_CALLS["sparse_attention_dense"] == before + 1
    assert tbsa.LAUNCHES == launches
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=O_TOL, rtol=0)


def test_jnp_impl_is_the_dense_path_on_the_cpu():
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(1, 64, 2, 16, seed=2))
    cfg = tsc.FixedSparsityConfig(num_heads=2, block=16, attention="unidirectional")
    before = tbsa.DENSE_CALLS["sparse_attention_dense"]
    dense = sparse_attention(q, k, v, cfg, causal=True, impl="jnp")
    assert tbsa.DENSE_CALLS["sparse_attention_dense"] == before + 1
    torch.testing.assert_close(dense, sparse_attention(q, k, v, cfg, causal=True), atol=1e-5,
                               rtol=0)


def test_dispatcher_refusals():
    q = torch.zeros(1, 64, 2, 16)
    cfg = tsc.FixedSparsityConfig(num_heads=2, block=16)
    with pytest.raises(ValueError, match="heads"):
        sparse_attention(q, q, q, tsc.FixedSparsityConfig(num_heads=4, block=16))
    with pytest.raises(ValueError, match="impl"):
        sparse_attention(q, q, q, cfg, impl="triton")
    meta = torch.zeros(1, 64, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        sparse_attention(meta, meta, meta, cfg)


def test_jnp_impl_is_refused_for_cuda_tensors(monkeypatch):
    """``impl="jnp"`` names the plain version, which the card never runs: a
    CUDA tensor is refused before anything else happens (checked here with
    a tensor that reports the cuda device type)."""

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    q = torch.zeros(1, 64, 2, 16).as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="jnp"):
        sparse_attention(q, q, q, tsc.FixedSparsityConfig(num_heads=2, block=16), impl="jnp")


def test_key_mask_warns_at_long_sequences():
    S = 2048
    q = torch.zeros(1, S, 1, 16)
    cfg = tsc.FixedSparsityConfig(num_heads=1, block=128)
    with pytest.warns(UserWarning, match="key_mask"):
        sparse_attention(q, q, q, cfg, key_mask=torch.ones(1, S))


def test_index_lists_cached_per_config_length_and_device():
    tbsa._CACHE.clear()
    before = dict(tbsa.CACHE_STATS)
    cfg = tsc.FixedSparsityConfig(num_heads=2, block=16)
    a = tbsa.index_lists(cfg, 128, "cpu")
    b = tbsa.index_lists(tsc.FixedSparsityConfig(num_heads=2, block=16), 128, "cpu")
    assert a is b  # an equal config is the same entry
    assert tbsa.CACHE_STATS["misses"] == before["misses"] + 1
    assert tbsa.CACHE_STATS["hits"] == before["hits"] + 1
    assert tbsa.index_lists(cfg, 256, "cpu") is not a
    assert tbsa.index_lists(tsc.FixedSparsityConfig(num_heads=2, block=32), 128, "cpu") is not a
    q = torch.zeros(1, 128, 2, 16)
    misses = tbsa.CACHE_STATS["misses"]
    for _ in range(3):  # layers and steps of one model reuse the entry
        sparse_attention(q, q, q, cfg)
    assert tbsa.CACHE_STATS["misses"] == misses
    np.testing.assert_array_equal(a.kidx.numpy(), tbsa.layout_to_index_lists(a.layout)[0])


def test_module_api_matches_jax():
    B, S, H, D = 1, 64, 4, 16
    q, k, v, _ = _qkv(B, S, H, D, seed=5)
    jmod = jssa.SparseSelfAttention(jsc.FixedSparsityConfig(num_heads=H, block=16), impl="jnp")
    tmod = SparseSelfAttention(tsc.FixedSparsityConfig(num_heads=H, block=16))
    assert isinstance(tmod, torch.nn.Module) and not list(tmod.parameters())
    out_t = tmod(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(jmod(q, k, v)), atol=O_TOL, rtol=0)


def test_layout_shape_is_checked():
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="layout"):
        tbsa.block_sparse_attention(q, q, q, np.ones((2, 3, 3), bool), 16)
