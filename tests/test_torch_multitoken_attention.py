"""The paged multi-token kernel's plain version (the CPU path) against the
JAX package's Pallas kernel in interpret mode and against its jnp fallback,
on the cases of ``tests/unit/ops/test_decode_attention.py::TestPagedMultitoken``:
ragged base, a GQA pool, future positions masked, each query slice equal to
the single-token plain version. Tolerance 1e-5 (fp32; not bitwise: the two
frameworks reduce in different orders). The kernel itself runs only on the
card (``test_torch_cuda_kernels.py``); here its wrapper must refuse CPU
tensors and the launch count must stay 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import (
    paged_multitoken_cached_attention as j_multitoken_cached,
)
from deepspeed_tpu.ops.pallas.decode_attention import (
    paged_multitoken_attention as j_multitoken_kernel,
)
from deepspeed_tpu_torch.ops import paged_decode_attention as pda
from deepspeed_tpu_torch.ops import paged_multitoken_attention as pma
from deepspeed_tpu_torch.ops.attention import paged_multitoken_cached_attention

TOL = dict(atol=1e-5, rtol=1e-5)


def _setup(B=3, T=4, H=4, KV=4, D=64, page=8, P=24, n=4, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, T, H, D).astype(np.float32)
    kp = rs.randn(P, KV, page, D).astype(np.float32)
    vp = rs.randn(P, KV, page, D).astype(np.float32)
    bt = rs.choice(np.arange(1, P), (B * n,), replace=False).reshape(B, n).astype(np.int32)
    return q, kp, vp, bt


def _port(q, kp, vp, bt, base):
    t = torch.from_numpy
    return pma.paged_multitoken_attention_ref(
        t(q), t(kp), t(vp), t(bt), t(np.asarray(base, np.int32))
    ).numpy()


def _jax_kernel(q, kp, vp, bt, base):
    return np.asarray(j_multitoken_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(base, jnp.int32), interpret=True,
    ))


def _jax_fallback(q, kp, vp, bt, base):
    return np.asarray(j_multitoken_cached(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(base, jnp.int32), impl="jnp",
    ))


@pytest.mark.parametrize("base", [[0, 13, 27], [3, 11, 19], [0, 0, 0], [7, 8, 28]])
def test_plain_version_matches_the_pallas_kernel_and_fallback(base):
    q, kp, vp, bt = _setup()
    got = _port(q, kp, vp, bt, base)
    np.testing.assert_allclose(got, _jax_kernel(q, kp, vp, bt, base), **TOL)
    np.testing.assert_allclose(got, _jax_fallback(q, kp, vp, bt, base), **TOL)


def test_gqa_pool():
    q, _, _, bt = _setup()
    rs = np.random.RandomState(3)
    kp = rs.randn(24, 2, 8, 64).astype(np.float32)  # KV=2 < H=4
    vp = rs.randn(24, 2, 8, 64).astype(np.float32)
    base = [1, 9, 22]
    got = _port(q, kp, vp, bt, base)
    np.testing.assert_allclose(got, _jax_kernel(q, kp, vp, bt, base), **TOL)
    np.testing.assert_allclose(got, _jax_fallback(q, kp, vp, bt, base), **TOL)


def test_long_chunk_against_the_pallas_kernel():
    """A chunk-prefill shape: one slot, 16 queries spanning two pages of a
    table whose tail is scratch-padded."""
    q, kp, vp, bt = _setup(B=1, T=16, n=6, seed=5)
    bt[0, 4:] = 0
    base = [16]
    got = _port(q, kp, vp, bt, base)
    np.testing.assert_allclose(got, _jax_kernel(q, kp, vp, bt, base), **TOL)
    np.testing.assert_allclose(got, _jax_fallback(q, kp, vp, bt, base), **TOL)


def test_each_query_slice_is_the_single_token_plain_version():
    """Query t of the T-token plain version equals the single-token plain
    version at pos = base + t (the shape the verify step relies on)."""
    q, kp, vp, bt = _setup(seed=2)
    base = np.asarray([3, 11, 19], np.int32)
    t = torch.from_numpy
    mt = _port(q, kp, vp, bt, base)
    for i in range(q.shape[1]):
        st = pda.paged_decode_attention_ref(
            t(np.ascontiguousarray(q[:, i])), t(kp), t(vp), t(bt), t(base + i)
        ).numpy()
        np.testing.assert_allclose(mt[:, i], st, **TOL)


def test_causal_offsets_mask_future_positions():
    """Query t sees positions <= base + t: poisoning position base+2 changes
    queries 2.. but leaves queries 0..1 untouched."""
    q, kp, vp, bt = _setup(B=1, seed=4)
    base = [8]  # positions 8..11 are queries 0..3
    out1 = _port(q, kp, vp, bt, base)
    pg, off = int(bt[0, 10 // 8]), 10 % 8  # position base+2 = 10
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[pg, :, off] = 99.0
    vp2[pg, :, off] = -99.0
    out2 = _port(q, kp2, vp2, bt, base)
    np.testing.assert_array_equal(out1[:, :2], out2[:, :2])
    assert not np.allclose(out1[:, 2:], out2[:, 2:])
    np.testing.assert_allclose(out2, _jax_kernel(q, kp2, vp2, bt, base), **TOL)


def test_bad_head_ratio_raises():
    q, _, _, bt = _setup()
    kp = np.zeros((24, 3, 8, 64), np.float32)
    with pytest.raises(ValueError, match="divide"):
        _port(q, kp, kp, bt, [0, 0, 0])


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    q, kp, vp, bt = _setup(seed=3)
    t = torch.from_numpy
    base = [2, 17, 26]
    got = paged_multitoken_cached_attention(
        t(q), t(kp), t(vp), t(bt), t(np.asarray(base, np.int32))
    )
    np.testing.assert_array_equal(got.numpy(), _port(q, kp, vp, bt, base))
    assert pma.LAUNCHES["paged_multitoken_attention"] == 0


def test_kernel_wrapper_refuses_cpu_tensors_and_int8_scales():
    q, kp, vp, bt = _setup()
    t = torch.from_numpy
    args = (t(q), t(kp), t(vp), t(bt), t(np.zeros(3, np.int32)))
    with pytest.raises(ValueError, match="CUDA"):
        pma.paged_multitoken_attention(*args)
    # scales belong to an int8 pool only (the wrapper and the dispatcher
    # both say so), and an int8 pool on the CPU is refused as any CPU tensor
    with pytest.raises(TypeError, match="int8"):
        pma.paged_multitoken_attention(*args, scales=torch.ones(24, 4, 2))
    with pytest.raises(ValueError, match="int8"):
        paged_multitoken_cached_attention(*args, scales=torch.ones(24, 4, 2))
    kq = torch.zeros(24, 4, 8, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        pma.paged_multitoken_attention(args[0], kq, kq, *args[3:], scales=torch.ones(24, 4, 2))
    assert not any(pma.LAUNCHES[k] for k in pma.KERNELS)
