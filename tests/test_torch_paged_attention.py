"""The paged decode kernel's plain version (the CPU path) against the JAX
package's Pallas kernel in interpret mode and against its jnp fallback, on
the cases of ``tests/unit/ops/test_decode_attention.py::TestPagedDecode``.
Tolerance 1e-5 (fp32). The kernel itself runs only on the card
(``test_torch_cuda_kernels.py``); here its wrapper must refuse CPU tensors
and the launch count must stay 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import paged_cached_attention as j_paged_cached
from deepspeed_tpu.ops.pallas.decode_attention import paged_decode_attention as j_paged_kernel
from deepspeed_tpu_torch.ops import paged_decode_attention as pda
from deepspeed_tpu_torch.ops.attention import paged_cached_attention

TOL = dict(atol=1e-5, rtol=1e-5)


def _setup(B=3, H=4, KV=4, D=64, page=8, P=16, n=4, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, D).astype(np.float32)
    kp = rs.randn(P, KV, page, D).astype(np.float32)
    vp = rs.randn(P, KV, page, D).astype(np.float32)
    # distinct non-scratch pages per slot: the gather must follow the table
    bt = rs.choice(np.arange(1, P), (B * n,), replace=False).reshape(B, n).astype(np.int32)
    return q, kp, vp, bt


def _port(q, kp, vp, bt, pos):
    t = torch.from_numpy
    return pda.paged_decode_attention_ref(
        t(q), t(kp), t(vp), t(bt), t(np.asarray(pos, np.int32))
    ).numpy()


def _jax_kernel(q, kp, vp, bt, pos):
    return np.asarray(j_paged_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos, jnp.int32), interpret=True,
    ))


def _jax_fallback(q, kp, vp, bt, pos):
    return np.asarray(j_paged_cached(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos, jnp.int32), impl="jnp",
    ))


@pytest.mark.parametrize("pos", [[0, 13, 31], [5, 5, 5], [7, 8, 9]])
def test_plain_version_matches_the_pallas_kernel_and_fallback(pos):
    q, kp, vp, bt = _setup()
    got = _port(q, kp, vp, bt, pos)
    np.testing.assert_allclose(got, _jax_kernel(q, kp, vp, bt, pos), **TOL)
    np.testing.assert_allclose(got, _jax_fallback(q, kp, vp, bt, pos), **TOL)


def test_gqa_pool():
    q, _, _, bt = _setup()
    rs = np.random.RandomState(2)
    kp = rs.randn(16, 2, 8, 64).astype(np.float32)  # KV=2 < H=4
    vp = rs.randn(16, 2, 8, 64).astype(np.float32)
    pos = [3, 9, 30]
    got = _port(q, kp, vp, bt, pos)
    np.testing.assert_allclose(got, _jax_kernel(q, kp, vp, bt, pos), **TOL)
    np.testing.assert_allclose(got, _jax_fallback(q, kp, vp, bt, pos), **TOL)


def test_poisoned_scratch_entries_are_ignored():
    """Table entries past a slot's length point at the scratch page; what
    lives there, or in any page the slot does not own, never reaches the
    output."""
    q, kp, vp, bt = _setup(B=1, n=4)
    pos = [7]  # only the slot's first page is live
    out1 = _port(q, kp, vp, bt, pos)
    keep = int(bt[0, 0])
    poisoned, poisoned_v = kp.copy(), vp.copy()
    mask = np.arange(16) != keep
    poisoned[mask] = 99.0
    poisoned_v[mask] = -99.0
    bt_scratch = bt.copy()
    bt_scratch[0, 1:] = 0
    out2 = _port(q, poisoned, poisoned_v, bt_scratch, pos)
    np.testing.assert_allclose(out1, out2, atol=1e-6)
    np.testing.assert_allclose(
        out1, _jax_kernel(q, poisoned, poisoned_v, bt_scratch, pos), **TOL
    )


def test_bad_head_ratio_raises():
    q, _, _, bt = _setup()
    kp = np.zeros((16, 3, 8, 64), np.float32)
    with pytest.raises(ValueError, match="divide"):
        _port(q, kp, kp, bt, [0, 0, 0])


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    before = pda.LAUNCHES
    q, kp, vp, bt = _setup(seed=3)
    t = torch.from_numpy
    pos = t(np.asarray([2, 17, 30], np.int32))
    got = paged_cached_attention(t(q), t(kp), t(vp), t(bt), pos)
    np.testing.assert_array_equal(got.numpy(), _port(q, kp, vp, bt, [2, 17, 30]))
    assert pda.LAUNCHES == before == 0


def test_kernel_wrapper_refuses_cpu_tensors_and_int8_scales():
    q, kp, vp, bt = _setup()
    t = torch.from_numpy
    args = (t(q), t(kp), t(vp), t(bt), t(np.zeros(3, np.int32)))
    with pytest.raises(ValueError, match="CUDA"):
        pda.paged_decode_attention(*args)
    with pytest.raises(NotImplementedError, match="int8"):
        pda.paged_decode_attention(*args, scales=torch.ones(16, 4, 2))
    assert pda.LAUNCHES == 0
