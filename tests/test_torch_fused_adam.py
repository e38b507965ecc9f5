"""The port's fused AdamW / LAMB (``deepspeed_tpu_torch.ops.fused_adam``) on
the CPU, where its entries run the plain versions, against the JAX
package's Pallas functions in interpret mode and against optax, from the
same numpy inputs; the cases and tolerances of
``tests/unit/ops/test_fused_adam.py`` (2e-6 for AdamW, 1e-4 over 3 bf16-grad
steps, 3e-5 for LAMB). Then the multi-tensor entries the optimizers call:
the three Adam modes with a per-leaf decay, LAMB's per-leaf trust ratio
with and without the clamp, a zero-norm leaf, and the dispatch, which
takes the plain version only for CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeed_tpu.ops import fused_adam as jfa
from deepspeed_tpu_torch.ops import fused_adam as tfa


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


@pytest.mark.parametrize("n", [1024 * 8, 1000, 3])  # aligned, pad, tiny
def test_flat_matches_pallas_and_optax(n):
    rs = np.random.RandomState(0)
    p = rs.randn(n).astype(np.float32)
    g = rs.randn(n).astype(np.float32)
    lr, wd = 1e-3, 0.01
    tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
    updates, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(p)), jnp.asarray(p))
    p_ref = np.asarray(optax.apply_updates(jnp.asarray(p), updates))
    z = jnp.zeros(n, jnp.float32)
    pj, mj, vj = jfa.fused_adamw_flat(jnp.asarray(p), jnp.asarray(g), z, z, jnp.int32(1), lr,
                                      (0.9, 0.999), 1e-8, wd, interpret=True)
    zt = torch.zeros(n)
    pt, mt, vt = tfa.fused_adamw_flat(_t(p), _t(g), zt, zt, 1, lr, (0.9, 0.999), 1e-8, wd)
    np.testing.assert_allclose(pt.numpy(), p_ref, rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=2e-6, atol=2e-7)
    # m and v in optax's arithmetic: (1 - b) rounded from double (the
    # Pallas kernel forms 1 - b2 in f32, 1.3e-5 off for b2 = 0.999)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-6)
    np.testing.assert_allclose(mt.numpy(), 0.1 * g, rtol=1e-6)
    np.testing.assert_allclose(vt.numpy(), g * g * np.float32(1 - 0.999), rtol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=2e-5)
    assert float(zt.abs().max()) == 0.0  # the flat entry returns new tensors


def test_multi_step_bf16_grads_match_pallas_and_optax():
    rs = np.random.RandomState(1)
    n = 2048
    p = jnp.asarray(rs.randn(n), jnp.float32)
    tx = optax.adamw(1e-2, weight_decay=0.1)
    state = tx.init(p)
    p_ref, p_j = p, p
    m_j = v_j = jnp.zeros_like(p)
    p_t, m_t, v_t = _t(p), torch.zeros(n), torch.zeros(n)
    for t in range(1, 4):
        g = jnp.asarray(rs.randn(n), jnp.float32).astype(jnp.bfloat16)
        u, state = tx.update(g.astype(jnp.float32), state, p_ref)
        p_ref = optax.apply_updates(p_ref, u)
        p_j, m_j, v_j = jfa.fused_adamw_flat(p_j, g, m_j, v_j, jnp.int32(t), 1e-2,
                                             weight_decay=0.1, interpret=True)
        g_t = _t(g.astype(jnp.float32)).to(torch.bfloat16)
        p_t, m_t, v_t = tfa.fused_adamw_flat(p_t, g_t, m_t, v_t, t, 1e-2, weight_decay=0.1)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-4, atol=1e-5)


def test_tree_matches_pallas_and_optax():
    rs = np.random.RandomState(2)
    params = {"a": rs.randn(4, 300).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    grads = {k: np.full_like(v, 0.5) for k, v in params.items()}
    jp = jax.tree.map(jnp.asarray, params)
    zeros = jax.tree.map(jnp.zeros_like, jp)
    pj, _, _ = jfa.fused_adamw_tree(jp, jax.tree.map(jnp.asarray, grads), zeros, zeros,
                                    jnp.int32(1), 1e-3, interpret=True)
    tp = {k: _t(v) for k, v in params.items()}
    tz = {k: torch.zeros_like(v) for k, v in tp.items()}
    pt, mt, vt = tfa.fused_adamw_tree(tp, {k: _t(v) for k, v in grads.items()}, tz, tz, 1, 1e-3)
    assert pt.keys() == params.keys() and mt.keys() == params.keys()
    tx = optax.adamw(1e-3, weight_decay=0.0)
    u, _ = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(jp), jp)
    ref = optax.apply_updates(jp, u)
    for k in params:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(ref[k]), rtol=2e-6, atol=2e-7)
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=2e-6, atol=2e-7)


@pytest.mark.parametrize("clamp", [False, True])
def test_lamb_flat_matches_pallas_and_optax(clamp):
    """Unclamped (the bounds the JAX test passes) against optax.lamb and the
    Pallas function; clamped at the defaults [0.01, 10] against the Pallas
    function, on a tensor whose ratio lies above 10."""
    n = 4096
    rs = np.random.RandomState(3)
    scale = 50.0 if clamp else 1.0
    p = (rs.randn(n) * scale).astype(np.float32)
    g = (rs.randn(n) * 0.1).astype(np.float32)
    bounds = {} if clamp else {"min_trust": 0.0, "max_trust": 1e9}
    z = jnp.zeros(n, jnp.float32)
    pj, mj, vj = jfa.fused_lamb_flat(jnp.asarray(p), jnp.asarray(g), z, z, jnp.int32(1), 1e-2,
                                     (0.9, 0.999), 1e-6, 0.05, interpret=True, **bounds)
    zt = torch.zeros(n)
    pt, mt, vt = tfa.fused_lamb_flat(_t(p), _t(g), zt, zt, 1, 1e-2, (0.9, 0.999), 1e-6, 0.05,
                                     **bounds)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=2e-5)  # 1 - b2, as above
    if clamp:
        # the clamp bites: unclamped, ||p|| / ||u|| is ~19
        pu, _, _ = tfa.fused_lamb_flat(_t(p), _t(g), zt, zt, 1, 1e-2, (0.9, 0.999), 1e-6, 0.05,
                                       min_trust=0.0, max_trust=1e9)
        moved, moved_unclamped = (np.abs(p - x.numpy()).max() for x in (pt, pu))
        assert moved < 0.6 * moved_unclamped, (moved, moved_unclamped)  # trust ~19 → 10
    else:
        tx = optax.lamb(1e-2, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.05)
        u, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(p)), jnp.asarray(p))
        p_ref = optax.apply_updates(jnp.asarray(p), u)
        np.testing.assert_allclose(pt.numpy(), np.asarray(p_ref), rtol=3e-5, atol=3e-6)


def _tree(seed):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(6, 10).astype(np.float32), "b": rs.randn(10).astype(np.float32),
            "s": rs.randn(2, 3, 5).astype(np.float32), "z": np.zeros((4, 4), np.float32)}


def _optax_adam(mode, lr, wd):
    mask = lambda tree: jax.tree.map(lambda x: x.ndim >= 2, tree)  # noqa: E731
    if mode == "decoupled":
        return optax.adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd, mask=mask)
    if mode == "l2":
        return optax.chain(optax.add_decayed_weights(wd, mask=mask),
                           optax.adam(lr, b1=0.9, b2=0.95, eps=1e-8))
    return optax.adam(lr, b1=0.9, b2=0.95, eps=1e-8)


@pytest.mark.parametrize("mode", ["decoupled", "l2", "none"])
def test_multi_tensor_adam_modes_match_optax(mode):
    """Three steps over a mixed-rank tree with the ndim >= 2 decay mask,
    handed over as one per-leaf weight decay."""
    params = _tree(4)
    jp = jax.tree.map(jnp.asarray, params)
    tx = _optax_adam(mode, 1e-2, 0.1)
    st = tx.init(jp)
    names = sorted(params)
    tp = [_t(params[k]) for k in names]
    mus, nus = [torch.zeros_like(x) for x in tp], [torch.zeros_like(x) for x in tp]
    wds = [0.1 if params[k].ndim >= 2 else 0.0 for k in names]
    rs = np.random.RandomState(5)
    for step in range(1, 4):
        grads = {k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        u, st = tx.update(jax.tree.map(jnp.asarray, grads), st, jp)
        jp = optax.apply_updates(jp, u)
        tfa.multi_tensor_adam_(tp, [_t(grads[k]) for k in names], mus, nus, step, 1e-2,
                               (0.9, 0.95), 1e-8, wds, mode)
    for k, got in zip(names, tp):
        np.testing.assert_allclose(got.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("clamp", [False, True])
def test_multi_tensor_lamb_per_leaf_trust_and_zero_norm_leaf(steps, clamp):
    """LAMB over a tree: one trust ratio per leaf (a stacked [2, 3, 5] leaf
    gets one, not one per layer), the all-zero leaf takes trust 1 (its
    ||p|| is 0), unclamped against optax.lamb and clamped against the flat
    Pallas function applied leaf by leaf."""
    params = _tree(6)
    names = sorted(params)
    tp = [_t(params[k]) for k in names]
    mus, nus = [torch.zeros_like(x) for x in tp], [torch.zeros_like(x) for x in tp]
    jp = jax.tree.map(jnp.asarray, params)
    tx = optax.lamb(1e-2, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.05)
    st = tx.init(jp)
    jflat = {k: (jnp.asarray(params[k]).reshape(-1),) + (jnp.zeros(params[k].size),) * 2
             for k in names}
    rs = np.random.RandomState(7)
    for step in range(1, steps + 1):
        grads = {k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        tfa.multi_tensor_lamb_(tp, [_t(grads[k]) for k in names], mus, nus, step, 1e-2,
                               (0.9, 0.999), 1e-6, [0.05] * len(names),
                               *((0.01, 10.0) if clamp else (None, None)))
        if clamp:
            for k in names:
                jflat[k] = jfa.fused_lamb_flat(*jflat[k][:1], jnp.asarray(grads[k]).reshape(-1),
                                               *jflat[k][1:], jnp.int32(step), 1e-2,
                                               (0.9, 0.999), 1e-6, 0.05, interpret=True)
        else:
            u, st = tx.update(jax.tree.map(jnp.asarray, grads), st, jp)
            jp = optax.apply_updates(jp, u)
    for k, got in zip(names, tp):
        ref = np.asarray(jflat[k][0]).reshape(params[k].shape) if clamp else np.asarray(jp[k])
        np.testing.assert_allclose(got.numpy(), ref, rtol=3e-5, atol=3e-6, err_msg=k)


def test_zero_norm_leaf_moves_by_lr_times_u():
    """At step 1 with wd 0 a zero leaf has ||p|| = 0: trust 1, so p' = -lr *
    m^ / (sqrt(v^) + eps) = -lr * sign(g) (to eps)."""
    p, g = torch.zeros(8), torch.linspace(-1, 1, 8) + 0.01
    m, v = torch.zeros(8), torch.zeros(8)
    tfa.multi_tensor_lamb_([p], [g], [m], [v], 1, 0.5, (0.9, 0.999), 1e-6, [0.0])
    np.testing.assert_allclose(p.numpy(), -0.5 * np.sign(g.numpy()), rtol=1e-4)


def test_dispatch_has_no_other_route():
    """CPU tensors run the plain version; any other device raises instead
    of finding a fallback; the launch counts stay 0 on the CPU."""
    before = dict(tfa.LAUNCHES)
    x = [torch.zeros(4, device="meta")]
    with pytest.raises(ValueError, match="no implementation"):
        tfa.multi_tensor_adam_(x, x, x, x, 1, 1e-3)
    with pytest.raises(ValueError, match="no implementation"):
        tfa.multi_tensor_lamb_(x, x, x, x, 1, 1e-3)
    p = [torch.ones(4)]
    tfa.multi_tensor_adam_(p, [torch.ones(4)], [torch.zeros(4)], [torch.zeros(4)], 1, 1e-3)
    assert tfa.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors_and_host_reads():
    p = [torch.ones(4)]
    z = [torch.zeros(4)]
    with pytest.raises(ValueError, match="CUDA"):
        tfa.multi_tensor_adam(p, p, z, z, 1, 1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.multi_tensor_lamb(p, p, z, z, 1, 1e-3)
    with pytest.raises(TypeError, match="Python numbers"):
        tfa.multi_tensor_adam_(p, p, z, z, torch.tensor(1), 1e-3)
    with pytest.raises(ValueError, match="shapes"):
        tfa.multi_tensor_adam_(p, [torch.ones(5)], z, z, 1, 1e-3)
    with pytest.raises(ValueError, match="mode"):
        tfa.multi_tensor_adam_(p, p, z, z, 1, 1e-3, mode="adagrad")


def test_bias_corrections_are_optax_f32():
    """f32 bias corrections: equal to optax's at the first steps; later
    within 1e-5 relative (XLA's f32 pow and torch's round b**t differently
    by an ulp or two of b**t, which 1 - b**t magnifies)."""
    for t in (1, 2, 10, 1000):
        got = tfa.bias_corrections((0.9, 0.999), t)
        want = [float(1 - b ** jnp.asarray(t, jnp.int32)) for b in (0.9, 0.999)]
        assert got == pytest.approx(want, rel=1e-5 if t > 2 else 0, abs=0)
