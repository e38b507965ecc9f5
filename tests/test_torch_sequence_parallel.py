"""Sequence parallelism of the port (``parallel/sequence.py``,
``ops/ring_flash_attention.py``, GPT-2 over a dp x sp mesh) against the JAX
package on the CPU. The oracle is ``tests/unit/test_sequence_parallel.py``.

Every gloo case runs in one world-4 job started with the module
(``tests/torch_dist.py`` ``sequence_tp``); the JAX references are computed
while the ranks run, on 4 of the 8 virtual devices (dp 2 x sp 2 there is
rank r = dp r // 2, sp r % 2 here, the device order of JAX's mesh).

- ring and Ulysses against JAX's ``sequence_parallel_attention`` on the
  same mesh and against the dense attention: forward, the gradients of
  ``sum(o ** 2)``, non-causal, Ulysses' fallback to the ring;
- ring flash through the flash kernels' plain versions against JAX's
  ``impl="ring_flash", interpret=True`` at JAX's S512 D64;
- GPT-2 ``train_batch`` at dp 2 x sp 2 (ring, Ulysses, dropout 0.1, and
  the ring under the "attn" remat policy with ``ce_chunk``) against JAX's
  engine on the same mesh.

Tolerances are JAX's own: 2e-5 forward, 5e-5 the ring's and Ulysses'
gradients, 1e-4 ring flash's, 2e-4 the losses over 2 steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.attention import causal_attention_jnp
from deepspeed_tpu.parallel.sequence import sequence_parallel_attention as jspa
from deepspeed_tpu.parallel.sequence import shard_sequence as jshard
from deepspeed_tpu.parallel.topology import MeshSpec as JMeshSpec
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import ring_flash_attention as trfa
from deepspeed_tpu_torch.parallel import sequence as tseq

from tests import torch_dist
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-5, rtol=5e-5)
GRAD_FLASH = dict(atol=1e-4, rtol=1e-4)
LOSS = dict(atol=2e-4, rtol=2e-4)

DP2SP2 = {"dp": 2, "sp": 2}
SP4 = {"sp": 4}


def _qkv(B=2, S=64, H=8, D=16, seed=0):
    r = np.random.RandomState(seed)
    return tuple((r.randn(B, S, H, D) * 0.3).astype(np.float32) for _ in range(3))


QKV = _qkv()
QKV_H6 = _qkv(H=6, seed=1)
QKV_BIG = _qkv(B=2, S=512, H=2, D=64, seed=5)

ATTN = [
    ("ring", DP2SP2, "ring", True, *QKV),
    ("ulysses", DP2SP2, "ulysses", True, *QKV),
    ("ring_nc", SP4, "ring", False, *QKV),
    ("ulysses_nc", DP2SP2, "ulysses", False, *QKV),
    ("ulysses_fallback", SP4, "ulysses", True, *QKV_H6),
    ("ring_flash", DP2SP2, "ring_flash", True, *QKV_BIG),
]

CONF = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "zero_optimization": {"stage": 1}, "steps_per_print": 10**9}
TRAIN = [
    ("ring", {"attn_impl": "ring"}),
    ("ulysses", {"attn_impl": "ulysses"}),
    ("ring_dropout", {"attn_impl": "ring", "dropout": 0.1}),
    ("ring_remat_chunk", {"attn_impl": "ring", "remat": True, "remat_policy": "attn",
                          "ce_chunk": 48}),
]
# sp and tp together at dp 1 (JAX's spec P(dp, sp, tp, None): each rank
# its sequence columns and its heads), Ulysses over the local heads
SP2TP2 = {"dp": 1, "sp": 2, "tp": 2}
MIXED = [("ulysses_sp2_tp2", {"attn_impl": "ulysses", "dropout": 0.1})]


def _params():
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))


def _batches():
    ids = np.random.RandomState(0).randint(0, 512, size=(4, 128)).astype(np.int32)
    return [{"input_ids": ids}, {"input_ids": ids}]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    p, b = _params(), _batches()
    train = [(name, ov, dict(CONF, mesh=DP2SP2), p, b, {}) for name, ov in TRAIN]
    train += [(name, ov, dict(CONF, mesh=SP2TP2, train_micro_batch_size_per_gpu=4), p, b, {})
              for name, ov in MIXED]
    return torch_dist.start(4, "sequence_tp", (ATTN, train), tmp_path_factory.mktemp("sp"))


def _jmesh(shape, devices):
    n = int(np.prod(list(shape.values())))
    return JMeshSpec(**shape, devices=devices[:n]).build_mesh()


def _assemble(job, name, like):
    """The ranks' outputs placed at their rows and columns of the whole."""
    out = np.zeros_like(like)
    for res in job:
        r = res[f"attn:{name}"]
        o = r["o"]
        dp_r, sp_r = r["coords"]
        b0, s0 = dp_r * o.shape[0], sp_r * o.shape[1]
        out[b0:b0 + o.shape[0], s0:s0 + o.shape[1]] = o
    return out


def _grads(job, name):
    return [sum(res[f"attn:{name}"]["grads"][i] for res in job) for i in range(3)]


def _dense(q, k, v, causal):
    if causal:
        return causal_attention_jnp(q, k, v)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(logits, axis=-1), v)


@pytest.mark.parametrize("name,shape,impl,causal", [c[:4] for c in ATTN[:5]])
def test_attention_matches_jax_and_dense(job, devices, name, shape, impl, causal):
    """Each rank's shard of the output equals JAX's sequence-parallel
    attention on the same mesh and the dense attention; the gradients of
    ``sum(o ** 2)``, summed over the ranks' shards, equal the dense
    ones."""
    q, k, v = (jnp.asarray(x) for x in next(c for c in ATTN if c[0] == name)[4:])
    mesh = _jmesh(shape, devices)
    want_sp = np.asarray(jax.jit(lambda q, k, v: jspa(q, k, v, mesh, impl=impl, causal=causal))(
        *jshard((q, k, v), mesh)))
    want = np.asarray(_dense(q, k, v, causal))
    dense_grads = jax.grad(lambda q, k, v: jnp.sum(_dense(q, k, v, causal) ** 2),
                           argnums=(0, 1, 2))(q, k, v)
    got = _assemble(job, name, np.asarray(q))
    np.testing.assert_allclose(got, want_sp, **FWD)
    np.testing.assert_allclose(got, want, **FWD)
    for g, w, which in zip(_grads(job, name), dense_grads, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD, err_msg=f"d{which}")


def test_ring_flash_matches_jax_interpret(job, devices):
    """Ring flash (the flash kernels' plain versions each step on the CPU)
    against JAX's ring flash in interpret mode at JAX's S512 D64 on dp 2 x
    sp 2: the output and the gradients."""
    q, k, v = (jnp.asarray(x) for x in QKV_BIG)
    mesh = _jmesh(DP2SP2, devices)

    def loss(q, k, v):
        return jnp.sum(jspa(q, k, v, mesh, impl="ring_flash", interpret=True) ** 2)

    sharded = jshard((q, k, v), mesh)
    want = np.asarray(jax.jit(lambda q, k, v: jspa(q, k, v, mesh, impl="ring_flash",
                                                   interpret=True))(*sharded))
    want_g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*sharded)
    np.testing.assert_allclose(_assemble(job, "ring_flash", np.asarray(q)), want, **FWD)
    for g, w, which in zip(_grads(job, "ring_flash"), want_g, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_FLASH, err_msg=f"d{which}")


@pytest.mark.parametrize("name,overrides", TRAIN)
def test_gpt2_train_batch_matches_jax_engine(job, devices, name, overrides):
    """GPT-2 ``train_batch`` at dp 2 x sp 2 against ``DeepSpeedEngine`` on
    the same mesh from the same weights and batches: the losses of 2 steps
    (the JAX engine's attention per the case; its "attn" policy and chunked
    loss where the case has them), on every rank."""
    mesh = _jmesh(DP2SP2, devices)
    cfg = jgpt2.get_config("gpt2-tiny", mesh=mesh, **overrides)
    eng = JEngine(jgpt2.make_module(cfg), dict(CONF, mesh=DP2SP2), mesh=mesh,
                  params=jax.tree.map(jnp.asarray, _params()), seed=0)
    want = [float(eng.train_batch(b)["loss"]) for b in _batches()]
    for res in job:
        r = res[name]
        assert r["mesh"] == DP2SP2
        np.testing.assert_allclose(r["loss"], want, **LOSS)


@pytest.mark.parametrize("name,overrides", MIXED)
def test_gpt2_over_sp_and_tp_matches_jax_engine(job, devices, name, overrides):
    """dp 1 x sp 2 x tp 2: each rank its sequence columns and its heads
    (JAX's spec ``P(dp, sp, tp, None)``), the vocab-parallel head and the
    dropout's row stride, against JAX's engine on the same mesh."""
    mesh = _jmesh(SP2TP2, devices)
    cfg = jgpt2.get_config("gpt2-tiny", mesh=mesh, **overrides)
    conf = dict(CONF, mesh=SP2TP2, train_micro_batch_size_per_gpu=4)
    eng = JEngine(jgpt2.make_module(cfg), conf, mesh=mesh,
                  params=jax.tree.map(jnp.asarray, _params()), seed=0)
    want = [float(eng.train_batch(b)["loss"]) for b in _batches()]
    for res in job:
        assert res[name]["mesh"] == {"sp": 2, "tp": 2}
        np.testing.assert_allclose(res[name]["loss"], want, **LOSS)


def test_remat_and_chunked_loss_keep_the_shard_trajectory(job):
    """The "attn" remat policy and the chunked loss change nothing on a
    shard: the losses and norms equal the plain ring's."""
    for res in job:
        np.testing.assert_allclose(res["ring_remat_chunk"]["loss"], res["ring"]["loss"],
                                   rtol=1e-6)
        np.testing.assert_allclose(res["ring_remat_chunk"]["grad_norm"],
                                   res["ring"]["grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("s_loc,d,ok", [(64, 64, False), (128, 48, False), (128, 64, True),
                                        (256, 128, True), (128, 192, False), (0, 64, False)])
def test_ring_flash_ok(s_loc, d, ok):
    """JAX's cases (S_loc a multiple of 128, D a multiple of 64) read
    against the port's kernels, which take D 64, 128 and 256."""
    assert trfa.ring_flash_ok(s_loc, d, 4) is ok
    if s_loc % 128 == 0 and s_loc and d % 64 == 0 and d <= 128:
        from deepspeed_tpu.ops.pallas.ring_flash_attention import ring_flash_ok

        assert ring_flash_ok(s_loc, d, 4) is ok


def test_ring_flash_forced_on_a_misfit_shard_raises():
    """``ring_flash`` forced on a shard the kernels do not take raises, as
    JAX's does; it never becomes the plain ring."""
    q = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="ring flash needs"):
        trfa.ring_flash_attention(q, q, q)


def test_online_merge_equals_merge_partials():
    """The ring's online merge (JAX's ``_merge``) over four blocks equals
    the all-at-once merge of ``ops.decode_attention.merge_partials``; a
    masked block (lse -1e30) merges to nothing."""
    rs = np.random.RandomState(2)
    B, S, H, D, n = 2, 8, 3, 16, 4
    os_ = [torch.from_numpy(rs.randn(B, S, H, D).astype(np.float32)) for _ in range(n)]
    lses = [torch.from_numpy(rs.randn(B, H, S).astype(np.float32)) for _ in range(n)]
    lses[2] = torch.full((B, H, S), -1e30)
    u = torch.zeros(B, S, H, D)
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros(B, H, S)
    for o, lse in zip(os_, lses):
        u, m, l = trfa._merge(u, m, l, o, lse)
    got = u / l.transpose(1, 2)[..., None]
    live = [i for i in range(n) if i != 2]
    ms = torch.stack([lses[i] for i in live], -1)             # [B, H, S, k]
    acc = torch.stack([os_[i].permute(0, 2, 1, 3) for i in live], -2)  # [B, H, S, k, D]
    want = tda.merge_partials(ms, torch.ones_like(ms), acc).permute(0, 2, 1, 3)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_no_sp_axis_falls_back_to_dense():
    """Without a mesh (or an sp axis) it is the dense causal attention of
    the local tensors, as JAX's falls back."""
    q, k, v = (torch.from_numpy(x[:, :16]) for x in QKV)
    got = tseq.sequence_parallel_attention(q, k, v, None, impl="ring")
    want = causal_attention_jnp(*(jnp.asarray(x[:, :16]) for x in QKV))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(ValueError, match="unknown sequence-parallel impl"):
        tseq.sequence_parallel_attention(q, k, v, None, impl="striped")
