"""Dropout with JAX's masks on the CPU: the port's plain ``dropout``
(``ops/dropout.py``) against the JAX package's GPT-2 ``_dropout`` bit for
bit in f32, bf16 and fp16 with its gradient (tolerance 0), the kernel's
wrappers refusing CPU tensors, every remat policy recomputing the same
masks, and the engine's eval keys. The training trajectories against
``DeepSpeedEngine`` are in ``test_torch_dropout_training.py``.

Then the identities the kernel (``csrc/threefry.cu``) relies on, proven on
the CPU: the integer keep test ``bits <= keep_threshold(p)`` against the
plain ``uniform < p`` for all 2^23 mantissas (and random low bits) at the
rates in use and at random rates; the quotient as a multiply by the f32
reciprocal against the correctly rounded division for all 65,536 bf16 and
fp16 inputs; and a numpy model of the kernel's per-thread walk (scalar
head and tail, 16-byte vectors) drawing element i from counter i."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import dropout as tdo
from deepspeed_tpu_torch.ops import prng
from deepspeed_tpu_torch.utils.weights import params_from_numpy, tree_leaves
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

RATE = 0.1
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
          (jnp.float16, torch.float16)]

CONFIG = {
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "steps_per_print": 1000,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 3e-3, "betas": [0.9, 0.95], "eps": 1e-6, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-3, "warmup_num_steps": 4}},
}


def _params(seed=0):
    cfg = jgpt2.get_config("gpt2-tiny")
    return jax.tree.map(np.asarray, jgpt2.init_params(cfg, jax.random.PRNGKey(seed)))


def _batches(n, rows, S=32, seed=0):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 512, (rows, S)).astype(np.int32)} for _ in range(n)]


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_dropout_and_its_gradient_equal_jax(jdt, tdt, rate):
    rs = np.random.RandomState(0)
    x = rs.randn(3, 37, 5).astype(np.float32)
    dy = rs.randn(3, 37, 5).astype(np.float32)
    for seed in (0, 7):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        y_j, vjp = jax.vjp(lambda z: jgpt2._dropout(z, rate, jk, True), jnp.asarray(x, jdt))
        (g_j,) = vjp(jnp.asarray(dy, jdt))
        xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
        y_t = tdo.dropout(xt, prng.fold_in(prng.PRNGKey(seed), 3), rate)
        (g_t,) = torch.autograd.grad(y_t, xt, torch.from_numpy(dy).to(tdt))
        assert y_t.dtype == tdt
        np.testing.assert_array_equal(y_t.detach().float().numpy(),
                                      np.asarray(y_j.astype(jnp.float32)))
        np.testing.assert_array_equal(g_t.float().numpy(), np.asarray(g_j.astype(jnp.float32)))


def test_bf16_divides_by_the_rounded_keep_probability():
    """jax turns 1 - rate into bf16 before the division: 0.9 -> 0.8984375."""
    p, c = prng.keep_scale(0.1, torch.bfloat16)
    assert c == 0.8984375 and p == float(np.float32(0.9))
    x = torch.ones(4096, dtype=torch.bfloat16)
    y = tdo.dropout(x, prng.PRNGKey(1), 0.1)
    kept = y[y != 0]
    assert torch.equal(kept, torch.full_like(kept, float(torch.tensor(1 / 0.8984375,
                                                                      dtype=torch.bfloat16))))


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        prng.dropout_kernel(torch.zeros(8), prng.PRNGKey(0), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        prng.uniform_rows_kernel(prng.PRNGKey(0)[None], 8, device="cpu")
    with pytest.raises(ValueError, match="no implementation"):
        tdo.dropout(torch.zeros(8, device="meta"), prng.PRNGKey(0), 0.1)
    with pytest.raises(ValueError, match="rate"):
        tdo.dropout(torch.zeros(8), prng.PRNGKey(0), 1.0)


def test_no_dropout_without_a_key_or_at_eval():
    cfg = tgpt2.get_config("gpt2-tiny", dropout=RATE)
    params = params_from_numpy(_params(1), "cpu")
    ids = torch.from_numpy(_batches(1, 2, seed=1)[0]["input_ids"]).long()
    ref = tgpt2.forward(tgpt2.get_config("gpt2-tiny"), params, ids)
    for train, rng in ((False, prng.PRNGKey(0)), (True, None)):
        torch.testing.assert_close(tgpt2.forward(cfg, params, ids, train, rng), ref,
                                   atol=0, rtol=0)
    dropped = tgpt2.forward(cfg, params, ids, True, prng.PRNGKey(0))
    assert not torch.equal(dropped, ref)


@pytest.mark.parametrize("policy", ["full", "attn", "dots"])
def test_remat_recomputes_the_same_masks(policy):
    """Every remat policy's backward recomputes the dropouts from the same
    keys: the gradients equal those without remat."""
    params = _params(8)
    ids = torch.from_numpy(_batches(1, 2, seed=8)[0]["input_ids"]).long()
    grads = []
    for remat in (False, True):
        cfg = tgpt2.get_config("gpt2-tiny", dropout=RATE, remat=remat, remat_policy=policy)
        tp = params_from_numpy(params, "cpu")
        leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(tp)]
        loss, _ = tgpt2.lm_loss(cfg, tp, {"input_ids": ids}, prng.PRNGKey(3), True)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=0)


def test_dropout_changes_the_trajectory():
    """The masks matter: the same run without dropout ends elsewhere."""
    params = _params(0)
    out = []
    for rate in (0.0, RATE):
        eng, *_ = dtt.initialize(model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny",
                                                                          dropout=rate)),
                                 config=dict(CONFIG),
                                 model_parameters=params_from_numpy(params, "cpu"), device="cpu")
        out.append([float(eng.train_batch(b)["loss"]) for b in _batches(2, 4, seed=3)])
    assert out[0][0] != out[1][0]


def test_eval_and_forward_keys_follow_jax():
    """eval_batch without a key splits the engine's key; forward evaluates
    under fold_in(rng, 0x5EED) and leaves the training key alone."""
    teng, *_ = dtt.initialize(model=tgpt2.make_module(tgpt2.get_config("gpt2-tiny",
                                                                       dropout=RATE)),
                              config=dict(CONFIG), model_parameters=params_from_numpy(_params(2),
                                                                                      "cpu"),
                              device="cpu")
    start = teng._rng.copy()
    np.testing.assert_array_equal(start, np.asarray(jax.random.PRNGKey(1)))
    b = _batches(1, 4, seed=4)[0]
    teng.forward(b)
    np.testing.assert_array_equal(teng._rng, start)
    teng.eval_batch(b)
    np.testing.assert_array_equal(teng._rng, np.asarray(jax.random.split(jax.random.PRNGKey(1))[0]))


# ---------------------------------------------------------------------------
# the identities the kernel relies on
# ---------------------------------------------------------------------------

def _keep_test_agrees(rate, seed=0):
    """Every mantissa m (bits m << 9 plus random low bits): the kernel's
    ``bits <= thr`` against the plain version's ``uniform(bits) < p``."""
    p, _ = prng.keep_scale(prng.check_rate(rate), torch.float32)
    thr = prng.keep_threshold(p)
    low = np.random.RandomState(seed).randint(0, 512, 2 ** 23)
    bits = torch.from_numpy((np.arange(2 ** 23, dtype=np.int64) << 9) | low)
    plain = prng.bits_to_unit_float(bits) < prng.device_scalar(p, torch.device("cpu"))
    return torch.equal(bits <= thr, plain)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.9, 1 - 2.0 ** -23])
def test_integer_keep_test_is_the_uniform_compare(rate):
    assert _keep_test_agrees(rate)


@settings(max_examples=12, deadline=None)
@given(st.floats(min_value=0.0, max_value=1.0, exclude_max=True, allow_subnormal=False))
def test_integer_keep_test_at_random_rates(rate):
    assert _keep_test_agrees(rate, seed=1)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_reciprocal_multiply_is_the_rounded_quotient(dtype, rate):
    """At the rates in use, ``dtype(f32(x) * r)`` is the plain version's
    ``x / c`` (``dropout_ref``: torch's division by a ``dtype`` scalar) for
    every one of the 65,536 inputs, NaNs aside, so the kernel multiplies."""
    r, exact = prng.reciprocal_is_exact(rate, dtype)
    assert exact
    _, c = prng.keep_scale(rate, dtype)
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(dtype)
    num = ~torch.isnan(x)
    by_mul = (x.float() * torch.tensor(r, dtype=torch.float32)).to(dtype)
    plain = x / prng.device_scalar(c, x.device, dtype)
    assert torch.equal(by_mul[num].view(torch.int16), plain[num].view(torch.int16))
    assert not prng.reciprocal_is_exact(rate, torch.float32)[1]  # f32 always divides


def _dropout_walk(n, x_off, y_off, size, grid=3, threads=4):
    """A numpy model of ``dropout_kernel``'s loops as ``launch_dropout``
    sets them up (x and y at byte offsets ``x_off`` / ``y_off`` from a
    16-byte boundary, ``size``-byte elements; a small grid so that the
    grid-stride loops turn) → the counter each element was drawn from
    (-1: none; an element drawn twice fails)."""
    V = 16 // size
    head, nvec = n, 0
    if (x_off - y_off) % 16 == 0:
        head = min((16 - x_off % 16) % 16 // size, n)
        nvec = (n - head) // V
    tail = head + nvec * V
    counter = np.full(n, -1, np.int64)

    def draw(elements, counters):
        assert np.all(counter[elements] == -1)
        counter[elements] = counters

    stride = grid * threads
    for g in range(stride):
        draw(np.arange(g, head, stride), np.arange(g, head, stride))
        draw(np.arange(tail + g, n, stride), np.arange(tail + g, n, stride))
        for v in range(g, nvec, stride):
            i0 = head + v * V
            assert (x_off + i0 * size) % 16 == 0 and (y_off + i0 * size) % 16 == 0
            draw(np.arange(i0, i0 + V), i0 + np.arange(V))
    return counter


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("x_el,y_el", [(0, 0), (1, 1), (3, 3), (1, 0)])  # offsets in elements
@pytest.mark.parametrize("n", [1, 7, 8, 9, 61, 8 * 13 + 5])
def test_kernel_walk_draws_element_i_from_counter_i(n, x_el, y_el, size):
    counter = _dropout_walk(n, x_el * size % 16, y_el * size % 16, size)
    np.testing.assert_array_equal(counter, np.arange(n))
    key = prng.fold_in(prng.PRNGKey(3), 9)
    k = [int(w) for w in prng.key_words(key)]
    lo = counter.astype(np.uint32)
    y0, y1 = prng.threefry2x32(np.uint32(k[0]), np.uint32(k[1]), np.zeros_like(lo), lo)
    np.testing.assert_array_equal((y0 ^ y1).astype(np.int64),
                                  prng.random_bits_rows(key, n)[0].numpy())


def test_uniform_rows_walk_draws_element_j_from_counter_j():
    """``uniform_rows_kernel``: row r of [R, n] f32 starts at 4 r n bytes, so
    an odd n misaligns every other row; each row's head, float4 body and
    tail draw element j from counter j under its own key."""
    R, n = 5, 8 * 3 + 3
    for r in range(R):
        off = 4 * r * n % 16
        counter = _dropout_walk(n, off, off, 4)
        np.testing.assert_array_equal(counter, np.arange(n))
