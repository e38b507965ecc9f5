"""The port's layer-streaming checkpoint loader and Megatron ingestion on
the CPU (``module_inject/load_checkpoint.py``,
``checkpoint/megatron_loader.py``), held against the JAX package's:

- a GPT-2 HF checkpoint directory written by the test (safetensors, one
  file; torch ``.bin``, sharded with an index file) streams into the tree
  the GPT-2 policy converts from the live module, equal to JAX's streamed
  tree, in fp32 and bf16 bit for bit;
- ``init_inference(checkpoint=dir)`` generates the live module's greedy
  stream (HF's ``generate``) and forwards its logits, fp32 within the
  oracle's 5e-3; ``checkpoint`` beside ``model`` is refused as in JAX;
- a registered map loads its architecture; an unknown one is refused;
- the Megatron converter round-trips, merges tp rows and pp × tp grids
  (``checkpoint/reshape.py``) to JAX's tree, and refuses unknown keys; it
  matches keys outside the layers by their exact suffix, where the JAX
  package's substring test files an embedding-norm key under ``wte`` and
  refuses a tied output head: the difference is pinned here."""

import json
import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.checkpoint import megatron_loader as jmeg
from deepspeed_tpu.module_inject import load_checkpoint as jload
from deepspeed_tpu_torch.checkpoint import megatron_loader as tmeg
from deepspeed_tpu_torch.checkpoint.reshape import split_pp_state_dict, split_tp_state_dict
from deepspeed_tpu_torch.module_inject import load_checkpoint as tload
from deepspeed_tpu_torch.module_inject import replace_policy as tpolicy
from deepspeed_tpu_torch.utils.weights import params_to_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

warnings.filterwarnings("ignore")
transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def hf_gpt2():
    torch.manual_seed(0)
    cfg = transformers.GPT2Config(n_embd=64, n_layer=2, n_head=4, vocab_size=512,
                                  n_positions=128, resid_pdrop=0.0, embd_pdrop=0.0,
                                  attn_pdrop=0.0)
    model = transformers.GPT2LMHeadModel(cfg)
    model.eval()
    return model


@pytest.fixture(scope="module")
def ckpt_dirs(hf_gpt2, tmp_path_factory):
    """The model written twice: one safetensors file, and ``.bin`` shards
    with an index."""
    st = tmp_path_factory.mktemp("st")
    hf_gpt2.save_pretrained(st, safe_serialization=True)
    bn = tmp_path_factory.mktemp("bin")
    hf_gpt2.save_pretrained(bn, safe_serialization=False, max_shard_size="100KB")
    assert (bn / "pytorch_model.bin.index.json").exists()
    return {"safetensors": st, "bin": bn}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_streamed_equals_policy_and_jax(fmt, dtype, hf_gpt2, ckpt_dirs):
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jdt = {"fp32": np.float32, "bf16": ml_dtypes.bfloat16}[dtype]
    kind, cfg, params = tload.load_checkpoint_streamed(str(ckpt_dirs[fmt]), dtype=tdt)
    assert kind == "gpt2" and cfg.n_layer == 2 and cfg.n_embd == 64
    got = _flat(params_to_numpy(params))
    assert params["wte"].dtype == params["blocks"]["attn"]["c_attn_w"].dtype == tdt
    _, _, pol = tpolicy.HFGPT2LayerPolicy.convert(hf_gpt2)
    want = {k: v.astype(jdt).astype(np.float32) for k, v in _flat(pol).items()}
    _, _, jtree = jload.load_checkpoint_streamed(str(ckpt_dirs[fmt]),
                                                 dtype={"fp32": jnp.float32,
                                                        "bf16": jnp.bfloat16}[dtype])
    jflat = {k: np.asarray(v).astype(np.float32) for k, v in _flat(jtree).items()}
    assert sorted(got) == sorted(want) == sorted(jflat)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], jflat[k], err_msg=k)


def test_init_inference_from_checkpoint(hf_gpt2, ckpt_dirs):
    eng = dtt.init_inference(checkpoint=str(ckpt_dirs["safetensors"]), dtype=torch.float32,
                             device="cpu")
    assert eng.kind == "gpt2"
    ids = np.random.RandomState(1).randint(0, 512, (1, 7))
    with torch.no_grad():
        ref = hf_gpt2.generate(torch.tensor(ids), max_new_tokens=6, do_sample=False,
                               pad_token_id=0).numpy()
        logits = hf_gpt2(torch.tensor(ids)).logits.numpy()
    np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=6), ref)
    assert np.abs(eng({"input_ids": ids}).numpy() - logits).max() < 5e-3
    # the config's key is the same source
    eng2 = dtt.init_inference(config={"checkpoint": str(ckpt_dirs["bin"]), "dtype": "fp32"},
                              device="cpu")
    np.testing.assert_array_equal(eng2.generate(ids, max_new_tokens=6), ref)
    with pytest.raises(ValueError, match="not both"):
        dtt.init_inference(model=hf_gpt2, checkpoint=str(ckpt_dirs["bin"]), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        dtt.init_inference(params={}, checkpoint=str(ckpt_dirs["bin"]), device="cpu")


def test_registered_map_and_unknown_architecture(ckpt_dirs, tmp_path):
    d = tmp_path / "other"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"model_type": "toy"}))
    torch.save({"w": torch.arange(6.0)}, d / "pytorch_model.bin")
    with pytest.raises(ValueError, match="no streaming checkpoint map for model_type=toy"):
        tload.load_checkpoint_streamed(str(d))
    tload.register_checkpoint_map(
        "toy", lambda c: c.get("model_type") == "toy",
        lambda reader, c, dtype: ("toy", c, {"w": reader.get("w").to(dtype)}))
    try:
        kind, _, params = tload.load_checkpoint_streamed(str(d), dtype=torch.float32)
        assert kind == "toy" and torch.equal(params["w"], torch.arange(6.0))
    finally:
        tload._CKPT_MAPS.pop("toy")
    with pytest.raises(FileNotFoundError):
        (tmp_path / "empty").mkdir()
        tload._CkptReader(str(tmp_path / "empty"))


def _gpt2_tree(seed=0, L=3, E=16, V=40, P=12):
    rs = np.random.RandomState(seed)

    def n(*s):
        return rs.standard_normal(s).astype(np.float32)

    return {"wte": n(V, E), "wpe": n(P, E),
            "ln_f": {"scale": n(E), "bias": n(E)},
            "blocks": {"ln_1": {"scale": n(L, E), "bias": n(L, E)},
                       "ln_2": {"scale": n(L, E), "bias": n(L, E)},
                       "attn": {"c_attn_w": n(L, E, 3 * E), "c_attn_b": n(L, 3 * E),
                                "c_proj_w": n(L, E, E), "c_proj_b": n(L, E)},
                       "mlp": {"c_fc_w": n(L, E, 4 * E), "c_fc_b": n(L, 4 * E),
                               "c_proj_w": n(L, 4 * E, E), "c_proj_b": n(L, E)}}}


def test_megatron_roundtrip_grid_and_jax():
    tree = _gpt2_tree()
    meg = tmeg.gpt2_tree_to_megatron(tree)
    assert sorted(meg) == sorted(jmeg.gpt2_tree_to_megatron(tree))
    for sd in (meg, split_tp_state_dict(meg, 2),
               [split_tp_state_dict(s, 2) for s in split_pp_state_dict(meg, 3)]):
        got = _flat(tmeg.megatron_shards_to_gpt2_tree(sd))
        want = _flat(jmeg.megatron_shards_to_gpt2_tree(sd))
        assert sorted(got) == sorted(want) == sorted(_flat(tree))
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], _flat(tree)[k], err_msg=k)
    for bad in ({"layers.0.attention.rotary_emb.inv_freq": np.ones(4)},
                {"some.unrelated.tensor": np.ones(4)}):
        with pytest.raises(KeyError, match="unmapped"):
            tmeg.megatron_to_gpt2_tree(bad)


def test_megatron_exact_suffix_differs_from_jax_substring():
    tree = _gpt2_tree(seed=1)
    meg = {"language_model." + k: v for k, v in tmeg.gpt2_tree_to_megatron(tree).items()}
    # an embedding-norm key: JAX files it under wte (by substring), the port
    # refuses it as unmapped
    norm_key = "language_model.embedding.word_embeddings_layernorm.weight"
    odd = dict(meg, **{norm_key: np.ones(16, np.float32)})
    assert jmeg.megatron_to_gpt2_tree(odd)["wte"].shape == (16,)
    with pytest.raises(KeyError, match="unmapped megatron key"):
        tmeg.megatron_to_gpt2_tree(odd)
    # a tied output head (a copy of word_embeddings, which reshape.py routes
    # to the last pp stage): JAX raises, the port drops the copy
    tied = dict(meg, **{"language_model.output_layer.weight": tree["wte"].copy()})
    with pytest.raises(KeyError, match="unmapped"):
        jmeg.megatron_to_gpt2_tree(tied)
    got = _flat(tmeg.megatron_to_gpt2_tree(tied))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(got[k], v)
    # an untied head cannot live in the tied GPT-2 tree
    untied = dict(meg, **{"language_model.output_layer.weight": tree["wte"] + 1.0})
    with pytest.raises(KeyError, match="untied output head"):
        tmeg.megatron_to_gpt2_tree(untied)
