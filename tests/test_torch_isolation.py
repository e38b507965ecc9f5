"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import deepspeed_tpu_torch as dtt

REPO = Path(__file__).resolve().parent.parent
# the port, the card's smoke run, and the rank bodies the CPU tests run
# in their gloo processes (which must not import JAX either)
PORT_FILES = sorted((REPO / "deepspeed_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "torch_dist.py"]


def test_imports_without_jax_or_the_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['deepspeed_tpu'] = None\n"
        "import deepspeed_tpu_torch\n"
        "for m in pkgutil.walk_packages(deepspeed_tpu_torch.__path__, 'deepspeed_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'deepspeed_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "deepspeed_tpu"), (
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}"
            )


def test_entry_point_defaults_to_the_card():
    """No device means the CUDA card; without one it raises instead of
    quietly running on the CPU."""
    if torch.cuda.is_available():
        eng = dtt.init_inference("gpt2-tiny", dtype=torch.float32)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            dtt.init_inference("gpt2-tiny", dtype=torch.float32)
    assert dtt.init_inference("gpt2-tiny", device="cpu").device.type == "cpu"


def test_the_slice_modules_are_scanned():
    """The speculative / prefix-cache / chunked-prefill slice's modules and
    its kernel source are part of what the scans above cover."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("ops/paged_multitoken_attention.py", "ops/attention.py",
                "serving/kv_cache.py", "serving/model.py", "serving/scheduler.py",
                "runtime/config.py"):
        assert f"deepspeed_tpu_torch/{mod}" in names
    assert (REPO / "deepspeed_tpu_torch/csrc/paged_multitoken_attention.cu").is_file()


def test_the_fleet_modules_are_scanned():
    """The fleet, the replay harness and their CLIs are part of what the
    scans above cover."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("serving/fleet.py", "serving/replay.py", "tools/request_trace.py",
                "tools/fleet_dash.py", "telemetry/request_trace.py", "resilience/manifest.py",
                "elasticity/preemption.py"):
        assert f"deepspeed_tpu_torch/{mod}" in names


def test_multitoken_dispatch_has_no_other_route():
    """CPU tensors run the plain version, CUDA tensors the kernel; any other
    device raises instead of finding a fallback."""
    from deepspeed_tpu_torch.ops.attention import paged_multitoken_cached_attention

    q = torch.zeros(1, 2, 4, 64, device="meta")
    pool = torch.zeros(4, 4, 8, 64, device="meta")
    bt = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    base = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        paged_multitoken_cached_attention(q, pool, pool, bt, base)


def test_the_training_slice_modules_are_scanned():
    """The training slice's modules and its kernel sources are part of what
    the scans above cover."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("ops/flash_attention.py", "models/lm_loss.py", "models/gpt2.py",
                "runtime/engine.py", "runtime/optimizers.py", "runtime/lr_schedules.py",
                "runtime/fp16/loss_scaler.py", "runtime/dataloader.py", "runtime/module.py",
                "runtime/activation_checkpointing.py", "tools/profile_training.py"):
        assert f"deepspeed_tpu_torch/{mod}" in names
    for src in ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "flash_attention_common.cuh"):
        assert (REPO / "deepspeed_tpu_torch/csrc" / src).is_file()


def test_causal_attention_has_no_other_route():
    """CPU tensors run the plain version, CUDA tensors the flash kernels;
    any other device raises instead of finding a fallback."""
    from deepspeed_tpu_torch.ops.attention import causal_attention

    q = torch.zeros(1, 128, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        causal_attention(q, q, q)


def test_the_inference_slice_modules_are_scanned():
    """The int8-pages / offline-generate slice's modules and its kernel
    sources are part of what the scans above cover."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("ops/quantizer.py", "ops/decode_attention.py", "inference/engine.py",
                "tools/profile_generate.py"):
        assert f"deepspeed_tpu_torch/{mod}" in names
    for src in ("decode_attention.cu", "paged_decode_attention.cu",
                "paged_multitoken_attention.cu"):
        assert (REPO / "deepspeed_tpu_torch/csrc" / src).is_file()


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8])
def test_cached_and_int8_dispatch_have_no_other_route(kv_dtype):
    """The contiguous decode dispatch and the int8 paged dispatch: CPU
    tensors run the plain versions, CUDA tensors the kernels; any other
    device raises instead of finding a fallback."""
    from deepspeed_tpu_torch.ops.attention import cached_attention, paged_cached_attention

    q = torch.zeros(1, 4, 64, device="meta")
    if kv_dtype == torch.float32:
        cache = torch.zeros(1, 16, 4, 64, device="meta")
        with pytest.raises(ValueError, match="no implementation"):
            cached_attention(q, cache, cache, 3)
        return
    pool = torch.zeros(4, 4, 8, 64, dtype=torch.int8, device="meta")
    scales = torch.zeros(4, 4, 2, device="meta")
    bt = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    pos = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        paged_cached_attention(q, pool, pool, bt, pos, scales=scales)


def test_the_optimizer_slice_modules_are_scanned():
    """The optimizer slice's modules and its kernel source are part of what
    the scans above cover."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("ops/fused_adam.py", "runtime/optimizers.py", "runtime/engine.py",
                "runtime/activation_checkpointing.py", "models/lm_loss.py"):
        assert f"deepspeed_tpu_torch/{mod}" in names
    assert (REPO / "deepspeed_tpu_torch/csrc/fused_adam.cu").is_file()


def test_the_random_streams_slice_modules_are_scanned():
    """The int8-weights / JAX-random-streams slice's modules and its kernel
    source are part of what the scans above cover."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("ops/prng.py", "ops/dropout.py", "ops/sampling.py", "ops/quantizer.py",
                "models/gpt2.py", "models/bert.py", "runtime/engine.py", "serving/model.py",
                "serving/scheduler.py", "inference/engine.py", "utils/weights.py"):
        assert f"deepspeed_tpu_torch/{mod}" in names
    assert (REPO / "deepspeed_tpu_torch/csrc/threefry.cu").is_file()


def test_random_draws_have_no_other_route():
    """The dropout and uniform dispatch: CPU tensors run the plain
    versions, CUDA tensors the threefry kernel; any other device raises."""
    from deepspeed_tpu_torch.ops import dropout, prng

    with pytest.raises(ValueError, match="no implementation"):
        dropout.dropout(torch.zeros(8, device="meta"), prng.PRNGKey(0), 0.1)
    with pytest.raises(ValueError, match="no implementation"):
        prng.uniform_rows(prng.PRNGKey(0)[None], 8, device="meta")


def test_the_telemetry_slice_modules_are_scanned():
    """The telemetry slice's modules (the plane and its serving hooks) are
    part of what the scans above cover."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("telemetry/__init__.py", "telemetry/registry.py", "telemetry/tracer.py",
                "telemetry/exporters.py", "telemetry/compile_stats.py",
                "telemetry/watchdog.py", "telemetry/request_trace.py", "telemetry/kv_heat.py",
                "telemetry/timeseries.py", "telemetry/slo_budget.py",
                "serving/scheduler.py", "serving/kv_cache.py", "serving/request.py",
                "inference/engine.py", "runtime/config.py", "utils/graphs.py"):
        assert f"deepspeed_tpu_torch/{mod}" in names


def test_the_zero_slice_modules_are_scanned():
    """The comm/, parallel/ and ZeRO slice's modules (and the rank helper
    of the CPU tests, which a spawned rank imports) are part of what the
    scans above cover, and the helper imports neither JAX nor the JAX
    package either."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("comm/__init__.py", "comm/backend.py", "comm/torch.py", "comm/comm.py",
                "parallel/__init__.py", "parallel/topology.py", "runtime/zero/__init__.py",
                "runtime/zero/partitioning.py", "runtime/zero/tiling.py",
                "utils/init_on_device.py", "utils/zero_to_fp32.py", "checkpoint/reshape.py"):
        assert f"deepspeed_tpu_torch/{mod}" in names
    test_no_import_of_jax_or_the_jax_package(REPO / "tests" / "torch_dist.py")


def test_distributed_init_defaults_to_the_card():
    """``init_distributed`` takes NCCL, which needs the card, unless the
    caller asks for gloo; ``initialize`` still resolves the card."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import gpt2

    model = gpt2.make_module(gpt2.get_config("gpt2-tiny"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusals are what the CPU shows")
    with pytest.raises(RuntimeError, match="CUDA"):
        comm.init_distributed(verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dtt.initialize(model=model, config={"train_batch_size": 2,
                                            "zero_optimization": {"stage": 3}})
    assert not comm.is_initialized()


def test_the_placement_slice_modules_are_scanned():
    """The tensor-parallel / disaggregated slice's modules, and the rank
    bodies that serve on gloo ranks, are part of what the scans above
    cover."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for mod in ("module_inject/__init__.py", "module_inject/tp_shard.py",
                "serving/placement.py", "serving/scheduler.py", "serving/model.py",
                "models/gpt2.py", "comm/torch.py", "runtime/config.py", "utils/graphs.py"):
        assert f"deepspeed_tpu_torch/{mod}" in names
    assert "tests/torch_dist.py" in names
