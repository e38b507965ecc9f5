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
PORT_FILES = sorted((REPO / "deepspeed_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


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
