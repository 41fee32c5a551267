"""What the PyTorch port imports, checked in fresh interpreters: the test
process itself has jax loaded (tests/conftest.py imports it)."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "valley_tpu_torch"


def _run(code: str, env_extra=None) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT), **(env_extra or {})}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_tiny_slice_runs_without_jax():
    """Importing the port and serving a video question on the tiny model
    never loads jax."""
    got = _run("""
import json, sys
import numpy as np
import valley_tpu_torch
from valley_tpu_torch.inference.engine import GenerationConfig
from valley_tpu_torch.inference.run_valley import load_model
from valley_tpu_torch.inference.generate import completion
engine, tk = load_model("random:tiny", "cpu", buckets=(64,),
                        max_new_tokens=4)
frames = np.random.default_rng(0).integers(0, 256, (2, 3, 28, 28)
                                           ).astype(np.uint8)
out = completion(engine, tk, None,
                 [{"role": "user", "content": "What? <video>"}],
                 GenerationConfig(max_new_tokens=4), frames=frames)
print(json.dumps({"jax": "jax" in sys.modules, "out": out}))
""")
    assert got["jax"] is False
    assert isinstance(got["out"][0], str)


def test_kernel_modules_import_without_triton_or_nvcc():
    """The kernel modules import, and run their plain versions on CPU
    tensors, with triton unimportable and no nvcc on PATH; nothing is
    built."""
    got = _run("""
import json, sys
sys.modules["triton"] = None          # any `import triton` now fails
import torch
from valley_tpu_torch.ops import _build, attention
from valley_tpu_torch.ops.decode_attention import decode_attention_stacked
from valley_tpu_torch.ops.flash_attention import flash_attention
q = torch.zeros((1, 4, 2, 16))
flash_attention(q, q, q, None, causal=True)
decode_attention_stacked(q[:, :1], torch.zeros((1, 1, 4, 2, 16)),
                         torch.zeros((1, 1, 4, 2, 16)), 0,
                         torch.ones((1, 4), dtype=torch.bool))
print(json.dumps({"loaded": _build.load.cache_info().currsize}))
""", {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent"})
    assert got == {"loaded": 0}


def test_port_sources_avoid_jax_and_library_attention():
    """No jax import, no library attention kernel, no torch.compile, and
    no module of the JAX package that pulls in jax; chip_smoke.py imports
    nothing of the JAX package at all."""
    banned = [r"^\s*(import|from)\s+jax\b", r"scaled_dot_product_attention",
              r"torch\.compile", r"flash_attn", r"cudnn\.",
              r"^\s*(import|from)\s+valley_tpu\."
              r"(models|ops|serve|utils|inference|train|parallel)\b"]
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        for pat in banned:
            assert not re.search(pat, text, re.M), (path, pat)
    # the smoke script reaches the config through the port, never through
    # the JAX package; it may name cuDNN (to turn its TF32 off)
    smoke = (ROOT / "chip_smoke.py").read_text()
    for pat in [p for p in banned if p != r"cudnn\."] + [
            r"^\s*(import|from)\s+valley_tpu(\.|\s|$)"]:
        assert not re.search(pat, smoke, re.M), ("chip_smoke.py", pat)
