"""What the PyTorch port imports, checked in fresh interpreters: the test
process itself has jax loaded (tests/conftest.py imports it)."""

import ast
import dataclasses
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


def test_pool_and_batch_runner_run_without_jax():
    """The serving pool, the batch runner and the new kernel modules import
    and serve two pooled requests on the CPU without loading jax or the
    JAX package."""
    got = _run("""
import json, sys
from valley_tpu_torch.inference import batch_infer
from valley_tpu_torch.inference.continuous import ContinuousEngine, _drain
from valley_tpu_torch.inference.run_valley import load_model
from valley_tpu_torch.ops import matvec, read_bw
engine, tk = load_model("random:tiny", "cpu", buckets=(64,),
                        max_new_tokens=4, steps_per_call=2)
pool = ContinuousEngine(engine, rows=2)
qs = [pool.submit(tk.encode(t), max_new_tokens=3, eos_id=-1)
      for t in ("hello", "a longer question")]
out = [list(_drain(q, timeout=60)) for q in qs]
pool.close()
loaded = sorted(n for n in sys.modules
                if n == "jax" or n.startswith("jax.") or n == "valley_tpu"
                or n.startswith("valley_tpu."))
print(json.dumps({"loaded": loaded, "lens": [len(o) for o in out]}))
""")
    assert got == {"loaded": [], "lens": [3, 3]}


def test_conversation_and_lab_run_without_jax():
    """The conversation REPL's module, the lab's, K1's numerics and K3's
    variants tools and the session code import, and a two-turn session and the lab kernels' plain versions
    run on the CPU, without loading jax or the JAX package."""
    got = _run("""
import json, sys
import torch
from valley_tpu_torch.inference import ChatSession, GenerationConfig
from valley_tpu_torch.inference import run_valley_conv
from valley_tpu_torch.inference.run_valley import load_model
from valley_tpu_torch.ops import decode_lab
from valley_tpu_torch.tools import (decode_attn_lab, decode_variants,
                                    flash_numerics)
engine, tk = load_model("random:tiny", "cpu", buckets=(64,),
                        max_new_tokens=4)
sess = ChatSession(engine, GenerationConfig(max_new_tokens=3))
replies = [sess.chat(tk.encode(t), eos_ids=[-1]) for t in ("hi", "more")]
q = torch.zeros((1, 1, 2, 64), dtype=torch.bfloat16)
k = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
decode_lab.attn_head_chunked(q, k, k, torch.zeros((1, 8)), 8)
decode_lab.attn_stage(q[:, 0], k[None].transpose(2, 3).contiguous(),
                      k[None].transpose(2, 3).contiguous(),
                      torch.zeros((1, 8)), 0, 3)
loaded = sorted(n for n in sys.modules
                if n == "jax" or n.startswith("jax.") or n == "valley_tpu"
                or n.startswith("valley_tpu."))
print(json.dumps({"loaded": loaded, "lens": [len(r) for r in replies],
                  "extends": sess.extends}))
""")
    assert got == {"loaded": [], "lens": [3, 3], "extends": 1}


def test_serve_stack_runs_without_jax():
    """The serve and utils modules import, and a tiny worker registered
    with the controller answers a request through the controller's proxy
    and a checkpoint written and read back by the port's own safetensors
    code, with jax, the JAX package, ``requests``, ``safetensors`` and
    ``transformers`` unimportable: none of them is loaded."""
    got = _run("""
import json, sys, tempfile
for name in ("jax", "valley_tpu", "requests", "safetensors",
             "transformers"):
    sys.modules[name] = None              # any import of them now fails
import argparse
import torch
from valley_tpu_torch.serve import (batcher, cli, controller, hbm, httpd,
                                    model_worker, openai_api,
                                    register_worker, test_message)
from valley_tpu_torch.utils import delta, hf_bridge, logging, safetensors_io
args = model_worker.build_parser().parse_args(
    ["--device", "cpu", "--buckets", "64", "--max-new-tokens", "4",
     "--no-register"])
engine, tk = model_worker.load_engine(args)
ctrl = controller.Controller()
c_app = controller.build_app(ctrl)
c_addr = f"http://localhost:{c_app.start()}"
args.controller_address = c_addr
worker = model_worker.make_worker(args, engine, tk)
w_app = model_worker.build_app(worker)
worker.worker_addr = f"http://localhost:{w_app.start()}"
worker.register_to_controller()
chunks = list(httpd.stream_chunks(c_addr + "/worker_generate_stream", {
    "model": "valley", "prompt": "hi", "temperature": 0.0,
    "max_new_tokens": 3}))
c_app.shutdown(); w_app.shutdown()
d = tempfile.mkdtemp()
hf_bridge.export_valley_checkpoint(engine.cfg, engine.params, d)
cfg, params, _ = hf_bridge.load_valley_checkpoint(
    d, tokenizer=tk, device="cpu", dtype=torch.float32)
want = engine.params.state_dict()
same = all(torch.equal(t, want[k]) for k, t in params.state_dict().items())
loaded = sorted(n for n, m in sys.modules.items() if m is not None and (
    n.split(".")[0] in ("jax", "valley_tpu", "requests", "safetensors",
                        "transformers")))
print(json.dumps({"loaded": loaded, "code": chunks[-1]["error_code"],
                  "same": same}))
""")
    assert got == {"loaded": [], "code": 0, "same": True}


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
from valley_tpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_bwd)
q = torch.zeros((1, 4, 2, 16))
out, lse = flash_attention(q, q, q, None, causal=True, return_lse=True)
flash_attention_bwd(q, q, q, None, out, lse, q, causal=True)
decode_attention_stacked(q[:, :1], torch.zeros((1, 1, 4, 2, 16)),
                         torch.zeros((1, 1, 4, 2, 16)), 0,
                         torch.ones((1, 4), dtype=torch.bool))
from valley_tpu_torch.ops.matvec import bf16_matvec, matvec
from valley_tpu_torch.ops.read_bw import read_sum
x = torch.zeros((2, 16), dtype=torch.bfloat16)
bf16_matvec(x, torch.zeros((16, 8), dtype=torch.bfloat16), kf=True)
matvec(x, torch.zeros((8, 16), dtype=torch.bfloat16))
read_sum(x, torch.ones(()))
print(json.dumps({"loaded": _build.load.cache_info().currsize}))
""", {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent"})
    assert got == {"loaded": 0}


# any import of the JAX package or one of its modules
JAX_PACKAGE_IMPORT = r"^\s*(import|from)\s+valley_tpu(\.|\s|$)"
# the functions of chip_smoke.py that may call a library kernel, each for
# the yardstick ``library_ms``, timed and used nowhere in the port
LIBRARY_TIMERS = {"scaled_dot_product_attention": "library_attention_ms",
                  "_weight_int8pack_mm": "library_matvec_ms",
                  "_weight_int4pack_mm": "library_int4_matvec_ms",
                  "_convert_weight_to_int4pack": "library_int4_matvec_ms"}


def test_port_sources_avoid_jax_and_library_attention():
    """No file of the port and not chip_smoke.py imports jax or anything
    of the JAX package (the port keeps its own copies of the host code);
    no library attention kernel and no torch.compile in the port."""
    banned = [r"^\s*(import|from)\s+jax\b", JAX_PACKAGE_IMPORT,
              r"scaled_dot_product_attention", r"_weight_int8pack_mm",
              r"_weight_int4pack_mm", r"_convert_weight_to_int4pack",
              r"torch\.compile", r"flash_attn", r"cudnn\."]
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        for pat in banned:
            assert not re.search(pat, text, re.M), (path, pat)
    # the smoke script may name cuDNN (to turn its TF32 off) and time the
    # library's kernels as yardsticks inside LIBRARY_TIMERS only
    smoke = (ROOT / "chip_smoke.py").read_text()
    for pat in [p for p in banned if p not in (
            r"cudnn\.", *LIBRARY_TIMERS)]:
        assert not re.search(pat, smoke, re.M), ("chip_smoke.py", pat)
    for call, fn in LIBRARY_TIMERS.items():
        timer = [n for n in ast.walk(ast.parse(smoke))
                 if isinstance(n, ast.FunctionDef) and n.name == fn]
        assert len(timer) == 1
        inside = range(timer[0].lineno, timer[0].end_lineno + 1)
        for no, line in enumerate(smoke.splitlines(), 1):
            if call in line:
                assert no in inside, ("chip_smoke.py", no, line)


def test_the_pattern_catches_jax_package_imports():
    for line in ("import valley_tpu", "from valley_tpu import config",
                 "    from valley_tpu.data.video import load_video",
                 "import valley_tpu.tokenizer as t"):
        assert re.search(JAX_PACKAGE_IMPORT, line, re.M), line
    for line in ("import valley_tpu_torch", "from valley_tpu_torch import x",
                 "# see valley_tpu/config.py"):
        assert not re.search(JAX_PACKAGE_IMPORT, line, re.M), line


def test_every_module_imports_and_trains_without_jax():
    """A fresh interpreter imports every module of the port, then trains
    one tiny step on the CPU: neither jax nor any module of the JAX
    package is ever loaded."""
    got = _run("""
import importlib, json, pkgutil, sys, tempfile
import numpy as np, torch
import valley_tpu_torch
names = [m.name for m in pkgutil.walk_packages(valley_tpu_torch.__path__,
                                               "valley_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from valley_tpu_torch import valley_tiny
from valley_tpu_torch.data.dataset import (DataCollatorForSupervisedDataset,
                                           DataLoader)
from valley_tpu_torch.models import valley
from valley_tpu_torch.train.trainer import TrainConfig, Trainer
cfg = valley_tiny()
rng = np.random.default_rng(0)
tok = cfg.tokens
span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + [tok.im_end]
rows = []
for i in range(2):
    ids = rng.integers(5, 400, 24)
    ids[1:1 + len(span)] = span
    rows.append(dict(input_ids=ids, labels=ids.copy(),
                     image=rng.standard_normal((1, 3, 28, 28)).astype(
                         np.float32)))
params = valley.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32)
tc = TrainConfig(output_dir=tempfile.mkdtemp(), freeze_backbone=True,
                 tune_mm_mlp_adapter=True, save_steps=0)
trainer = Trainer(cfg, tc, params, DataLoader(
    rows, 2, DataCollatorForSupervisedDataset(), num_workers=1))
m = trainer.train_step(trainer.device_batch(next(iter(
    trainer.train_loader.loader.epoch(0)))))
loaded = sorted(n for n in sys.modules
                if n == "jax" or n.startswith("jax.") or n == "valley_tpu"
                or n.startswith("valley_tpu."))
print(json.dumps({"modules": len(names), "loaded": loaded,
                  "updated": m["updated"], "loss": m["loss"],
                  "parallel": [n for n in names if ".parallel" in n]}))
""")
    assert got["loaded"] == []
    assert got["modules"] >= 25
    assert got["parallel"] == [
        "valley_tpu_torch.parallel", "valley_tpu_torch.parallel.distributed",
        "valley_tpu_torch.parallel.lockstep", "valley_tpu_torch.parallel.mesh",
        "valley_tpu_torch.parallel.sharding",
        "valley_tpu_torch.parallel.tensor"]
    assert got["updated"] and got["loss"] > 0


def test_config_presets_equal_the_jax_presets():
    """The port's copy of config.py gives the same presets."""
    from valley_tpu import config as jconfig
    from valley_tpu_torch import config

    for name in ("valley_tiny", "valley_7b", "valley_13b"):
        assert dataclasses.asdict(getattr(config, name)()) == \
            dataclasses.asdict(getattr(jconfig, name)()), name
