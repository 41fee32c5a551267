"""The bf16 GEMV (K6) and the read-bandwidth probe (K7) of the PyTorch
port on the CPU: their plain versions against the Pallas kernels they
replace (tools/exp_pallas_gemv.py ``matvec`` T1, tools/exp_pallas_gemv2.py
``matvec_vpu`` T2 and ``matvec_vpu_bf16acc`` T3, tools/exp_read_bw.py
``pallas_sum_2d`` T8, in interpret mode), the dispatching `matvec`, and the
decoder's router (`llama._linear`), which sends a few rows of a bf16
weight to the GEMV and everything else to the library.

Inputs are made with numpy from a seed.  Shapes meet the tools' block
rules (last block dims multiples of 128, second-to-last of 8 or whole).
"""

import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from valley_tpu_torch.models import llama
from valley_tpu_torch.ops import matvec as mv
from valley_tpu_torch.ops import quant
from valley_tpu_torch.ops.attention import KERNELS, PLAIN, Attention
from valley_tpu_torch.ops.read_bw import read_sum, read_sum_plain

ROOT = Path(__file__).resolve().parent.parent


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(rng, shape, scale=1.0):
    """bf16 values as a jax array and the same values as a torch tensor."""
    a = jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)
    return a, torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


@pytest.mark.parametrize("rows,h,f", [(1, 256, 384), (8, 512, 256),
                                      (3, 384, 128)])
def test_bf16_matvec_plain_matches_pallas_t1(rows, h, f):
    """T1 takes w (H, F), the (K, F) layout; the port's plain version takes
    it with ``kf`` and its transpose without.  fp32 outputs agree to 1e-5
    of their largest (the same exact products, summed in another order)."""
    rng = np.random.default_rng(rows)
    jx, tx = _bf16(rng, (rows, h))
    jw, tw = _bf16(rng, (h, f), h ** -0.5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_tool("exp_pallas_gemv").matvec(
            jx, jw, hb=128, fb=128, rows=rows))
    tol = 1e-5 * np.abs(want).max()
    for got in (mv.bf16_matvec_plain(tx, tw, kf=True),
                mv.bf16_matvec_plain(tx, tw.t().contiguous()),
                mv.bf16_matvec(tx, tw, kf=True),       # CPU: the plain one
                mv.matvec(tx, tw.t().contiguous())):
        assert got.dtype == torch.float32 and got.shape == (rows, f)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert mv.bf16_matvec.launches == 0


@pytest.mark.parametrize("h,f", [(256, 256), (512, 384)])
def test_bf16_matvec_plain_matches_pallas_t2(h, f):
    """T2 is the same function at one row, an fp32 multiply-accumulate
    over a lane-replicated x (H, 128)."""
    rng = np.random.default_rng(h + f)
    jx, tx = _bf16(rng, (1, h))
    jw, tw = _bf16(rng, (h, f), h ** -0.5)
    xcol = jnp.broadcast_to(jx[0, :, None], (h, 128))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_tool("exp_pallas_gemv2").matvec_vpu(
            xcol, jw, hb=128, fb=128))
    got = mv.bf16_matvec_plain(tx, tw, kf=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


T3_SCRIPT = r"""
import importlib.util, json, sys
import jax.numpy as jnp, numpy as np, torch
from jax.experimental.pallas import tpu as pltpu
from valley_tpu_torch.ops.matvec import bf16_matvec_plain
spec = importlib.util.spec_from_file_location("t", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
rng = np.random.default_rng(5)
out = {}
for h, f in ((256, 256), (384, 128)):
    x = jnp.asarray(rng.standard_normal((1, h)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((h, f)) * h ** -0.5, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mod.matvec_vpu_bf16acc(
            jnp.broadcast_to(x[0, :, None], (h, 128)), w, hb=128, fb=128))
    tx = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    tw = torch.from_numpy(np.asarray(w, np.float32)).bfloat16()
    scale = float(np.abs(want).max())
    out[f"{h}x{f}"] = [
        float(np.abs(bf16_matvec_plain(tx, tw, True, True).numpy()
                     - want).max()) / scale,
        float(np.abs(bf16_matvec_plain(tx, tw, True).numpy()
                     - want).max()) / scale]
print(json.dumps(out))
"""


def test_rounded_products_plain_matches_pallas_t3():
    """T3 rounds each product to bf16 and sums in fp32, but only with XLA's
    excess precision off: by default XLA keeps the bf16 product in fp32
    and T3 computes T1's function.  The flag must be set before jax is
    imported, so this runs in a fresh interpreter.  Bar: the rounded plain
    version within 1e-5 of T3's largest output, and T3 at least ten times
    farther from the unrounded one (it does round)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false"}
    res = subprocess.run(
        [sys.executable, "-c", T3_SCRIPT,
         str(ROOT / "tools" / "exp_pallas_gemv2.py")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    for name, (rounded, unrounded) in json.loads(
            res.stdout.strip().splitlines()[-1]).items():
        assert rounded <= 1e-5, (name, rounded)
        assert unrounded >= 10 * max(rounded, 1e-6), (name, unrounded)


@pytest.mark.parametrize("n,d,rb", [(1024, 128, 256), (512, 256, 128)])
def test_read_sum_plain_matches_pallas_t8(n, d, rb):
    """T8's pallas_call (taken from ``pallas_sum_2d``'s jitted loop, which
    only repeats it) sums the row blocks times the SMEM scalar."""
    rng = np.random.default_rng(n)
    jx, tx = _bf16(rng, (n, d))
    jx = jnp.abs(jx) + jnp.bfloat16(0.5)
    tx = tx.abs() + 0.5
    seed = np.float32(0.75)
    with pltpu.force_tpu_interpret_mode():
        run = _tool("exp_read_bw").pallas_sum_2d(jx, rb)
        jitted = inspect.getclosurevars(run).nonlocals["run"]
        call = inspect.getclosurevars(jitted.__wrapped__).nonlocals["call"]
        want = np.asarray(call(jnp.full((1, 1), seed), jx))
    for got in (read_sum_plain(tx, torch.tensor(seed)),
                read_sum(tx, torch.tensor([[seed]]))):   # CPU: plain
        assert got.shape == (1, 1) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert read_sum.launches == 0


def test_matvec_dispatches_by_storage():
    """bf16 -> K6 (both layouts), packed uint8 -> K5, int8 -> K4, anything
    else refused; the plain dispatch matches."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(
        np.float32)).bfloat16()
    wf = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32))
    w8, s8 = quant.quantize_tensor(wf.bfloat16())
    w4, s4 = quant.quantize_tensor(wf.bfloat16(), bits=4, group_size=32)
    w4 = quant.pack_int4(w4)
    for fn, plain in ((mv.matvec, mv.matvec_plain),
                      (KERNELS.matvec, PLAIN.matvec)):
        torch.testing.assert_close(fn(x, wf.bfloat16()),
                                   mv.bf16_matvec_plain(x, wf.bfloat16()))
        torch.testing.assert_close(
            fn(x, wf.t().contiguous().bfloat16(), None, True),
            mv.bf16_matvec_plain(x, wf.bfloat16()))
        torch.testing.assert_close(fn(x, w8, s8),
                                   quant.int8_matvec_plain(x, w8, s8))
        torch.testing.assert_close(fn(x, w4, s4),
                                   quant.int4_matvec_plain(x, w4, s4))
        torch.testing.assert_close(plain(x, w8, s8), fn(x, w8, s8))
        with pytest.raises(ValueError, match=r"\(F, K\)"):
            fn(x, w8, s8, True)
        with pytest.raises(TypeError):
            fn(x, wf)


class _Spy:
    """An `Attention` whose matvec records the rows it was given."""

    def __init__(self):
        self.rows = []

    def matvec(self, x, w, scale=None, kf=False):
        self.rows.append((x.shape[0], w.dtype, kf))
        return mv.matvec_plain(x, w, scale, kf)

    def attention(self):
        return Attention(KERNELS.prefill, KERNELS.decode, self.matvec)


@pytest.mark.parametrize("rows", [1, 3, 8, 9, 64])
def test_router_sends_few_bf16_rows_to_the_gemv(rows):
    """Up to MAX_ROWS rows of a bf16 weight (both layouts) take the GEMV,
    fp32 out; more take the library's product in x's dtype; an fp32 weight
    never takes it."""
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((1, rows, 64)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((48, 64)).astype(
        np.float32)).bfloat16()
    spy = _Spy()
    with torch.no_grad():
        y = llama._linear(x, w, None, spy.attention())
        yt = llama._linear(x, w.t().contiguous(), None, spy.attention(),
                           kf=True)
        y32 = llama._linear(x.float(), w.float(), None, spy.attention())
    gemv = rows <= quant.MAX_ROWS
    assert spy.rows == ([(rows, torch.bfloat16, False),
                         (rows, torch.bfloat16, True)] if gemv else [])
    assert y.shape == yt.shape == (1, rows, 48)
    assert y.dtype == (torch.float32 if gemv else torch.bfloat16)
    assert y32.dtype == torch.float32
    torch.testing.assert_close(y.float(), yt.float())
    want = x.float() @ w.float().t()
    torch.testing.assert_close(y.float(), want, atol=0.05, rtol=0.02)


def test_router_keeps_gradients_off_the_gemv():
    """A bf16 product whose operand tracks a gradient takes the library's
    product (K6 has no backward), and the gradient flows."""
    x = torch.randn((1, 2, 64), generator=torch.Generator().manual_seed(0)
                    ).bfloat16().requires_grad_()
    w = torch.randn((48, 64), generator=torch.Generator().manual_seed(1)
                    ).bfloat16()
    spy = _Spy()
    y = llama._linear(x, w, None, spy.attention())
    assert spy.rows == []
    y.float().sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    with torch.no_grad():
        llama._linear(x, w, None, spy.attention())
    assert spy.rows == [(2, torch.bfloat16, False)]


def test_proj_and_logits_route_bf16_decode_through_matvec():
    """`_proj` and `logits_from_hidden` on a bf16 tree: one decode row goes
    through ``attention.matvec`` for every projection and the (in, out)
    lm_head (``kf``), and the result equals the fp32 product cast back."""
    from valley_tpu_torch import valley_tiny

    cfg = valley_tiny()
    params = llama.init_params(cfg.text, torch.Generator().manual_seed(0),
                               torch.bfloat16)
    spy = _Spy()
    x = torch.randn((2, 1, cfg.text.hidden_size),
                    generator=torch.Generator().manual_seed(2)).bfloat16()
    with torch.inference_mode():
        y = llama._proj(params["layers"], 1, "w_down",
                        torch.randn((2, 1, cfg.text.intermediate_size))
                        .bfloat16(), spy.attention())
        logits = llama.logits_from_hidden(params, x, spy.attention())
    assert y.dtype == torch.bfloat16 and y.shape == (2, 1, 64)
    assert spy.rows == [(2, torch.bfloat16, False), (2, torch.bfloat16, True)]
    assert logits.dtype == torch.float32
    torch.testing.assert_close(
        logits, (x.float() @ params["lm_head"].float()), atol=1e-5,
        rtol=1e-5)
