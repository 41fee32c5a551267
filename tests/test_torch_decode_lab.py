"""The decode-attention lab's plain versions (``ops/decode_lab.py``) on the
CPU, against the TPU measurement kernels they stand for, run in interpret
mode: T4 ``decode_attn_pallas`` (tools/exp_attn_pallas2.py), T5
``attn_pallas`` (tools/exp_attn_layout.py), T6 ``decode_attn_stacked``
(tools/exp_attn_pallas3.py) and T7 ``make_kernel(stage)``
(tools/exp_kernel_ablate.py, called with ``run_stage``'s grid spec and a
block-diagonal ``qd``), and against the tools' XLA oracles ``attn_xla`` and
``attn_hsd``.  The tools read some shapes from module globals; the tests
set them with ``monkeypatch``.

Inputs are made with numpy from a seed and given to both sides as the same
bf16 values.  Tolerances, relative to the largest |output|:
- T4-T6 (fp32 out) against their tools: 1e-5.  Both take fp32 logits of
  the same exact bf16 products, the same fp32 softmax and the same bf16
  rounding of the unnormalised probabilities, and differ in summation
  order; a probability whose rounding flips moves an output by far less.
- T7 (bf16 out): 2^-7, one bf16 step at the largest output (stage 0 is
  exact).
- Against the XLA oracles: 2^-7.  The oracles round the normalised
  probabilities to bf16, the kernels the unnormalised ones.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from valley_tpu_torch.ops import decode_lab as lab
from valley_tpu_torch.ops.decode_attention import decode_attention_plain
from valley_tpu_torch.tools.decode_attn_lab import conversation_valid

ROOT = Path(__file__).resolve().parent.parent
TOOL_TOL = 1e-5
BF16_TOL = 2 ** -7


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


def _bias(valid):
    """(B, S) bool -> the -1e9 bias, for jax and for torch."""
    b = np.where(valid, 0.0, -1e9).astype(np.float32)
    return jnp.asarray(b), torch.from_numpy(b)


def _close(got, want, rel):
    got, want = (x.float().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x, np.float32) for x in (got, want))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _inputs(seed, b=1, h=8, s=96, d=128, layers=None, n_valid=70):
    """q (B, 1, H, D) N(0, 1); K and V N(0, 1) * 0.3 head-major
    (B, H, S, D), stacked (L, ...) with ``layers``; the first ``n_valid``
    slots valid, row 1 (if any) with a hole."""
    rng = np.random.default_rng(seed)
    jq, tq = _bf16(rng, (b, 1, h, d))
    lead = (layers,) if layers else ()
    jk, tk = _bf16(rng, lead + (b, h, s, d), 0.3)
    jv, tv = _bf16(rng, lead + (b, h, s, d), 0.3)
    valid = np.arange(s)[None, :] < n_valid
    valid = np.repeat(valid, b, axis=0)
    if b > 1:
        valid[1, 10:30] = False
    return (jq, jk, jv), (tq, tk, tv), valid


@pytest.mark.parametrize("hc", [8, 16])
def test_t4_plain_matches_pallas(hc):
    (jq, jk, jv), (tq, tk, tv), valid = _inputs(0, h=16)
    jb, tb = _bias(valid)
    mod = _tool("exp_attn_pallas2")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mod.decode_attn_pallas(jq, jk, jv, jb, hc=hc))
    got = lab.attn_head_major_plain(tq, tk, tv, tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, TOOL_TOL)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    _close(lab.attn_head_chunked(tq, tk, tv, tb, hc), want, TOOL_TOL)
    assert lab.attn_head_chunked.launches == 0
    _close(got, mod.attn_xla(jq, jk, jv, jb), BF16_TOL)


def test_t5_plain_matches_pallas(monkeypatch):
    """T5 reads S and D from its module and broadcasts row 0's bias: at
    B = 1 that is the row's own."""
    (jq, jk, jv), (tq, tk, tv), valid = _inputs(1, h=8, s=80, d=64)
    jb, tb = _bias(valid)
    mod = _tool("exp_attn_layout")
    monkeypatch.setattr(mod, "S", 80)
    monkeypatch.setattr(mod, "D", 64)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mod.attn_pallas(jq, jk, jv, jb))
    got = lab.attn_per_head(tq, tk, tv, tb)
    _close(got, want, TOOL_TOL)
    _close(got, mod.attn_hsd(jq, jk, jv, jb), BF16_TOL)


def test_t6_plain_matches_pallas_at_layer_2_of_4():
    (jq, jk, jv), (tq, tk, tv), valid = _inputs(2, h=16, layers=4)
    jb, tb = _bias(valid)
    mod = _tool("exp_attn_pallas3")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mod.decode_attn_stacked(jq, jk, jv, jb, 2, hc=8))
    got = lab.attn_stacked_head_major(tq, tk, tv, tb, 2, hc=8)
    _close(got, want, TOOL_TOL)
    _close(got, mod.attn_xla(jq, jk[2], jv[2], jb), BF16_TOL)


def _t7_tool(mod, stage, qd, k_flat, v_flat, bias, li):
    """``make_kernel(stage)`` through ``run_stage``'s grid spec
    (exp_kernel_ablate.py:82-108) on these arrays."""
    _, b, s, hd = k_flat.shape
    h = qd.shape[-1]
    d = hd // h
    vmem = pltpu.VMEM
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(b, 1),
        in_specs=[
            pl.BlockSpec((1, hd, h), lambda bi, si, li: (bi, 0, 0),
                         memory_space=vmem),
            pl.BlockSpec((1, 1, s, hd), lambda bi, si, li: (li[0], bi, si, 0),
                         memory_space=vmem),
            pl.BlockSpec((1, 1, s, hd), lambda bi, si, li: (li[0], bi, si, 0),
                         memory_space=vmem),
            pl.BlockSpec((1, s), lambda bi, si, li: (bi, si),
                         memory_space=vmem),
        ],
        out_specs=pl.BlockSpec((1, h, d), lambda bi, si, li: (bi, 0, 0),
                               memory_space=vmem),
        scratch_shapes=[vmem((1, 128), jnp.float32),
                        vmem((1, 128), jnp.float32),
                        vmem((h, d), jnp.float32)])
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(
            mod.make_kernel(stage), grid_spec=grid_spec,
            out_shape=jax.ShapeDtypeStruct((b, h, d), jnp.bfloat16),
        )(jnp.asarray([li], jnp.int32), qd, k_flat, v_flat, bias),
            np.float32)


def _block_diagonal(q):
    """(B, H, D) -> the (B, H*D, H) qd of decode_pallas.py:167-172 (one kv
    head per query head): column h holds q[:, h] in rows h*D..(h+1)*D."""
    b, h, d = q.shape
    qd = np.zeros((b, h * d, h), np.float32)
    for i in range(h):
        qd[:, i * d:(i + 1) * d, i] = q[:, i]
    return jnp.asarray(qd, jnp.bfloat16)


@pytest.mark.parametrize("stage", lab.STAGES)
def test_t7_plain_matches_pallas_stage(monkeypatch, stage):
    """The slot-major (L, B, S, H, D) cache is the tool's (L, B, S, H*D)
    one in memory; layer 1 of 3, two rows, a hole in row 1."""
    layers, b, s, h, d = 3, 2, 80, 4, 64
    rng = np.random.default_rng(10 + stage)
    jq, tq = _bf16(rng, (b, h, d))
    jk, tk = _bf16(rng, (layers, b, s, h, d), 0.3)
    jv, tv = _bf16(rng, (layers, b, s, h, d), 0.3)
    valid = np.repeat(np.arange(s)[None, :] < 60, b, axis=0)
    valid[1, 5:25] = False
    jb, tb = _bias(valid)
    mod = _tool("exp_kernel_ablate")
    for name, val in (("H", h), ("D", d), ("S", s)):
        monkeypatch.setattr(mod, name, val)
    want = _t7_tool(mod, stage, _block_diagonal(np.asarray(jq, np.float32)),
                    jk.reshape(layers, b, s, h * d),
                    jv.reshape(layers, b, s, h * d), jb, 1)
    got = lab.attn_stage_plain(tq, tk, tv, tb, 1, stage)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, d)
    if stage == 0:
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        _close(got, want, BF16_TOL)
    _close(lab.attn_stage(tq, tk, tv, tb, 1, stage), want, BF16_TOL)
    assert lab.attn_stage.launches == 0


def test_t7_stage3_is_decode_attention_with_a_bias():
    """Stage 3 computes K3's bf16 function with the mask as a bias."""
    rng = np.random.default_rng(20)
    _, tq = _bf16(rng, (1, 8, 128))
    _, tk = _bf16(rng, (2, 1, 200, 8, 128))
    _, tv = _bf16(rng, (2, 1, 200, 8, 128))
    valid = torch.from_numpy(np.random.default_rng(21).random((1, 200))
                             < 0.7)
    bias = torch.where(valid, 0.0, -1e9).float()
    got = lab.attn_stage_plain(tq, tk, tv, bias, 1, 3)
    want = decode_attention_plain(tq[:, None], tk, tv, 1, valid)[:, 0]
    _close(got, want, BF16_TOL)


def test_fully_masked_row_gives_the_mean_of_v():
    """Every slot of row 1 carries the -1e9 bias: the tools' softmax is
    uniform, so the output is V's mean over the slots (K1 returns 0 for
    such a row instead)."""
    (jq, jk, jv), (tq, tk, tv), valid = _inputs(3, b=2, h=16)
    valid[1] = False
    jb, tb = _bias(valid)
    mean = tv[1].float().mean(dim=1)                       # (H, D)
    got = lab.attn_head_major_plain(tq, tk, tv, tb)
    _close(got[1, 0], mean, 1e-6)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_tool("exp_attn_pallas2").decode_attn_pallas(
            jq, jk, jv, jb, hc=8))
    _close(got, want, TOOL_TOL)
    slot_major = tk.transpose(1, 2)[None].contiguous(), \
        tv.transpose(1, 2)[None].contiguous()
    staged = lab.attn_stage_plain(tq[:, 0], *slot_major, tb, 0, 3)
    _close(staged[1], mean, BF16_TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros((1, 1, 4, 128), dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 16, 128), dtype=torch.bfloat16)
    bias = torch.zeros((1, 16))
    with pytest.raises(ValueError, match="stage"):
        lab.attn_stage(q[:, 0], k[None].transpose(2, 3), k[None], bias, 0, 5)
    with pytest.raises(TypeError, match="bf16"):
        lab._check("t", q, k.float(), k, bias, "BHSD")
    with pytest.raises(ValueError, match="bias"):
        lab._check("t", q, k, k, bias[:, :8], "BHSD")
    with pytest.raises(ValueError, match="head_dim"):
        lab._check("t", q[..., :32], k[..., :32], k[..., :32], bias, "BHSD")
    with pytest.raises(ValueError, match="slots"):
        lab._check("t", q, k, k, bias, "BHSD", max_slots=8)
    with pytest.raises(ValueError, match="contiguous"):
        lab._check("t", q, k.transpose(2, 3).contiguous().transpose(2, 3),
                   k, bias, "BHSD")


def test_conversation_valid_matches_a_session():
    """The lab's conversation mask is the one `ChatSession` leaves: a
    473-token first turn in the 512 bucket, then chunks of 21 and 41 tokens
    (pow-2 spans of 32 and 64), each turn replying 64 tokens."""
    v = conversation_valid(2052, 473, 512, (21, 41), 64)[0]
    spans = [(0, 473), (512, 575), (575, 596), (607, 670), (670, 711),
             (734, 797)]
    want = torch.zeros(2052, dtype=torch.bool)
    for a, b in spans:
        want[a:b] = True
    assert torch.equal(v, want)
    assert int(v.sum()) == 473 + 21 + 41 + 3 * 63
