"""Numerics of K1 (``csrc/flash_fwd.cu``) on the card: how its rounding
choices move the two checks that read whole models, ``chip_smoke.py``'s
first-step training loss (bar 1e-4) and ``tests/test_torch_cuda.py``'s
``test_tiny_int8_serving_on_the_card`` (bar 0.05).

    python -m valley_tpu_torch.tools.flash_numerics [--layers N]

It builds K1 as shipped and variants made from the same source by text
substitution (`VARIANTS`; each raises if its anchor is no longer in the
source), one nvcc each, all started together, and holds each, with an fp64
attention (exact beyond the plain version), against the plain version
(``flash_attention_plain``) on:

1. the tiny int8a8 model's prefill logits (the card test's construction):
   W8A8 turns a one-ulp change of an attention output into an int8 step;
2. Valley-7B's first-step training loss on ``chip_smoke.py``'s batch and
   weights (`valley_tpu_torch.data.synthetic`, seed 1), TF32 off, at
   ``--layers`` of its 32 layers (16, chip_smoke.py's `TRAIN_LAYERS`, by
   default);
3. that forward's own attention inputs at its first, middle and last
   layers: how many bf16
   outputs differ from the plain version's, and their mean signed change;

and gives each variant's device time (profiler) at the serving prefill
(B1 S512 H32 D128 causal, 473 keys valid) and on layer 0's training inputs
(B16 S512 causal).  It needs a CUDA card and nvcc, and stops without them.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from valley_tpu_torch.ops import _build
from valley_tpu_torch.ops.attention import KERNELS, PLAIN, Attention
from valley_tpu_torch.ops.flash_attention import flash_attention_plain

# K1's P V step as shipped (`PTerms`, `split_p`, `p_times_v`): P carried
# as two bf16 terms, the small term's products first
PV_SHIPPED = """struct PTerms {
  uint32_t hi[BK / 16][4], lo[BK / 16][4];
};

// P's terms from S's sums (the probabilities, fp32), in wgmma's register A
// layout.
__device__ __forceinline__ void split_p(PTerms& p, const float* s) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    flash::c_to_a2(p.hi[kk], p.lo[kk], s + 8 * kk);
    fence_regs(p.hi[kk]);
    fence_regs(p.lo[kk]);
  }
}

// O += P V, issued (not committed): V's tile of BK keys at vb, MN-major.
template <int DP>
__device__ __forceinline__ void p_times_v(float (&o)[DP / 2],
                                          const PTerms& p, uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = sw128_desc(vb + kk * 2048, BK * ROW, 1024);
    wgmma_bf16_rs<DP, 1>(o, p.lo[kk], dv, 1);
    wgmma_bf16_rs<DP, 1>(o, p.hi[kk], dv, 1);
  }
}"""


def pv_step(terms: int, split: str = "rn", lo_first: bool = False) -> str:
    """K1's P V step with P carried as ``terms`` bf16 terms, each the
    remainder of the ones before it rounded to bf16 (``split`` "rn") or
    truncated to bf16 (``split`` "rz"; the last term is rounded); with
    ``lo_first`` the smallest term's products are taken first."""
    text = ("struct PTerms {\n"
            f"  uint32_t t[{terms}][BK / 16][4];\n"
            "};\n\n"
            "__device__ __forceinline__ void split_p(PTerms& p, "
            "const float* s) {\n"
            "#pragma unroll\n"
            "  for (int kk = 0; kk < BK / 16; ++kk) {\n")
    if terms == 1:
        text += "    flash::c_to_a(p.t[0][kk], s + 8 * kk);\n"
    else:
        cut = ("__bfloat162float(__float2bfloat16_rn(x))" if split == "rn"
               else "__uint_as_float(__float_as_uint(x) & 0xffff0000u)")
        text += (f"    auto cut = [](float x) {{ return {cut}; }};\n"
                 "    float c[8];\n"
                 "#pragma unroll\n"
                 "    for (int i = 0; i < 8; ++i) c[i] = s[8 * kk + i];\n"
                 "#pragma unroll\n"
                 "    for (int i = 0; i < 4; ++i) {\n")
        for n in range(terms - 1):
            text += ("      {\n"
                     "        const float h0 = cut(c[2 * i]);\n"
                     "        const float h1 = cut(c[2 * i + 1]);\n"
                     f"        p.t[{n}][kk][i] = flash::pack_bf16(h0, h1);\n"
                     "        c[2 * i] -= h0;\n"
                     "        c[2 * i + 1] -= h1;\n"
                     "      }\n")
        text += (f"      p.t[{terms - 1}][kk][i] = flash::pack_bf16(c[2 * i], "
                 "c[2 * i + 1]);\n"
                 "    }\n")
    for n in range(terms):
        text += f"    fence_regs(p.t[{n}][kk]);\n"
    text += ("  }\n"
             "}\n\n"
             "template <int DP>\n"
             "__device__ __forceinline__ void p_times_v(float (&o)[DP / 2],\n"
             "                                          const PTerms& p, "
             "uint32_t vb) {\n"
             "#pragma unroll\n"
             "  for (int kk = 0; kk < BK / 16; ++kk) {\n"
             "    const uint64_t dv = sw128_desc(vb + kk * 2048, BK * ROW, "
             "1024);\n")
    order = range(terms - 1, -1, -1) if lo_first else range(terms)
    for n in order:
        text += f"    wgmma_bf16_rs<DP, 1>(o, p.t[{n}][kk], dv, 1);\n"
    return text + "  }\n}"


# the output divided by the denominator instead of multiplied by its inverse
DIVIDE = [("      const float inv = 1.f / denom;\n", ""),
          ("o[4 * j + 2 * r] * inv,", "o[4 * j + 2 * r] / denom,"),
          ("o[4 * j + 2 * r + 1] * inv)", "o[4 * j + 2 * r + 1] / denom)")]
BK128 = [("constexpr int BK = 64;", "constexpr int BK = 128;"),
         ("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")]
VARIANTS = {
    "shipped": [],
    "bf16_p": [(PV_SHIPPED, pv_step(1))],
    "two_term": [(PV_SHIPPED, pv_step(2))],
    "two_term_rz": [(PV_SHIPPED, pv_step(2, "rz"))],
    "two_term_div": [(PV_SHIPPED, pv_step(2))] + DIVIDE,
    "two_term_rz_div": [(PV_SHIPPED, pv_step(2, "rz"))] + DIVIDE,
    "two_term_rz_lo_first": [(PV_SHIPPED, pv_step(2, "rz", True))],
    "three_term": [(PV_SHIPPED, pv_step(3))],
    # key tiles of 128: the running max and O rescaled every 128 keys
    "bk128": BK128,
    "bk128_two_term": BK128 + [(PV_SHIPPED, pv_step(2))],
}


def build(work: Path) -> dict:
    """Each variant of ``flash_fwd.cu`` built by one nvcc of its own, all
    started together; returns its C entry point by name."""
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: flash_fwd.cu no longer holds "
                                   f"{old[:60]!r}")
            text = text.replace(old, new)
        cu = work / f"flash_fwd_{name}.cu"
        cu.write_text(text)
        so = work / f"libflash_fwd_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).flash_fwd_bf16
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, vp, vp, i, i, i,
                       i, i, i, ctypes.c_float, i, vp]
        fn.restype = i
        fns[name] = fn
    return fns


def prefill_of(fn):
    """A prefill attention (`Attention.prefill`'s signature, no gradient)
    through one built variant."""
    def prefill(q, k, v, kv_mask=None, *, causal=False):
        b, sq, h, d = q.shape
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = torch.empty_like(q)
        lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        kv_mask.data_ptr(), kv_mask.stride(0),
                        out.data_ptr(), lse.data_ptr(), b, h, sq,
                        k.shape[1], d, int(causal), d ** -0.5, 0,
                        torch.cuda.current_stream().cuda_stream),
                     "flash_fwd_bf16")
        return out
    return prefill


def fp64_prefill(q, k, v, kv_mask=None, *, causal=False):
    """softmax(QK^T d^-1/2)V in fp64, rounded to q's dtype at the end."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[3]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                          k.double()) * d ** -0.5
    mask = kv_mask[:, None, None, :]
    if causal:
        mask = mask & torch.ones((sq, sk), dtype=torch.bool,
                                 device=q.device).tril(sk - sq)
    logits = logits.masked_fill(~mask, -1e9)
    p = torch.where(mask, torch.exp(logits - logits.amax(-1, keepdim=True)),
                    0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.double()).to(q.dtype)


def device_ms(fn, iters: int = 20) -> float:
    """Device ms per call of the flash_fwd kernel under ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if "flash_fwd_kernel" in e.key)
    if total <= 0:
        raise RuntimeError("the profiler recorded no flash_fwd_kernel time")
    return total / 1e3 / iters


def tiny_int8_logits(prefills: dict) -> dict:
    """Max |kernel - plain| of the tiny int8a8 model's prefill logits."""
    from valley_tpu_torch import valley_tiny
    from valley_tpu_torch.inference.engine import Engine, GenerationConfig
    from valley_tpu_torch.models import llama, valley
    from valley_tpu_torch.ops.quant import quantize_llama_params

    cfg = valley_tiny()
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    params = quantize_llama_params(llama.fuse_llama_params(params),
                                   act8=True)
    prompt = np.random.default_rng(0).integers(5, 400, 90).tolist()
    gcfg = GenerationConfig(max_new_tokens=6)

    def logits(attention):
        return Engine(cfg, params, buckets=(128,), max_new_tokens=6,
                      cache_dtype=torch.int8, steps_per_call=2,
                      attention=attention).prefill([prompt], None,
                                                   gcfg).logits

    ref = logits(PLAIN)
    return {name: (logits(Attention(fn, KERNELS.decode, KERNELS.matvec))
                   - ref).abs().max().item()
            for name, fn in prefills.items()}


def training(prefills: dict, layers: int) -> tuple:
    """(loss of the plain version, {name: loss - plain's}, {name: [(bf16
    outputs that differ from the plain version's, mean signed change) at
    its first, middle and last layer]}, layer 0's attention inputs) on
    ``chip_smoke.py``'s training batch and weights at ``layers`` layers."""
    from valley_tpu_torch import SpecialTokens, valley_7b
    from valley_tpu_torch.data.dataset import (
        DataCollatorForSupervisedDataset, DataLoader)
    from valley_tpu_torch.data.synthetic import BENCH_TOKENS, TrainRows
    from valley_tpu_torch.models import valley
    from valley_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = valley_7b(tokens=SpecialTokens(**BENCH_TOKENS))
    cfg = cfg.replace(text=dataclasses.replace(cfg.text,
                                               num_hidden_layers=layers))
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(1),
                                torch.bfloat16, "cuda")
    loader = DataLoader(TrainRows(cfg), 16,
                        DataCollatorForSupervisedDataset(
                            pad_token_id=0, pad_to_multiple=64),
                        seed=0, num_workers=1)
    tc = TrainConfig(output_dir=tempfile.mkdtemp(prefix="flash_numerics_"),
                     gradient_checkpointing=True, freeze_backbone=True,
                     tune_mm_mlp_adapter=True,
                     per_device_train_batch_size=16, save_steps=0)
    batch = Trainer(cfg, tc, params, loader, total_steps=1).device_batch(
        next(iter(loader.epoch(0))))
    inputs = []
    kept_layers = (0, layers // 2, layers - 1)

    def recording(q, k, v, kv_mask=None, *, causal=False):
        if len(inputs) in kept_layers:
            inputs.append((q.clone(), k.clone(), v.clone(), kv_mask.clone(),
                           causal))
        else:
            inputs.append(None)
        return flash_attention_plain(q, k, v, kv_mask, causal=causal)

    def loss(prefill):
        return float(valley.loss_fn(params, cfg, batch, remat=False,
                                    attention=Attention(prefill,
                                                        KERNELS.decode,
                                                        KERNELS.matvec)))

    with torch.no_grad():
        plain = loss(recording)
        diffs = {name: loss(fn) - plain for name, fn in prefills.items()}
    del params
    kept = [r for r in inputs if r is not None]
    changes = {name: [] for name in prefills}
    for q, k, v, mask, causal in kept:
        ref = flash_attention_plain(q, k, v, mask, causal=causal).float()
        for name, fn in prefills.items():
            d = fn(q, k, v, mask, causal=causal).float() - ref
            changes[name].append((int((d != 0).sum()), d.mean().item()))
    return plain, diffs, changes, kept[0]


def serving_inputs():
    """The serving prefill's attention inputs: B1 S512 H32 D128, N(0, 1)
    bf16 from a seed, 473 keys valid, causal."""
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn((1, 512, 32, 128), generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    mask = torch.ones((1, 512), dtype=torch.bool, device="cuda")
    mask[:, 473:] = False
    return q, k, v, mask, True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--layers", type=int, default=16)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_numerics: no CUDA device", file=sys.stderr)
        return 2
    # as chip_smoke.py: fp32 references in fp32 (the models have no
    # convolution: the patch embedding is a matmul)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="flash_numerics_") as work:
        fns = build(Path(work))
        prefills = {name: prefill_of(fn) for name, fn in fns.items()}
        prefills["fp64"] = fp64_prefill
        tiny = tiny_int8_logits(prefills)
        plain, diffs, changes, train_in = training(prefills, args.layers)
        serve_in = serving_inputs()
        times = {}
        for name in fns:
            q, k, v, mask, causal = serve_in
            a = device_ms(lambda: prefills[name](q, k, v, mask,
                                                 causal=causal))
            q, k, v, mask, causal = train_in
            times[name] = (a, device_ms(lambda: prefills[name](
                q, k, v, mask, causal=causal)))
    print(f"flash_numerics on {smi}")
    print("tiny int8a8 prefill logits, max |kernel - plain| (bar 0.05): " +
          ", ".join(f"{n} {x:.4f}" for n, x in tiny.items()))
    kept_layers = (0, args.layers // 2, args.layers - 1)
    print(f"7B first-step training loss at {args.layers} layers "
          f"{plain:.5f}; kernel - plain (bar "
          f"1e-4): " + ", ".join(f"{n} {x:+.3e}" for n, x in diffs.items()))
    for name, per_layer in changes.items():
        print(f"{name}: bf16 outputs changed against the plain version, "
              f"layers {kept_layers}: " + "; ".join(
                  f"{n} (mean signed {m:+.2e})" for n, m in per_layer))
    print("device ms at the serving prefill / on layer 0's training "
          "inputs: " + ", ".join(f"{n} {a:.4f} / {b:.4f}"
                                 for n, (a, b) in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
