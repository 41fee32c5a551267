"""Smoke test of the PyTorch port (``valley_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the CUDA kernels from ``valley_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes the Valley-7B path
gives it, then serves one 8-frame video question with Valley-7B at full
width and depth (random bf16 weights from a seed) through
``Engine.generate_tokens``, checks that the path went through the kernels,
and compares its logits at the prefill and at three decode steps with the
same path run on the plain attention functions.  TF32 is off for matmuls
and cuDNN, so fp32 references are fp32.

Every phase prints one line; a failed check raises and the script exits
non-zero.  The line before the last is a JSON object with each kernel's
launches on the main path, error, and device time beside its plain
version's; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel tolerance, relative to the reference output: max abs error <=
# REL_TOL * max|ref|, two bf16 ulps at the largest output.  Both sides
# compute in fp32 from the same bf16 inputs and round the output to bf16;
# they differ in summation order and, for decode, in where probabilities are
# rounded to bf16 (per 64-slot chunk in the kernel, after the global softmax
# in the plain version).  A CPU emulation of the kernel's rounding at the 7B
# decode shape differs from the plain version by up to 0.65% of max|ref|.
# Inputs are N(0, 1), so logits have unit spread and the output depends on
# which slots are attended: attending the hole in the 7B decode mask moves
# it by 12-47% of max|ref| in that emulation, and the planted fault below
# must fail the check.
REL_TOL = 2 ** -6
# Kernels vs plain logits of the full-size slice, at the prefill and at
# three teacher-forced decode steps: the kernels' one-ulp differences in
# the attention outputs propagate through 32 bf16 layers.  H100 readings of
# this script: 0.0703 at the prefill (largest logit 4.06); the bar is about
# twice that.
LOGIT_TOL = 0.15
DECODE_CHECK_STEPS = 3
NEW_TOKENS = 64
BENCH_TOKENS = dict(im_patch=31996, im_start=31997, im_end=31998,
                    vi_frame=31999, vi_start=31994, vi_end=31995)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds of ``fn()`` over a loop of ``iters`` calls, by
    CUDA events around the whole loop (host launch cost included)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_device(fn, iters: int = 1):
    """Run ``fn()`` ``iters`` times under the profiler's CUDA trace.
    Returns (device ms per call summed over every kernel and copy, the
    kernels by total device ms); raises if the trace holds no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    total = sum(ms for _, ms in rows)
    check(total > 0, "the profiler recorded no device time")
    return total / iters, sorted(rows, key=lambda r: -r[1])


def kernel_times(fn, plain_fn, iters: int) -> dict:
    """Per-call times of a kernel's wrapper and its plain version: ``ms``
    and ``plain_ms`` are device time from the profiler trace; ``loop_ms``
    and ``plain_loop_ms`` are a loop of calls timed by CUDA events."""
    fn()
    plain_fn()
    return {"ms": profile_device(fn, iters)[0],
            "plain_ms": profile_device(plain_fn, iters)[0],
            "loop_ms": time_ms(fn, iters), "plain_loop_ms": time_ms(
                plain_fn, iters)}


def fmt_times(t: dict) -> str:
    return (f"device {t['ms']:.4f} ms vs plain {t['plain_ms']:.4f} ms; loop "
            f"{t['loop_ms']:.4f} ms vs plain {t['plain_loop_ms']:.4f} ms")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def tolerance(ref: torch.Tensor) -> float:
    return REL_TOL * ref.float().abs().max().item()


def flash_cases(gen):
    """(name, q, k, v, kv_mask, causal): the 7B prefill shape first."""
    def qkv(b, s, h, d):
        return [torch.randn((b, s, h, d), generator=gen, device="cuda")
                .bfloat16() for _ in range(3)]

    cases = []
    q, k, v = qkv(1, 512, 32, 128)
    mask = torch.ones((1, 512), dtype=torch.bool, device="cuda")
    mask[:, 473:] = False                      # a prompt padded to 512
    cases.append(("7b_prefill_S512_D128", q, k, v, mask, True))
    q, k, v = qkv(2, 300, 4, 64)
    mask = torch.ones((2, 300), dtype=torch.bool, device="cuda")
    mask[0, 283:] = False
    cases.append(("ragged_S300_D64", q, k, v, mask, True))
    q, k, v = qkv(2, 96, 2, 64)
    mask = torch.ones((2, 96), dtype=torch.bool, device="cuda")
    mask[1] = False                            # every row of batch 1 masked
    cases.append(("fully_masked_rows_D64", q, k, v, mask, False))
    return cases


def decode_cases(gen, smax_7b: int, prompt_len: int, bucket: int):
    """(name, q, k_all, v_all, li, valid, hole): the 7B decode shape first,
    with the hole [prompt_len, bucket) that decode leaves in the mask."""
    def make(n_layers, b, smax, h, hkv, d):
        q = torch.randn((b, 1, h, d), generator=gen, device="cuda").bfloat16()
        kv = [torch.randn((n_layers, b, smax, hkv, d), generator=gen,
                          device="cuda").bfloat16() for _ in range(2)]
        return q, kv[0], kv[1]

    cases = []
    q, k, v = make(32, 1, smax_7b, 32, 32, 128)
    valid = torch.zeros((1, smax_7b), dtype=torch.bool, device="cuda")
    valid[:, :prompt_len] = True               # the prompt
    valid[:, bucket:bucket + 40] = True        # 40 decoded tokens
    cases.append(("7b_decode_L32_S%d_D128_hole" % smax_7b, q, k, v, 17,
                  valid, (prompt_len, bucket)))
    q, k, v = make(3, 1, 96, 4, 2, 32)
    valid = torch.rand((1, 96), generator=gen, device="cuda") < 0.8
    valid[:, :4] = True
    cases.append(("gqa_rep2_D32", q, k, v, 1, valid, None))
    q, k, v = make(3, 2, 640, 8, 8, 128)
    valid = torch.rand((2, 640), generator=gen, device="cuda") < 0.8
    valid[:, :4] = True
    cases.append(("batch2_S640_D128", q, k, v, 1, valid, None))
    q, k, v = make(3, 1, 3000, 4, 4, 128)
    valid = torch.rand((1, 3000), generator=gen, device="cuda") < 0.8
    cases.append(("S3000_D128", q, k, v, 2, valid, None))
    return cases


def decode_logits(engine, state, prompt_len: int, tokens):
    """fp32 logits of teacher-forced decode steps after ``state``'s
    prefill: step i feeds ``tokens[i]`` at slot bucket + i and rotary
    position prompt_len + i, as ``Engine._decode`` does."""
    from valley_tpu_torch.models import llama

    p, text, dev = engine.params["llama"], engine.cfg.text, engine.device
    valid = state.valid.clone()
    out = []
    with torch.inference_mode():
        for i, t in enumerate(tokens):
            slot = state.bucket + i
            valid[:, slot] = True
            hidden, _ = llama.forward_hidden(
                p, text, llama.embed(p, torch.tensor([[t]], device=dev)),
                positions=torch.tensor([[prompt_len + i]], device=dev),
                cache=state.cache, cache_index=slot, kv_valid=valid,
                attention=engine.attention)
            out.append(llama.logits_from_hidden(p, hidden)[0, 0])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from valley_tpu_torch import SpecialTokens, valley_7b
        from valley_tpu_torch.inference.engine import Engine, GenerationConfig
        from valley_tpu_torch.models import valley
        from valley_tpu_torch.ops import _build
        from valley_tpu_torch.ops.attention import PLAIN
        from valley_tpu_torch.ops.decode_attention import (
            decode_attention_plain, decode_attention_stacked)
        from valley_tpu_torch.ops.flash_attention import (
            flash_attention, flash_attention_plain)
    except ImportError as e:
        print(f"chip_smoke: run from the root of a valley-tpu checkout "
              f"({e})", file=sys.stderr)
        return 2
    check("jax" not in sys.modules, "the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 2. build
    print(f"build: {_build.build_all():.2f} s for {list(_build.SOURCES)}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    bucket, new = 512, NEW_TOKENS
    steps = new - 1
    # the engine's cache: bucket + max_new_tokens + steps_per_call slots
    smax = bucket + new + steps

    # 3. K1 against its plain version
    k1_err, k1_t = 0.0, None
    for name, q, k, v, mask, causal in flash_cases(gen):
        out, lse = flash_attention(q, k, v, mask, causal=causal,
                                   return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(q, k, v, mask, causal=causal,
                                             return_lse=True)
        err, tol = max_err(out, ref), tolerance(ref)
        lse_err = max_err(lse, ref_lse)
        check(bool(torch.isfinite(out.float()).all()),
              f"K1 {name}: not finite")
        check(err <= tol, f"K1 {name}: max abs err {err} > {tol}")
        check(lse_err <= 1e-3, f"K1 {name}: lse err {lse_err}")
        if name.startswith("fully_masked"):
            check(out[1].abs().max().item() == 0.0,
                  "K1: fully masked rows must be 0")
        k1_err = max(k1_err, err)
        line = (f"K1 flash_fwd {name}: max_abs_err {err:.3e} (tol {tol:.3e}"
                f"), lse err {lse_err:.3e} (tol 1e-3)")
        if k1_t is None:
            k1_t = kernel_times(
                lambda: flash_attention(q, k, v, mask, causal=causal),
                lambda: flash_attention_plain(q, k, v, mask, causal=causal),
                iters=20)
            line += " " + fmt_times(k1_t)
        print(line)

    # 4. K3 against its plain version
    k3_err, k3_t = 0.0, None
    for name, q, k, v, li, valid, hole in decode_cases(gen, smax, 473,
                                                       bucket):
        out = decode_attention_stacked(q, k, v, li, valid)
        torch.cuda.synchronize()
        ref = decode_attention_plain(q, k, v, li, valid)
        err, tol = max_err(out, ref), tolerance(ref)
        check(bool(torch.isfinite(out.float()).all()),
              f"K3 {name}: not finite")
        check(err <= tol, f"K3 {name}: max abs err {err} > {tol}")
        k3_err = max(k3_err, err)
        line = f"K3 decode_attn {name}: max_abs_err {err:.3e} (tol {tol:.3e})"
        if hole is not None:
            # planted fault: a kernel that attended the hole (as one that
            # took a length instead of the mask would) must fail the check
            filled = valid.clone()
            filled[:, hole[0]:hole[1]] = True
            fault = max_err(decode_attention_stacked(q, k, v, li, filled),
                            ref)
            check(fault > tol, f"K3 {name}: attending the hole moved the "
                  f"output by {fault} only, within the tolerance {tol}")
            line += f"; attending the hole instead: {fault:.3e} (must fail)"
        if k3_t is None:
            # walk the layers, as decode does, so each call reads its K/V
            # from device memory rather than from L2
            n_layers = k.shape[0]
            it = iter(range(10 ** 9))
            k3_t = kernel_times(
                lambda: decode_attention_stacked(
                    q, k, v, next(it) % n_layers, valid),
                lambda: decode_attention_plain(
                    q, k, v, next(it) % n_layers, valid), iters=64)
            kv_bytes = 2 * k[0].numel() * k.element_size()
            line += (f" {fmt_times(k3_t)} ({kv_bytes / 1e6:.2f} MB of K/V "
                     f"per call: {kv_bytes / k3_t['ms'] / 1e6:.1f} GB/s of "
                     f"the card's 3350)")
        print(line)
        del k, v

    # 5. the slice: Valley-7B, 8 uint8 frames, a 512-bucket prompt
    cfg = valley_7b(tokens=SpecialTokens(**BENCH_TOKENS))
    t0 = time.perf_counter()
    params = valley.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    print(f"valley_7b random bf16 weights: "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"params in {time.perf_counter() - t0:.1f} s")
    tok = cfg.tokens
    span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
        [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * 8 + [tok.vi_end]
    rng = np.random.default_rng(0)
    prompt = [1] + span + rng.integers(
        5, 30000, size=bucket - len(span) - 40).tolist()
    size = cfg.vision.image_size
    frames = rng.integers(0, 256, (1, 8, 3, size, size)).astype(np.uint8)
    gcfg = GenerationConfig(max_new_tokens=new, do_sample=False)
    engine = Engine(cfg, params, buckets=(bucket,), max_new_tokens=new,
                    steps_per_call=steps)

    def run():
        t0 = time.perf_counter()
        t_first, toks = None, []
        for t in engine.generate_tokens([prompt], frames, gcfg,
                                        eos_ids=[-1]):
            if t_first is None:
                t_first = time.perf_counter() - t0
            toks.append(int(t[0]))
        return t_first, time.perf_counter() - t0, toks

    run()   # warm-up: lazy CUDA / cuBLAS initialisation
    flash_attention.launches = 0
    decode_attention_stacked.launches = 0
    t_first, total, toks = run()           # the main path
    n_k1 = flash_attention.launches
    n_k3 = decode_attention_stacked.launches
    layers = cfg.text.num_hidden_layers
    check(len(toks) == new, f"generated {len(toks)} tokens, want {new}")
    check(all(0 <= t < cfg.text.vocab_size for t in toks), "token ids")
    check(n_k1 == layers, f"K1 launched {n_k1} times, want {layers}")
    check(n_k3 == layers * (new - 1),
          f"K3 launched {n_k3} times, want {layers * (new - 1)}")
    decode_tps = (new - 1) / (total - t_first)
    print(f"slice: prompt {len(prompt)} tokens in bucket {bucket}, 8 frames "
          f"{size}px uint8, {new} greedy tokens; launches K1 {n_k1} "
          f"K3 {n_k3}")
    print(f"slice: video->first-token {t_first:.4f} s, decode "
          f"{decode_tps:.2f} tok/s ({1e3 / decode_tps:.3f} ms/token) on "
          f"{smi}")

    # where the time goes: device busy time of the prefill and of a whole
    # request, against the unprofiled wall times above
    frames_dev = torch.from_numpy(frames).cuda()
    vision_ms = time_ms(lambda: valley.encode_images(params, cfg, frames_dev),
                        iters=3, warmup=1)
    vision_dev, _ = profile_device(
        lambda: valley.encode_images(params, cfg, frames_dev))
    prefill_dev, _ = profile_device(
        lambda: engine.prefill([prompt], frames, gcfg))
    run_dev, top = profile_device(run)
    decode_dev = (run_dev - prefill_dev) / (new - 1)
    wall_tok = (total - t_first) / (new - 1) * 1e3
    shares = ", ".join(f"{name[:48]} {100 * ms / run_dev:.1f}%"
                       for name, ms in top[:6])
    print(f"breakdown: video->first-token wall {t_first * 1e3:.2f} ms, "
          f"prefill device {prefill_dev:.2f} ms (vision tower device "
          f"{vision_dev:.2f} ms, wall {vision_ms:.2f} ms); decode wall "
          f"{wall_tok:.3f} ms/token, device busy {decode_dev:.3f} ms/token "
          f"(idle share {1 - decode_dev / wall_tok:.3f}); request device "
          f"busy {run_dev:.2f} ms of {total * 1e3:.2f} ms wall; top kernels: "
          f"{shares}")

    # the slice's logits through the kernels against the same path with
    # the plain attention functions: the prefill, then decode steps fed the
    # generated tokens
    plain_engine = Engine(cfg, params, buckets=(bucket,), max_new_tokens=new,
                          steps_per_call=steps, attention=PLAIN)
    states = [e.prefill([prompt], frames, gcfg)
              for e in (engine, plain_engine)]
    check(int(states[0].token[0]) == toks[0], "prefill is not repeatable")
    forced = toks[:DECODE_CHECK_STEPS]
    logits = [[s.logits[0]] + decode_logits(e, s, len(prompt), forced)
              for e, s in zip((engine, plain_engine), states)]
    for i, (lk, lp) in enumerate(zip(*logits)):
        where = "prefill" if i == 0 else f"decode step {i}"
        check(bool(torch.isfinite(lk).all())
              and lk.shape == (cfg.text.vocab_size,),
              f"{where} logits not finite or misshapen")
        diff = max_err(lk, lp)
        top2 = torch.topk(lp, 2).values
        same = int(lk.argmax()) == int(lp.argmax())
        print(f"slice: {where} logits kernels vs plain max abs diff "
              f"{diff:.4e} (tol {LOGIT_TOL}; max |logit| "
              f"{lp.abs().max().item():.3f}), greedy token "
              f"{'agrees' if same else 'differs'} (plain top-2 margin "
              f"{(top2[0] - top2[1]).item():.4f})")
        check(diff <= LOGIT_TOL, f"{where} logits beyond tolerance")
        check(same, f"{where}: kernels and plain pick different tokens")

    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "valley_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "valley_tpu/ops/flash_attention.py:54",
         "launches": n_k1, "max_abs_err": k1_err, **k1_t},
        {"name": "decode_attn", "route": "cuda",
         "source": "valley_tpu_torch/csrc/decode_attn.cu",
         "replaces": "valley_tpu/ops/decode_pallas.py:68",
         "launches": n_k3, "max_abs_err": k3_err, **k3_t},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
