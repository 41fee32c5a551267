"""Decode-attention lab: the measurement kernels T4-T7
(``ops/decode_lab.py``) beside K3 (``ops/decode_attention.py``) on the card.

    python -m valley_tpu_torch.tools.decode_attn_lab [--shape tools|conv]

``tools`` is the TPU tools' own shape (L32 B1 S640 H32 D128, the first 500
slots valid, N(0, 1) * 0.3 K and V, N(0, 1) q, from a seed); ``conv`` is a
Valley-13B conversation's session cache (L40 B1 S2052 H40 D128) with the
valid mask a three-turn conversation leaves (`conversation_valid`: the
bucket's padding, each chunk's pow-2 padding and each reply's trimmed
slot are holes), here filled with seeded values; ``chip_smoke.py`` runs the
same lab on a real session's cache.  Each variant is held against its
plain version, with a planted fault that must fail, then timed walking the
layers (so each call reads its K and V from device memory): device ms per
call from the profiler, the plain version's, and GB/s of the layer's K and
V bytes, as the tools printed theirs; then the ms of T7's stages and what
each stage adds.  It needs a CUDA card and stops without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Optional

import torch

from valley_tpu_torch.ops import decode_attention
from valley_tpu_torch.ops.decode_attention import (decode_attention_plain,
                                                   decode_attention_stacked)
from valley_tpu_torch.ops.decode_lab import (STAGES, attn_head_chunked,
                                             attn_head_major_plain,
                                             attn_per_head,
                                             attn_stacked_head_major,
                                             attn_stage, attn_stage_plain)

# max abs error <= REL_TOL * max|ref|: two bf16 ulps at the largest output
REL_TOL = 2 ** -6
HEAD_CHUNKS = (8, 16)                 # T4's and T6's heads per block
TOOLS_SHAPE = dict(layers=32, batch=1, slots=640, heads=32, head_dim=128,
                   valid=500)
NEG = -1e9
SOURCE = "valley_tpu_torch/csrc/decode_lab.cu"


def conversation_valid(smax: int, prompt_len: int, bucket: int,
                       chunks, new_tokens: int) -> torch.Tensor:
    """(1, smax) mask a `ChatSession` leaves after a first turn of
    ``prompt_len`` tokens in ``bucket`` and later turns whose chunks hold
    ``chunks`` tokens (the previous reply's pending token included), each
    turn replying ``new_tokens`` tokens: the last reply token of a turn is
    written by the next turn's chunk, and each chunk takes a pow-2 span of
    at least 16 slots."""
    valid = torch.zeros((1, smax), dtype=torch.bool)
    valid[:, :prompt_len] = True
    slot = bucket
    for c in (None, *chunks):
        if c is not None:
            valid[:, slot:slot + c] = True
            slot += 1 << max(4, (max(c, 2) - 1).bit_length())
        valid[:, slot:slot + new_tokens - 1] = True
        slot += new_tokens - 1
    return valid


@dataclasses.dataclass
class LabInputs:
    """One input of the lab: q (B, 1, H, D) bf16, the slot-major
    (L, B, S, H, D) bf16 cache ``k``/``v`` and its valid mask (B, S); the
    head-major copy, the -1e9 bias and q as (B, H, D) are derived.  With
    ``int8`` (k, k_scale, v, v_scale), the int8 cache ``k``/``v`` were
    dequantized from, K3-int8 runs on it too."""
    name: str
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    int8: Optional[tuple] = None

    def __post_init__(self):
        self.k_hm = self.k.permute(0, 1, 3, 2, 4).contiguous()
        self.v_hm = self.v.permute(0, 1, 3, 2, 4).contiguous()
        self.bias = torch.where(self.valid, 0.0, NEG).float()
        self.q3 = self.q[:, 0].contiguous()
        self.li = self.k.shape[0] // 2         # the layer the checks read

    def layer_bytes(self, var: Optional["Variant"] = None) -> int:
        """One layer's K and V bytes, what a kernel walking every slot
        reads: bf16, or for K3-int8 int8 and the bf16 scales."""
        n = self.k[0].numel()
        if var is not None and var.name == "K3-int8":
            return 2 * (n + n // self.k.shape[-1] * 2)
        return 2 * n * self.k.element_size()

    def need_bytes(self, var: "Variant") -> int:
        """What ``var``'s function needs moved, each byte once (K3's row
        counts it so): the valid slots' K and V (int8 and their bf16 scales
        for K3-int8, else bf16), q, the mask (K3's bool, the others' fp32
        bias) and the output (fp32 for T4-T6, else bf16)."""
        _, b, s, h, d = self.k.shape
        n_valid = int(self.valid.sum())
        kv = 2 * n_valid * h * (d + 2) if var.name == "K3-int8" \
            else 2 * n_valid * h * d * 2
        mask = b * s * (1 if var.name.startswith("K3") else 4)
        out = b * h * d * (4 if var.name[:2] in ("T4", "T5", "T6") else 2)
        return kv + self.q.numel() * 2 + mask + out

    def need_flops(self) -> int:
        """QK and PV: 4 D operations per valid slot and head."""
        _, _, _, h, d = self.k.shape
        return 4 * d * h * int(self.valid.sum())


def tools_inputs(gen: torch.Generator) -> LabInputs:
    """The tools' shape and data (exp_attn_pallas2.py:96-99), on the
    card."""
    s = TOOLS_SHAPE
    shape = (s["layers"], s["batch"], s["slots"], s["heads"], s["head_dim"])
    dev = gen.device
    q = torch.randn((s["batch"], 1, s["heads"], s["head_dim"]),
                    generator=gen, device=dev).bfloat16()
    k, v = ((torch.randn(shape, generator=gen, device=dev) * 0.3).bfloat16()
            for _ in range(2))
    valid = torch.arange(s["slots"], device=dev)[None, :] < s["valid"]
    return LabInputs("tools", q, k, v, valid.expand(s["batch"], -1)
                     .contiguous())


def conv_inputs(k, k_scale, v, v_scale, valid, gen: torch.Generator
                ) -> LabInputs:
    """A session's int8 cache (L, B, S, H, D) with its bf16 scales and valid
    mask, dequantized to bf16 (``k * k_scale``, as the extend reads it),
    with a seeded N(0, 1) q."""
    def deq(c, sc):
        out = torch.empty(c.shape, dtype=torch.bfloat16, device=c.device)
        for li in range(c.shape[0]):
            out[li] = c[li].to(torch.bfloat16) * sc[li][..., None]
        return out

    _, b, _, h, d = k.shape
    q = torch.randn((b, 1, h, d), generator=gen, device=k.device).bfloat16()
    return LabInputs("conv", q, deq(k, k_scale), deq(v, v_scale),
                     valid.contiguous(), (k, k_scale, v, v_scale))


@dataclasses.dataclass
class Variant:
    """A kernel of the lab: ``run(li)`` launches it on layer li, ``plain(li)``
    runs its plain version, ``fault()`` the kernel on planted wrong inputs
    (``fault_what``) at the checked layer; ``blocks`` the grid of its
    (first) kernel, ``combine`` that of its combine kernel (0: none)."""
    name: str
    key: str
    replaces: str
    wrapper: Callable
    run: Callable
    plain: Callable
    fault: Callable
    fault_what: str
    blocks: int
    combine: int = 0
    source: str = SOURCE


def variants(x: LabInputs) -> list:
    """T4 (each hc), T5, T6 (each hc), T7 (each stage), K3 and, given the
    int8 cache, K3-int8 on ``x``."""
    n_layers, b, s, h, d = x.k.shape
    open_bias = torch.zeros_like(x.bias)       # every masked slot attended
    open_valid = torch.ones_like(x.valid)
    li = x.li
    out = []
    for hc in HEAD_CHUNKS:
        out.append(Variant(
            f"T4 hc={hc}", f"decode_lab_t4_hc{hc}",
            "tools/exp_attn_pallas2.py:48", attn_head_chunked,
            lambda i, hc=hc: attn_head_chunked(x.q, x.k_hm[i], x.v_hm[i],
                                               x.bias, hc),
            lambda i: attn_head_major_plain(x.q, x.k_hm[i], x.v_hm[i],
                                            x.bias),
            lambda hc=hc: attn_head_chunked(x.q, x.k_hm[li], x.v_hm[li],
                                            open_bias, hc),
            "the masked slots attended", b * -(-h // hc)))
    out.append(Variant(
        "T5", "decode_lab_t5", "tools/exp_attn_layout.py:81", attn_per_head,
        lambda i: attn_per_head(x.q, x.k_hm[i], x.v_hm[i], x.bias),
        lambda i: attn_head_major_plain(x.q, x.k_hm[i], x.v_hm[i], x.bias),
        lambda: attn_per_head(x.q, x.k_hm[li], x.v_hm[li], open_bias),
        "the masked slots attended", b * h))
    for hc in HEAD_CHUNKS:
        out.append(Variant(
            f"T6 hc={hc}", f"decode_lab_t6_hc{hc}",
            "tools/exp_attn_pallas3.py:63", attn_stacked_head_major,
            lambda i, hc=hc: attn_stacked_head_major(x.q, x.k_hm, x.v_hm,
                                                     x.bias, i, hc),
            lambda i: attn_head_major_plain(x.q, x.k_hm[i], x.v_hm[i],
                                            x.bias),
            lambda hc=hc: attn_stacked_head_major(x.q, x.k_hm, x.v_hm,
                                                  open_bias, li, hc),
            "the masked slots attended", b * -(-h // hc)))
    n_split = -(-s // 64)
    for st in STAGES:
        if st == 0:
            fault = (lambda: attn_stage(x.q3, x.k, x.v, x.bias,
                                        (li + 1) % n_layers, 0),
                     "the next layer read")
        elif st == 1:
            fault = (lambda: attn_stage(x.q3 * d ** 0.5, x.k, x.v, x.bias,
                                        li, 1), "the D^-1/2 scale lost")
        else:
            fault = (lambda st=st: attn_stage(x.q3, x.k, x.v, open_bias, li,
                                              st),
                     "the masked slots attended")
        out.append(Variant(
            f"T7 stage {st}", f"decode_lab_t7_stage{st}",
            "tools/exp_kernel_ablate.py:105", attn_stage,
            lambda i, st=st: attn_stage(x.q3, x.k, x.v, x.bias, i, st),
            lambda i, st=st: attn_stage_plain(x.q3, x.k, x.v, x.bias, i, st),
            fault[0], fault[1], b * h * n_split, 0 if st == 0 else b * h))
    k3_src = "valley_tpu_torch/csrc/decode_attn.cu"
    k3_blocks = b * h * -(-s // decode_attention._lib().chunk)
    out.append(Variant(
        "K3", "decode_attn_lab", "valley_tpu/ops/decode_pallas.py:68",
        decode_attention_stacked,
        lambda i: decode_attention_stacked(x.q, x.k, x.v, i, x.valid),
        lambda i: decode_attention_plain(x.q, x.k, x.v, i, x.valid),
        lambda: decode_attention_stacked(x.q, x.k, x.v, li, open_valid),
        "the masked slots attended", k3_blocks, b * h, k3_src))
    if x.int8 is not None:
        kq, ks, vq, vs = x.int8
        out.append(Variant(
            "K3-int8", "decode_attn_int8_lab",
            "valley_tpu/ops/decode_pallas.py:68", decode_attention_stacked,
            lambda i: decode_attention_stacked(x.q, kq, vq, i, x.valid, ks,
                                               vs),
            lambda i: decode_attention_plain(x.q, kq, vq, i, x.valid, ks, vs),
            lambda: decode_attention_stacked(x.q, kq, vq, li, open_valid, ks,
                                             vs),
            "the masked slots attended", k3_blocks, b * h, k3_src))
    return out


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check(x: LabInputs, var: Variant) -> tuple:
    """``var`` against its plain version at the checked layer, and its
    planted fault.  Returns (max abs error, tolerance, the fault's error);
    raises where the kernel misses the tolerance or the fault does not."""
    got = var.run(x.li)
    torch.cuda.synchronize()
    ref = var.plain(x.li)
    err, tol = max_err(got, ref), REL_TOL * ref.float().abs().max().item()
    if got.dtype != ref.dtype or got.shape != ref.shape \
            or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{x.name} {var.name}: dtype, shape or not "
                             "finite")
    if err > tol:
        raise AssertionError(f"{x.name} {var.name}: max abs err {err} > "
                             f"{tol}")
    fault = max_err(var.fault(), ref)
    if not fault > tol:
        raise AssertionError(f"{x.name} {var.name}: {var.fault_what} moved "
                             f"the output by {fault} only, within {tol}")
    return err, tol, fault


def stage3_against_k3(x: LabInputs) -> tuple:
    """T7 stage 3 is K3's bf16 function with a bias for the mask: its
    output against `decode_attention_plain` with the matching mask, and
    against K3 itself.  Returns both errors; raises past the tolerance."""
    got = attn_stage(x.q3, x.k, x.v, x.bias, x.li, 3)
    ref = decode_attention_plain(x.q, x.k, x.v, x.li, x.valid)[:, 0]
    k3 = decode_attention_stacked(x.q, x.k, x.v, x.li, x.valid)[:, 0]
    tol = REL_TOL * ref.float().abs().max().item()
    errs = max_err(got, ref), max_err(got, k3)
    if max(errs) > tol:
        raise AssertionError(f"{x.name} T7 stage 3 against K3's function: "
                             f"{errs} > {tol}")
    return errs


def walk(fn: Callable, n_layers: int) -> Callable:
    """A call of ``fn(li)`` on the next layer each time, as decode walks
    them: each call reads its K and V from device memory, not from L2."""
    it = iter(range(10 ** 9))
    return lambda: fn(next(it) % n_layers)


def device_ms(fn: Callable, iters: int) -> float:
    """Device ms per call of ``fn`` from the profiler: every kernel's and
    copy's time over ``iters`` calls.  A trace that holds no device time
    is taken again, up to three times in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA"))
        if total > 0:
            return total / 1e3 / iters
    raise RuntimeError("the profiler recorded no device time")


def grid_text(var: Variant, sms: int) -> str:
    """The grid and the blocks each SM gets: at B1 the head-chunked
    kernels launch a few blocks for 132 SMs."""
    combine = f" + {var.combine} (combine)" if var.combine else ""
    return (f"grid {var.blocks}{combine} blocks, {var.blocks / sms:.2f} per "
            "SM")


def stage_line(name: str, ms: dict) -> str:
    """T7's ms per stage and what each stage adds to the one before."""
    parts = [f"stage 0 {ms[0]:.4f}"] + [
        f"stage {s} {ms[s]:.4f} ({ms[s] - ms[s - 1]:+.4f})"
        for s in STAGES[1:]]
    return f"{name}: T7 ms per call by stage (increment): " + ", ".join(parts)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", choices=("tools", "conv"),
                        default="tools")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_attn_lab: needs a CUDA card", file=sys.stderr)
        return 2
    gen = torch.Generator("cuda").manual_seed(0)
    if args.shape == "tools":
        x = tools_inputs(gen)
    else:
        shape = (40, 1, 2052, 40, 128)
        k, v = ((torch.randn(shape, generator=gen, device="cuda") * 0.3)
                .bfloat16() for _ in range(2))
        valid = conversation_valid(2052, 473, 512, (21, 41), 64).cuda()
        q = torch.randn((1, 1, 40, 128), generator=gen,
                        device="cuda").bfloat16()
        x = LabInputs("conv", q, k, v, valid)
    n_layers, b, s, h, d = x.k.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{x.name}: L{n_layers} B{b} S{s} H{h} D{d}, "
          f"{int(x.valid.sum())} valid slots; "
          f"{torch.cuda.get_device_name(0)}, {sms} SMs")
    stage_ms = {}
    for var in variants(x):
        err, tol, fault = check(x, var)
        ms = device_ms(walk(var.run, n_layers), 20)
        plain_ms = device_ms(walk(var.plain, n_layers), 3)
        print(f"{x.name} {var.name}: max_abs_err {err:.3e} (tol {tol:.3e}); "
              f"{var.fault_what} instead: {fault:.3e} (must fail); device "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, "
              f"{x.layer_bytes(var) / ms / 1e6:.1f} GB/s of the layer's K/V; "
              f"{grid_text(var, sms)}")
        if var.name.startswith("T7"):
            stage_ms[int(var.name[-1])] = ms
    errs = stage3_against_k3(x)
    print(f"{x.name} T7 stage 3 against decode_attention_plain with the "
          f"mask: {errs[0]:.3e}, against K3: {errs[1]:.3e}")
    print(stage_line(x.name, stage_ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
