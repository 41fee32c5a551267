"""What writing the gradients of the decoder's stacked weights costs on the
card, for each of Valley-7B's (L, out, in) stacks, two ways:

- ``select``: each layer indexes the stack (``w[li]``), as the decoder once
  did; autograd's backward of each index writes a zeroed tensor
  the size of the whole stack and adds it into the stack's gradient;
- ``unbind``: one ``w.unbind(0)`` before the layers (`llama._per_layer`),
  whose backward stacks the layers' gradients once.

Each way is timed by CUDA events around ``torch.autograd.backward`` of the
layers' views with a random gradient each (the layers' own products are
left out), beside the bytes bound of writing the gradient once at
3.35 TB/s.  A full stage-2 update of Valley-7B pays the sum over the
stacks once.

    python -m valley_tpu_torch.tools.stacked_grads
"""

from __future__ import annotations

import subprocess

import torch

# Valley-7B (LLaMA-2-7B): name -> (out, in) of one layer, 32 layers
LAYERS = 32
STACKS = {"wq": (4096, 4096), "wk": (4096, 4096), "wv": (4096, 4096),
          "wo": (4096, 4096), "w_gate": (11008, 4096),
          "w_up": (11008, 4096), "w_down": (4096, 11008),
          "attn_norm": (4096,), "mlp_norm": (4096,)}
HBM_BYTES_PER_S = 3.35e12


def backward_ms(w: torch.Tensor, grads, way: str, iters: int = 3) -> float:
    """Mean ms of one backward of the layers' views of ``w``."""
    def run():
        w.grad = None
        parts = w.unbind(0) if way == "unbind" else \
            [w[li] for li in range(w.shape[0])]
        torch.autograd.backward(parts, grads)

    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    gen = torch.Generator("cuda").manual_seed(0)
    sums = {"select": 0.0, "unbind": 0.0, "bound": 0.0}
    for name, shape in STACKS.items():
        w = torch.zeros((LAYERS,) + shape, dtype=torch.bfloat16,
                        device="cuda", requires_grad=True)
        g = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        grads = [g] * LAYERS
        times = {way: backward_ms(w, grads, way)
                 for way in ("select", "unbind")}
        bound = w.numel() * w.element_size() / HBM_BYTES_PER_S * 1e3
        for k, v in (*times.items(), ("bound", bound)):
            sums[k] += v
        print(f"{name} {tuple(w.shape)}: select {times['select']:.3f} ms, "
              f"unbind {times['unbind']:.3f} ms, bound {bound:.3f} ms")
        del w, g, grads
        torch.cuda.empty_cache()
    print(f"every stack of one update: select {sums['select']:.2f} ms, "
          f"unbind {sums['unbind']:.2f} ms, bound {sums['bound']:.2f} ms, "
          f"on {smi}")


if __name__ == "__main__":
    main()
