"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where torch sees no CUDA device (decided
inside the fixture, at run time).  On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: max abs error <= 2^-6 * max|ref|, two bf16 ulps at the largest
output.  Both sides compute in fp32 from the same bf16 inputs and round the
output to bf16; the decode kernel also rounds probabilities to bf16 per
64-slot chunk rather than after the global softmax.  Inputs are N(0, 1), so
logits have unit spread and attending a wrong slot moves the output by far
more than the tolerance (the decode test plants that fault and checks it
is caught).
"""

import pytest
import torch

from valley_tpu_torch.ops.decode_attention import (decode_attention_plain,
                                                   decode_attention_stacked)
from valley_tpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_plain)

REL_TOL = 2 ** -6

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


def _err_and_tol(out, ref):
    return ((out.float() - ref.float()).abs().max().item(),
            REL_TOL * ref.float().abs().max().item())


@pytest.mark.parametrize("b,s,h,d,causal,tail", [
    (1, 512, 32, 128, True, 39), (2, 300, 4, 64, True, 17),
    (1, 77, 2, 32, False, 0), (2, 130, 4, 16, True, 5)])
def test_flash_kernel_matches_plain(gen, b, s, h, d, causal, tail):
    q, k, v = (_randn(gen, b, s, h, d) for _ in range(3))
    mask = torch.ones((b, s), dtype=torch.bool, device="cuda")
    if tail:
        mask[:, s - tail:] = False
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, mask, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, mask, causal=causal,
                                         return_lse=True)
    err, tol = _err_and_tol(out, ref)
    assert err <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def test_flash_kernel_refuses_what_it_cannot_take(gen):
    q = _randn(gen, 1, 64, 2, 128)
    with pytest.raises(TypeError):
        flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                        q[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                        q.transpose(1, 2))


@pytest.mark.parametrize("b,smax,h,hkv,d", [
    (1, 639, 32, 32, 128), (1, 96, 4, 2, 32), (2, 640, 8, 8, 128),
    (1, 3000, 4, 4, 128), (1, 100, 8, 1, 64), (1, 70, 4, 4, 16)])
def test_decode_kernel_matches_plain_with_mask_hole(gen, b, smax, h, hkv, d):
    n_layers, li = 3, 2
    q = _randn(gen, b, 1, h, d)
    k = _randn(gen, n_layers, b, smax, hkv, d)
    v = _randn(gen, n_layers, b, smax, hkv, d)
    valid = torch.zeros((b, smax), dtype=torch.bool, device="cuda")
    valid[:, :3 * smax // 8] = True                 # the prompt
    valid[:, smax // 2:smax // 2 + smax // 4] = True  # decoded tokens
    before = decode_attention_stacked.launches
    out = decode_attention_stacked(q, k, v, li, valid)
    torch.cuda.synchronize()
    assert decode_attention_stacked.launches == before + 1
    ref = decode_attention_plain(q, k, v, li, valid)
    err, tol = _err_and_tol(out, ref)
    assert err <= tol
    # a kernel that attended the hole (read a length, not the mask) fails
    filled = valid.clone()
    filled[:, 3 * smax // 8:smax // 2] = True
    fault, _ = _err_and_tol(decode_attention_stacked(q, k, v, li, filled),
                            ref)
    assert fault > tol
