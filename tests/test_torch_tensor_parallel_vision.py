"""The CLIP tower and the projector cut over the mesh's ``model`` axis in
the PyTorch port, against world 1 (the port on one process) and the JAX
package (``valley_tpu/parallel/sharding.py:78-124``: the tower's q/k/v/fc1
and their biases cut on their outputs, o/fc2 on their inputs, an int8
tower's scales with their weight's outputs, the projector by its
outputs).

The ranks are gloo processes of tests/torch_mp_worker.py over a file store
in the test's tmp directory, one CPU thread each, worlds (1, 1, 2) and
(1, 1, 4) spawned at once; each carries one JAX init over with
``from_jax_params`` and cuts it with `sharding.shard_params`, then runs
`valley.encode_images` on two videos of two raw uint8 frames, as the
serving path sends them.  The trees: fp32, the same weights in bf16, and
JAX's int8 (weight-only) and W8A8 towers (``quantize_vision_params``).

Bars, of the largest |output|, with their readings (this file's run on
the CPU; the cut sums the row-parallel products' partial sums over the
ranks, in another order than one device):
- fp32 and the weight-only int8 tower: 1e-5 of world 1's and of JAX's
  (read: at most 3.8e-7 of world 1's, 7.0e-7 of JAX's, where world 1
  reads 6.7e-7);
- the W8A8 tower: each row-parallel product quantizes its tokens by
  their absmax over the group and sums its int32 partials exactly, so its
  int8 activations are world 1's; read 2.1e-7 of world 1's and 3.0e-7 of
  JAX's (these frames move no activation across an int8 rounding edge),
  and held to 1e-5 of both, the bar of the float trees, not the 1e-2
  of tests/test_torch_vision_quant.py's W8A8 case, whose frames cross
  edges;
- bf16: 2e-2 of world 1's and of JAX's bf16 run (read: 8.0e-3 of world
  1's, 7.0e-3 to 8.0e-3 of JAX's, where world 1 reads 8.0e-3: one bf16
  rounding of the largest feature).
Every rank holds the same features, bit for bit.  A (1, 1, 2) engine
with a W8A8 tower gives JAX's greedy tokens on a video prompt.  The file
takes about 25 s on its worker alone.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_tensor_parallel import (_jax_tokens, _spawn, _video,
                                              _wait)
from valley_tpu import config as C
from valley_tpu.models import valley as jvalley
from valley_tpu.ops import quant as jquant
from valley_tpu_torch import config as TC
from valley_tpu_torch.models import valley
from valley_tpu_torch.parallel import tensor
from valley_tpu_torch.weights import from_jax_params

MESHES = [(1, 1, 2), (1, 1, 4)]
TREES = ["fp32", "bf16", "int8", "int8a8"]
# {tree: (bar against world 1, bar against JAX)}, of the largest output
BARS = {"fp32": (1e-5, 1e-5), "int8": (1e-5, 1e-5), "int8a8": (1e-5, 1e-5),
        "bf16": (2e-2, 2e-2)}
NEW = 6


def _trees():
    """The JAX trees: fp32 (carried over as bf16 too), and the int8 and
    W8A8 towers of the same init."""
    cfg = C.valley_tiny()
    base = jax.device_get(jvalley.init_params(cfg, jax.random.key(31),
                                              jnp.float32))

    def copy():     # the quantizers consume their trees
        return jax.tree.map(jnp.asarray, base)

    return {"fp32": base,
            "int8": jax.device_get(jquant.quantize_vision_params(copy())),
            "int8a8": jax.device_get(jquant.quantize_vision_params(
                copy(), act8=True))}


def _frames(cfg):
    size = cfg.vision.image_size
    return np.random.default_rng(32).integers(
        0, 256, (2, 2, 3, size, size)).astype(np.uint8)


def _scenarios(frames, video):
    out = [{"kind": "encode", "name": f"encode_{t}",
            "tree": "fp32" if t == "bf16" else t, "dtype": t,
            "images": frames} for t in TREES]
    out.append({"kind": "engine", "name": "engine_int8a8", "tree": "int8a8",
                "prompts": [video], "new": NEW, "bucket": 64})
    return out


def _features(params, cfg, frames):
    feats = valley.encode_images(params, cfg, torch.from_numpy(frames))
    return feats.pooled.float().numpy(), feats.frame_cls.float().numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's results; world 1's and JAX's features beside them,
    and JAX's greedy tokens with the W8A8 tower."""
    tmp = tmp_path_factory.mktemp("tpvision")
    cfg = C.valley_tiny()
    trees = _trees()
    frames = _frames(cfg)
    video = _video(cfg)
    spawned = [_spawn(tmp, mesh, trees, _scenarios(frames, video))
               for mesh in MESHES]
    tcfg = TC.valley_tiny()
    local, jax_out = {}, {}
    with torch.inference_mode():
        for t in TREES:
            tree = trees["fp32" if t == "bf16" else t]
            dtype = torch.bfloat16 if t == "bf16" else torch.float32
            local[t] = _features(from_jax_params(tree, "cpu", dtype), tcfg,
                                 frames)
            jtree = jax.tree.map(jnp.asarray, tree)
            if t == "bf16":
                jtree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jtree)
            want = jvalley.encode_images(jtree, cfg, jnp.asarray(frames))
            jax_out[t] = (np.asarray(want.pooled, np.float32),
                          np.asarray(want.frame_cls, np.float32))
    tokens = _jax_tokens(cfg, trees["int8a8"], [video], NEW)
    got = [_wait(*s) for s in spawned]
    return {"local": local, "jax": jax_out, "tokens": tokens,
            **dict(zip(MESHES, got))}


def _worst(got, want) -> float:
    return max(float(np.abs(g - w).max() / np.abs(w).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("mesh", MESHES)
def test_cut_tower_matches_world_1_and_jax(runs, mesh, tree):
    """`encode_images` on a cut tower and projector: the pooled and
    per-frame features within the file's bars of world 1's and of JAX's
    `encode_images`."""
    got = runs[mesh][f"encode_{tree}"]["features"]
    to_local, to_jax = BARS[tree]
    assert _worst(got, runs["local"][tree]) <= to_local
    assert _worst(got, runs["jax"][tree]) <= to_jax


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_holds_the_same_features(runs, mesh):
    """The projector's gather gives every rank the same features, bit for
    bit, in every tree."""
    for tree in TREES:
        every = runs[mesh][f"encode_{tree}"]["every"]
        assert len(every) == mesh[2]
        for other in every[1:]:
            for g, w in zip(other, every[0]):
                np.testing.assert_array_equal(g, w, err_msg=tree)


@pytest.mark.parametrize("mesh", MESHES)
def test_rank_holds_its_share_of_tower_and_projector(runs, mesh):
    """Each rank keeps heads/N of the tower's q/k/v and o, its MLP's
    columns/N, and hidden/N of the projector's outputs."""
    cfg = TC.valley_tiny()
    n, L = mesh[2], cfg.vision.num_hidden_layers
    h, f = cfg.vision.hidden_size, cfg.vision.intermediate_size
    assert runs[mesh]["encode_fp32"]["shapes"] == {
        "wq": (L, h, h // n), "fc1": (L, h, f // n), "wo": (L, h // n, h),
        "bq": (L, h // n), "fc1_bias": (L, f // n),
        "projector.w": (h, cfg.text.hidden_size // n)}


def test_engine_with_cut_w8a8_tower_gives_jax_tokens(runs):
    """A (1, 1, 2) `Engine(mesh=)` over the W8A8 tower's tree (the worker's
    ``--quantize-vision int8a8``): the greedy tokens of a video prompt
    equal JAX's one-device engine's."""
    got = runs[(1, 1, 2)]["engine_int8a8"]["tokens"]
    assert all(ranks == runs["tokens"] for ranks in got)


def test_plan_tower_refuses_what_the_axis_does_not_divide():
    """ViT-L/14 over 4 ranks: 4 heads and 1024 MLP columns a rank, the
    13B projector's 5120 outputs 1280; a tower whose heads, MLP width or
    projector outputs do not divide is refused, with the reason."""
    vit = TC.VisionConfig()
    plan = tensor.plan_tower(vit, 5120, 4, 3, None)
    assert (plan.heads, plan.ffn, plan.hidden, plan.rank) == \
        (4, 1024, 1280, 3)
    with pytest.raises(ValueError, match="vision attention heads 16"):
        tensor.plan_tower(vit, 4096, 3, 0, None)
    with pytest.raises(ValueError, match="intermediate_size 100"):
        tensor.plan_tower(TC.VisionConfig(intermediate_size=100,
                                          num_attention_heads=8), 64, 8, 0,
                          None)
    with pytest.raises(ValueError, match="projector's outputs"):
        tensor.plan_tower(vit, 4100, 8, 0, None)
