"""LoRA on the PyTorch port against the JAX package, on the CPU, on
``valley_tiny`` with fp32 weights made once by the JAX ``init_params`` and
``add_lora`` (r 4, alpha 8), carried across by ``from_jax_params``.

B starts at zero in ``add_lora``, which makes the adapter invisible and
A's gradient zero; the tests draw B from a seed instead (N(0, 0.1)), so
every factor moves the output and takes a gradient.

Tolerances, with their reasons:
- logits 1e-5 absolute and the loss 1e-5: fp32 on both sides, the
  summation order of the products their only difference;
- gradients 1e-4 of max|ref| (as tests/test_torch_train.py holds the
  projector's);
- the trainer's parameter movement over three clipped updates within 2e-3
  of the JAX movement's largest element (tests/test_torch_train.py says
  why; Adam eps 1e-2), adapter dropout off on both sides: the masks come
  from different bit generators (ROADMAP §3);
- ``merge_lora`` 1e-6 of max|w|: fp32 products of 4 terms in another
  order.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import FakeDataset, _batch, _leaves
from valley_tpu import config as C
from valley_tpu.data.dataset import DataCollatorForSupervisedDataset as JColl
from valley_tpu.data.dataset import DataLoader as JLoader
from valley_tpu.models import valley as jvalley
from valley_tpu.train import lora as jlora
from valley_tpu.train.trainer import TrainConfig as JTrainConfig
from valley_tpu.train.trainer import Trainer as JTrainer
from valley_tpu.train.trainer import label_params as jlabel_params
from valley_tpu_torch.data.dataset import \
    DataCollatorForSupervisedDataset as TColl
from valley_tpu_torch.data.dataset import DataLoader as TLoader
from valley_tpu_torch.models import llama, valley
from valley_tpu_torch.train import lora
from valley_tpu_torch.train.trainer import TrainConfig, Trainer, label_params
from valley_tpu_torch.weights import from_jax_params, set_trainable, to_numpy

R, ALPHA = 4, 8
ADAPTER_NAMES = [f"llama.layers.{n}_lora_{s}" for n in lora.DEFAULT_TARGETS
                 for s in ("a", "b")]
TRAINABLE = ("projector.w", "projector.b", *ADAPTER_NAMES)


@pytest.fixture(scope="module")
def cfg():
    return C.valley_tiny()


@pytest.fixture(scope="module")
def jparams(cfg):
    """JAX weights with adapters, B drawn nonzero from a seed."""
    p = jvalley.init_params(cfg, jax.random.key(0), jnp.float32)
    p = jlora.add_lora(p, jax.random.key(1), r=R, alpha=ALPHA,
                       dtype=jnp.float32)
    layers = dict(p["llama"]["layers"])
    rng = np.random.default_rng(7)
    for name in lora.DEFAULT_TARGETS:
        shape = layers[name + "_lora_b"].shape
        layers[name + "_lora_b"] = jnp.asarray(
            0.1 * rng.standard_normal(shape), jnp.float32)
    return dict(p, llama=dict(p["llama"], layers=layers))


def _port(jparams):
    return from_jax_params(jax.device_get(jparams), "cpu", torch.float32)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_adapter_tree_converts_and_round_trips(jparams):
    tp = _port(jparams)
    names = {n for n, _ in tp.named_parameters()}
    assert set(ADAPTER_NAMES) <= names
    assert "llama.layers.lora_scale" in names
    back = _leaves(to_numpy(tp))
    for name, want in _leaves(jax.device_get(jparams)).items():
        np.testing.assert_array_equal(back[name], np.asarray(want), name)


def test_forward_with_adapters_matches_jax(cfg, jparams):
    batch = _batch(cfg)
    want = jvalley.forward(jparams, cfg, jnp.asarray(batch["input_ids"]),
                           jnp.asarray(batch["images"]),
                           jnp.asarray(batch["attention_mask"]),
                           frame_mask=jnp.asarray(batch["frame_mask"]),
                           use_flash=False)
    tp = _port(jparams)
    with torch.no_grad():
        got = valley.forward(tp, cfg, torch.from_numpy(batch["input_ids"]),
                             torch.from_numpy(batch["images"]),
                             torch.from_numpy(batch["attention_mask"]),
                             torch.from_numpy(batch["frame_mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # the adapters matter: the merged-away base gives other logits
    base = dict(jparams, llama=dict(jparams["llama"], layers={
        k: v for k, v in jparams["llama"]["layers"].items()
        if not llama.is_lora_name(k)}))
    plain = jvalley.forward(base, cfg, jnp.asarray(batch["input_ids"]),
                            jnp.asarray(batch["images"]),
                            jnp.asarray(batch["attention_mask"]),
                            frame_mask=jnp.asarray(batch["frame_mask"]),
                            use_flash=False)
    assert np.abs(np.asarray(plain) - np.asarray(want)).max() > 1e-2


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_adapter_grads_match_jax(cfg, jparams, remat):
    batch = _batch(cfg)
    layers = jparams["llama"]["layers"]
    ad = {k: v for k, v in layers.items() if k.endswith(("_lora_a",
                                                          "_lora_b"))}

    def jloss(adapters, proj):
        p = dict(jparams, projector=proj,
                 llama=dict(jparams["llama"], layers={**layers, **adapters}))
        return jvalley.loss_fn(p, cfg, _jbatch(batch), remat=remat,
                               use_flash=False)

    jl, (jga, jgp) = jax.value_and_grad(jloss, argnums=(0, 1))(
        ad, jparams["projector"])
    want = {"projector.w": jgp["w"], "projector.b": jgp["b"],
            **{f"llama.layers.{k}": v for k, v in jga.items()}}

    tp = _port(jparams)
    set_trainable(tp, TRAINABLE)
    named = dict(tp.named_parameters())
    loss = valley.loss_fn(tp, cfg, {k: torch.from_numpy(np.asarray(v))
                                    for k, v in batch.items()}, remat=remat)
    grads = torch.autograd.grad(loss, [named[n] for n in TRAINABLE])
    assert abs(float(loss.detach()) - float(jl)) < 1e-5
    for name, g in zip(TRAINABLE, grads):
        w = np.asarray(want[name])
        assert np.abs(w).max() > 0, name
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err)


def test_label_params_under_lora_match_jax(jparams):
    flags = dict(lora=True, freeze_backbone=False, tune_mm_mlp_adapter=True)
    want = _leaves(jlabel_params(jparams, JTrainConfig(**flags)))
    got = label_params(_port(jparams), TrainConfig(**flags))
    assert got == want
    assert sorted(n for n, lab in got.items() if lab == "lora") == \
        sorted(ADAPTER_NAMES)


def test_trainer_with_lora_matches_jax_trainer(cfg, jparams, tmp_path):
    """Three updates of two accumulated micro-batches each, the clip far
    under the gradient norm, a one-update warmup, the 'lora' group on its
    own learning rate (lora_lr) and its own clip: logged metrics at every
    step and every parameter afterwards, frozen ones unmoved; then the
    planted control with the adapters on the base learning rate."""
    common = dict(learning_rate=1e-3, lora_lr=3e-3, max_grad_norm=0.05,
                  adam_eps=1e-2, gradient_accumulation_steps=2,
                  num_train_epochs=1, per_device_train_batch_size=2,
                  save_steps=0, warmup_ratio=0.34,
                  gradient_checkpointing=True, lora=True, lora_dropout=0.0,
                  freeze_backbone=False, tune_mm_mlp_adapter=True)
    jt = JTrainer(cfg, JTrainConfig(output_dir=str(tmp_path / "jax"),
                                    mesh_data=1, mesh_fsdp=1, mesh_model=1,
                                    **common),
                  jax.tree.map(jnp.copy, jparams),
                  JLoader(FakeDataset(cfg), 2,
                          JColl(pad_token_id=0, pad_to_multiple=16), seed=0))
    assert jt.train(resume=False) == 3

    def port(out, **over):
        tt = Trainer(cfg, TrainConfig(output_dir=str(tmp_path / out),
                                      **dict(common, **over)),
                     _port(jparams),
                     TLoader(FakeDataset(cfg), 2,
                             TColl(pad_token_id=0, pad_to_multiple=16),
                             seed=0))
        assert tt.train(resume=False) == 3
        return tt

    tt = port("port")
    assert [g["label"] for g in tt.optimizer.param_groups] == \
        ["base", "lora"]

    def lines(path):
        with open(path / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    jl, tl = lines(tmp_path / "jax"), lines(tmp_path / "port")
    assert [r["step"] for r in tl] == [r["step"] for r in jl] == [1, 2, 3]
    for a, b in zip(jl, tl):
        assert b["grad_norm"] > common["max_grad_norm"]   # clipping fires
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                   rtol=1e-5)
    start = _leaves(jax.device_get(jparams))
    want = {n: np.asarray(w) - np.asarray(start[n])
            for n, w in _leaves(jax.device_get(jt.state.params)).items()}
    labels = label_params(tt.params, tt.tc)

    def misses(params):
        got = _leaves(to_numpy(params))
        out = []
        for name, w in want.items():
            moved = got[name] - np.asarray(start[name])
            if labels[name] == "frozen":
                assert not moved.any() and not w.any(), name
                continue
            assert np.abs(w).max() > 0, name
            if np.abs(moved - w).max() > 2e-3 * np.abs(w).max():
                out.append(name)
        return out

    assert misses(tt.params) == []
    assert sorted(misses(port("one_lr", lora_lr=None).params)) == \
        sorted(ADAPTER_NAMES)


def test_merge_lora_matches_jax(jparams):
    want = jax.device_get(jlora.merge_lora(jparams))
    tp = _port(jparams)
    before = {n: p.detach().clone() for n, p in tp.named_parameters()}
    merged = lora.merge_lora(tp)
    got = _leaves(to_numpy(merged))
    assert set(got) == set(_leaves(want))
    for name, w in _leaves(want).items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-6 * np.abs(w).max() + 1e-12,
                                   err_msg=name)
    # the trainer's weights are left alone
    for n, p in tp.named_parameters():
        assert torch.equal(p, before[n]), n
    assert lora.merge_lora(merged) is merged    # nothing left to merge
    with pytest.raises(ValueError, match="LoRA"):
        llama.fuse_llama_params(tp)
    fused = llama.fuse_llama_params(merged)
    assert "wqkv" in fused["llama"]["layers"]


def test_split_and_load_lora_round_trip(cfg, jparams, tmp_path):
    from valley_tpu_torch.utils import checkpoint as ckpt_lib

    tp = _port(jparams)
    adapter = lora.split_lora(tp)
    want = {k: np.asarray(v) for k, v in jlora.split_lora(jparams).items()}
    assert set(adapter) == set(want)
    for k, v in adapter.items():
        np.testing.assert_array_equal(v.numpy(), want[k], k)
    assert lora.is_lora_key(("llama", "layers", "wq_lora_a"))
    assert lora.is_lora_key("llama.layers.w_down_lora_b")
    assert not lora.is_lora_key("llama.layers.lora_scale")
    assert not lora.is_lora_key(("llama", "layers", "wq"))

    ckpt_lib.save_pytree(tmp_path / "adapter", adapter)
    restored = ckpt_lib.restore_pytree(tmp_path / "adapter")
    base = lora.merge_lora(lora.add_lora(
        _port(jparams), torch.Generator().manual_seed(0), r=R))
    base_layers = {n for n, _ in base["llama"]["layers"].named_parameters()}
    assert not any(llama.is_lora_name(n) for n in base_layers)
    loaded = lora.load_lora(base, restored)
    for k, v in adapter.items():
        assert torch.equal(loaded["llama"]["layers"][k], v), k
    # the merge of the loaded tree is JAX's merge of the same arrays
    jbase = jax.device_get(jlora.merge_lora(jlora.add_lora(
        jvalley.init_params(cfg, jax.random.key(0), jnp.float32),
        jax.random.key(1), r=R, alpha=ALPHA, dtype=jnp.float32)))
    jwant = _leaves(jax.device_get(jlora.merge_lora(
        jlora.load_lora(jbase, {k: v.numpy() for k, v in adapter.items()}))))
    got = _leaves(to_numpy(lora.merge_lora(lora.load_lora(
        from_jax_params(jbase, "cpu", torch.float32), restored))))
    for name, w in jwant.items():
        np.testing.assert_allclose(got[name], np.asarray(w), rtol=0,
                                   atol=1e-6 * np.abs(w).max() + 1e-12,
                                   err_msg=name)


def test_add_lora_initialisation(cfg):
    tp = valley.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32)
    a1 = lora.add_lora(tp, torch.Generator().manual_seed(3), r=R, alpha=ALPHA,
                       dtype=torch.float32)
    a2 = lora.add_lora(tp, torch.Generator().manual_seed(3), r=R, alpha=ALPHA,
                       dtype=torch.float32)
    lay = a1["llama"]["layers"]
    for name in lora.DEFAULT_TARGETS:
        _, fan_out, fan_in = lay[name].shape
        a, b = lay[name + "_lora_a"], lay[name + "_lora_b"]
        assert a.shape == (cfg.text.num_hidden_layers, fan_in, R)
        assert b.shape == (cfg.text.num_hidden_layers, R, fan_out)
        assert not b.any()
        assert abs(float(a.std()) * fan_in ** 0.5 - 1.0) < 0.35
        assert torch.equal(a, a2["llama"]["layers"][name + "_lora_a"])
    assert torch.all(lay["lora_scale"] == ALPHA / R)
    # B = 0: the adapted model is the base model
    ids = torch.randint(5, 300, (1, 12), generator=torch.Generator()
                        .manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(valley.forward(a1, cfg, ids),
                                   valley.forward(tp, cfg, ids), rtol=0,
                                   atol=0)


# -- adapter dropout ---------------------------------------------------------

def test_dropout_mask_rate_and_keys():
    keep = 0.95
    m = llama.dropout_mask(llama.fold_in(42, 0), (64, 4096), keep, "cpu")
    rate = 1.0 - m.float().mean().item()
    # 262,144 draws: the rate's standard error is 4.3e-4
    assert abs(rate - 0.05) < 0.003
    same = llama.dropout_mask(llama.fold_in(42, 0), (64, 4096), keep, "cpu")
    assert torch.equal(m, same)
    keys = {llama.fold_in(llama.fold_in(llama.fold_in(42, step), layer),
                          proj)
            for step in range(3) for layer in range(4) for proj in range(7)}
    assert len(keys) == 3 * 4 * 7
    masks = [llama.dropout_mask(k, (64, 4096), keep, "cpu")
             for k in sorted(keys)[:6]]
    for i in range(len(masks)):
        for j in range(i):
            assert not torch.equal(masks[i], masks[j])


def _dropout_masks(monkeypatch, fn):
    """Run ``fn`` recording every mask `llama._proj` draws, by (layer key,
    projection)."""
    seen = []
    real = llama.dropout_mask

    def record(key, shape, keep, device):
        m = real(key, shape, keep, device)
        seen.append((key, m))
        return m

    monkeypatch.setattr(llama, "dropout_mask", record)
    out = fn()
    monkeypatch.setattr(llama, "dropout_mask", real)
    return out, seen


def test_dropout_masks_per_step_layer_and_projection(cfg, jparams,
                                                     monkeypatch, tmp_path):
    """The trainer's masks: the same for the same (seed, micro-batch),
    other ones at the next micro-batch, in every layer and projection; a
    rate near the recipe's 0.05."""
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in _batch(cfg).items()}

    def trainer(out):
        loader = TLoader(FakeDataset(cfg), 2,
                         TColl(pad_token_id=0, pad_to_multiple=16), seed=0)
        return Trainer(cfg, TrainConfig(
            output_dir=str(tmp_path / out), lora=True, lora_dropout=0.05,
            freeze_backbone=False, tune_mm_mlp_adapter=True,
            gradient_checkpointing=False), _port(jparams), loader,
            total_steps=4)

    t1, t2 = trainer("a"), trainer("b")
    (l1, _, _), m1 = _dropout_masks(monkeypatch,
                                    lambda: t1.loss_and_grads(batch))
    (l2, _, _), m2 = _dropout_masks(monkeypatch,
                                    lambda: t2.loss_and_grads(batch))
    assert torch.equal(l1, l2)
    assert len(m1) == len(m2) == 7 * cfg.text.num_hidden_layers
    for (k1, a), (k2, b) in zip(m1, m2):
        assert k1 == k2 and torch.equal(a, b)
    assert len({k for k, _ in m1}) == len(m1)   # layer x projection
    t2.step = 1
    (l3, _, _), m3 = _dropout_masks(monkeypatch,
                                    lambda: t2.loss_and_grads(batch))
    assert not torch.equal(l1, l3)
    for (k1, a), (k3, b) in zip(m1, m3):
        assert k1 != k3 and not torch.equal(a, b)
    dropped = sum(int((~m).sum()) for _, m in m1)
    total = sum(m.numel() for _, m in m1)
    assert abs(dropped / total - 0.05) < 0.01


def test_dropout_under_remat_equals_no_remat(cfg, jparams, monkeypatch):
    """At dropout 0.05 the recomputed layers draw the masks again: the
    loss and every adapter and projector gradient with remat on equal
    those with remat off, and the recompute's masks are the forward's."""
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in _batch(cfg).items()}
    out = {}
    for remat in (True, False):
        tp = _port(jparams)
        set_trainable(tp, TRAINABLE)
        named = dict(tp.named_parameters())

        def run():
            loss = valley.loss_fn(tp, cfg, batch, remat=remat,
                                  lora_rng=llama.fold_in(42, 5),
                                  lora_dropout=0.05)
            return loss, torch.autograd.grad(loss,
                                             [named[n] for n in TRAINABLE])

        out[remat], seen = _dropout_masks(monkeypatch, run)
        per_forward = 7 * cfg.text.num_hidden_layers
        assert len(seen) == per_forward * (2 if remat else 1)
        if remat:   # the backward's recompute drew the same masks
            first = dict(seen[:per_forward])
            for key, m in seen[per_forward:]:
                assert torch.equal(first[key], m)
    (lr, gr), (ln, gn) = out[True], out[False]
    assert torch.equal(lr, ln)
    for name, a, b in zip(TRAINABLE, gr, gn):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)
    # the dropout is live: without it the loss is another
    tp = _port(jparams)
    with torch.no_grad():
        plain = valley.loss_fn(tp, cfg, batch, remat=False)
    assert abs(float(plain) - float(lr.detach())) > 1e-4


def test_eval_engine_refilled_in_place_equals_a_fresh_engine(cfg, jparams):
    """`train.refresh_weights`: an engine built on one merged tree and
    refilled with another (the adapters moved) decodes as an engine built
    on the second, its tensors never replaced (graphs replay them)."""
    from valley_tpu_torch.inference.engine import Engine, GenerationConfig
    from valley_tpu_torch.train.train import refresh_weights

    tp = _port(jparams)
    first = lora.merge_lora(tp)
    eng = Engine(cfg, first, buckets=(64,), max_new_tokens=6,
                 cache_dtype=torch.float32)
    ptrs = [p.data_ptr() for p in eng.params.parameters()]
    with torch.no_grad():
        for name in lora.DEFAULT_TARGETS:
            tp["llama"]["layers"][name + "_lora_b"].mul_(-3.0)
    second = lora.merge_lora(tp)
    ids = [[5, 9, 13, 17, 21, 25]]
    gen = GenerationConfig(max_new_tokens=6, do_sample=False)

    def tokens(engine):
        return [int(t[0]) for t in engine.generate_tokens(ids, None, gen,
                                                          eos_ids=[-1])]

    before = tokens(eng)
    refresh_weights(eng.params, second)
    assert [p.data_ptr() for p in eng.params.parameters()] == ptrs
    fresh = Engine(cfg, second, buckets=(64,), max_new_tokens=6,
                   cache_dtype=torch.float32)
    assert tokens(eng) == tokens(fresh)
    assert tokens(fresh) != before
