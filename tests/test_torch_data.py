"""The PyTorch port's copy of the data pipeline against the JAX package's:
the same corpus on disk (text, image and video conversations), the same
tokenizer and the same seed give the same batches, array for array.

Token ids, labels, masks and frame masks must be equal; pixels to 1e-6
(both decode with OpenCV and run the same numpy transforms).  The JAX
package runs with its native C++ decoder off (``VALLEY_DISABLE_NATIVE``):
the port has no native decoder, and the JAX package's native and OpenCV
paths do not agree with each other (ROADMAP.md, section 3).
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from valley_tpu.data.dataset import DataLoader as JLoader
from valley_tpu.data.dataset import PrefetchLoader as JPrefetch
from valley_tpu.data.dataset import \
    make_video_supervised_data_module as jmake
from valley_tpu.tokenizer import ByteFallbackTokenizer as JTok
from valley_tpu_torch.data.dataset import DataLoader as TLoader
from valley_tpu_torch.data.dataset import PrefetchLoader as TPrefetch
from valley_tpu_torch.data.dataset import \
    make_video_supervised_data_module as tmake
from valley_tpu_torch.tokenizer import ByteFallbackTokenizer as TTok


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    from PIL import Image

    root = tmp_path_factory.mktemp("data_corpus")
    rng = np.random.default_rng(3)
    vid_dir = root / "videos" / "webvid"
    vid_dir.mkdir(parents=True)
    w = cv2.VideoWriter(str(vid_dir / "a.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 40))
    for _ in range(24):
        w.write(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
    w.release()
    img_dir = root / "images"
    img_dir.mkdir()
    Image.fromarray(rng.integers(0, 256, (36, 44, 3), dtype=np.uint8)
                    ).save(img_dir / "p.png")
    text = [{"id": f"t{i}", "conversations": [
        {"from": "human", "value": f"question number {i}?"},
        {"from": "gpt", "value": "answer " * (i + 1)}]} for i in range(4)]
    images = [{"id": f"i{i}", "image": "p.png", "conversations": [
        {"from": "human", "value": "<image>\nwhat is shown?"},
        {"from": "gpt", "value": f"noise {i}"}]} for i in range(4)]
    videos = [{"id": f"v{i}", "video": "a.mp4", "conversations": [
        {"from": "human", "value": "<video>\ndescribe it"},
        {"from": "gpt", "value": f"frames change {i}"},
        {"from": "human", "value": "and then?"},
        {"from": "gpt", "value": "they stop"}]} for i in range(4)]
    (root / "d.json").write_text(json.dumps(text + images))
    (root / "v.json").write_text(json.dumps(videos))
    return root


def _batches(make, tokenizer, loader_cls, root, prefetch_cls=None):
    args = SimpleNamespace(
        data_path=str(root / "d.json"), video_data_path=str(root / "v.json"),
        image_folder=str(root / "images"),
        video_folder=str(root / "videos"), is_multimodal=True,
        mm_use_im_start_end=True, num_frames=3, conv_mode="v1",
        crop_size=28, scale_size=32, patch_size=14)
    module = make(tokenizer, args)
    loader = loader_cls(module["train_dataset"], 4, module["data_collator"],
                        seed=5)
    if prefetch_cls is not None:
        loader = prefetch_cls(loader, depth=2)
    return [b for epoch in (0, 1) for b in loader.epoch(epoch)]


@pytest.mark.parametrize("prefetch", [False, True])
def test_port_batches_equal_jax_batches(corpus, prefetch, monkeypatch):
    monkeypatch.setenv("VALLEY_DISABLE_NATIVE", "1")
    jb = _batches(jmake, JTok(model_max_length=256), JLoader, corpus,
                  JPrefetch if prefetch else None)
    tb = _batches(tmake, TTok(model_max_length=256), TLoader, corpus,
                  TPrefetch if prefetch else None)
    assert len(tb) == len(jb) == 6
    for a, b in zip(jb, tb):
        assert set(a) == set(b) == {"input_ids", "labels", "attention_mask",
                                    "images", "frame_mask"}
        for key in ("input_ids", "labels", "attention_mask", "frame_mask"):
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
        np.testing.assert_allclose(b["images"], a["images"], rtol=0,
                                   atol=1e-6)
    # the corpus reaches every modality: videos of 3 frames, images, text
    frames = np.concatenate([b["frame_mask"].sum(axis=1) for b in tb])
    assert set(frames.tolist()) == {1, 3}
    assert any((b["labels"] != -100).any() for b in tb)
