"""Frames and text fields out of an eval dump whose frames are base64,
the port's own copy of ``valley_tpu/utils/decode_img.py``: each input line
is a JSON record with ``video_frame`` (a list of base64 images) and text
fields; a sampled share of the frames is written as JPEGs (PIL) and the
text fields as one JSON file per record.

    python -m valley_tpu_torch.utils.decode_img --path dump.jsonl \\
        --save-path frames/
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import random


def b64_decode(string) -> bytes:
    if isinstance(string, str):
        string = string.encode()
    return base64.decodebytes(string)


def image_preprocess(image_str):
    from PIL import Image

    return Image.open(io.BytesIO(b64_decode(image_str))).convert("RGB")


def extract(path: str, save_path: str, text_fields=("merge_ocr", "title",
                                                    "gt_label"),
            frame_sample_rate: float = 0.5, limit: int = 50,
            seed: int = 0) -> int:
    os.makedirs(save_path, exist_ok=True)
    rng = random.Random(seed)
    written = 0
    with open(path) as f:
        for idx, line in enumerate(f):
            if idx > limit:
                break
            data = json.loads(line)
            text = {k: data[k] for k in text_fields if k in data}
            with open(os.path.join(save_path, f"{idx}.json"), "w") as out:
                out.write(json.dumps(text, indent=4))
            for i, frame in enumerate(data.get("video_frame", [])):
                if rng.random() < frame_sample_rate:
                    image_preprocess(frame).save(
                        os.path.join(save_path, f"{idx}_{i}.jpg"),
                        quality=95)
                    written += 1
    return written


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", required=True, help="jsonl eval dump")
    parser.add_argument("--save-path", required=True)
    parser.add_argument("--limit", type=int, default=50)
    parser.add_argument("--frame-sample-rate", type=float, default=0.5)
    args = parser.parse_args()
    n = extract(args.path, args.save_path, limit=args.limit,
                frame_sample_rate=args.frame_sample_rate)
    print(f"wrote {n} frames to {args.save_path}")


if __name__ == "__main__":
    main()
