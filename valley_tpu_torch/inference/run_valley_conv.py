"""Interactive multi-turn video chat on the PyTorch port, the counterpart
of ``valley_tpu/inference/run_valley_conv.py``.

python -m valley_tpu_torch.inference.run_valley_conv --model-name random:tiny \
    --video-file v.mp4 [--device cpu]

Reads questions from standard input; ``exit`` or an empty line quits, and
``change video <path>`` switches clips (the conversation starts again).
The first turn carries the frames and the whole prompt; later turns send
only their own tokens to the `ChatSession`, which keeps the cache across
turns.  It runs on the card; without one it stops unless ``--device cpu``
is given.  ``--model-name`` is a checkpoint directory or a ``random:``
configuration, loaded as `run_valley.load_model` loads them.
"""

from __future__ import annotations

import argparse
import logging

SHELL_UI_HEADER = r"""
 _    __      ____
| |  / /___ _/ / /__  __  __
| | / / __ `/ / / _ \/ / / /
| |/ / /_/ / / /  __/ /_/ /
|___/\__,_/_/_/\___/\__, /
                   /____/   video assistant — type 'exit' to quit,
                            'change video <path>' to switch clips.
"""


def load_frames(engine, path: str, num_frames: int):
    """(1, T, 3, H, W) CLIP-normalised frames of an mp4 or a frame
    directory."""
    from valley_tpu_torch.data.video import load_video_tchw

    size = engine.cfg.vision.image_size
    return load_video_tchw(path, fixed_frame_number=num_frames,
                           crop_size=size,
                           scale_size=max(size * 256 // 224, size))[None]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-name", type=str, required=True)
    parser.add_argument("--video-file", type=str, required=True,
                        help="mp4 file or directory of frames")
    parser.add_argument("--vision-tower", type=str, default=None)
    parser.add_argument("--lora-path", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=0.7)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--num-frames", type=int, default=8)
    parser.add_argument("--conv-mode", type=str, default="v1")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    from valley_tpu_torch.conversation import conv_templates
    from valley_tpu_torch.inference.engine import (ChatSession,
                                                   GenerationConfig)
    from valley_tpu_torch.inference.generate import media_replace_token
    from valley_tpu_torch.inference.run_valley import load_model

    engine, tokenizer = load_model(args.model_name, args.device,
                                   max_new_tokens=args.max_new_tokens,
                                   vision_tower=args.vision_tower,
                                   lora_path=args.lora_path)
    print(SHELL_UI_HEADER)
    images = load_frames(engine, args.video_file, args.num_frames)
    conv = conv_templates[args.conv_mode].copy()
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature,
                           do_sample=args.temperature >= 1e-4,
                           stop=(conv.sep,))
    session = ChatSession(engine, gen)     # the cache is kept across turns
    eos = [getattr(tokenizer, "eos_token_id", 2) or 2]
    first_turn = True

    while True:
        try:
            inp = input(f"{conv.roles[0]}: ").strip()
        except EOFError:
            break
        if not inp or inp == "exit":
            break
        if inp.startswith("change video "):
            path = inp[len("change video "):].strip()
            try:
                images = load_frames(engine, path, args.num_frames)
            except Exception as e:  # noqa: BLE001 -- reported, REPL goes on
                print(f"failed to load {path}: {e}")
                continue
            conv = conv_templates[args.conv_mode].copy()
            session = ChatSession(engine, gen)
            first_turn = True
            print(f"switched to {path}; conversation reset.")
            continue

        if first_turn:
            inp = media_replace_token(engine.cfg.num_patches,
                                      images.shape[1]) + " " + inp
        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], None)
        if first_turn:
            ids = tokenizer.encode(conv.get_prompt())
        else:
            # a later turn's own tokens, framed as the template frames them
            ids = tokenizer.encode(
                f" {conv.roles[0]}: {inp}{conv.sep}{conv.roles[1]}:")
            if ids and ids[0] == getattr(tokenizer, "bos_token_id", 1):
                ids = ids[1:]
        print(f"{conv.roles[1]}: ", end="", flush=True)
        reply = session.chat(ids, images=images if first_turn else None,
                             tokenizer=tokenizer, eos_ids=eos)
        text = tokenizer.decode(reply, skip_special_tokens=True)
        idx = text.find(conv.sep)
        if idx >= 0:
            text = text[:idx]
        print(text)
        conv.messages[-1][-1] = text
        first_turn = False


if __name__ == "__main__":
    main()
