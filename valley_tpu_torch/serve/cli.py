"""Local chat REPL (parity with `valley/serve/cli.py`: a
conversation-template chat loop), the port's counterpart of
``valley_tpu/serve/cli.py``: a `ChatSession` keeps the cache across turns,
so later turns prefill only their own tokens.

python -m valley_tpu_torch.serve.cli --model-path <dir> [--video <file>] \
    [--device cpu]
"""

from __future__ import annotations

import argparse
import logging

from valley_tpu_torch.conversation import conv_templates
from valley_tpu_torch.inference.engine import GenerationConfig


def chat_loop(engine, tokenizer, conv_mode: str = "v1",
              temperature: float = 0.7, max_new_tokens: int = 512,
              video: str | None = None, num_frames: int = 8,
              input_fn=input, print_fn=print, speculative=False):
    conv = conv_templates[conv_mode].copy()
    images = None
    if video is not None:
        import numpy as np

        from valley_tpu_torch.data.video import load_video

        size = engine.cfg.vision.image_size
        clip = load_video(video, fixed_frame_number=num_frames,
                          crop_size=size,
                          scale_size=max(size * 256 // 224, size))
        images = np.transpose(clip, (1, 0, 2, 3))[None]

    if speculative:
        from valley_tpu_torch.inference.speculative import \
            SpecChatSession as ChatSession
    else:
        from valley_tpu_torch.inference.engine import ChatSession
    from valley_tpu_torch.inference.generate import media_replace_token

    gen = GenerationConfig(max_new_tokens=max_new_tokens,
                           temperature=temperature,
                           do_sample=temperature >= 1e-4,
                           stop=(conv.sep,), stream_interval=2)
    # Multi-turn KV reuse: later turns only prefill their delta tokens.
    session = ChatSession(engine, gen)
    first_turn = True
    while True:
        try:
            inp = input_fn(f"{conv.roles[0]}: ")
        except EOFError:
            inp = ""
        if not inp:
            print_fn("exit...")
            break
        if first_turn and images is not None:
            inp = media_replace_token(engine.cfg.num_patches,
                                      images.shape[1]) + " " + inp
        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], None)
        if first_turn:
            delta = conv.get_prompt()          # system + first human turn
        else:
            delta = (f" {conv.roles[0]}: {inp}{conv.sep}"
                     f"{conv.roles[1]}:")
        ids = tokenizer.encode(delta)
        if not first_turn and ids and ids[0] == getattr(
                tokenizer, "bos_token_id", 1):
            ids = ids[1:]                      # no BOS mid-conversation

        print_fn(f"{conv.roles[1]}: ", end="", flush=True)
        reply = session.chat(ids, images=images if first_turn else None,
                             tokenizer=tokenizer,
                             eos_ids=[getattr(tokenizer, "eos_token_id", 2)
                                      or 2])
        text = tokenizer.decode(reply, skip_special_tokens=True)
        for s in gen.stop:
            idx = text.find(s)
            if idx >= 0:
                text = text[:idx]
        print_fn(text)
        conv.messages[-1][-1] = text
        first_turn = False


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, default="random:tiny")
    parser.add_argument("--vision-tower", type=str, default=None)
    parser.add_argument("--lora-path", type=str, default=None)
    parser.add_argument("--conv-mode", type=str, default="v1")
    parser.add_argument("--video", type=str, default=None)
    parser.add_argument("--num-frames", type=int, default=8)
    parser.add_argument("--temperature", type=float, default=0.7)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--buckets", type=str, default="256,512,1024,2048")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--speculative", action="store_true",
                        help="n-gram self-speculative decode (greedy "
                             "token-identical, sampling "
                             "distribution-exact)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    from valley_tpu_torch.serve.model_worker import load_engine

    engine, tokenizer = load_engine(args)
    chat_loop(engine, tokenizer, args.conv_mode, args.temperature,
              args.max_new_tokens, args.video, args.num_frames,
              speculative=args.speculative)


if __name__ == "__main__":
    main()
