"""Smoke-test client: send one prompt through controller -> worker and
print the stream (the reference's `test_message.py` is broken — imports
`llava` — this is the working equivalent); the port's copy of
``valley_tpu/serve/test_message.py``, on `httpd`'s urllib client."""

import argparse
import json

from valley_tpu_torch.conversation import default_conversation
from valley_tpu_torch.serve.httpd import iter_delimited, open_json, post_json


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--worker-address", type=str, default=None)
    parser.add_argument("--model-name", type=str, default="valley")
    parser.add_argument("--max-new-tokens", type=int, default=32)
    parser.add_argument("--message", type=str,
                        default="Tell me a story with more than 1000 words.")
    args = parser.parse_args()

    if args.worker_address:
        worker_addr = args.worker_address
    else:
        post_json(args.controller_address + "/refresh_all_workers", {})
        models = post_json(args.controller_address + "/list_models",
                           {})["models"]
        print(f"Models: {models}")
        worker_addr = post_json(
            args.controller_address + "/get_worker_address",
            {"model": args.model_name})["address"]
        print(f"worker_addr: {worker_addr}")
    if worker_addr == "":
        print("No available workers")
        return

    conv = default_conversation.copy()
    conv.append_message(conv.roles[0], args.message)
    prompt = conv.get_prompt()

    with open_json(worker_addr + "/worker_generate_stream",
                   {"model": args.model_name, "prompt": prompt,
                    "max_new_tokens": args.max_new_tokens,
                    "temperature": 0.7, "stop": conv.sep},
                   timeout=60) as response:
        for chunk in iter_delimited(response):
            data = json.loads(chunk.decode())
            print(data["text"].split(conv.sep)[-1], end="\r")
    print("")


if __name__ == "__main__":
    main()
