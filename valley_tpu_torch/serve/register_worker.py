"""Manually register a model worker with the controller
(parity with `valley/serve/register_worker.py`); the port's copy of
``valley_tpu/serve/register_worker.py``."""

import argparse

from valley_tpu_torch.serve.httpd import post_json


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", type=str, required=True)
    parser.add_argument("--worker-name", type=str, required=True)
    parser.add_argument("--check-heart-beat", action="store_true")
    args = parser.parse_args()

    post_json(args.controller_address + "/register_worker", {
        "worker_name": args.worker_name,
        "check_heart_beat": args.check_heart_beat,
        "worker_status": None,
    })


if __name__ == "__main__":
    main()
