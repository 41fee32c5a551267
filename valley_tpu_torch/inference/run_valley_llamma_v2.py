"""LLaMA-2 Valley one-shot inference, the port's counterpart of
``valley_tpu/inference/run_valley_llamma_v2.py`` (parity with
`valley/inference/run_valley_llamma_v2.py`, which pins `Valley2-7b` and
sampling on): `run_valley` with ``--do-sample`` added.

python -m valley_tpu_torch.inference.run_valley_llamma_v2 \
    --model-name <checkpoint dir> --video-file v.mp4 [--device cpu]
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--do-sample" not in argv:
        argv.append("--do-sample")

    from valley_tpu_torch.inference.run_valley import main as run

    run(argv)


if __name__ == "__main__":
    main()
