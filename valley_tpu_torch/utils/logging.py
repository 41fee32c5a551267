"""The port's own copy of the parts of ``valley_tpu/utils/logging.py`` it
uses: `server_error_msg`, the text a stream carries when a request fails,
and the training entry point's `rank_zero_info` and
`print_trainable_params`.  The port runs one process, which is rank 0.
"""

from __future__ import annotations

import logging
from typing import Mapping, Optional

server_error_msg = ("**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE "
                    "OR REFRESH THIS PAGE.**")


def rank_zero_info(message: str, logger=None) -> None:
    """Log ``message`` at INFO from rank 0 (logging.py:100-102)."""
    (logger or logging.getLogger(__name__)).info(message)


def print_trainable_params(params, labels: Optional[Mapping[str, str]] = None
                           ) -> str:
    """Print and return a table of every parameter's element count and
    label group, and the trainable total ('frozen' labels excluded;
    without ``labels`` every parameter counts as 'base'), as
    logging.py:105-130 tabulates the JAX tree.  ``params`` is a module
    (``named_parameters``); names are dotted."""
    lines = [f"{'param':60s} {'count':>14s} {'group':>8s}"]
    total = trainable = 0
    for name, p in params.named_parameters():
        n = p.numel()
        lab = labels[name] if labels is not None else "base"
        total += n
        if lab != "frozen":
            trainable += n
        lines.append(f"{name.replace('.', '/'):60s} {n:14,d} {lab:>8s}")
    lines.append(f"total={total:,} trainable={trainable:,} "
                 f"({100.0 * trainable / max(total, 1):.2f}%)")
    table = "\n".join(lines)
    print(table)
    return table
