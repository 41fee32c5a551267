"""Logging and observability helpers, the port's own copy of
``valley_tpu/utils/logging.py``: `build_logger` (a daily-rotating file
handler on every logger, stdout and stderr redirected into loggers),
`get_logger`, `StreamToLogger`, the serving texts `server_error_msg` and
`moderation_msg`, the fail-open `violates_moderation`,
`pretty_print_semaphore`, `disable_progress`, and the training entry
point's `rank_zero_info` and `print_trainable_params`, which log from
process 0 only (a run under torchrun has one process a device; a run
without a process group is process 0).
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
import sys
import urllib.request
from typing import Mapping, Optional

from valley_tpu_torch.parallel.distributed import process_index

handler = None

server_error_msg = ("**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE "
                    "OR REFRESH THIS PAGE.**")
moderation_msg = ("YOUR INPUT VIOLATES OUR CONTENT MODERATION GUIDELINES. "
                  "PLEASE TRY AGAIN.")

MODERATION_URL = "https://api.openai.com/v1/moderations"


class StreamToLogger:
    """A file-like object whose complete lines go to ``logger`` at
    ``log_level`` (logging.py:28-52); a line without its newline waits in
    ``linebuf`` until the next write or `flush`.  Other attributes are the
    terminal's (the stdout it replaced)."""

    def __init__(self, logger: logging.Logger, log_level=logging.INFO):
        self.terminal = sys.stdout
        self.logger = logger
        self.log_level = log_level
        self.linebuf = ""

    def __getattr__(self, attr):
        return getattr(self.terminal, attr)

    def write(self, buf):
        temp_linebuf = self.linebuf + buf
        self.linebuf = ""
        for line in temp_linebuf.splitlines(True):
            if line[-1] == "\n":
                self.logger.log(self.log_level, line.rstrip())
            else:
                self.linebuf += line

    def flush(self):
        if self.linebuf != "":
            self.logger.log(self.log_level, self.linebuf.rstrip())
        self.linebuf = ""


def build_logger(logger_name: str, logger_filename: str,
                 log_dir: str = ".") -> logging.Logger:
    """``logger_name``'s logger at INFO (logging.py:55-86): the root
    handler's format set, stdout and stderr redirected into the "stdout"
    (INFO) and "stderr" (ERROR) loggers, and, on the first call, a
    `TimedRotatingFileHandler` of ``log_dir/logger_filename`` (daily, UTC)
    added to every logger that exists then."""
    global handler

    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")

    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logging.getLogger().handlers[0].setFormatter(formatter)

    stdout_logger = logging.getLogger("stdout")
    stdout_logger.setLevel(logging.INFO)
    sys.stdout = StreamToLogger(stdout_logger, logging.INFO)
    stderr_logger = logging.getLogger("stderr")
    stderr_logger.setLevel(logging.ERROR)
    sys.stderr = StreamToLogger(stderr_logger, logging.ERROR)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if handler is None:
        os.makedirs(log_dir, exist_ok=True)
        filename = os.path.join(log_dir, logger_filename)
        handler = logging.handlers.TimedRotatingFileHandler(
            filename, when="D", utc=True)
        handler.setFormatter(formatter)
        for item in logging.root.manager.loggerDict.values():
            if isinstance(item, logging.Logger):
                item.addHandler(handler)
    return logger


def get_logger(name: str, filename: Optional[str] = None) -> logging.Logger:
    """``name``'s logger at INFO, writing also to ``filename`` when given
    (logging.py:89-97)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if filename:
        fh = logging.FileHandler(filename)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s | %(levelname)s | %(message)s"))
        logger.addHandler(fh)
    return logger


def rank_zero_info(message: str, logger=None) -> None:
    """Log ``message`` at INFO from rank 0 (logging.py:100-102)."""
    if process_index() == 0:
        (logger or logging.getLogger(__name__)).info(message)


def print_trainable_params(params, labels: Optional[Mapping[str, str]] = None
                           ) -> str:
    """Print (from rank 0) and return a table of every parameter's element
    count and label group, and the trainable total ('frozen' labels
    excluded; without ``labels`` every parameter counts as 'base'), as
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
    if process_index() == 0:
        print(table)
    return table


def violates_moderation(text: str) -> bool:
    """Whether OpenAI's moderation endpoint flags ``text`` (newlines
    removed), as logging.py:133-152 asks it.  Fails open: False when
    ``OPENAI_API_KEY`` is not set, and False when the request or its
    answer fails.  The request is made only with a key."""
    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key:
        return False
    req = urllib.request.Request(
        MODERATION_URL,
        data=json.dumps({"input": text.replace("\n", "")}).encode(),
        headers={"Content-Type": "application/json",
                 "Authorization": "Bearer " + api_key})
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return bool(json.loads(r.read())["results"][0]["flagged"])
    except Exception:
        return False


def pretty_print_semaphore(semaphore) -> str:
    """"None", or the semaphore's value and whether it is locked, for a
    threading or an asyncio semaphore (logging.py:155-161)."""
    if semaphore is None:
        return "None"
    locked = semaphore.locked() if hasattr(semaphore, "locked") \
        else semaphore._value == 0
    return f"Semaphore(value={semaphore._value}, locked={locked})"


def disable_progress() -> None:
    """Turn tqdm's progress bars off for this process and its children."""
    os.environ["TQDM_DISABLE"] = "1"
