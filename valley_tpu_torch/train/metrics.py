"""Generation metrics of the PyTorch port: BLEU / ROUGE / (optional)
BERTScore, the port's own copy of ``valley_tpu/train/metrics.py``.

The reference computes these through the `evaluate` hub
(`valley/train/trainner.py:207-208,444-448`); here BLEU-4 (corpus, with
brevity penalty) and ROUGE-1/2/L are implemented natively, with BERTScore
gated on the `bert_score` package being installed.  Also the per-rank
jsonl shard writing and merge of the eval flow
(`trainner.py:122-147,465-486`).
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
from typing import Dict, Iterable, List, Sequence


def _tokenize(text: str) -> List[str]:
    return re.findall(r"\w+", text.lower())


def _ngrams(tokens: Sequence[str], n: int):
    return collections.Counter(
        tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu(predictions: Sequence[str], references: Sequence[str],
         max_n: int = 4) -> float:
    """Corpus BLEU with uniform weights and brevity penalty (sacrebleu-style
    smoothing: precision floor of 1/(2*len))."""
    log_precisions = []
    pred_toks = [_tokenize(p) for p in predictions]
    ref_toks = [_tokenize(r) for r in references]
    for n in range(1, max_n + 1):
        match, total = 0, 0
        for p, r in zip(pred_toks, ref_toks):
            pc, rc = _ngrams(p, n), _ngrams(r, n)
            match += sum((pc & rc).values())
            total += max(sum(pc.values()), 0)
        if total == 0:
            return 0.0
        prec = match / total if match else 1.0 / (2.0 * total)
        log_precisions.append(math.log(prec))
    pred_len = sum(len(p) for p in pred_toks)
    ref_len = sum(len(r) for r in ref_toks)
    if pred_len == 0:
        return 0.0
    bp = 1.0 if pred_len > ref_len else math.exp(1 - ref_len / pred_len)
    return bp * math.exp(sum(log_precisions) / max_n)


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y
                       else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def _f1(match: float, pred_n: int, ref_n: int) -> float:
    if match == 0 or pred_n == 0 or ref_n == 0:
        return 0.0
    p, r = match / pred_n, match / ref_n
    return 2 * p * r / (p + r)


def rouge(predictions: Sequence[str], references: Sequence[str]
          ) -> Dict[str, float]:
    """Mean ROUGE-1/2 F1 and ROUGE-L F1."""
    r1, r2, rl = [], [], []
    for pred, ref in zip(predictions, references):
        p, r = _tokenize(pred), _tokenize(ref)
        p1, g1 = _ngrams(p, 1), _ngrams(r, 1)
        p2, g2 = _ngrams(p, 2), _ngrams(r, 2)
        r1.append(_f1(sum((p1 & g1).values()), sum(p1.values()),
                      sum(g1.values())))
        r2.append(_f1(sum((p2 & g2).values()), sum(p2.values()),
                      sum(g2.values())))
        rl.append(_f1(_lcs_len(p, r), len(p), len(r)))

    def mean(xs):
        return sum(xs) / len(xs) if xs else 0.0

    return {"rouge1": mean(r1), "rouge2": mean(r2), "rougeL": mean(rl)}


def bert_score(predictions, references) -> Dict[str, float]:
    """BERTScore if the optional dependency is present, else {} (the
    reference uses it via evaluate, `trainner.py:444-448`)."""
    try:
        import bert_score as bs  # type: ignore
    except ImportError:
        return {}
    P, R, F = bs.score(list(predictions), list(references), lang="en")
    return {"bertscore_f1": float(F.mean())}


def compute_generation_metrics(predictions: Sequence[str],
                               references: Sequence[str]) -> Dict[str, float]:
    out = {"bleu": bleu(predictions, references)}
    out.update(rouge(predictions, references))
    out.update(bert_score(predictions, references))
    return out


# -- per-rank shard writing / merging (trainner.py:122-147,465-486) -----

def jsonl_write(path: str, rank: int, records: Iterable[dict]) -> str:
    shard = f"{path}.worker{rank}"
    with open(shard, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return shard


def merge_files(path: str) -> List[dict]:
    """Merge `{path}.worker*` shards into `path` and return the records."""
    records: List[dict] = []
    d = os.path.dirname(path) or "."
    base = os.path.basename(path)
    shards = sorted(f for f in os.listdir(d)
                    if f.startswith(base + ".worker"))
    with open(path, "w") as out:
        for shard in shards:
            with open(os.path.join(d, shard)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        records.append(json.loads(line))
                        out.write(line + "\n")
            os.remove(os.path.join(d, shard))
    return records
