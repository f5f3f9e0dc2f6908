"""Evaluation metrics: CER / WER (edit distance) and spoken-QA scores (a
copy of freeze_omni_tpu/utils/metrics.py, pure Python).

Tooling for the reference's headline ASR tables (BASELINE.md: CER on aishell-
class sets, WER on LibriSpeech): normalized Levenshtein distance at character
and word granularity.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def normalize_text(text: str, lower: bool = True) -> str:
    text = re.sub(r"[^\w\s一-鿿]", " ", text)
    text = re.sub(r"\s+", " ", text).strip()
    return text.lower() if lower else text


def cer(ref: str, hyp: str) -> float:
    r = normalize_text(ref).replace(" ", "")
    h = normalize_text(hyp).replace(" ", "")
    return edit_distance(r, h) / max(len(r), 1)


def wer(ref: str, hyp: str) -> float:
    r = normalize_text(ref).split()
    h = normalize_text(hyp).split()
    return edit_distance(r, h) / max(len(r), 1)


def corpus_score(pairs: List[Tuple[str, str]], char_level: bool
                 ) -> float:
    """Length-weighted corpus CER/WER over (ref, hyp) pairs."""
    errs = 0
    total = 0
    for ref, hyp in pairs:
        if char_level:
            r = normalize_text(ref).replace(" ", "")
            h = normalize_text(hyp).replace(" ", "")
        else:
            r = normalize_text(ref).split()
            h = normalize_text(hyp).split()
        errs += edit_distance(r, h)
        total += len(r)
    return errs / max(total, 1)


# ---------------------------------------------------------------------------
# Spoken QA scoring (BASELINE.md: Web Questions / LlaMA Questions / Audio
# Trivia QA accuracy, assets/qa.png). SQuAD-style normalization: lowercase,
# strip punctuation and articles, collapse whitespace.
# ---------------------------------------------------------------------------

_QA_ARTICLES = {"a", "an", "the"}


def qa_normalize(text: str) -> str:
    import re

    text = re.sub(r"[^\w\s]", " ", text.lower())
    toks = [t for t in text.split() if t not in _QA_ARTICLES]
    return " ".join(toks)


def qa_exact_match(answers: List[str], hyp: str) -> float:
    h = qa_normalize(hyp)
    golds = [g for g in (qa_normalize(a) for a in answers) if g]
    return float(any(g == h for g in golds))


def qa_contains(answers: List[str], hyp: str) -> float:
    """Spoken-QA accuracy as the reference tables use it: the generated
    response counts as correct when it CONTAINS a gold answer (responses are
    conversational, not extractive spans). Gold answers that NORMALIZE empty
    ('the', punctuation-only) are skipped — they would match anything."""
    h = f" {qa_normalize(hyp)} "
    golds = [g for g in (qa_normalize(a) for a in answers) if g]
    return float(any(f" {g} " in h for g in golds))


def qa_f1(answers: List[str], hyp: str) -> float:
    """Max token-F1 over the gold answers."""
    from collections import Counter

    hyp_toks = qa_normalize(hyp).split()
    best = 0.0
    for a in answers:
        gold = qa_normalize(a).split()
        if not gold:
            continue  # normalizes empty — would credit empty hypotheses
        if not hyp_toks:
            continue
        common = Counter(hyp_toks) & Counter(gold)
        overlap = sum(common.values())
        if overlap == 0:
            continue
        p = overlap / len(hyp_toks)
        r = overlap / len(gold)
        best = max(best, 2 * p * r / (p + r))
    return best
