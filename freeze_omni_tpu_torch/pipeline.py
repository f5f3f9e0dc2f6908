"""Host-side text normalisation of the response path (counterpart of
post_process in freeze_omni_tpu/pipeline.py). The JAX module's
InferencePipeline and DuplexPipeline come with a later slice.
"""

from __future__ import annotations

import re


def post_process(text: str) -> str:
    """Normalize model text for TTS (models/pipeline.py:90-130 behavior):
    unify CJK/ASCII punctuation, strip markup and whitespace runs, reformat
    numbered lists, and guarantee terminal punctuation."""
    for a, b in [("、", "，"), ("(", ","), (")", ","), ("（", "，"), ("）", "，")]:
        text = text.replace(a, b)
    text = re.sub(r"[\n\r\t]", "", text)
    text = re.sub(r"[*_`~]", "", text)
    text = re.sub(r"(\.|\:)\s+", r"\1", text)
    if re.search(r"[一-龥]", text):
        text = re.sub(r"(\d+)\.\s*([一-龥A-Za-z])", r"\1：\2", text)
    else:
        text = re.sub(r"(\d+)\.\s*([\w])", r"\1:\2", text)
    if text and text[-1] not in ["。", "？", "！", ".", "?", "!"]:
        if text[-1] in [",", "，", ";", "；", ":", "：", "、"]:
            text = text[:-1] + "。"
        else:
            text += "。"
    return text
