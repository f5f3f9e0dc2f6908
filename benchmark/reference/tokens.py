"""The chat-control token ids the duplex path splices in, as the published
Freeze-Omni template writes them (audioLLM.py: the role prompt
'<|im_start|>system\\n' + role without its '<|im_end|>', the user prefix
'<|im_end|>\\n<|im_start|>user\\n', the assistant prefix
'<|im_end|>\\n<|im_start|>assistant\\n'), in the byte vocabulary a
weightless deployment serves: UTF-8 bytes, with <|im_start|> and
<|im_end|> at Qwen2's ids 151644 and 151645 (the top two ids of a
smaller vocabulary)."""

from __future__ import annotations

from typing import List


def encode(text: str, vocab_size: int) -> List[int]:
    start, end = (151644, 151645) if vocab_size > 151645 else \
        (vocab_size - 2, vocab_size - 1)
    out: List[int] = []
    i = 0
    while i < len(text):
        if text.startswith("<|im_start|>", i):
            out.append(start)
            i += len("<|im_start|>")
        elif text.startswith("<|im_end|>", i):
            out.append(end)
            i += len("<|im_end|>")
        else:
            out.extend(text[i].encode("utf-8"))
            i += 1
    return out


def role_ids(role: str, vocab_size: int) -> List[int]:
    return encode("<|im_start|>system\n" + role, vocab_size)


def prefix_ids(vocab_size: int) -> dict:
    return {"user": encode("<|im_end|>\n<|im_start|>user\n", vocab_size),
            "system": encode("<|im_end|>\n<|im_start|>assistant\n", vocab_size)}
