"""Tokenizers (copy of the JAX package's utils/tokenizer.py).

`HFTokenizer`: adapter over a local transformers tokenizer directory
(transformers is imported only when one is built; nothing is downloaded).
`ByteTokenizer`: the fallback for weightless operation and tests, UTF-8
bytes offset past a reserved special-token block, with Qwen2-style
chat-control tokens. `ChatTemplate`: the chat-control id sequences the
duplex path splices in front of audio chunks.
"""

from __future__ import annotations

from typing import List, Sequence


class ByteTokenizer:
    """UTF-8 byte tokenizer with a reserved special block at the top of a
    Qwen2-shaped id space (im_start/im_end ids match Qwen2's real ids when
    vocab_size allows, so converted checkpoints keep working)."""

    def __init__(self, vocab_size: int = 152064):
        self.vocab_size = vocab_size
        if vocab_size > 151645:
            self.im_start_id = 151644
            self.im_end_id = 151645
        else:
            self.im_start_id = vocab_size - 2
            self.im_end_id = vocab_size - 1
        self.eos_token_id = self.im_end_id
        self.eod_id = self.im_end_id

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        i = 0
        while i < len(text):
            if text.startswith("<|im_start|>", i):
                out.append(self.im_start_id)
                i += len("<|im_start|>")
            elif text.startswith("<|im_end|>", i):
                out.append(self.im_end_id)
                i += len("<|im_end|>")
            else:
                out.extend(int(b) for b in text[i].encode("utf-8"))
                i += 1
        return out

    def decode(self, ids: Sequence[int]) -> str:
        buf = bytearray()
        parts: List[str] = []
        for t in ids:
            if t == self.im_start_id or t == self.im_end_id:
                if buf:
                    parts.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                parts.append("<|im_start|>" if t == self.im_start_id else "<|im_end|>")
            elif t < 256:
                buf.append(t)
        if buf:
            parts.append(buf.decode("utf-8", errors="replace"))
        return "".join(parts)


class HFTokenizer:
    """Adapter over transformers.AutoTokenizer loaded from a local path."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path, trust_remote_code=True,
                                                 local_files_only=True)
        self.vocab_size = len(self.tok)
        self.im_start_id = self.tok.convert_tokens_to_ids("<|im_start|>")
        self.im_end_id = self.tok.convert_tokens_to_ids("<|im_end|>")
        self.eos_token_id = self.tok.eos_token_id
        self.eod_id = self.im_end_id

    def encode(self, text: str) -> List[int]:
        return self.tok(text)["input_ids"]

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(ids)


class ChatTemplate:
    """Precomputed chat-control token id sequences (audioLLM.py:111-126).

    role_prompt(role): '<|im_start|>system\\n' + role  (pipeline.py:63-65; the
    trailing <|im_end|> is intentionally omitted, audioLLM.py:326-327)
    user prefix:    <|im_end|>\\n<|im_start|>user\\n    (audioLLM.py:295-296)
    system prefix:  <|im_end|>\\n<|im_start|>assistant\\n (audioLLM.py:297-298)
    """

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.user_prefix_ids = tokenizer.encode("<|im_end|>\n<|im_start|>user\n")
        self.system_prefix_ids = tokenizer.encode("<|im_end|>\n<|im_start|>assistant\n")

    def role_prompt_ids(self, role: str) -> List[int]:
        return self.tokenizer.encode("<|im_start|>system\n" + role)
