"""The port's copies of the JAX package's host modules: the config
dataclasses and presets, and the ByteTokenizer / ChatTemplate whose ids the
serving tick splices in front of every audio chunk. Exact equality: both are
plain Python with no arithmetic to round."""

import dataclasses
import os

import pytest

from freeze_omni_tpu import config as jcfg
from freeze_omni_tpu.utils import tokenizer as jtok
from freeze_omni_tpu_torch import config as tcfg
from freeze_omni_tpu_torch.utils import tokenizer as ttok

CONFIG_JSON = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "freeze_omni_tpu", "assets", "tiny_s2s",
    "config.json"))


@pytest.mark.parametrize("make", [
    lambda m: m.tiny_system(),
    lambda m: m.flagship_system(),
    lambda m: m.load_system_config(CONFIG_JSON),
], ids=["tiny", "flagship", "tiny_s2s_json"])
def test_system_config_copy_matches_jax(make):
    assert dataclasses.asdict(make(tcfg)) == dataclasses.asdict(make(jcfg))


@pytest.mark.parametrize("vocab", [512, 152064])
def test_tokenizer_and_chat_template_match_jax(vocab):
    tt, jt = ttok.ByteTokenizer(vocab), jtok.ByteTokenizer(vocab)
    text = "<|im_start|>system\nhé 你好<|im_end|>\n"
    assert tt.encode(text) == jt.encode(text)
    assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text)) == text
    tc, jc = ttok.ChatTemplate(tt), jtok.ChatTemplate(jt)
    assert tc.user_prefix_ids == jc.user_prefix_ids
    assert tc.system_prefix_ids == jc.system_prefix_ids
    role = tcfg.tiny_system().duplex.default_prompt
    assert tc.role_prompt_ids(role) == jc.role_prompt_ids(role)
