"""The launch plans of K1, K5 and K2 at the widths one tensor-parallel rank
runs (parallel/mesh: tp = 2 and tp = 4 of the flagship's Qwen2-7B widths),
held to the same invariants as at one card's widths
(test_torch_tile_plan.py, test_torch_k5_plan.py, test_torch_prefill_plan.py):
each plan covers K (or the visible slots) once, in whole groups, fills the
card where the shape allows and fits the block's shared memory. The kernels
themselves run at these shapes on the card (chip_smoke phase 15)."""

import pytest

from freeze_omni_tpu_torch.config import flagship_system
from freeze_omni_tpu_torch.ops.quant_matmul import TILE_K
from tests.test_torch_k5_plan import \
    test_small_plan_covers_k_in_whole_groups_and_fills_the_card as small_case
from tests.test_torch_prefill_plan import \
    test_prefill_plan_covers_rows_and_slots_once_fills_the_card_and_fits as k2_case
from tests.test_torch_tile_plan import \
    test_tile_plan_covers_k_once_fills_the_card_and_fits as tile_case

LLM = flagship_system().audio_llm.llm
D, HDK, KV, FFN, V = (LLM.hidden, LLM.num_heads * LLM.head_dim,
                      LLM.num_kv_heads * LLM.head_dim, LLM.ffn, LLM.vocab_size)


def shard_shapes(tp):
    """(K, O) of one rank's q, k/v, o, gate/up, down and lm_head."""
    return [(D, HDK // tp), (D, KV // tp), (HDK // tp, D), (D, FFN // tp),
            (FFN // tp, D), (D, V // tp)]


SHAPES = sorted({(tp, K, O) for tp in (2, 4) for K, O in shard_shapes(tp)})


@pytest.mark.parametrize("kernel,group", [("K1", None), ("K5", 64), ("K5", 128)])
@pytest.mark.parametrize("N", [8, 232])
@pytest.mark.parametrize("tp,K,O", SHAPES)
def test_tile_plan_at_shard_shapes(tp, K, O, N, kernel, group):
    if group is not None:
        # K5's tile path: whole groups of whole 16-row bf16 K steps
        assert K % group == 0 and group % 16 == 0 and TILE_K % 16 == 0
    tile_case(K, O, N, kernel, group)


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("N", [1, 8, 16])
@pytest.mark.parametrize("tp,K,O", SHAPES)
def test_small_plan_at_shard_shapes(tp, K, O, N, group):
    small_case(K, O, N, group)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("B,T,S,valid", [(8, 29, 1024, 8), (8, 29, 2048, 8),
                                         (8, 1, 1024, 1), (8, 1, 2048, 1),
                                         (8, 89, 1024, 89), (2, 89, 2048, 89)])
def test_prefill_plan_at_shard_shapes(B, T, S, valid, tp):
    # tp = 4 leaves one kv head a rank, seven query heads on it
    k2_case(B, T, LLM.num_heads // tp, LLM.num_kv_heads // tp, LLM.head_dim,
            S, valid)
