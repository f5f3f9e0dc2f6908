"""K3/K4's kernel (csrc/decode_attention.cu) as far as the CPU reaches it:
K4's launch plan (`decode_plan`), the cut of a row's visible slots into
splits that the kernel makes on the card and the warps' sub-tiles of each
split (`split_ranges` and `warp_slots` below state them), the block's
shared memory and the workspace the plan implies, and the plain version
that CPU tensors take. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from freeze_omni_tpu_torch.ops import attention as att

SMS = 132
SMEM_PER_BLOCK = 227 * 1024   # an H100 block's shared memory, at most
WARPS, WARP_SLOTS = 4, 8      # a block's warps, and the slots each takes of a tile
STAGES = 3                    # sub-tiles in a warp's ring of copies
# (B, H, Hkv, dk, S, cache dtype): the phase-7 pool (one speech-decoder
# layer), the phase-9 pool (rows of 1521 slots), first_response, the LLM's
# text decode at --kv_quant 0, the per-session path's B = 1 calls (the
# LLM's bf16 text decode and StreamingTTS's speech decoder), an f32 cache
# under the LLM's heads, narrow heads whose short rows have fewer tiles than
# the plan has splits, the tiny widths of the card tests, the trained tiny
# system's speech decoder (head dim 32) and head dim 32 under 16 query heads
# a kv head
SHAPES = {
    "pool": (8, 14, 14, 64, 465, torch.float32),
    "service_pool": (4, 14, 14, 64, 1521, torch.float32),
    "first_response": (8, 14, 14, 64, 2048, torch.float32),
    "llm_bf16": (8, 28, 4, 128, 2048, torch.bfloat16),
    "session_llm": (1, 28, 4, 128, 2048, torch.bfloat16),
    "session_tts": (1, 14, 14, 64, 2048, torch.float32),
    "llm_f32_cache": (6, 28, 4, 128, 300, torch.float32),
    "short_rows": (8, 2, 2, 64, 2048, torch.float32),
    "tiny": (3, 8, 2, 64, 100, torch.bfloat16),
    "tiny_tts": (1, 4, 4, 32, 256, torch.float32),
    "dk32_rep16": (4, 16, 1, 32, 700, torch.bfloat16),
}


def plan_of(name):
    return att.decode_plan(*SHAPES[name][:5])


def lengths_of(S):
    """0, 1, the edges of the first tiles, half of S, S-1 and S."""
    tile = att.DECODE_TILE
    out = {0, 1, tile - 1, tile, tile + 1, 2 * tile - 1, 2 * tile,
           2 * tile + 1, S // 2, S - 1, S}
    return sorted(n for n in out if n <= S)


def split_ranges(length, splits, tile=att.DECODE_TILE):
    """The kernel's SplitCut: the slot runs [s0, s1) of a row with `length`
    visible slots under `splits` blocks. Its ceil(length / tile) tiles go
    to min(splits, tiles) blocks, block sp taking tiles [sp * tiles // used,
    (sp + 1) * tiles // used); the other blocks exit at once."""
    tiles = -(-length // tile)
    used = min(splits, tiles)
    cut = [sp * tiles // used for sp in range(used + 1)] if used else []
    return [(cut[i] * tile, min(cut[i + 1] * tile, length)) for i in range(used)]


def warp_slots(s0, s1, warp, tile=att.DECODE_TILE):
    """The slots warp `warp` scores in the run [s0, s1): WARP_SLOTS of each
    tile, from the tile's slot WARP_SLOTS * warp; a sub-tile that starts at
    or past s1 is skipped, one that ends past it is cut (its tail
    zero-filled and masked)."""
    out = []
    for t0 in range(s0, s1, tile):
        start = t0 + warp * WARP_SLOTS
        out += range(start, min(start + WARP_SLOTS, s1))
    return out


def query_heads(H, Hkv):
    """The query heads a block holds: rep rounded up to 1, 8 or 16 (the
    kernel's MR; the padding heads are zero queries)."""
    rep = H // Hkv
    return 1 if rep == 1 else 8 if rep <= 8 else 16


def ring_bytes(H, Hkv, dk, dtype):
    """A block's dynamic shared memory: 4 warps' rings of STAGES
    sub-tiles of 8 K and 8 V rows in the cache's dtype, and the query heads
    in f32 (the kernel's Geo and smem_bytes)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    return STAGES * att.DECODE_TILE * 2 * dk * esize \
        + 4 * query_heads(H, Hkv) * dk


CASES = [(name, n) for name, shape in SHAPES.items() for n in lengths_of(shape[4])]


def check_cut(plan, length):
    for splits in (plan.splits, 1):   # K4's plan, and K3's single pass
        runs = split_ranges(length, splits)
        # the blocks that run: at most `splits`, none empty, whole tiles,
        # shares within one tile of each other
        assert len(runs) <= splits and len(runs) == min(splits, -(-length // plan.tile))
        assert all(b > a and a % plan.tile == 0 for a, b in runs)
        assert all(a < length for a, _ in runs)   # warp 0 sees a visible slot
        sizes = [-(-(b - a) // plan.tile) for a, b in runs]
        assert not sizes or max(sizes) - min(sizes) <= 1
        # every visible slot in exactly one (split, warp), none past length
        seen = [s for a, b in runs for w in range(WARPS) for s in warp_slots(a, b, w)]
        assert sorted(seen) == list(range(length))


@pytest.mark.parametrize("name,length", CASES)
def test_every_visible_slot_lies_in_exactly_one_split_and_warp(name, length):
    check_cut(plan_of(name), length)


def test_first_response_lengths_73_to_123():
    """first_response's rows see 73..123 of S = 2048 slots: 3 or 4 tiles
    against one split (one pass a row), and against the 8 splits of the
    narrow heads' plan, where blocks past a row's tiles exit at once."""
    for name in ("first_response", "short_rows"):
        plan = plan_of(name)
        for length in range(73, 124):
            check_cut(plan, length)
            assert len(split_ranges(length, plan.splits)) == min(
                plan.splits, -(-length // plan.tile))


@pytest.mark.parametrize("name", list(SHAPES))
def test_workspace_holds_every_split_partial(name):
    """A block's partial of (row b, kv head hk, split sp): rep rows of dk
    accumulators at ((b * Hkv + hk) * splits + sp) * rep, then the maxima,
    then the sums (the kernel's and the merge's indexing); the merge takes
    a lane a split."""
    B, H, Hkv, dk, S, _ = SHAPES[name]
    plan = plan_of(name)
    rep, splits = H // Hkv, plan.splits
    assert 1 <= splits <= att.DECODE_MAX_SPLITS <= 32
    if splits == 1:
        assert plan.workspace_floats == 0
        return
    n_part = B * Hkv * splits * rep
    last = ((B - 1) * Hkv + Hkv - 1) * splits + splits - 1
    top = max((last * rep + rep - 1) * dk + dk - 1,      # accumulators
              n_part * dk + last * rep + rep - 1,        # maxima
              n_part * (dk + 1) + last * rep + rep - 1)  # sums
    assert top + 1 == plan.workspace_floats == B * H * splits * (dk + 2)
    assert 4 * plan.workspace_floats <= 4 * 2 ** 20   # within the smallest workspace


@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_puts_about_one_block_on_each_sm_and_fits_a_block(name):
    """B * Hkv * splits is the multiple of B * Hkv nearest the 132 SMs,
    unless S's tiles or DECODE_MAX_SPLITS cap it, and never below one split;
    a block's ring fits its shared memory, whatever the cache's dtype."""
    B, H, Hkv, dk, S, dtype = SHAPES[name]
    plan = plan_of(name)
    bh, cap = B * Hkv, min(att.DECODE_MAX_SPLITS, -(-S // plan.tile))
    want = min(range(1, SMS + 1), key=lambda n: (abs(bh * n - SMS), -n))
    assert plan.splits == max(1, min(cap, want))
    assert abs(bh * want - SMS) <= bh / 2 or want == 1
    smem = ring_bytes(H, Hkv, dk, dtype)
    assert smem <= SMEM_PER_BLOCK
    # the 4 warps' partials (m, l and rep x dk accumulators) reuse the ring;
    # a block holds at most 16 query heads and 1024 // dk
    max_rep = min(1024 // dk, 16)
    assert H // Hkv <= query_heads(H, Hkv) <= max_rep
    assert WARPS * max_rep * (dk + 2) * 4 <= smem - 4 * query_heads(H, Hkv) * dk


def test_plan_at_the_serving_shapes():
    """The speech decoder's 8 rows of 14 kv heads (the phase-7 pool,
    first_response): one block a (row, head), 112 in all, no merge and no
    workspace; the phase-9 pool's 4 rows: 2 blocks, which cut 1295 visible
    slots (41 tiles) 20 / 21 tiles; the LLM's text decode: 4 blocks a (row,
    kv head), 128 in all; the narrow heads: 8, of which a row of 73 slots
    uses 3 (one tile each)."""
    for name in ("pool", "first_response"):
        assert plan_of(name) == (32, 1, 0)
    assert split_ranges(309, 1) == [(0, 309)]
    assert plan_of("service_pool").splits == 2
    assert split_ranges(1295, 2) == [(0, 640), (640, 1295)]
    assert plan_of("llm_bf16").splits == 4
    assert plan_of("short_rows").splits == 8
    assert split_ranges(73, 8) == [(0, 32), (32, 64), (64, 73)]
    # one session (B = 1): the LLM's 4 kv heads take 32 splits, a merge and
    # 1 x 28 x 32 x 130 floats (466 KB) of the 4 MB workspace; the speech
    # decoder's 14 heads take 9 splits
    assert plan_of("session_llm") == (32, 32, 116480)
    assert plan_of("session_tts") == (32, 9, 14 * 9 * 66)
    # a short S caps the splits at its tiles
    assert att.decode_plan(2, 14, 14, 64, 40).splits == 2


def test_cpu_tensors_take_the_plain_version_at_first_response_lengths():
    """first_response's lengths (73..123 visible of S) with NaN in every
    slot past them: on CPU tensors K3 and K4 run the plain version and
    launch nothing; `block` must be > 0 on every device."""
    rng = np.random.RandomState(0)
    B, H, Hkv, dk, S = 8, 14, 14, 64, 160
    q = torch.from_numpy(rng.randn(B, H, dk).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(B, S, Hkv, dk).astype(np.float32))
            for _ in range(2))
    length = torch.linspace(73, 123, B).round().to(torch.int32)
    for b, n in enumerate(length.tolist()):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    before = (att.decode_attention.launches, att.decode_attention_blocked.launches)
    ref = att.decode_attention_reference(q, k, v, length)
    assert torch.isfinite(ref).all()
    for fn in (att.decode_attention, att.decode_attention_blocked, att.gqa_decode):
        torch.testing.assert_close(fn(q, k, v, length), ref, rtol=0, atol=0)
    assert (att.decode_attention.launches,
            att.decode_attention_blocked.launches) == before
    for block in (0, -256):
        with pytest.raises(ValueError, match="block"):
            att.decode_attention_blocked(q, k, v, length, block=block)
