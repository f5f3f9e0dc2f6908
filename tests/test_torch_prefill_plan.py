"""K2's bf16 kernel (csrc/prefill_quant.cu) as far as the CPU reaches it:
the launch plan (`prefill_plan`), the cut of the visible slots into splits
that the kernel makes on the card (`split_ranges`, `splits_seen` below
state it), the block's shared memory and the workspace the plan implies,
and the plain version that CPU tensors take. The kernel itself runs only
on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from freeze_omni_tpu_torch.ops import attention as att

SMS = 132
SMEM_PER_BLOCK = 227 * 1024   # an H100 block's shared memory, at most
TICK_VALID = [8, 9, 10, 11, 25, 26, 27, 28]   # a dual tick's valid tokens of 29
# (B, T, H, Hkv, dk, S, valid tokens a row): the tick, the text step, the
# role prefill (B = 8 and B = 2) at flagship attention widths, and the tiny
# widths of the card tests
SHAPES = [(8, 29, 28, 4, 128, S, 8) for S in (1024, 2048)] + \
    [(8, 1, 28, 4, 128, S, 1) for S in (1024, 2048)] + \
    [(B, 89, 28, 4, 128, S, 89) for B in (8, 2) for S in (1024, 2048)] + \
    [(3, 6, 8, 2, 64, 100, 6)]


def split_ranges(visible, splits):
    """The kernel's SplitCut: the slot runs [s0, s1) of a row tile whose
    largest qend is `visible` and that takes `splits` splits. Its
    ceil(visible / 64) tiles go to min(splits, tiles) runs of whole tiles,
    run sp taking tiles [sp * tiles // used, (sp + 1) * tiles // used)."""
    tiles = -(-visible // att.PREFILL_TILE)
    used = min(splits, tiles)
    cut = [sp * tiles // used * att.PREFILL_TILE for sp in range(used + 1)]
    return [(cut[i], min(cut[i + 1], visible)) for i in range(used)]


def splits_seen(qe, visible, splits):
    """SplitCut::seen_by: how many of split_ranges(visible, splits) the
    merge adds for a row with qend qe."""
    tiles = -(-visible // att.PREFILL_TILE)
    used = min(splits, tiles)
    return (-(-qe // att.PREFILL_TILE) * used + tiles - 1) // tiles


def ring_bytes(dk):
    """A bf16 block's dynamic shared memory: 3 stages of 64-slot tiles of
    int8 K and V rows (padded to 144 bytes at dk 128; 64 and 80 at dk 64)
    and their two f32 scales (the kernel's TcGeo)."""
    kstr, vstr = (144, 144) if dk == 128 else (64, 80)
    return 3 * att.PREFILL_TILE * (kstr + vstr + 8)


@pytest.mark.parametrize("B,T,H,Hkv,dk,S,valid", SHAPES)
def test_prefill_plan_covers_rows_and_slots_once_fills_the_card_and_fits(
        B, T, H, Hkv, dk, S, valid):
    plan = att.prefill_plan(B, T, H, Hkv, dk, S)
    rep = H // Hkv
    # row tiles of 16, 32 or 64 compacted rows; the kernel deals the units
    # of the valid rows' tiles over the blocks: each unit exactly once
    assert plan.rows in (16, 32, 64) and (plan.rows == 64 or T * rep <= plan.rows)
    tiles = -(-valid * rep // plan.rows)
    per_tile = min(plan.tile_splits, max(1, plan.splits // tiles))
    assert plan.tile_splits in (1, plan.splits)
    dealt = sorted(u for blk in range(plan.splits)
                   for u in range(blk, tiles * per_tile, plan.splits))
    assert dealt == list(range(tiles * per_tile))
    assert per_tile == 1 or tiles * per_tile <= plan.splits   # a partial slot each
    # at every visible length the splits cover [0, visible) once in runs of
    # whole 64-slot tiles, none empty; a row with qend qe sees exactly the
    # first splits_seen(qe, ...) of them
    for visible in sorted({1, 63, 64, 65, S // 3, S // 2 + 1, S - 1, S}):
        runs = split_ranges(visible, per_tile)
        assert 1 <= len(runs) <= per_tile
        assert [s for a, b in runs for s in range(a, b)] == list(range(visible))
        assert all(a % att.PREFILL_TILE == 0 and b > a for a, b in runs)
        for qe in range(1, visible + 1, max(1, visible // 37)):
            seen = [i for i, (a, _) in enumerate(runs) if a < qe]
            assert seen == list(range(splits_seen(qe, visible, per_tile)))
    # the blocks fill the card wherever S's tiles allow
    assert B * Hkv * plan.splits >= min(SMS, B * Hkv * -(-S // att.PREFILL_TILE))
    # the partials fit the budget, the ring a block's shared memory
    assert plan.workspace_floats == (B * Hkv * plan.splits * plan.rows * (dk + 2)
                                     if plan.tile_splits > 1 else 0)
    assert 4 * plan.workspace_floats <= att.PREFILL_WORKSPACE_BYTES <= 9 * 2 ** 20
    assert ring_bytes(dk) <= SMEM_PER_BLOCK


def test_prefill_plan_at_the_serving_shapes():
    """The tick: 8 blocks of 4 warps a (b, kv head), 256 in all (two an
    SM), which split the one row tile of 56 rows (545 visible slots: 7
    splits of one tile, one of two); the text step: 16 blocks of one warp
    (four an SM), one tile each; the role prefill deals its ten row tiles
    a (b, kv head) over 8 blocks, one split each, with no merge pass and
    no workspace."""
    tick = att.prefill_plan(8, 29, 28, 4, 128, 1024)
    assert (tick.rows, tick.splits, tick.tile_splits) == (64, 8, 8)
    assert split_ranges(545, 8) == [(64 * i, 64 * i + 64) for i in range(7)] \
        + [(448, 545)]
    text = att.prefill_plan(8, 1, 28, 4, 128, 1024)
    assert (text.rows, text.splits, text.tile_splits) == (16, 16, 16)
    assert len(split_ranges(545, 16)) == 9
    role = att.prefill_plan(8, 89, 28, 4, 128, 1024)
    assert (role.rows, role.splits, role.tile_splits) == (64, 8, 1)
    assert role.workspace_floats == 0


def test_cpu_tensors_take_the_plain_version_at_the_tick_mask():
    """A tick-shaped qend (8 of 29 tokens valid) on CPU tensors: the wrapper
    runs the plain version, launches nothing, and the masked queries come
    out as zeros."""
    rng = np.random.RandomState(0)
    B, T, H, Hkv, dk, S = 2, 29, 8, 2, 64, 96
    q = torch.from_numpy(rng.randn(B, T, H, dk).astype(np.float32)).to(torch.bfloat16)
    k_q, v_q = (torch.from_numpy(rng.randint(-128, 128, (B, S, Hkv, dk)).astype(np.int8))
                for _ in range(2))
    k_s, v_s = (torch.from_numpy((0.01 + 0.05 * rng.rand(B, S, Hkv)).astype(np.float32))
                for _ in range(2))
    k_s[:, S - 1] = float("nan")
    v_s[:, S - 1] = float("inf")
    qend = torch.zeros((B, T), dtype=torch.int32)
    qend[:, TICK_VALID] = (torch.tensor([40, 70])[:, None]
                           + torch.arange(1, 9)).to(torch.int32)
    before = att.prefill_quant.launches
    out = att.prefill_quant(q, k_q, k_s, v_q, v_s, qend)
    assert att.prefill_quant.launches == before
    ref = att.prefill_quant_reference(q, k_q, k_s, v_q, v_s, qend)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    valid = qend > 0
    assert int(valid.sum()) == 2 * 8
    assert torch.isfinite(out.float()).all() and (out[~valid] == 0).all()
