"""The tile path of K1 and K5 (csrc/wonly_tile.cuh) as far as the CPU
reaches it: the launch plan (`tile_plan`), the block's shared memory and the
split workspace it implies, and the plain versions that CPU tensors take.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import math

import numpy as np
import pytest
import torch

from freeze_omni_tpu_torch.ops import quant_matmul as qm

SMS = 132
SHAPES = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
          (3584, 152064)]   # q/o, k/v, gate/up, down, the lm_head
KERNELS = [("K1", None), ("K5", 64), ("K5", 128)]


@pytest.mark.parametrize("kernel,group", KERNELS)
@pytest.mark.parametrize("N", [17, 89, 232, 1856])
@pytest.mark.parametrize("K,O", SHAPES)
def test_tile_plan_covers_k_once_fills_the_card_and_fits(K, O, N, kernel, group):
    nt, wr, splits, kps = qm.tile_plan(N, K, O, group)
    assert nt in (1, 2, 4) and wr in (1, 2) and N <= 32 or (nt, wr) == (4, 2)
    steps = -(-K // qm.TILE_K)
    # split s covers K steps [s * kps, min(steps, (s + 1) * kps)): none
    # empty, K exactly once (the kernel's own arithmetic), whole groups
    covered = []
    for s in range(splits):
        k0, k1 = s * kps * qm.TILE_K, min(K, (s + 1) * kps * qm.TILE_K)
        assert k1 > k0
        if group is not None:
            assert k0 % group == 0 and k1 % group == 0
        covered += list(range(k0, k1))
    assert covered == list(range(K))
    # the grid fills the card wherever its tiles and K steps allow
    rows, cols = 8 * nt * wr, 64 * (4 // wr)
    tiles = -(-N // rows) * -(-O // cols)
    unit = 1 if group is None else math.lcm(qm.TILE_K, group) // qm.TILE_K
    assert tiles * splits >= min(SMS, tiles * -(-steps // unit))
    assert splits == 1 or tiles < 2 * SMS
    # the block's ring fits its shared memory, and the partials the budget
    assert qm.tile_smem_bytes(nt, wr, kernel == "K5") <= qm.SMEM_PER_BLOCK
    ws = 4 * splits * N * O if splits > 1 else 0
    assert ws <= qm.TILE_WORKSPACE_BYTES <= 20 * 2 ** 20


def test_tile_plan_at_the_tick():
    """N = 232: 2 x 2 warps (64 rows x 128 columns); the narrow and the deep
    projections split, gate/up (592 tiles) do not."""
    assert qm.tile_plan(232, 3584, 18944, 64) == (4, 2, 1, 56)
    for K, O in ((3584, 3584), (3584, 512), (18944, 3584)):
        nt, wr, splits, kps = qm.tile_plan(232, K, O, 64)
        assert (nt, wr) == (4, 2) and splits > 1
    # text decode (K1 at N = 8): one warp row of 8 rows, 256 columns
    assert qm.tile_plan(8, 3584, 152064)[:3] == (1, 1, 1)


@pytest.mark.parametrize("N", [8, 232])
def test_cpu_tensors_take_the_plain_version_k1(N):
    rng = np.random.RandomState(N)
    x = torch.from_numpy(rng.randn(N, 96).astype(np.float32))
    w_q = torch.from_numpy(rng.randint(-128, 128, (96, 40)).astype(np.int8))
    scale = torch.from_numpy(rng.rand(40).astype(np.float32))
    before = qm.quant_matmul.launches
    y = qm.quant_matmul(x, w_q, scale)
    assert qm.quant_matmul.launches == before
    torch.testing.assert_close(y, qm.quant_matmul_reference(x, w_q, scale),
                               rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_k5_tile_size():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(89, 128).astype(np.float32)).to(torch.bfloat16)
    w_q4 = torch.from_numpy(rng.randint(0, 256, (64, 40)).astype(np.uint8))
    scale4 = torch.from_numpy(rng.rand(2, 40).astype(np.float32))
    total, small = qm.quant_matmul4.launches, qm.quant_matmul4.launches_small
    y = qm.quant_matmul4(x, w_q4, scale4, 64)
    assert (qm.quant_matmul4.launches, qm.quant_matmul4.launches_small) == (total, small)
    torch.testing.assert_close(y, qm.quant_matmul4_reference(x, w_q4, scale4, 64),
                               rtol=0, atol=0)
