"""K5's small-N path as far as the CPU reaches it: the launch plan
(`small_plan`), the dispatch by N (`takes_small_path`) and the plain version
that CPU tensors take. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from freeze_omni_tpu_torch.ops import quant_matmul as qm

SMS = 132
SHAPES = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
          (3584, 152064)]   # q/o, k/v, gate/up, down, the int4 lm_head


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("N", [1, 8, 16])
@pytest.mark.parametrize("K,O", SHAPES)
def test_small_plan_covers_k_in_whole_groups_and_fills_the_card(K, O, N, group):
    warps, splits = qm.small_plan(N, K, O, group)
    G = K // group
    gps = -(-G // splits)
    assert warps in (1, 2, 4)
    # split s covers groups [s * gps, min(G, (s + 1) * gps)): whole groups,
    # none empty, K exactly once (the kernel's own arithmetic)
    covered = []
    for s in range(splits):
        g0, g1 = s * gps, min(G, (s + 1) * gps)
        assert g1 > g0
        covered += list(range(g0 * group, g1 * group))
    assert covered == list(range(K))
    slabs = -(-O // 128)                    # 128-column warp slabs
    blocks = -(-slabs // warps) * splits
    assert blocks >= min(SMS, slabs * G)
    # a split's x slice fits the block's shared-memory budget
    rows = next(r for r in (4, 8, 16, 32) if N <= r)
    assert gps * group * rows * 4 <= max(qm._X_SLICE_BYTES, group * rows * 4)


def test_dispatch_takes_the_small_path_exactly_up_to_small_n():
    assert 8 <= qm.SMALL_N <= 16 <= qm.SMALL_N_MAX
    for N in range(1, 300):
        assert qm.takes_small_path(N, 64) == (N <= qm.SMALL_N)
    assert not qm.takes_small_path(0, 64)
    # a group whose x slice cannot fit shared memory stays on the tile path
    assert not qm.takes_small_path(1, 4096)


@pytest.mark.parametrize("N", [1, 8, 232])
def test_cpu_tensors_take_the_plain_version(N):
    rng = np.random.RandomState(N)
    x = torch.from_numpy(rng.randn(N, 128).astype(np.float32))
    w_q4 = torch.from_numpy(rng.randint(0, 256, (64, 40)).astype(np.uint8))
    scale4 = torch.from_numpy(rng.rand(2, 40).astype(np.float32))
    total, small = qm.quant_matmul4.launches, qm.quant_matmul4.launches_small
    y = qm.quant_matmul4(x, w_q4, scale4, 64)
    assert (qm.quant_matmul4.launches, qm.quant_matmul4.launches_small) == (total, small)
    torch.testing.assert_close(y, qm.quant_matmul4_reference(x, w_q4, scale4, 64),
                               rtol=0, atol=0)
