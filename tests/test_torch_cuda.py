"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.

Every test here is marked `cuda` and skips without a CUDA device (decided
inside the `cuda` fixture, never at import). The machine with the card has no
JAX, so this file imports none; run it there with

    pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX for the CPU suite).
Tolerances: f32 activations compare at 1e-4 (the kernels change only the
order of f32 sums and apply the scales after the dot instead of before);
bf16 activations at rtol = atol = 2e-2 (one bf16 rounding of the output).
Masked rows (qend = 0, length = 0) are compared to zero, not to the plain
version's values.
"""

import numpy as np
import pytest
import torch

from freeze_omni_tpu_torch.ops import _build
from freeze_omni_tpu_torch.ops import attention as att
from freeze_omni_tpu_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the H100 with "
                    "`pytest --noconftest -m cuda tests/test_torch_cuda.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qm_inputs(N, K, O, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((N, K), generator=g).to(dtype)
    w_q = torch.randint(-127, 128, (K, O), generator=g, dtype=torch.int8)
    scale = (torch.rand(O, generator=g) + 0.5) / (127.0 * K ** 0.5)
    return x.to(device), w_q.to(device), scale.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K,O", [
    (1, 3584, 512), (89, 3584, 3584), (232, 3584, 18944), (232, 18944, 3584),
    (1856, 3584, 512),
    (7, 200, 131),     # ragged K and O (O % 4 != 0: scalar weight loads)
    (65, 96, 130),     # ragged N just past one row block
])
def test_quant_matmul_matches_plain(cuda, dtype, N, K, O):
    x, w_q, scale = _qm_inputs(N, K, O, dtype, cuda)
    before = qm.quant_matmul.launches
    y = qm.quant_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert qm.quant_matmul.launches == before + 1
    ref = qm.quant_matmul_reference(x, w_q, scale)
    assert y.dtype == dtype and y.shape == (N, O)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)


def test_linear_takes_a_strided_activation(cuda):
    """The last position of a prefill (hidden[:, -1], a strided view) goes
    through K1 like a dense one."""
    from freeze_omni_tpu_torch.models.layers import linear

    _, w_q, scale = _qm_inputs(1, 96, 130, torch.bfloat16, cuda)
    hidden = torch.randn((3, 5, 96), device=cuda).to(torch.bfloat16)
    before = qm.quant_matmul.launches
    y = linear({"w_q": w_q, "scale": scale}, hidden[:, -1])
    torch.cuda.synchronize()
    assert qm.quant_matmul.launches == before + 1
    ref = qm.quant_matmul_reference(hidden[:, -1].contiguous(), w_q, scale)
    torch.testing.assert_close(y.float(), ref.float(), rtol=2e-2, atol=2e-2)


def _q4_inputs(N, K, O, group, dtype, device, seed=0):
    """Packed bytes drawn over all of 0..255, so both nibbles take every
    value, 0 (weight -8) included."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((N, K), generator=g).to(dtype)
    w_q4 = torch.randint(0, 256, (K // 2, O), generator=g, dtype=torch.uint8)
    scale4 = (torch.rand((K // group, O), generator=g) + 0.5) / (7.0 * K ** 0.5)
    return x.to(device), w_q4.to(device), scale4.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K,O,group", [
    (1, 3584, 512, 64), (8, 3584, 3584, 64), (89, 3584, 18944, 64),
    (232, 18944, 3584, 64), (1856, 3584, 512, 64),
    (232, 3584, 3584, 128),    # the coarser group of tests/test_quant.py
    (8, 3584, 152064, 64),     # the int4 lm_head of quantize_llm_params
    (7, 200, 131, 10),         # K not a multiple of the K step; O % 4 != 0
    (65, 96, 130, 32),         # ragged N just past one row block
])
def test_quant_matmul4_matches_plain(cuda, dtype, N, K, O, group):
    x, w_q4, scale4 = _q4_inputs(N, K, O, group, dtype, cuda)
    before = qm.quant_matmul4.launches
    y = qm.quant_matmul4(x, w_q4, scale4, group)
    torch.cuda.synchronize()
    assert qm.quant_matmul4.launches == before + 1
    ref = qm.quant_matmul4_reference(x, w_q4, scale4, group)
    assert y.dtype == dtype and y.shape == (N, O)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)


def _q4_inputs_nib0(N, K, O, group, dtype, device, seed=0):
    """_q4_inputs with a first tile of nibble-0 bytes (weight -8, which the
    quantizer never writes but the kernel must compute)."""
    x, w_q4, scale4 = _q4_inputs(N, K, O, group, dtype, device, seed)
    w_q4[:32, :128] = 0
    return x, w_q4, scale4


SMALL_CASES = [(K, O, N, 64) for (K, O) in (
    (3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (3584, 152064))
    for N in (1, 2, 3, 5, 8, qm.SMALL_N)] + [
    (3584, 3584, 8, 128),      # the coarser group
    (3776, 520, 5, 64),        # 59 groups over the splits; O % 16 != 0
    (200, 131, 3, 10),         # a group of 5 packed rows; bytewise loads
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,O,N,group", SMALL_CASES)
def test_quant_matmul4_small_path_matches_plain(cuda, dtype, K, O, N, group):
    """N <= SMALL_N takes the split-K path, agrees with the plain version
    and gives bit-identical outputs from call to call."""
    assert qm.takes_small_path(N, group)
    x, w_q4, scale4 = _q4_inputs_nib0(N, K, O, group, dtype, cuda, seed=N + O)
    total, small = qm.quant_matmul4.launches, qm.quant_matmul4.launches_small
    y = qm.quant_matmul4(x, w_q4, scale4, group)
    y2 = qm.quant_matmul4(x, w_q4, scale4, group)
    torch.cuda.synchronize()
    assert qm.quant_matmul4.launches == total + 2
    assert qm.quant_matmul4.launches_small == small + 2
    assert torch.equal(y, y2)
    ref = qm.quant_matmul4_reference(x, w_q4, scale4, group)
    assert y.dtype == dtype and y.shape == (N, O)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)


PROJ = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))
TILE_NS = (17, 89, 232, 233, 1856)
TILE_CASES = [("K5", K, O, N, 64) for (K, O) in PROJ for N in TILE_NS] + [
    ("K5", 3584, 3584, 17, 128), ("K5", 3584, 3584, 232, 128),   # coarser group
    ("K5", 18944, 3584, 232, 128),     # K = 18944, split in whole groups of 128
    ("K5", 3776, 520, 17, 64), ("K5", 3776, 520, 232, 64),   # ragged O
] + [("K1", K, O, N, None) for (K, O) in PROJ for N in (1, 8) + TILE_NS] + [
    ("K1", 3584, 152064, 8, None), ("K1", 3584, 152064, 89, None),   # lm_head
    ("K1", 3776, 520, 17, None), ("K1", 3776, 520, 232, None),      # ragged O
]


@pytest.mark.parametrize("kernel,K,O,N,group", TILE_CASES)
def test_tile_path_matches_plain(cuda, kernel, K, O, N, group):
    """The mma.sync tile path (bf16) of K5 at N > SMALL_N and of K1 at every
    N agrees with the plain version, gives bit-identical outputs from two
    calls, and counts one launch a call (K5's small path none). K5's
    weights have a tile of nibble 0; K1's hold -128 and 127."""
    if kernel == "K5":
        assert not qm.takes_small_path(N, group)
        x, w, s = _q4_inputs_nib0(N, K, O, group, torch.bfloat16, cuda, seed=N + O)
        fn = qm.quant_matmul4
        run = lambda: fn(x, w, s, group)   # noqa: E731
        ref = qm.quant_matmul4_reference(x, w, s, group)
    else:
        x, w, s = _qm_inputs(N, K, O, torch.bfloat16, cuda, seed=N + O)
        w[:16, :64] = -128
        w[16:32, :64] = 127
        fn = qm.quant_matmul
        run = lambda: fn(x, w, s)   # noqa: E731
        ref = qm.quant_matmul_reference(x, w, s)
    total = fn.launches
    small = qm.quant_matmul4.launches_small
    y = run()
    y2 = run()
    torch.cuda.synchronize()
    assert fn.launches == total + 2
    assert qm.quant_matmul4.launches_small == small
    assert torch.equal(y, y2)
    assert y.dtype == torch.bfloat16 and y.shape == (N, O)
    torch.testing.assert_close(y.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("N", [12, 24, 32])
def test_quant_matmul4_paths_agree_when_forced(cuda, N):
    """Both paths forced at one N (as the crossover timing runs them) give
    the plain version's result; the tick sizes take the tile path."""
    x, w_q4, scale4 = _q4_inputs_nib0(N, 3584, 3584, 64, torch.bfloat16, cuda)
    ref = qm.quant_matmul4_reference(x, w_q4, scale4, 64).float()
    for path in ("small", "tile"):
        small = qm.quant_matmul4.launches_small
        y = qm.quant_matmul4(x, w_q4, scale4, 64, path=path)
        torch.cuda.synchronize()
        assert qm.quant_matmul4.launches_small == small + (path == "small")
        torch.testing.assert_close(y.float(), ref, rtol=2e-2, atol=2e-2)
    for n in (89, 232):
        assert not qm.takes_small_path(n, 64)


def test_quant_matmul4_small_path_rejects_malformed_input(cuda):
    x, w_q4, scale4 = _q4_inputs(4, 128, 64, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="group"):
        qm.quant_matmul4(x, w_q4, scale4, 32)
    with pytest.raises(ValueError, match="path"):
        qm.quant_matmul4(x, w_q4, scale4, 64, path="fast")
    big = torch.zeros((qm.SMALL_N_MAX + 1, 128), dtype=torch.bfloat16,
                      device=cuda)
    with pytest.raises(ValueError, match="small-N"):
        qm.quant_matmul4(big, w_q4, scale4, 64, path="small")
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul4(x.t().contiguous().t(), w_q4, scale4, 64)


def test_linear_takes_a_strided_activation_int4(cuda):
    """A w_q4 leaf goes through K5 for a strided view like a dense one."""
    from freeze_omni_tpu_torch.models.layers import linear

    _, w_q4, scale4 = _q4_inputs(1, 128, 130, 64, torch.bfloat16, cuda)
    hidden = torch.randn((3, 5, 128), device=cuda).to(torch.bfloat16)
    b = torch.randn(130, device=cuda)
    k1, k5 = qm.quant_matmul.launches, qm.quant_matmul4.launches
    y = linear({"w_q4": w_q4, "scale4": scale4, "b": b}, hidden[:, -1])
    torch.cuda.synchronize()
    assert qm.quant_matmul4.launches == k5 + 1
    assert qm.quant_matmul.launches == k1
    assert y.dtype == torch.bfloat16
    ref = qm.quant_matmul4_reference(hidden[:, -1].contiguous(), w_q4, scale4,
                                     64) + b.to(torch.bfloat16)
    torch.testing.assert_close(y.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_quant_matmul4_rejects_what_the_kernel_does_not_take(cuda):
    x, w_q4, scale4 = _q4_inputs(4, 128, 64, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul4(x.t().contiguous().t(), w_q4, scale4, 64)
    with pytest.raises(TypeError):
        qm.quant_matmul4(x.half(), w_q4, scale4, 64)
    with pytest.raises(TypeError, match="uint8"):
        qm.quant_matmul4(x, w_q4.to(torch.int8), scale4, 64)
    with pytest.raises(ValueError, match="group"):
        qm.quant_matmul4(x, w_q4, scale4, 32)
    with pytest.raises(ValueError, match="devices"):
        qm.quant_matmul4(x, w_q4.cpu(), scale4, 64)


def _pq_inputs(B, T, H, Hkv, dk, S, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, T, H, dk).astype(np.float32)).to(dtype)
    k_q = torch.from_numpy(rng.randint(-127, 128, (B, S, Hkv, dk)).astype(np.int8))
    v_q = torch.from_numpy(rng.randint(-127, 128, (B, S, Hkv, dk)).astype(np.int8))
    k_s = torch.from_numpy(0.01 + rng.rand(B, S, Hkv).astype(np.float32) * 0.05)
    v_s = torch.from_numpy(0.01 + rng.rand(B, S, Hkv).astype(np.float32) * 0.05)
    # ragged visibility as in a tick: per-row lengths, some invalid queries
    # (qend = 0) and one row with no valid query at all
    lengths = rng.randint(S // 8, S - T - 1, size=B)
    qend = lengths[:, None] + np.arange(1, T + 1)[None, :]
    qend[rng.rand(B, T) < 0.3] = 0
    qend[-1] = 0
    # the scratch slot S-1 may hold anything: it must never reach a product
    k_s[:, S - 1] = float("nan")
    v_s[:, S - 1] = float("inf")
    t = [x.to(device) for x in (q, k_q, k_s, v_q, v_s)]
    return (*t, torch.from_numpy(qend.astype(np.int32)).to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,Hkv,dk,S", [
    (8, 29, 28, 4, 128, 1024), (8, 29, 28, 4, 128, 2048),
    (2, 89, 28, 4, 128, 1024),   # the role prefill
    (3, 6, 8, 2, 64, 100),       # tiny widths, S not a multiple of the tile
])
def test_prefill_quant_matches_plain(cuda, dtype, B, T, H, Hkv, dk, S):
    q, k_q, k_s, v_q, v_s, qend = _pq_inputs(B, T, H, Hkv, dk, S, dtype, cuda)
    before = att.prefill_quant.launches
    out = att.prefill_quant(q, k_q, k_s, v_q, v_s, qend)
    torch.cuda.synchronize()
    assert att.prefill_quant.launches == before + 1
    ref = att.prefill_quant_reference(q, k_q, k_s, v_q, v_s, qend)
    valid = qend > 0
    assert torch.isfinite(out.float()).all()
    assert (out[~valid] == 0).all()
    tol = TOL[dtype]
    torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                               rtol=tol, atol=tol)


TICK_VALID = [8, 9, 10, 11, 25, 26, 27, 28]   # a dual tick's valid tokens of 29


def _tick_qend(lengths, T=29):
    """A regular tick's qend: the valid tokens of each row see the row's
    cache and the valid tokens before them; the others are masked (0)."""
    qend = np.zeros((len(lengths), T), np.int64)
    for rank, t in enumerate(TICK_VALID):
        qend[:, t] = np.asarray(lengths) + rank + 1
    return qend


def _k2_case(case, rng):
    """(B, T, H, Hkv, dk, S, qend) of one bf16 case of K2."""
    if case == "text_step":      # T = 1, qend = length + 1, one row at S-1
        S = 1024
        lengths = rng.randint(1, S - 2, size=8)
        lengths[0] = S - 2
        return 8, 1, 28, 4, 128, S, (lengths + 1)[:, None]
    if case == "tick_mask":      # 8 of 29 valid, one row with no valid query
        S = 1024
        qend = _tick_qend(rng.randint(S // 4, S - 40, size=8))
        qend[3] = 0
        return 8, 29, 28, 4, 128, S, qend
    if case == "role_prefill":   # T = 89 at B = 2: every token valid
        return 2, 89, 28, 4, 128, 1024, np.stack([np.arange(1, 90),
                                                  np.arange(301, 390)])
    if case == "role_prefill_b8":   # B = 8: one split a row tile, which
        # writes the output itself (10 row tiles over the blocks)
        assert att.prefill_plan(8, 89, 28, 4, 128, 1024).tile_splits == 1
        return 8, 89, 28, 4, 128, 1024, \
            np.arange(1, 90)[None, :] + 100 * np.arange(8)[:, None]
    if case == "qend_S_minus_1":  # the last valid token sees all but slot S-1
        S = 2048
        return 4, 29, 28, 4, 128, S, _tick_qend([S - 9, 100, 1500, 7])
    if case == "split_boundary":  # qends at the kernel's split edges +- 1
        B, T, S = 4, 29, 1024
        qmax = 700   # one row tile: it takes every split
        # the kernel's cut: ceil(qmax / 64) tiles over `used` splits, split
        # sp starting at tile sp * tiles // used
        tiles = -(-qmax // 64)
        used = min(att.prefill_plan(B, T, 28, 4, 128, S).tile_splits, tiles)
        e1, e2 = (sp * tiles // used * 64 for sp in (1, 2))
        assert used > 2 and e2 < qmax - 1
        qend = np.zeros((B, T), np.int64)
        qend[:, TICK_VALID] = [e1 - 1, e1, e1 + 1, e2 - 1, e2, e2 + 1,
                               qmax - 1, qmax]
        return B, T, 28, 4, 128, S, qend
    assert case == "tiny_dk64"   # tiny widths, S not a multiple of the tile
    S = 100
    qend = rng.randint(0, S, size=(3, 6))
    qend[0, 0] = 0
    qend[1] = 0
    return 3, 6, 8, 2, 64, S, qend


@pytest.mark.parametrize("case", ["text_step", "tick_mask", "role_prefill",
                                  "role_prefill_b8", "qend_S_minus_1",
                                  "split_boundary", "tiny_dk64"])
def test_prefill_quant_bf16_cases(cuda, case):
    """The tensor-core kernel at the main paths' qend patterns and at its
    own edges: NaN/Inf in slot S-1, valid rows within 2e-2 of the plain
    version, masked rows zero, two calls bit-identical, one launch a call."""
    rng = np.random.RandomState(len(case))
    B, T, H, Hkv, dk, S, qend = _k2_case(case, rng)
    q, k_q, k_s, v_q, v_s, _ = _pq_inputs(B, T, H, Hkv, dk, S, torch.bfloat16,
                                          cuda, seed=len(case))
    qend = torch.from_numpy(np.asarray(qend, np.int32)).to(cuda)
    before = att.prefill_quant.launches
    out = att.prefill_quant(q, k_q, k_s, v_q, v_s, qend)
    out2 = att.prefill_quant(q, k_q, k_s, v_q, v_s, qend)
    torch.cuda.synchronize()
    assert att.prefill_quant.launches == before + 2
    assert torch.equal(out, out2)
    ref = att.prefill_quant_reference(q, k_q, k_s, v_q, v_s, qend)
    valid = qend > 0
    assert torch.isfinite(out.float()).all()
    assert (out[~valid] == 0).all()
    torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                               rtol=2e-2, atol=2e-2)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x, w_q, scale = _qm_inputs(4, 64, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul(x.t().contiguous().t(), w_q, scale)
    with pytest.raises(TypeError):
        qm.quant_matmul(x.half(), w_q, scale)
    q, k_q, k_s, v_q, v_s, qend = _pq_inputs(1, 2, 4, 2, 32, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        att.prefill_quant(q, k_q, k_s, v_q, v_s, qend)
    with pytest.raises(TypeError, match="int32"):
        att.prefill_quant(q, k_q, k_s, v_q, v_s, qend.long())


def _decode_inputs(B, H, Hkv, dk, S, q_dtype, kv_dtype, device, seed=0,
                   lengths=None):
    """Ragged lengths including 0, 1, 255, 256, 257 and S-1 (or `lengths`);
    NaN in the scratch slot S-1 and in every slot at or past a row's
    length."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, H, dk).astype(np.float32)).to(q_dtype)
    k = rng.randn(B, S, Hkv, dk).astype(np.float32)
    v = rng.randn(B, S, Hkv, dk).astype(np.float32)
    special = [0, 1, 255, 256, 257, S - 1] if lengths is None else list(lengths)
    length = np.array([special[i] if i < len(special) else rng.randint(1, S)
                       for i in range(B)], np.int32)
    length = np.minimum(length, S - 1)
    for b, n in enumerate(length):
        k[b, n:] = np.nan
        v[b, n:] = np.nan
    k[:, S - 1] = np.nan
    v[:, S - 1] = np.nan
    t = [torch.from_numpy(x).to(kv_dtype).to(device) for x in (k, v)]
    return q.to(device), t[0], t[1], torch.from_numpy(length).to(device)


def decode_tol(q_dtype):
    """K3/K4's (atol, rtol) against the plain version. bf16: one rounding of
    the output (2^-7 relative) and 1e-3, tight enough to catch a split left
    out or a wrong score (~1e-2 at lengths of a few hundred slots)."""
    return (1e-3, 2 ** -7) if q_dtype == torch.bfloat16 else (TOL[q_dtype],) * 2


DECODE_CASES = [   # B, H, Hkv, dk, S, q dtype, cache dtype
    (8, 28, 4, 128, 1024, torch.bfloat16, torch.bfloat16),   # LLM text decode
    (8, 14, 14, 64, 1265, torch.float32, torch.float32),     # BatchedTTS pool
    (8, 14, 14, 64, 2048, torch.float32, torch.float32),     # first_response
    (6, 28, 4, 128, 300, torch.bfloat16, torch.float32),     # cache wider than q
    (6, 8, 2, 64, 300, torch.float32, torch.bfloat16),
    (6, 4, 4, 32, 256, torch.float32, torch.float32),        # tiny speech decoder
    (6, 16, 1, 32, 300, torch.bfloat16, torch.bfloat16),     # dk 32, rep 16
]


@pytest.mark.parametrize("which", ["decode_attention", "decode_attention_blocked"])
@pytest.mark.parametrize("B,H,Hkv,dk,S,q_dtype,kv_dtype", DECODE_CASES)
def test_decode_attention_matches_plain(cuda, which, B, H, Hkv, dk, S, q_dtype,
                                        kv_dtype):
    q, k, v, length = _decode_inputs(B, H, Hkv, dk, S, q_dtype, kv_dtype, cuda)
    fn = getattr(att, which)
    before = fn.launches
    out = fn(q, k, v, length)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = att.decode_attention_reference(q, k, v, length)
    valid = length > 0
    assert out.dtype == q_dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    assert (out[~valid] == 0).all()
    atol, rtol = decode_tol(q_dtype)
    torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                               rtol=rtol, atol=atol)


F32, BF16 = torch.float32, torch.bfloat16
FIRST_RESPONSE = [73, 80, 87, 94, 102, 109, 116, 123]   # visible of 2048
TILE_EDGES = [0, 1, 31, 32, 33, 64, 309, 464]   # tiles of 32 slots
DECODE_PLAN_CASES = {   # B, H, Hkv, dk, S, q dtype, cache dtype, lengths
    # the phase-7 pool shape: one split (a pass a row, no merge)
    "pool_tile_edges": (8, 14, 14, 64, 465, F32, F32, TILE_EDGES),
    # the same rows under 4 kv heads: 4 splits cut at the tile edges
    "split_tile_edges": (8, 4, 4, 64, 465, F32, F32, TILE_EDGES),
    # first_response: one split
    "first_response": (8, 14, 14, 64, 2048, F32, F32, FIRST_RESPONSE),
    # 8 splits against rows of 3-4 tiles: blocks past the tiles exit
    "short_rows": (8, 2, 2, 64, 2048, F32, F32, FIRST_RESPONSE),
    # the phase-9 pool: rows of 1521 slots, 2 splits
    "service_pool": (4, 14, 14, 64, 1521, F32, F32, [1520, 700, 33, 0]),
    # the LLM's text decode at --kv_quant 0: rep 7 x dk 128, 4 splits
    "llm_bf16": (8, 28, 4, 128, 2048, BF16, BF16, [0, 1, 545, 2047, 32, 63, 1000, 1537]),
    "bf16_q_f32_cache": (4, 28, 4, 128, 700, BF16, F32, [699, 0, 97, 1]),
    "f32_q_bf16_cache": (4, 14, 14, 64, 700, F32, BF16, [699, 0, 97, 1]),
    "rep16_dk64": (2, 16, 1, 64, 300, BF16, BF16, [299, 65]),   # rep * dk = 1024
    "rep8_dk128_f32": (2, 8, 1, 128, 300, F32, F32, [299, 33]),
}


@pytest.mark.parametrize("which", ["decode_attention", "decode_attention_blocked"])
@pytest.mark.parametrize("case", list(DECODE_PLAN_CASES))
def test_decode_attention_plan_cases(cuda, which, case):
    """K4's plan edges (and K3's single pass on the same inputs) in all four
    dtype pairs: one launch a call, two calls bit-identical, masked rows
    zero, valid rows within the tolerance of q's dtype."""
    B, H, Hkv, dk, S, q_dtype, kv_dtype, lengths = DECODE_PLAN_CASES[case]
    q, k, v, length = _decode_inputs(B, H, Hkv, dk, S, q_dtype, kv_dtype, cuda,
                                     seed=S, lengths=lengths)
    assert length.tolist() == [min(n, S - 1) for n in lengths]
    fn = getattr(att, which)
    before = fn.launches
    out = fn(q, k, v, length)
    out2 = fn(q, k, v, length)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(out, out2)
    ref = att.decode_attention_reference(q, k, v, length)
    valid = length > 0
    assert out.dtype == q_dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    assert (out[~valid] == 0).all()
    atol, rtol = decode_tol(q_dtype)
    torch.testing.assert_close(out[valid].float(), ref[valid].float(),
                               rtol=rtol, atol=atol)


SESSION_SHAPES = {   # B = 1: the per-session path's two K4 calls
    "session_llm": (1, 28, 4, 128, 2048, BF16, BF16),     # text decode, 32 splits
    "session_tts": (1, 14, 14, 64, 2048, F32, F32),       # StreamingTTS, 9 splits
}


@pytest.mark.parametrize("length", [0, 1, 31, 32, 33, 2047])
@pytest.mark.parametrize("case", list(SESSION_SHAPES))
def test_decode_attention_one_session(cuda, case, length):
    """K4 at B = 1 with NaN past the length: one launch a call, two calls
    bit-identical, a length-0 row zero, else within q's dtype's tolerance."""
    B, H, Hkv, dk, S, q_dtype, kv_dtype = SESSION_SHAPES[case]
    q, k, v, lens = _decode_inputs(B, H, Hkv, dk, S, q_dtype, kv_dtype, cuda,
                                   seed=length, lengths=[length])
    fn = att.decode_attention_blocked
    before = fn.launches
    out, out2 = fn(q, k, v, lens), fn(q, k, v, lens)
    torch.cuda.synchronize()
    assert fn.launches == before + 2 and torch.equal(out, out2)
    assert torch.isfinite(out.float()).all()
    if length == 0:
        assert (out == 0).all()
        return
    ref = att.decode_attention_reference(q, k, v, lens)
    atol, rtol = decode_tol(q_dtype)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("which", ["decode_attention", "decode_attention_blocked"])
@pytest.mark.parametrize("case", ["first_response", "short_rows", "llm_bf16"])
def test_decode_attention_replayed_from_a_cuda_graph(cuda, which, case):
    """A call captured in a CUDA graph (after warm-up calls on the capture
    stream, as a caller captures) and replayed gives the eager call's bits,
    also after the lengths change in place."""
    B, H, Hkv, dk, S, q_dtype, kv_dtype, lengths = DECODE_PLAN_CASES[case]
    q, k, v, length = _decode_inputs(B, H, Hkv, dk, S, q_dtype, kv_dtype, cuda,
                                     seed=S, lengths=lengths)
    fn = getattr(att, which)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn(q, k, v, length)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        static_out = fn(q, k, v, length)
    for step in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static_out, fn(q, k, v, length))
        length.copy_(torch.clamp(length - 17, min=0))   # rows shrink, one to 0
        k[:, :, :, :] = torch.where(torch.isnan(k), k, k * 0.5)
    del graph
    _build.release_workspace(torch.cuda.current_device(), stream.cuda_stream)


def test_gqa_decode_launches_k4(cuda):
    q, k, v, length = _decode_inputs(4, 14, 14, 64, 600, torch.float32,
                                     torch.float32, cuda)
    k3, k4 = att.decode_attention.launches, att.decode_attention_blocked.launches
    out = att.gqa_decode(q, k, v, length)
    torch.cuda.synchronize()
    assert att.decode_attention_blocked.launches == k4 + 1
    assert att.decode_attention.launches == k3
    ref = att.decode_attention_reference(q, k, v, length)
    valid = length > 0
    torch.testing.assert_close(out[valid], ref[valid], rtol=1e-4, atol=1e-4)


def test_decode_wrappers_reject_what_the_kernel_does_not_take(cuda):
    for fn in (att.decode_attention, att.decode_attention_blocked):
        q, k, v, length = _decode_inputs(2, 4, 2, 48, 16, torch.float32,
                                         torch.float32, cuda)
        with pytest.raises(ValueError, match="head_dim"):
            fn(q, k, v, length)
        q, k, v, length = _decode_inputs(2, 32, 1, 32, 16, torch.float32,
                                         torch.float32, cuda)
        with pytest.raises(ValueError, match="rep over 16"):
            fn(q, k, v, length)
        q, k, v, length = _decode_inputs(2, 4, 2, 64, 16, torch.float32,
                                         torch.float32, cuda)
        with pytest.raises(TypeError):
            fn(q.half(), k, v, length)
        with pytest.raises(TypeError, match="int32"):
            fn(q, k, v, length.long())
        with pytest.raises(ValueError, match="on cpu"):
            fn(q, k.cpu(), v, length)
        with pytest.raises(ValueError, match="contiguous"):
            fn(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, length)
