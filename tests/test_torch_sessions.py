"""Session export/import and serving snapshots of the port's ServingEngine
(runtime/engine.py, runtime/session.py), on the CPU: the port's own round
trips, the layouts a row crosses (f32, bf16, int8 KV), and snapshot
directories written by one package and restored by the other.

A snapshot is one `leaf_j` per cache leaf in `jax.tree.leaves` order, which
`session.row_leaves` reproduces; the KV travels in float layout, and an
int8 store requantizes on import (qwen2.quantize_cache): a row it exported
comes back with its codes and scales, bit for bit, in every slot a query
can see.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from freeze_omni_tpu import config as jcfg_mod
from freeze_omni_tpu.runtime.engine import ServingEngine as JaxEngine
from freeze_omni_tpu.utils.checkpoint import load_native
from freeze_omni_tpu_torch import config as tcfg_mod
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.config import tiny_system
from freeze_omni_tpu_torch.runtime.engine import ServingEngine
from freeze_omni_tpu_torch.runtime.session import row_from_leaves, row_leaves
from tests.test_torch_engine import PROB_ATOL

ASSET = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     "freeze_omni_tpu", "assets", "tiny_s2s"))


def _chunks(seed, n, t=32):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, t, 80).astype(np.float32) for _ in range(n)]


def _engine(kv_dtype=torch.float32, kv_quant_bits=None, max_sessions=8):
    cfg = tiny_system()
    cfg = dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, kv_quant_bits=kv_quant_bits, max_sessions=max_sessions))
    return ServingEngine(cfg, seed=0, kv_dtype=kv_dtype, device="cpu")


def _warm(engine, sid="m1", seeds=(11, 12), role="Migration test."):
    engine.open_session(sid, role=role)
    for i, s in enumerate(seeds):
        engine.submit_chunk(sid, "user", _chunks(s, 1)[0], is_sl=(i == 0))
        engine.tick()


def _next(engine, sid, seed):
    engine.submit_chunk(sid, "user", _chunks(seed, 1)[0], is_sl=False)
    pred = engine.tick()["user"][engine.store.slot_of(sid)]
    return np.array([pred["state_1"], pred["state_2"]])


def test_row_leaves_follow_jax_tree_leaves():
    """The flattening order is jax.tree.leaves' over the same NamedTuples
    (None fields skipped), and row_from_leaves inverts it."""
    store = _engine(kv_quant_bits=8).store
    row = store.gather_slot(0)
    assert [id(t) for t in row_leaves(row)] == [id(t) for t in jax.tree.leaves(row)]
    canon = store.row_template_canonical
    assert canon.kv.k_scale is None and canon.kv.k.dtype == torch.float32
    back = row_from_leaves(canon, row_leaves(canon))
    assert [id(t) for t in row_leaves(back)] == [id(t) for t in row_leaves(canon)]
    with pytest.raises(ValueError, match="leaves"):
        row_from_leaves(canon, row_leaves(canon)[:-1])


def test_import_resumes_exactly():
    src, dst = _engine(), _engine()
    _warm(src)
    blob = src.export_session("m1")
    assert blob["prefix_len"] > 0 and blob["role"] == "Migration test."
    dst.import_session("m1", blob)
    s_slot, d_slot = src.store.slot_of("m1"), dst.store.slot_of("m1")
    assert src.store.kv_length(s_slot) == dst.store.kv_length(d_slot)
    assert dst.store.prefix_len[d_slot] == blob["prefix_len"]
    assert np.abs(_next(src, "m1", 13) - _next(dst, "m1", 13)).max() < 1e-6


def test_bf16_store_casts_an_f32_export():
    src, dst = _engine(), _engine(kv_dtype=torch.bfloat16)
    _warm(src)
    dst.import_session("m1", src.export_session("m1"))
    row = dst.store.gather_slot(dst.store.slot_of("m1"))
    assert row.kv.k.dtype == torch.bfloat16 and row.enc_user.k_cache.dtype == torch.bfloat16
    p = _next(dst, "m1", 15)
    assert np.isfinite(p).all() and (0 <= p).all() and (p <= 1).all()


def test_int8_store_round_trips_its_codes():
    src, dst = _engine(kv_quant_bits=8), _engine(kv_quant_bits=8)
    _warm(src)
    blob = src.export_session("m1")
    assert blob["caches"].kv.k.dtype == np.float32       # float layout
    assert blob["caches"].kv.k_scale is None
    dst.import_session("m1", blob)
    a = src.store.gather_kv(src.store.slot_of("m1"))
    b = dst.store.gather_kv(dst.store.slot_of("m1"))
    n = int(a.length[0])
    assert int(b.length[0]) == n > 0
    S = a.k.shape[2]
    for q in ("k", "v", "k_scale", "v_scale"):   # slot S-1 is scratch
        assert torch.equal(getattr(a, q)[:, :, :S - 1], getattr(b, q)[:, :, :S - 1]), q
    assert np.abs(_next(src, "m1", 16) - _next(dst, "m1", 16)).max() < 1e-6


def test_save_restore_round_trip(tmp_path):
    src = _engine()
    for i, sid in enumerate(("a", "b")):
        src.open_session(sid, role=f"Snapshot test {i}.")
        src.submit_chunk(sid, "user", _chunks(20 + i, 1)[0], is_sl=True)
    src.tick()
    assert set(src.save_sessions(str(tmp_path))) == {"a", "b"}
    index = json.loads((tmp_path / "sessions.json").read_text())
    assert index["version"] == 1 and index["sessions"]["b"]["role"] == "Snapshot test 1."
    dst = _engine()
    assert set(dst.restore_sessions(str(tmp_path))) == {"a", "b"}
    dst.open_session("a")   # a reattach keeps the KV context
    assert dst.store.kv_length(dst.store.slot_of("a")) == \
        src.store.kv_length(src.store.slot_of("a"))
    assert np.abs(_next(src, "a", 25) - _next(dst, "a", 25)).max() < 1e-6


def test_restore_rejects_an_unknown_version(tmp_path):
    (tmp_path / "sessions.json").write_text(json.dumps({"version": 99}))
    with pytest.raises(ValueError, match="version"):
        _engine().restore_sessions(str(tmp_path))
    with pytest.raises(ValueError, match="version"):
        _engine().import_session("x", {"version": 2})


def test_a_full_store_skips_what_does_not_fit(tmp_path, capsys):
    src = _engine(max_sessions=3)
    for i in range(3):
        src.open_session(f"s{i}")
    src.save_sessions(str(tmp_path))
    dst = _engine(max_sessions=2)
    assert len(dst.restore_sessions(str(tmp_path))) == 2
    assert dst.num_active == 2
    assert "store full" in capsys.readouterr().err


def test_reattach_keeps_its_role():
    engine = _engine()
    engine.open_session("r1", role="Original role.")
    slot = engine.store.slot_of("r1")
    length = engine.store.kv_length(slot)
    engine.open_session("r1")   # a reconnect names no role
    assert engine._slot_role[slot] == "Original role."
    assert engine.store.kv_length(slot) == length
    assert engine.export_session("r1")["role"] == "Original role."


@pytest.fixture(scope="module")
def checkpoint_engines():
    """The committed tiny system (f32 weights) in both packages, 4 session
    rows each; the port's store keeps its KV in int8 so a snapshot crosses
    layouts both ways (the JAX store is float)."""
    def cfg(mod, bits):
        c = mod.load_system_config(os.path.join(ASSET, "config.json"))
        return dataclasses.replace(c, serving=dataclasses.replace(
            c.serving, max_sessions=4, kv_quant_bits=bits))

    params = load_native(os.path.join(ASSET, "params"))["audiollm"]
    je = JaxEngine(cfg(jcfg_mod, None), params=params)
    te = ServingEngine(cfg(tcfg_mod, 8), device="cpu",
                       params=weights.from_jax(jax.tree.map(np.asarray, params),
                                               device="cpu"))
    return {"jax": je, "port": te}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_snapshot_restores_in_the_other_package(checkpoint_engines, tmp_path,
                                                writer, reader):
    """Two sessions tick twice on the writer and are saved; the reader
    restores the directory; one more tick on the same chunks on both sides
    agrees within PROB_ATOL, with equal KV lengths."""
    w, r = checkpoint_engines[writer], checkpoint_engines[reader]
    sids = [f"{writer}-{i}" for i in range(2)]
    for i, sid in enumerate(sids):
        w.open_session(sid, role=f"Cross-package snapshot {i}.")
    for t in range(2):
        for i, sid in enumerate(sids):
            for ident in ("user", "system"):
                w.submit_chunk(sid, ident, _chunks(40 + 4 * t + i, 1)[0],
                               is_sl=(t == 0))
        w.tick()
    assert set(w.save_sessions(str(tmp_path))) == set(sids)
    assert set(r.restore_sessions(str(tmp_path))) == set(sids)
    probs = {}
    for name, e in ((writer, w), (reader, r)):
        for i, sid in enumerate(sids):
            e.submit_chunk(sid, "user", _chunks(60 + i, 1)[0], is_sl=False)
            e.submit_chunk(sid, "system", _chunks(70 + i, 1)[0], is_sl=False)
        res = e.tick()["user"]
        probs[name] = np.array([[res[e.store.slot_of(s)][k]
                                 for k in ("state_1", "state_2")] for s in sids])
        lengths = [e.store.kv_length(e.store.slot_of(s)) for s in sids]
        probs[name + "_len"] = lengths
        for sid in sids:
            e.close_session(sid)
    assert probs[writer + "_len"] == probs[reader + "_len"]
    np.testing.assert_allclose(probs[reader], probs[writer], rtol=0, atol=PROB_ATOL)
