"""The port's host-side duplex pieces run the cases of tests/test_duplex.py
(EnergyVAD IPU lifecycle, serializer priority and ordering, PCM queues,
ThreadSafeQueue, IPUHandle, EventSink) through both packages, which must
agree exactly."""

import numpy as np
import pytest

from freeze_omni_tpu.config import VADConfig as JaxVADConfig
from freeze_omni_tpu.duplex import events as jevents
from freeze_omni_tpu.duplex import ipu as jipu
from freeze_omni_tpu.duplex import serializer as jser
from freeze_omni_tpu.duplex import vad as jvad
from freeze_omni_tpu.utils import queues as jqueues
from freeze_omni_tpu_torch.config import VADConfig
from freeze_omni_tpu_torch.duplex import events as tevents
from freeze_omni_tpu_torch.duplex import ipu as tipu
from freeze_omni_tpu_torch.duplex import serializer as tser
from freeze_omni_tpu_torch.duplex import vad as tvad
from freeze_omni_tpu_torch.utils import queues as tqueues

PACKAGES = {
    "jax": (JaxVADConfig, jvad, jser, jqueues, jipu, jevents),
    "torch": (VADConfig, tvad, tser, tqueues, tipu, tevents),
}


def _both(fn):
    out = {name: fn(*mods) for name, mods in PACKAGES.items()}
    return out["torch"], out["jax"]


def test_energy_vad_ipu_lifecycle():
    def run(VADCfg, vad, *_):
        cfg = VADCfg(chunk_size=512, min_silence_s=0.064,  # 2 chunks
                     min_speech_s=0.0)  # immediate onset
        v = vad.EnergyVAD(cfg)
        loud = 0.5 * np.sin(2 * np.pi * 440 * np.arange(512) / 16000)
        quiet = np.zeros(512, np.float32)
        outs = [v.predict({"audio": a, "time_stamp": float(i)})
                for i, a in enumerate([quiet] * 5 + [loud, loud] + [quiet] * 3)]
        return [(o["status"], o["prob"], len(o["cached_audio"])) for o in outs]

    ours, ref = _both(run)
    assert ours == ref
    assert [s for s, _, _ in ours] == [None] * 5 + ["ipu_sl", "ipu_cl", "ipu_cl",
                                                    "ipu_el", None]
    assert ours[5][2] <= VADConfig().history_cache_chunks


def test_serializer_user_priority_and_pseudo_ipu():
    def run(_c, _v, ser, *_):
        s = ser.ContextSerializer()
        for ts, ident, st, f, ipu in ((1.0, "user", "ipu_sl", "u1", 1),
                                      (2.0, "system", "ipu_cl", "s1", 2),
                                      (3.0, "user", "ipu_el", "u2", 1),
                                      (4.0, "system", "ipu_cl", "s2", 2),
                                      (5.0, "system", "ipu_cl", "s3", 2)):
            s.add_feature_chunk({"time_stamp": ts, "identity": ident,
                                 "status": st, "feature": f, "ipu_id": ipu})
        return [None if o is None else (o["feature"], o["status"])
                for o in (s.get_next_feature() for _ in range(5))]

    ours, ref = _both(run)
    assert ours == ref == [("u1", "ipu_sl"), None, ("u2", "ipu_el"),
                           ("s2", "ipu_sl"), ("s3", "ipu_cl")]


def test_serializer_timestamp_ordering():
    def run(_c, _v, ser, *_):
        s = ser.ContextSerializer()
        s.add_feature_chunk({"time_stamp": 2.0, "identity": "user",
                             "status": "ipu_cl", "feature": "b", "ipu_id": 1})
        s.add_feature_chunk({"time_stamp": 1.0, "identity": "user",
                             "status": "ipu_sl", "feature": "a", "ipu_id": 1})
        return [s.get_next_feature()["feature"], s.get_next_feature()["feature"],
                len(s)]

    ours, ref = _both(run)
    assert ours == ref == ["a", "b", 0]


def test_pcm_queue_chunks_and_s16le():
    def run(_c, _v, _s, queues, *_):
        q = queues.PCMQueue()
        q.push(np.arange(5, dtype=np.float32))
        q.push(np.arange(5, 8, dtype=np.float32))
        short = q.pull(10)
        out = q.pull(6)
        left = q.available()
        q.push_s16le(np.array([16384, -16384], dtype="<i2").tobytes())
        return short, out.tolist(), left, q.pull(2).tolist()

    ours, ref = _both(run)
    assert ours == ref
    assert ours == (None, list(range(6)), 2, [6.0, 7.0])


def test_pcm_queue_bounded_drops_oldest():
    def run(_c, _v, _s, queues, *_):
        q = queues.PCMQueue(max_samples=10)
        q.push(np.arange(8, dtype=np.float32))
        q.push(np.arange(8, dtype=np.float32) + 100)
        return q.available(), q.dropped, q.pull(10).tolist(), \
            queues.PCMQueue().max_samples

    ours, ref = _both(run)
    assert ours == ref
    assert ours == (10, 6, [6.0, 7.0] + [100.0 + i for i in range(8)],
                    120 * 16000)


def test_thread_safe_queue():
    def run(_c, _v, _s, queues, *_):
        q = queues.ThreadSafeQueue()
        q.put(1)
        q.put(2)
        return q.drain(), q.get()

    ours, ref = _both(run)
    assert ours == ref == ([1, 2], None)


def test_ipu_handle_lifecycle():
    def run(*mods):
        h = mods[4].IPUHandle("user", 1.0)
        opened = h.closed
        h.add_chunk(np.zeros(4), 1.1)
        h.set_end_timestamp(2.0)
        h.register_response_state({"decision": "dialog_ss", "state_1": 0.9})
        return opened, h.closed, h.duration(), h.response_states[0]["decision"]

    ours, ref = _both(run)
    assert ours == ref == (False, True, 1.0, "dialog_ss")


def test_event_sink_catalog_and_dispatch():
    def run(*mods):
        sink = mods[5].EventSink()
        got = []
        sink.on("vad_event", lambda p: got.append(p["status"]))
        sink.emit("vad_event", {"status": "ipu_sl"})
        sink.emit("dialog_state_update", {"state": "dialog_cl"})
        return (tuple(sink.EVENTS), got,
                [e["status"] for e in sink.events_of("vad_event")],
                [e["state"] for e in sink.events_of("dialog_state_update")])

    ours, ref = _both(run)
    assert ours == ref
    assert "response_interrupted" in ours[0] and ours[1] == ["ipu_sl"]


@pytest.mark.parametrize("name", ["PCMQueue", "ThreadSafeQueue"])
def test_queues_are_thread_safe_under_contention(name):
    """Four producers and one consumer: nothing lost or duplicated."""
    import sys
    import threading

    q = getattr(tqueues, name)()
    n, got = 2000, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def produce(k):
            for i in range(n):
                if name == "PCMQueue":
                    q.push(np.array([k * n + i], np.float32))
                else:
                    q.put(k * n + i)

        threads = [threading.Thread(target=produce, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    if name == "PCMQueue":
        got = q.pull(q.available()).astype(int).tolist()
    else:
        got = q.drain()
    assert sorted(got) == list(range(4 * n))
