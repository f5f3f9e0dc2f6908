"""The one traffic generator. A mix is a data file, `traffic/<name>.json`,
read by `load_mix`; everything here is driven by its keys, and the same
seed gives the same calls, audio and arrival schedule.

A lane is one client connection. It places calls one after another; call
`k` of lane `l` is one of `call_pool` conversations of `call_s` seconds
(the same for every seed; the seed deals them to the lanes) on two
channels, cut
into messages of `message_samples` 16 kHz samples (224 ms), sent as s16le
bytes as a websocket client sends them:

- user: utterances of `user_utterance_s`, cut from a bank of speech
  surrogate clips at `speech_scale`, separated by pauses of `user_pause_s`;
- system: after an utterance, with probability `system_turn_prob`, a talk
  spurt of `system_spurt_s` after a gap of `turn_gap_s`; the user's next
  utterance then starts `turn_gap_s` after the spurt, or, with probability
  `barge_in_prob`, `barge_in_overlap_s` before its end (a barge-in);
- both channels carry Gaussian noise of `noise_floor` (the energy VAD's
  floor never settles on digital zeros).

How messages arrive is the mix's `mode`:

- "ahead": a closed loop. Each lane keeps `lead_messages` messages of both
  channels ahead of what the service has fully processed (a reconnect's
  catch-up, or a replay faster than real time).
- "open": an open loop. Message j of a call is due `(j + 1) * 224 ms` after
  the call starts; a lane starts at a seeded phase in [0, 224 ms) and its
  next call `call_gap_s` after the previous one ends.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

from .speech import SAMPLE_RATE, clip_bank

HERE = Path(__file__).resolve().parent
_MASK = (1 << 64) - 1


def load_mix(name: str, root: Path = HERE) -> dict:
    """The mix's parameters; a `traffic/<name>.py` beside the data file, if
    there is one, may define `adjust(mix) -> mix`."""
    path = root / "traffic" / f"{name}.json"
    with open(path) as f:
        mix = json.load(f)
    mix["name"] = name
    code = root / "traffic" / f"{name}.py"
    if code.exists():
        spec = importlib.util.spec_from_file_location(f"_mix_{name}", code)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mix = mod.adjust(mix)
    return mix


class Call:
    """One conversation: both channels as int16 arrays of whole messages."""

    def __init__(self, lane: int, k: int, user: np.ndarray, system: np.ndarray,
                 msg: int):
        self.lane, self.k, self.msg = lane, k, msg
        self.user, self.system = user, system
        self.n_msgs = user.shape[0] // msg

    @property
    def sid(self) -> str:
        return f"l{self.lane}c{self.k}"

    def message(self, channel: str, j: int) -> bytes:
        a = self.user if channel == "user" else self.system
        return a[j * self.msg:(j + 1) * self.msg].tobytes()


class Traffic:
    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed) & _MASK
        self.msg = int(mix["message_samples"])
        self.msg_s = self.msg / SAMPLE_RATE
        self.bank = clip_bank([0xC11B], int(mix["clip_bank"]),
                              max(mix["user_utterance_s"][1],
                                  mix["system_spurt_s"][1]))
        self._pool = None

    def _u(self, rng, key) -> float:
        lo, hi = self.mix[key]
        return float(rng.uniform(lo, hi))

    def _place(self, out: np.ndarray, rng, t0: float, dur: float) -> None:
        a = int(round(t0 * SAMPLE_RATE))
        n = min(int(round(dur * SAMPLE_RATE)), out.shape[0] - a)
        if a >= out.shape[0] or n <= 0:
            return
        clip = self.bank[int(rng.integers(self.bank.shape[0]))]
        off = int(rng.integers(clip.shape[0] - n + 1))
        out[a:a + n] += self.mix["speech_scale"] * clip[off:off + n]

    def call(self, lane: int, k: int) -> Call:
        """Call k of a lane: one of the mix's `call_pool` conversations
        (made once at set-up, so opening a call in the window costs the
        service's work only), dealt in a seeded order: round k gives lane l
        conversation perm[(l + k) % call_pool], so with call_pool equal to
        the lanes, or dividing them, every round serves the whole pool
        equally often."""
        if self._pool is None:
            P = int(self.mix["call_pool"])
            self._pool = [self._conversation(i) for i in range(P)]
            self._perm = np.random.default_rng([self.seed, 0xCA11]).permutation(P)
        P = len(self._pool)
        user, system = self._pool[self._perm[(lane + k) % P]]
        return Call(lane, k, user, system, self.msg)

    def prepare(self) -> None:
        self.call(0, 0)

    def _conversation(self, idx: int):
        """Conversation idx of the pool. It does not depend on the seed, so
        every seed serves the same set of conversations; the seed deals
        them to the lanes (and sets the open loop's phases)."""
        m = self.mix
        rng = np.random.default_rng([0xC0F5, idx])
        audio = np.random.default_rng([0xA0D1, idx])
        n_msgs = max(1, int(round(self._u(rng, "call_s") / self.msg_s)))
        N = n_msgs * self.msg
        end_s = N / SAMPLE_RATE
        user = np.zeros(N, np.float64)
        system = np.zeros(N, np.float64)
        t = self._u(rng, "lead_in_s")
        while t < end_s:
            u = self._u(rng, "user_utterance_s")
            self._place(user, audio, t, u)
            end = t + u
            if rng.random() < m["system_turn_prob"]:
                s0 = end + self._u(rng, "turn_gap_s")
                sd = self._u(rng, "system_spurt_s")
                self._place(system, audio, s0, sd)
                if rng.random() < m["barge_in_prob"]:
                    t = max(end + 0.1,
                            s0 + sd - self._u(rng, "barge_in_overlap_s"))
                else:
                    t = s0 + sd + self._u(rng, "turn_gap_s")
            else:
                t = end + self._u(rng, "user_pause_s")
        noise = np.random.default_rng([0x0015E, idx])
        user += m["noise_floor"] * noise.standard_normal(N, dtype=np.float32)
        system += m["noise_floor"] * noise.standard_normal(N, dtype=np.float32)
        to16 = lambda x: np.clip(np.round(x * 32767), -32768, 32767).astype("<i2")  # noqa: E731
        return to16(user), to16(system)

    # the open loop's schedule
    def lane_phase(self, lane: int) -> float:
        rng = np.random.default_rng([self.seed, 0x9A5E, lane])
        return float(rng.uniform(0.0, self.msg_s))

    def call_gap(self, lane: int, k: int) -> float:
        """Seed-independent: the seed moves the lanes' phases only."""
        rng = np.random.default_rng([0x6A9, lane, k])
        return self._u(rng, "call_gap_s")


def pcm(message: bytes) -> np.ndarray:
    """A message as the service reads it: s16le over 32768, float32."""
    return np.frombuffer(message, "<i2").astype(np.float32) / 32768.0
