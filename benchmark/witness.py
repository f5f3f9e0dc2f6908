"""The onset-replay aliasing of the port's gating chunker, shown on the CPU.

`frontend/chunker.GatingChunker.process_and_gate` returns an IPU onset's
replay features as views of its history ring (`self.history[i][None]`).
They wait in the session's serializer, one taken a tick; when later silent
windows shift the ring before a view is taken, the engine is handed other
windows' fbank. The duplex mixes (system speech whose spurts end while
their replays still queue) make it happen; the listen mixes (system
channel silent) do not.

    python3 benchmark/witness.py [--copy] SEED [SEED ...]

serves the duplex-overload mix's calls (6 lanes, 200 steps) at the test widths
(tests/data/configs/tiny-int8.json, KV 2048 so no session rolls) and
prints the numbers the judge compares; --copy serves them with the replay
features copied when they are made, the second witness: the fbank gap
then falls to the reference's rounding.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 200   # a fixed schedule: the closed loop then serves it alike on every run


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--copy", action="store_true")
    p.add_argument("seeds", type=int, nargs="+")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness, traffic
    from freeze_omni_tpu_torch.frontend import chunker

    if args.copy:
        real = chunker.GatingChunker.process_and_gate

        def copied(self, ann):
            out = real(self, ann)
            if out is not None:
                out["feature_last_chunk"] = [f.copy() for f in out["feature_last_chunk"]]
            return out

        chunker.GatingChunker.process_and_gate = copied
    data = ROOT / "benchmark" / "tests" / "data"
    conf = json.loads((data / "configs" / "tiny-int8.json").read_text())
    conf["dims"]["llm"]["max_kv_len"] = 2048
    mix = traffic.load_mix("duplex-overload")
    mix.update(sessions=6, sample_lanes=6, call_pool=12, warmup_ticks=2)
    for seed in args.seeds:
        out = harness.execute({"name": "witness", "kernels": []}, conf, mix, seed,
                              0.0, False, "cpu", log=lambda *a: None, steps=STEPS)
        n = out["numbers"]
        print(json.dumps({"seed": seed, "replay_copied": args.copy,
                          **{k: n[k] for k in ("fbank_gap", "state_gap",
                                               "submit_mismatch", "compared")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
