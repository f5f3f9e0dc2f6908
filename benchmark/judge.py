"""`correct`: what the served sessions decided, judged against the plain
reference (benchmark/reference), which re-derives everything from the
call's audio and the benchmark's float weights.

For a sample of calls drawn from the seed (every call of the sampled
lanes, the lane whose first call is the longest among them), the reference
replays the host frontend on the schedule on which the service read the
call's windows (how many of each channel in each step, a fact of timing),
then the model over the whole call. The numbers compared:

- fbank_gap: the largest |served - reference| of any submitted feature;
- vad_prob_gap: the largest gap of a window's speech probability, both
  channels;
- vad_status_mismatch: windows whose IPU status differs (a window whose
  reference probability lies within vad_prob_gap's limit of the
  threshold takes the served side's speech decision, since both agree to
  that limit);
- submit_mismatch: features submitted to the engine in another step,
  identity, order or with another is_sl than the reference's;
- state_gap: the largest |served - reference| of state_1 or state_2 over
  every decision of the sampled calls;
- missing: sampled calls' user features without a decision;
- compared: decisions compared (at least `min_compared`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import frontend as ref_fe
from .reference import model as ref_model
from .traffic import pcm

VAD_WEIGHTS = Path(__file__).resolve().parents[1] / "freeze_omni_tpu" / "assets" / "vad.npz"


def vad_weights() -> dict:
    with np.load(VAD_WEIGHTS) as z:
        return {k: z[k].astype(np.float64) for k in z.files}


def _schedule(rec, last_step: int) -> List[tuple]:
    """Every step the call saw: from the one after its open to the one
    before its close (steps run 0 .. last_step - 1)."""
    end = rec.close_step if rec.close_step is not None else last_step
    return [(s, *rec.reads.get(s, [0, 0])) for s in range(rec.open_step, end)]


def frontend_checks(recs, traffic, conf: dict, last_step: int, limits: dict,
                    low: bool = False):
    """Replays each sampled call's frontend. Returns (numbers, replays).
    low: the control; the frontend replayed in bfloat16 takes the served
    side's place."""
    fe_cfg = conf["frontend"]
    w = vad_weights()
    tol = limits["vad_prob_gap"]
    num = {"fbank_gap": 0.0, "vad_prob_gap": 0.0, "vad_status_mismatch": 0,
           "submit_mismatch": 0}
    replays = {}
    for rec in recs:
        call = rec.call
        audio = {i: [pcm(call.message(i, j)) for j in range(len(rec.probs[i]))]
                 for i in ("user", "system")}
        rp = ref_fe.replay_call(audio, _schedule(rec, last_step), fe_cfg, w,
                                rec.probs, tol)
        replays[rec.sid] = rp
        probs, status, submits = rec.probs, rec.status, rec.submits
        if low:
            lp = ref_fe.replay_call(audio, _schedule(rec, last_step), fe_cfg, w,
                                    rec.probs, tol, low=True)
            probs, status = lp.probs, lp.statuses
            submits = [(s, i, sl, f[None]) for s, i, sl, f, _ in lp.submits]
        for i in ("user", "system"):
            a, b = np.asarray(probs[i]), np.asarray(rp.probs[i])
            if a.shape != b.shape:
                num["vad_status_mismatch"] += abs(a.shape[0] - b.shape[0])
                continue
            if a.size:
                num["vad_prob_gap"] = max(num["vad_prob_gap"],
                                          float(np.abs(a - b).max()))
            num["vad_status_mismatch"] += sum(
                a != b for a, b in zip(status[i], rp.statuses[i]))
        served = [(s, i, sl) for s, i, sl, _ in submits]
        ref = [(s, i, sl) for s, i, sl, _, _ in rp.submits]
        if served != ref:
            n = min(len(served), len(ref))
            num["submit_mismatch"] += sum(a != b for a, b in zip(served[:n], ref[:n])) \
                + abs(len(served) - len(ref))
        else:
            for (_, _, _, f), (_, _, _, g, _) in zip(submits, rp.submits):
                num["fbank_gap"] = max(num["fbank_gap"],
                                       float(np.abs(np.asarray(f)[0] - g).max()))
    return num, replays


def reference_states(recs, replays, weights, dims: dict, precision: dict,
                     role_ids, prefix_ids: Dict[str, List[int]], device):
    """Per call, the reference's [user decisions, 3] state probabilities."""
    calls = [r for r in recs if replays[r.sid].submits]
    if not calls:
        return {}
    chunks = {i: [[torch.as_tensor(f, dtype=torch.float32, device=device)
                   for s, ident, sl, f, j in replays[r.sid].submits if ident == i]
                  for r in calls] for i in ("user", "system")}
    emb = {}
    for i in ("user", "system"):
        p_enc = weights_tree(weights, f"encoder_{i}")
        p_adp = weights_tree(weights, f"adapter_{i}")
        emb[i] = ref_model.audio_embeddings(p_enc, p_adp, dims, chunks[i], device,
                                            ref_model.activation_rounding(precision))
        del p_enc, p_adp
    prefix = {i: ref_model.prefix_embeddings(weights, prefix_ids[i], device)
              for i in ("user", "system")}
    seqs = []
    for c, r in enumerate(calls):
        rows, reads, n = [], [], {"user": 0, "system": 0}
        subs = replays[r.sid].submits
        # one tick's tokens: the user's (prefix when is_sl, then the chunk),
        # then the system's
        for s, ident, sl, f, j in sorted(subs, key=lambda x: (x[0], x[1] != "user")):
            if sl:
                rows.append(prefix[ident])
            rows.append(emb[ident][c][n[ident]])
            n[ident] += 1
            if ident == "user":
                reads.append(sum(x.shape[0] for x in rows) - 1)
        seqs.append({"embeds": torch.cat(rows, 0), "reads": reads})
    states = ref_model.decode_calls(weights, dims, precision, role_ids, seqs, device)
    return {r.sid: st.cpu().numpy() for r, st in zip(calls, states)}


def weights_tree(weights, top: str) -> dict:
    from .weights import nest

    return nest(dict(weights.items(top + "/")), top + "/")


def state_checks(recs, states: Dict[str, np.ndarray],
                 served: Optional[Dict[str, np.ndarray]] = None) -> dict:
    """state_gap over every decision of the compared calls; `served`
    replaces the program's decisions (the control)."""
    gap, compared, missing = 0.0, 0, 0
    for r in recs:
        ref = states.get(r.sid)
        n_user = sum(1 for x in r.submits if x[1] == "user")
        if ref is None:
            missing += n_user
            continue
        got = served[r.sid][:, 1:] if served is not None else \
            np.asarray([d[:2] for d in r.decisions], np.float64).reshape(-1, 2)
        n = min(len(got), ref.shape[0])
        missing += max(ref.shape[0] - len(got), 0) + max(n_user - ref.shape[0], 0)
        if n:
            gap = max(gap, float(np.abs(got[:n] - ref[:n, 1:]).max()))
        compared += n
    return {"state_gap": gap, "missing": missing, "compared": compared}


def checks_of(numbers: dict, limits: dict) -> Dict[str, dict]:
    """{name: {value, limit}}; `compared` is a floor, the rest ceilings."""
    out = {}
    for k in ("fbank_gap", "vad_prob_gap", "vad_status_mismatch",
              "submit_mismatch", "state_gap", "missing", "compared"):
        if k in numbers:
            lim = limits.get(k, 0) if k != "compared" else limits["min_compared"]
            out[k] = {"value": numbers[k], "limit": lim}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    ok = True
    for k, c in checks.items():
        v = c["value"]
        if v is None or (isinstance(v, float) and not np.isfinite(v)):
            return False
        ok &= v >= c["limit"] if k == "compared" else v <= c["limit"]
    return bool(ok)
