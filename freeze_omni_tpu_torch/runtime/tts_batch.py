"""Batched streaming speech synthesis: a resident pool of sentence jobs
(counterpart of freeze_omni_tpu/runtime/tts_batch.py).

Every in-flight sentence is a row of ONE pooled `DecodeState`:

- `start()` runs the pre-NN + prefix + prefill preamble for all sentences
  that arrive together in one batch and copies the fresh rows into free
  pool rows;
- `step()` advances EVERY active row by one codec chunk's worth of AR tokens
  in one `decode_segment` (inactive rows are frozen by the `active` mask),
  then vocodes every row with a full token window, one codec call per padded
  window length;
- seam splicing (`find_min_seam`) and chunk bookkeeping stay on the host per
  job, with the reference's streaming semantics: chunk + look-ahead token
  windows, left/right trimming, quiet-point splicing (llm2tts.py:114-160).

The pool has a fixed capacity: when it is full, `start` starts fewer and the
caller queues the rest. Each row holds `max_kv_len` decoder KV slots
(`row_slots`); a sentence whose preamble leaves its row less than one codec
chunk is refused on its own (`take_refused`), and the others start. The JAX pool pads its batches to powers of two and
pre-compiles every shape in `warmup`; PyTorch runs eagerly, so here batches
keep their size and there is nothing to warm.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import TTSConfig
from ..models import speech_decoder as sd
from ..tts import bucket_pad, find_min_seam, preamble, vocode
from ..utils.device import resolve_device

BUCKET = 32


def row_slots(cfg: TTSConfig, max_frames: int) -> int:
    """Decoder KV slots of a pool row that holds a sentence of up to
    `max_frames` prefix frames and `max_frames` text frames: bos, both
    blocks, the token budget rounded up to whole codec chunks and a margin
    of 8 (the scratch slot among them), capped at the decoder's
    max_kv_len."""
    chunk = cfg.codec_chunk_size
    budget = -(-cfg.max_tokens // chunk) * chunk
    return min(cfg.decoder.max_kv_len, 1 + 2 * max_frames + budget + 8)


class _Job:
    __slots__ = ("key", "buf", "pcm", "left", "right", "done_decode", "total",
                 "room")

    def __init__(self, key, padding: int, room: int):
        self.key = key
        self.buf = np.zeros((0,), np.int64)
        self.pcm = np.zeros((1, 1, 0), np.float32)
        self.left = 0
        self.right = padding
        self.done_decode = False
        self.total = 0
        self.room = room   # codec tokens its KV row holds after the preamble


def _pad_rows(arrays: List[Optional[np.ndarray]], dim: int):
    """[1, t_i, dim] arrays (or None) -> ([n, t_max, dim] f32, [n, t_max]
    validity), zero-padded."""
    t_max = max((a.shape[1] for a in arrays if a is not None), default=1)
    x = np.zeros((len(arrays), t_max, dim), np.float32)
    m = np.zeros((len(arrays), t_max), bool)
    for i, a in enumerate(arrays):
        if a is not None:
            x[i, : a.shape[1]] = a[0]
            m[i, : a.shape[1]] = True
    return x, m


def _bucketed(arrays, dim: int, device):
    """Rows padded to a common length, then to a multiple of BUCKET, with a
    mask that is True only on each row's own frames."""
    x, m = _pad_rows(arrays, dim)
    xb, mb = bucket_pad(x, BUCKET, device)
    full = np.zeros(tuple(mb.shape), bool)
    full[:, : m.shape[1]] = m
    return xb, torch.from_numpy(full).to(device)


class BatchedTTS:
    def __init__(self, params: dict, cfg: TTSConfig, capacity: int,
                 seed: int = 0, max_kv_len: Optional[int] = None, device=None):
        """params: {'decoder', 'codec'} on `device` (None: the card).
        capacity: pool rows (concurrent sentences). max_kv_len: decoder KV
        slots per row; by default `row_slots` for a 4 x BUCKET prefix and
        text instead of the decoder's full context, since `capacity` rows
        stay resident. The duplex service passes the bound of its longest
        response (DuplexService)."""
        self.cfg = cfg
        self.params = params
        self.capacity = capacity
        self.device = resolve_device(device)
        dcfg = cfg.decoder
        if max_kv_len is None:
            max_kv_len = row_slots(cfg, 4 * BUCKET)
        self.max_kv_len = max_kv_len
        self._dcfg = dataclasses.replace(dcfg, max_kv_len=max_kv_len)
        cache = sd.init_cache(self._dcfg, capacity, device=self.device)
        self.state = sd.init_decode_state(self._dcfg, cache,
                                          max(cfg.penalty_window_size, 1))
        self.active = np.zeros((capacity,), bool)
        self.jobs: Dict[int, _Job] = {}   # row -> job
        self._refused: List[Tuple[object, str]] = []
        self._free: List[int] = list(range(capacity))
        # start/step run on the service tick thread, while a session close
        # may cancel() from another thread mid-step
        self._lock = threading.Lock()
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.set_global_tokens(cfg.codec.global_tokens)

    @property
    def n_active(self) -> int:
        return len(self.jobs)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def set_global_tokens(self, tokens) -> None:
        self._global_tokens = torch.as_tensor(
            np.asarray(tokens, np.int64).reshape(1, 1, -1), device=self.device)

    # ------------------------------------------------------------------

    def start(self, sentences: List[Tuple[object, np.ndarray,
                                          Optional[np.ndarray]]]) -> int:
        """sentences: [(key, hidden [1,T,idim], prefix [1,P,idim]|None)].
        Starts as many as there are free rows, in order; returns how many
        started. One preamble batch covers them all. A sentence whose
        preamble leaves its row less than one codec chunk is refused: it
        takes no row, and `take_refused` lists it with the reason."""
        with self._lock:
            n_free = len(self._free)
        # the preamble writes bos + the hidden block + the prefix (when the
        # decoder keeps prefix KV) into the row; codec tokens follow, one
        # segment per step, and slot max_kv_len - 1 is the scratch slot
        todo, rooms = [], []
        for key, h, p in sentences:
            if len(todo) == n_free:
                break
            used = 1 + h.shape[1] + (p.shape[1] if p is not None
                                     and self._dcfg.use_prefix_kv else 0)
            room = self.max_kv_len - 1 - used
            if room < self.cfg.codec_chunk_size:
                self._refused.append((key, (
                    f"sentence needs {used} decoder KV slots before its first "
                    f"{self.cfg.codec_chunk_size} codec tokens; the pool's rows "
                    f"hold {self.max_kv_len}")))
                continue
            todo.append((key, h, p))
            rooms.append(room)
        if not todo:
            return 0
        n = len(todo)
        idim = todo[0][1].shape[2]
        dparams = self.params["decoder"]
        with torch.no_grad():
            hidden, h_mask = _bucketed([h for _, h, _ in todo], idim, self.device)
            if self._dcfg.use_prefix_kv and any(p is not None for _, _, p in todo):
                prefix, p_mask = _bucketed([p for _, _, p in todo], idim,
                                           self.device)
                cache = preamble(dparams, self._dcfg, hidden, h_mask, prefix,
                                 p_mask)
            else:
                cache = preamble(dparams, self._dcfg, hidden, h_mask)
            rows = sd.init_decode_state(self._dcfg, cache,
                                        max(self.cfg.penalty_window_size, 1))

        with self._lock:
            idx = [self._free.pop(0) for _ in range(n)]
            self._scatter(rows, idx)
            for i, (key, _h, _p) in enumerate(todo):
                self.jobs[idx[i]] = _Job(key, self.cfg.codec_padding_size,
                                         rooms[i])
                self.active[idx[i]] = True
        return n

    def take_refused(self) -> List[Tuple[object, str]]:
        """The (key, reason) of every sentence `start` refused since the
        last call, oldest first; clears the list."""
        refused, self._refused = self._refused, []
        return refused

    def _scatter(self, rows: sd.DecodeState, idx: List[int]) -> None:
        """Copy rows 0..len(idx)-1 of a fresh batch into pool rows `idx`, in
        place (cache leaves batch on axis 1, the rest on axis 0)."""
        dst = torch.as_tensor(idx, dtype=torch.long, device=self.device)
        pool, kv, new_kv = self.state, self.state.cache.kv, rows.cache.kv
        kv.k.index_copy_(1, dst, new_kv.k)
        kv.v.index_copy_(1, dst, new_kv.v)
        kv.length.index_copy_(0, dst, new_kv.length)
        pool.cache.prefix_len.index_copy_(0, dst, rows.cache.prefix_len)
        self.state = sd.DecodeState(
            cache=pool.cache,
            cur_token=pool.cur_token.index_copy(0, dst, rows.cur_token),
            recent=pool.recent.index_copy(0, dst, rows.recent),
            done=pool.done.index_copy(0, dst, rows.done))

    def cancel(self, key) -> None:
        """Drop all jobs with this key (barge-in, session close). Safe
        against a concurrent step()."""
        with self._lock:
            for row, job in list(self.jobs.items()):
                if job.key == key:
                    del self.jobs[row]
                    self.active[row] = False
                    self._free.append(row)

    def step(self, n_steps: Optional[int] = None
             ) -> Dict[object, List[Tuple[np.ndarray, bool]]]:
        """Advance every active job by n_steps AR tokens (default: one codec
        chunk) in one batch; vocode and splice full windows. Returns
        {key: [(pcm24 [1,1,n], final), ...]} for the PCM emitted."""
        return self.step_submit(n_steps)()

    def step_submit(self, n_steps: Optional[int] = None):
        """Enqueue the pooled decode without fetching its tokens; returns a
        zero-argument deliver callable producing step()'s result. The pool
        state advances here (stream order keeps later start()/cancel()
        coherent); the token fetch, windowing, vocoding and splicing run at
        deliver."""
        if not self.jobs:
            return lambda: {}
        n_steps = n_steps or self.cfg.codec_chunk_size
        with self._lock:
            full = [job.key for job in self.jobs.values()
                    if job.total + n_steps > job.room]
        if full:
            raise ValueError(f"a step of {n_steps} tokens overflows the KV rows "
                             f"of {full}")
        with self._lock, torch.no_grad():
            active = torch.from_numpy(self.active.copy()).to(self.device)
            toks, self.state = sd.decode_segment(
                self.params["decoder"], self._dcfg, self.state, self.gen,
                n_steps=n_steps, top_k=self.cfg.top_k,
                penalty_window=self.cfg.penalty_window_size,
                penalty=self.cfg.penalty, active=active)
            jobs_now = list(self.jobs.items())
        return lambda: self._deliver_step(toks, jobs_now, n_steps)

    def _deliver_step(self, toks, jobs_now, n_steps: int
                      ) -> Dict[object, List[Tuple[np.ndarray, bool]]]:
        cfg = self.cfg
        dcfg = self._dcfg
        chunk, padding = cfg.codec_chunk_size, cfg.codec_padding_size
        up = cfg.codec.upsample_rate
        toks = toks.cpu().numpy() if isinstance(toks, torch.Tensor) else \
            np.asarray(toks)
        out: Dict[object, List[Tuple[np.ndarray, bool]]] = {}
        # (job, window, final, left at extraction): job.left changes as later
        # windows of the same job queue up, so the trim offset is kept per window
        windows: List[Tuple[_Job, np.ndarray, bool, int]] = []
        for row, job in jobs_now:
            t = toks[row]
            # any special id (bos/sos/eos/pad >= codec_vocab) ends the
            # sentence, as in fastpath.first_response: the codec has no
            # embedding for one
            stop = np.where(t >= dcfg.codec_vocab)[0]
            if stop.size:
                t = t[: stop[0]]
                job.done_decode = True
            # tokens past the budget never reach the buffer (StreamingTTS.run
            # clamps its last segment to the remaining budget)
            budget = cfg.max_tokens - job.total
            if t.shape[0] >= budget:
                t = t[:budget]
                job.done_decode = True
            job.total += t.shape[0]
            if job.total + n_steps > job.room:
                # the next segment would not fit the row's KV: the sentence
                # ends here, as at its token budget
                job.done_decode = True
            job.buf = np.concatenate([job.buf, t.astype(np.int64)])
            # window boundaries depend on the token count alone, so a full
            # window before eos still comes out as a steady window
            while job.buf.shape[0] >= job.left + chunk + job.right:
                win = job.buf[: job.left + chunk + job.right]
                rest = job.buf[job.left + chunk + job.right:]
                job.buf = np.concatenate([win[-(padding + job.right):], rest])
                windows.append((job, win, False, job.left))
                job.left = padding
            if job.done_decode:
                if job.buf.shape[0] > 0:
                    windows.append((job, job.buf, True, job.left))
                    job.buf = np.zeros((0,), np.int64)
                else:
                    # nothing left to vocode: still deliver a final marker
                    # (with whatever the seam buffer holds), which is what
                    # tells the caller the sentence ended
                    out.setdefault(job.key, []).append((job.pcm, True))
                with self._lock:
                    if self.jobs.get(row) is job:  # not cancelled mid-step
                        del self.jobs[row]
                        self.active[row] = False
                        self._free.append(row)

        syns = vocode(self.params["codec"], cfg.codec, self._global_tokens,
                      [w[1] for w in windows]) if windows else []
        # splice and emit in window order, so a job's final flush follows its
        # steady chunks
        for (job, win, final, left), syn in zip(windows, syns):
            if final:
                emitted = np.concatenate([job.pcm, syn[:, :, left * up:]], axis=-1)
                out.setdefault(job.key, []).append((emitted, True))
            else:
                syn = syn[:, :, left * up: syn.shape[-1] - job.right * up]
                job.pcm, emitted = find_min_seam(job.pcm, syn, cfg.seam_window,
                                                 cfg.seam_threshold)
                if emitted is not None:
                    out.setdefault(job.key, []).append((emitted, False))
        return out
