"""The port's training path (training/train_step.py, optim.py, data.py,
models/masks.py, qwen2.train_forward, lora.delta) against the JAX package
on the CPU, at 2-layer widths.

Each curriculum stage runs one step from the same weights (the JAX init,
carried as numpy) on the same synthetic batch (training/data.py, numpy, the
same draws in both packages): the loss within 1e-5 relative, every
trainable leaf's gradient within 1e-4 of its largest entry (float32 sums in
other orders). After one AdamW step the parameters agree within 1e-6 where
the gradient is resolved: |g| above 1e-3 of the tree's largest gradient.
The first Adam step moves a parameter by lr * g / (|g| + eps), about
lr * sign(g), so an entry whose gradient is rounding noise (a key bias,
under a softmax that ignores it, has a gradient of exactly 0 in exact
arithmetic) moves by up to lr either way in either package; such entries
are held to 2 * lr. Given the same gradients, the two optimizers agree
within 1e-6 on every entry (test_adamw_update_matches_optax).
The frozen LLM gets no gradient and is not changed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from freeze_omni_tpu import config as jcfg
from freeze_omni_tpu.models import audio_llm as jaudio_llm
from freeze_omni_tpu.models import lora as jlora
from freeze_omni_tpu.models import masks as jmasks
from freeze_omni_tpu.models import qwen2 as jqwen2
from freeze_omni_tpu.models import speech_decoder as jsd
from freeze_omni_tpu.training import data as jdata
from freeze_omni_tpu.training import train_step as jts
from freeze_omni_tpu_torch import config as tcfg
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.models import masks as tmasks
from freeze_omni_tpu_torch.models import qwen2 as tqwen2
from freeze_omni_tpu_torch.training import data as tdata
from freeze_omni_tpu_torch.training import optim
from freeze_omni_tpu_torch.training import train_step as tts

LOSS_RTOL = 1e-5
GRAD_FRAC = 1e-4
PARAM_ATOL = 1e-6
LR = 1e-3


def cfgs(mod, prompt=False):
    cfg = mod.AudioLLMConfig(
        encoder=mod.EncoderConfig(input_dim=80, output_dim=32, attention_dim=32,
                                  attention_heads=4, linear_units=64,
                                  num_blocks=2, chunk_size=4, left_chunks=2,
                                  pe_max_len=256),
        adapter=mod.AdapterConfig(enc_out_dim=32, llm_dim=128),
        llm=mod.LLMConfig(hidden=128, num_layers=2, num_heads=4, num_kv_heads=2,
                          ffn=256, vocab_size=128, max_kv_len=64),
        prompt_finetune=prompt)
    dcfg = mod.SpeechDecoderConfig(idim=32, hidden=32, num_layers=2, num_heads=2,
                                   ffn=64, codec_vocab=16, max_kv_len=64)
    return cfg, dcfg


def jax_trees(stage):
    """(trainable, frozen) of `stage` as bin/train.py builds them, numpy."""
    cfg, dcfg = cfgs(jcfg, prompt=stage == "prompt")
    p = jaudio_llm.init_params(jax.random.PRNGKey(0), cfg)
    dec = lambda: jsd.init_params(jax.random.PRNGKey(1), dcfg)  # noqa: E731
    if stage == "ctc":
        tr = {"encoder_user": p["encoder_user"],
              "ctc_head": jts.init_ctc_head(jax.random.PRNGKey(2), cfg, 16)}
        fr = {}
    elif stage == "align":
        tr = {k: p[k] for k in ("encoder_user", "adapter_user")}
        fr = {"llm": p["llm"]}
    elif stage == "prompt":
        tr = {"prompt_embeddings": p["prompt_embeddings"]}
        fr = {k: p[k] for k in ("llm", "encoder_user", "adapter_user")}
    elif stage == "state":
        tr = {k: p[k] for k in ("encoder_user", "adapter_user", "predictor")}
        fr = {"llm": p["llm"]}
    elif stage == "decoder":
        tr, fr = {"speech_decoder": dec()}, {}
    elif stage == "lora":
        lo = jlora.init(jax.random.PRNGKey(3), cfg.llm, rank=4)
        # B drawn non-zero, so the adapter's delta and A's gradient are not 0
        rng = np.random.RandomState(5)
        lo = {k: {"a": v["a"], "b": 0.05 * rng.randn(*v["b"].shape)
                  .astype(np.float32)} for k, v in lo.items()}
        tr, fr = {"lora": lo}, {"llm": p["llm"]}
    else:
        tr = {k: p[k] for k in ("encoder_user", "adapter_user", "predictor")}
        tr["speech_decoder"] = dec()
        fr = {"llm": p["llm"]}
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return to_np(tr), to_np(fr)


def assert_tree_close(got, want, what, frac=None, atol=None):
    """Leaf by leaf: |got - want| <= frac * max|want| (+ atol)."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_tree_close(got[k], want[k], f"{what}/{k}", frac, atol)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, f"{what}/{i}", frac, atol)
        return
    g = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    tol = (atol or 0.0) + (frac or 0.0) * float(np.abs(w).max(initial=0.0))
    err = float(np.abs(g - w).max(initial=0.0))
    assert err <= tol, (what, err, tol)


def assert_params_close(got, want, grads):
    """Parameters after one step: within PARAM_ATOL where the gradient is
    resolved, within 2 * LR elsewhere (see the module docstring)."""
    g_all = [np.abs(np.asarray(g)) for g in jax.tree.leaves(grads)]
    resolved = 1e-3 * max(float(g.max(initial=0.0)) for g in g_all)
    got = jax.tree.leaves(optim.map_tree(lambda t: t.detach().numpy(), got))
    for p, w, g in zip(got, jax.tree.leaves(want), g_all):
        err = np.abs(p - np.asarray(w))
        assert err[g > resolved].max(initial=0.0) <= PARAM_ATOL
        assert err.max(initial=0.0) <= 2 * LR


def jax_step(stage, tr, fr, batch):
    cfg, dcfg = cfgs(jcfg, prompt=stage == "prompt")
    opt = optax.adamw(LR, weight_decay=0.01)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(t):
        if stage == "all":
            return jts.audio_llm_loss(
                {k: t[k] for k in ("encoder_user", "adapter_user", "predictor")},
                fr, cfg, jb["fbank"], jb["labels"], jb["label_mask"]) \
                + 0.1 * jts.speech_decoder_loss(
                    t["speech_decoder"], dcfg, jb["dec_hidden"],
                    jb["dec_hidden_lens"], jb["dec_y"], jb["dec_y_lens"]) \
                / jb["dec_y"].shape[0]
        return jts.stage_loss(stage, t, fr, cfg, dcfg, jb)

    jt = jax.tree.map(jnp.asarray, tr)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jt)
    updates, _ = opt.update(grads, opt.init(jt), jt)
    new = optax.apply_updates(jt, updates)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return float(loss), to_np(grads), to_np(new)


@pytest.mark.parametrize("stage", tts.STAGES)
def test_stage_step_matches_jax(stage):
    tr, fr = jax_trees(stage)
    jcfg_, jdcfg = cfgs(jcfg)
    batch = next(jdata.stage_batches(stage, jcfg_, jdcfg, 2, 1, seed=7))
    loss_j, grads_j, new_j = jax_step(stage, tr, fr, batch)

    cfg, dcfg = cfgs(tcfg, prompt=stage == "prompt")
    frozen = weights.from_jax(fr, device="cpu")
    state = tts.init_train_state(weights.from_jax(tr, device="cpu"), lr=LR)
    tb = tts.to_tensors(next(tdata.stage_batches(stage, cfg, dcfg, 2, 1, seed=7)),
                        "cpu")
    state, metrics = tts.stage_step(stage, state, frozen, cfg, dcfg, tb)

    loss = float(metrics["loss"])
    assert abs(loss - loss_j) <= LOSS_RTOL * abs(loss_j), (loss, loss_j)
    grads = optim.map_tree(lambda p: p.grad, state.trainable)
    assert_tree_close(grads, grads_j, "grad", frac=GRAD_FRAC, atol=1e-7)
    assert_params_close(state.trainable, new_j, grads_j)
    assert state.step == 1
    # the frozen tree is the caller's, untouched and without gradients
    for t in optim.leaves(frozen):
        assert t.grad is None and not t.requires_grad
    assert_tree_close(frozen, fr, "frozen", atol=0.0)


def test_batches_are_the_jax_draws():
    jc, jd = cfgs(jcfg)
    tc, td = cfgs(tcfg)
    for stage in tts.STAGES:
        for jb, tb in zip(jdata.stage_batches(stage, jc, jd, 3, 2, seed=4),
                          tdata.stage_batches(stage, tc, td, 3, 2, seed=4)):
            assert jb.keys() == tb.keys()
            for k in jb:
                np.testing.assert_array_equal(jb[k], tb[k])
    # resume: batch i of seed s + k is batch i + k of seed s
    a = list(tdata.stage_batches("state", tc, td, 2, 5, seed=10))
    b = list(tdata.stage_batches("state", tc, td, 2, 3, seed=12))
    for x, y in zip(a[2:], b):
        np.testing.assert_array_equal(x["fbank"], y["fbank"])


def test_train_forward_equals_jax_forward_with_lora():
    """qwen2.train_forward with a LoRA adapter against the JAX forward over
    a fresh cache of T + 1 slots (the training losses' call)."""
    cfg, _ = cfgs(jcfg)
    p = jax.tree.map(np.asarray, jqwen2.init_params(jax.random.PRNGKey(4), cfg.llm))
    lo = jlora.init(jax.random.PRNGKey(5), cfg.llm, rank=4, targets=jlora.TARGETS)
    rng = np.random.RandomState(6)
    lo = {k: {"a": np.asarray(v["a"]),
              "b": (0.05 * rng.randn(*v["b"].shape)).astype(np.float32)}
          for k, v in lo.items()}
    emb = (rng.randn(2, 9, cfg.llm.hidden) * 0.5).astype(np.float32)
    cache = jqwen2.init_cache(cfg.llm, 2, max_len=10, dtype=jnp.float32)
    want, _ = jqwen2.forward(p, cfg.llm, jnp.asarray(emb), jnp.ones((2, 9), bool),
                             cache, lora=lo, lora_scale=0.7)
    tc, _ = cfgs(tcfg)
    got = tqwen2.train_forward(weights.from_jax(p, device="cpu"), tc.llm,
                               torch.from_numpy(emb),
                               lora=weights.from_jax(lo, device="cpu"),
                               lora_scale=0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_forward_lora_on_a_cache_equals_train_forward():
    """The serving forward with a LoRA adapter over a fresh cache gives the
    training forward's hidden states."""
    cfg, _ = cfgs(tcfg)
    gen = torch.Generator().manual_seed(0)
    p = tqwen2.init_params(cfg.llm, gen, dtype=torch.float32, device="cpu")
    from freeze_omni_tpu_torch.models import lora as tlora

    lo = tlora.init(cfg.llm, gen, rank=4, targets=("q", "down"), device="cpu")
    lo["q"]["b"].normal_(generator=gen)
    emb = torch.randn(2, 7, cfg.llm.hidden, generator=gen)
    cache = tqwen2.init_cache(cfg.llm, 2, max_len=8, dtype=torch.float32,
                              device="cpu")
    with torch.no_grad():
        want, _ = tqwen2.forward(p, cfg.llm, emb, torch.ones(2, 7, dtype=torch.bool),
                                 cache, lora=lo, lora_scale=0.5)
        got = tqwen2.train_forward(p, cfg.llm, emb, lora=lo, lora_scale=0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_adamw_update_matches_optax():
    """Given the same gradients, optim.adamw's two steps are optax.adamw's
    within 1e-6 on every entry, small gradients included."""
    rng = np.random.RandomState(2)
    tree = {"w": rng.randn(5, 4).astype(np.float32),
            "b": [rng.randn(4).astype(np.float32)]}
    grads = [{"w": (rng.randn(5, 4) * 10.0 ** rng.randint(-9, 1, (5, 4)))
              .astype(np.float32), "b": [rng.randn(4).astype(np.float32)]}
             for _ in range(2)]
    opt = optax.adamw(LR, weight_decay=0.01)
    jt = jax.tree.map(jnp.asarray, tree)
    js = opt.init(jt)
    state = tts.init_train_state(weights.from_jax(tree, device="cpu"), lr=LR)
    for g in grads:
        upd, js = opt.update(jax.tree.map(jnp.asarray, g), js, jt)
        jt = optax.apply_updates(jt, upd)
        optim.set_grads(state.trainable, optim.leaves(weights.from_jax(g, device="cpu")))
        state.optimizer.step()
    assert_tree_close(state.trainable, jax.tree.map(np.asarray, jt), "adamw",
                      atol=PARAM_ATOL)


def test_adamw_resume_continues_the_step_count():
    """Two AdamW steps equal one step, a save of the moments and count
    (optim.opt_state) and one step on a fresh optimizer that loads them."""
    gen = torch.Generator().manual_seed(1)
    tree = {"w": torch.randn(4, 3, generator=gen), "b": [torch.randn(3, generator=gen)]}
    grads = [[torch.randn(4, 3, generator=gen), torch.randn(3, generator=gen)]
             for _ in range(2)]

    def step(state, g):
        optim.set_grads(state.trainable, g)
        state.optimizer.step()

    a = tts.init_train_state(tree, lr=1e-2)
    step(a, grads[0])
    saved = {"params": optim.map_tree(lambda t: t.detach().clone(), a.trainable),
             "opt": optim.opt_state(a.optimizer, a.trainable)}
    assert int(saved["opt"]["count"][0]) == 1
    step(a, grads[1])

    b = tts.init_train_state(saved["params"], lr=1e-2)
    optim.load_opt_state(b.optimizer, b.trainable, saved["opt"])
    step(b, grads[1])
    for x, y in zip(optim.leaves(a.trainable), optim.leaves(b.trainable)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_ctc_matches_optax_on_ragged_feasible_rows():
    """F.ctc_loss against optax.ctc_loss with padded frames and targets."""
    rng = np.random.RandomState(3)
    B, T, C = 3, 12, 6
    logits = rng.randn(B, T, C).astype(np.float32)
    t_len = np.array([12, 9, 5])
    tokens = rng.randint(0, C - 1, size=(B, 4)).astype(np.int32)
    n_len = np.array([4, 2, 3])
    want = optax.ctc_loss(jnp.asarray(logits),
                          jnp.asarray(np.arange(T)[None] >= t_len[:, None],
                                      jnp.float32),
                          jnp.asarray(tokens),
                          jnp.asarray(np.arange(4)[None] >= n_len[:, None],
                                      jnp.float32), blank_id=C - 1)
    logp = torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1)
    got = torch.nn.functional.ctc_loss(
        logp, torch.from_numpy(tokens).long(), torch.from_numpy(t_len),
        torch.from_numpy(n_len), blank=C - 1, reduction="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("case", ["pad", "causal", "chunk_left", "static",
                                  "full", "dynamic", "target"])
def test_masks_match_jax(case):
    lengths = np.array([5, 9, 1])
    lt = torch.from_numpy(lengths)
    valid_j = jmasks.make_valid_mask(jnp.asarray(lengths), 9)
    valid_t = tmasks.make_valid_mask(lt, 9)
    if case == "pad":
        want = jmasks.make_pad_mask(jnp.asarray(lengths), 9)
        got = tmasks.make_pad_mask(lt, 9)
    elif case == "causal":
        want, got = jmasks.subsequent_mask(9), tmasks.subsequent_mask(9)
    elif case == "chunk_left":
        want = jmasks.subsequent_chunk_mask(9, 2, 1)
        got = tmasks.subsequent_chunk_mask(9, 2, 1)
    elif case in ("static", "full"):
        size = 4 if case == "static" else 0
        want = jmasks.add_optional_chunk_mask(9, valid_j, False, size, 1)
        got = tmasks.add_optional_chunk_mask(9, valid_t, False, size, 1)
    elif case == "dynamic":
        # the JAX draw, pinned on the port's side
        key = jax.random.PRNGKey(3)
        want = jmasks.add_optional_chunk_mask(9, valid_j, True, 0, -1, key=key,
                                              max_dynamic_chunk=5)
        chunk = int(jax.random.randint(key, (), 1, 6))
        got = tmasks.add_optional_chunk_mask(9, valid_t, True, 0, -1, chunk=chunk)
        drawn = tmasks.add_optional_chunk_mask(
            9, valid_t, True, 0, -1, gen=torch.Generator().manual_seed(0),
            max_dynamic_chunk=5)
        assert drawn.shape == (3, 9, 9)
        with pytest.raises(ValueError):
            tmasks.add_optional_chunk_mask(9, valid_t, True, 0, -1)
    else:
        want, got = jmasks.target_mask(jnp.asarray(lengths), 9), tmasks.target_mask(lt, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prompt_embeddings_are_drawn_last():
    """cfg.prompt_finetune adds the prompt table without moving any other
    leaf of the same seed."""
    from freeze_omni_tpu_torch.models import audio_llm

    cfg, _ = cfgs(tcfg)
    a = audio_llm.init_params(cfg, seed=3, device="cpu")
    b = audio_llm.init_params(dataclasses.replace(cfg, prompt_finetune=True),
                              seed=3, device="cpu")
    assert b["prompt_embeddings"].shape == (cfg.prompt_num, cfg.llm.hidden)
    for x, y in zip(optim.leaves(a), optim.leaves({k: b[k] for k in a})):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the learned VAD's training (training/vad.py): the mixtures are the JAX
# draws, the GRU scan and its weighted BCE agree within 1e-5 (probabilities)
# and 1e-4 of each leaf's largest gradient.
# ---------------------------------------------------------------------------

from freeze_omni_tpu.training import vad as jvad  # noqa: E402
from freeze_omni_tpu_torch.training import vad as tvad  # noqa: E402


def test_vad_mixtures_are_the_jax_draws():
    for seed in (0, 1, 2):
        jw, jl, jwt = jvad.make_mixture(np.random.RandomState(seed))
        tw, tl, twt = tvad.make_mixture(np.random.RandomState(seed))
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(twt, jwt)
        np.testing.assert_array_equal(tvad.features(tw), jvad.features(jw))


def test_vad_gru_scan_and_loss_gradients_match_jax():
    params = jax.tree.map(np.asarray, jvad.init_vad_params(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(3)
    params["mean"] = rng.randn(tvad.N_MEL).astype(np.float32)
    params["scale"] = (0.5 + rng.rand(tvad.N_MEL)).astype(np.float32)
    wavs = [jvad.make_mixture(rng, seconds=0.5) for _ in range(2)]
    feats = np.stack([jvad.features(w) for w, _, _ in wavs])
    labels = np.stack([lb for _, lb, _ in wavs])
    wts = np.stack([wt for _, _, wt in wavs])
    tr = {k: v for k, v in params.items() if k not in ("mean", "scale")}

    def jloss(t):
        p = dict(t, mean=params["mean"], scale=params["scale"])
        probs = jax.vmap(lambda f: jvad.forward(p, f))(jnp.asarray(feats))
        bce = -(labels * jnp.log(probs + 1e-6)
                + (1 - labels) * jnp.log(1 - probs + 1e-6))
        return (bce * wts).sum() / wts.sum(), probs

    (loss_j, probs_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, tr))
    tp = weights.from_jax(params, device="cpu")
    ttr = optim.trainable({k: tp[k] for k in tr})
    probs = tvad.forward(dict(ttr, mean=tp["mean"], scale=tp["scale"]),
                         torch.from_numpy(feats))
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(probs_j),
                               rtol=0, atol=1e-5)
    loss = tvad.bce_loss(ttr, tp, torch.from_numpy(feats),
                         torch.from_numpy(labels), torch.from_numpy(wts))
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    assert_tree_close(optim.map_tree(lambda t: t.grad, ttr),
                      jax.tree.map(np.asarray, grads_j), "vad grad",
                      frac=GRAD_FRAC, atol=1e-7)


def test_vad_train_cli_writes_weights_the_learned_vad_reads(tmp_path):
    from freeze_omni_tpu_torch.config import VADConfig
    from freeze_omni_tpu_torch.duplex.vad import LearnedVAD

    out = tvad.train(steps=2, batch=2, seed=1, device="cpu")
    assert np.isfinite(out["losses"]).all() and out["losses"].shape == (2,)
    with pytest.raises(SystemExit, match="committed"):
        tvad.main(["--out", str(tvad.COMMITTED_WEIGHTS), "--steps", "1"])
    path = str(tmp_path / "vad.npz")
    tvad.main(["--out", path, "--steps", "1", "--batch", "1", "--device", "cpu"])
    vad = LearnedVAD(VADConfig(), weights=path)
    assert set(vad.params) == {"wz", "wr", "wh", "bz", "br", "bh", "wo", "bo",
                               "mean", "scale"}
    assert 0.0 <= vad.predict({"audio": np.zeros(512, np.float32),
                               "time_stamp": None})["prob"] <= 1.0
