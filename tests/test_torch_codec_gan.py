"""The port's codec GAN training (training/codec_gan.py) against the JAX
package on the CPU, from the same weights (the JAX init, carried as numpy)
and the same waveforms.

Discriminator scores and feature maps agree within 1e-4 of each map's
largest magnitude and the losses within 1e-4 relative (float32
convolutions summed in other orders); the log-mel L1 within 1e-4 relative.
One gan_step: the five losses within 1e-4 relative; after the step the
parameters agree within 1e-6 where the gradient is resolved (|g| above
1e-3 of the tree's largest gradient) and within 2 * lr elsewhere: the first
Adam step moves an entry by about lr * sign(g), so a gradient that is
rounding noise moves it by up to lr either way in either package (the
gradients are the port's, which the loss agreement vouches for).
`reseed_dead_codes` given the same RandomState writes the same codebooks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freeze_omni_tpu.config import CodecConfig as JCodecConfig
from freeze_omni_tpu.models import codec as jcodec
from freeze_omni_tpu.training import codec_gan as jgan
from freeze_omni_tpu_torch import weights
from freeze_omni_tpu_torch.config import CodecConfig
from freeze_omni_tpu_torch.models import codec as tcodec
from freeze_omni_tpu_torch.training import codec_gan as tgan
from freeze_omni_tpu_torch.training import optim

REL = 1e-4
PARAM_ATOL = 1e-6
LR = 2e-4


def cfgs():
    kw = dict(upsample_rates=(8, 5, 5, 3), upsample_kernel_sizes=(16, 10, 10, 6),
              upsample_initial_channel=32, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3, 5),), n_codes=16,
              global_code_num=2, global_feature_dim=8,
              global_feature_conv=(128, 8, 8, 3, 1), global_tokens=(0, 0))
    return JCodecConfig(**kw), CodecConfig(**kw)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def disc():
    return np_tree(jgan.init_discriminators(jax.random.PRNGKey(1)))


def wav(seed, n=1200, scale=0.1):
    return (np.random.RandomState(seed).randn(1, 1, n) * scale).astype(np.float32)


def close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rel * max(float(np.abs(want).max(initial=0.0)), 1e-30), (err, want)


def test_discriminators_match_jax(disc):
    x = wav(0, 1203)     # not a multiple of any period: reflect padding
    want = jgan.run_discriminators(disc, jnp.asarray(x))
    got = tgan.run_discriminators(weights.from_jax(disc, device="cpu"),
                                  torch.from_numpy(x))
    assert len(got) == len(want) == len(tgan.PERIODS) + 3
    for (gs, gf), (ws, wf) in zip(got, want):
        close(gs, ws)
        assert len(gf) == len(wf)
        for a, b in zip(gf, wf):
            close(a, b)


def test_adversarial_and_feature_losses_match_jax(disc):
    real, fake = wav(1), wav(2)
    tp = weights.from_jax(disc, device="cpu")
    jro, jfo = (jgan.run_discriminators(disc, jnp.asarray(a)) for a in (real, fake))
    tro, tfo = (tgan.run_discriminators(tp, torch.from_numpy(a)) for a in (real, fake))
    close(tgan.discriminator_loss(tro, tfo), jgan.discriminator_loss(jro, jfo))
    close(tgan.generator_adv_loss(tfo), jgan.generator_adv_loss(jfo))
    close(tgan.feature_matching_loss(tro, tfo), jgan.feature_matching_loss(jro, jfo))
    assert float(tgan.feature_matching_loss(tro, tro)) == 0.0


def test_mel_l1_matches_jax():
    a, b = wav(3, 4800), wav(4, 4800)
    close(tgan.mel_l1_loss(torch.from_numpy(a), torch.from_numpy(b)),
          jgan.mel_l1_loss(jnp.asarray(a), jnp.asarray(b)))
    assert float(tgan.mel_l1_loss(torch.from_numpy(a), torch.from_numpy(a))) == 0.0


def test_vq_losses_and_their_gradients_match_jax():
    rng = np.random.RandomState(5)
    q, pre = rng.randn(2, 4, 8).astype(np.float32), rng.randn(2, 4, 8).astype(np.float32)
    wl, (wgq, wgp) = jax.value_and_grad(jgan.vq_losses, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(pre))
    tq, tp = (torch.from_numpy(a).requires_grad_(True) for a in (q, pre))
    loss = tgan.vq_losses(tq, tp)
    loss.backward()
    close(loss, wl, 1e-6)
    close(tq.grad, wgq, 1e-6)
    close(tp.grad, wgp, 1e-6)


@pytest.mark.parametrize("n", [1200, 1201, 7])
def test_scale_pooling_is_xla_same_padding(n):
    x = np.random.RandomState(n).randn(1, 1, n).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), 0.0, jax.lax.add, (1, 1, 4),
                                 (1, 1, 2), "SAME") / 4.0
    close(tgan._avg_pool_same(torch.from_numpy(x)), want, 1e-6)


def test_gan_step_matches_jax(disc):
    jc, tc = cfgs()
    gen = np_tree(jcodec.init_params(jax.random.PRNGKey(0), jc))
    x = wav(3)
    codes = np.zeros((1, 2, 1), np.int32)
    gst = np.zeros((1, 1, 2), np.int32)

    def jgen(gp, w):
        return jcodec.decode(gp, jc, jnp.asarray(codes), jnp.asarray(gst))

    g_opt, d_opt = jgan.make_gan_optimizers(lr=LR)
    jstate = jgan.GanTrainState(gen, disc, g_opt.init(gen), d_opt.init(disc),
                                jnp.zeros((), jnp.int32))
    step = jax.jit(lambda st, w: jgan.gan_step(st, jc, w, jgen, g_opt, d_opt))
    jnew, jm = step(jstate, jnp.asarray(x))

    tstate = tgan.init_gan_state(weights.from_jax(gen, device="cpu"),
                                 weights.from_jax(disc, device="cpu"), lr=LR)
    tt = lambda a: torch.from_numpy(a).long()  # noqa: E731
    tstate, tm = tgan.gan_step(
        tstate, tc, torch.from_numpy(x),
        lambda gp, w: tcodec.decode(gp, tc, tt(codes), tt(gst)))
    assert tstate.step == 1
    for k in ("d_loss", "g_loss", "adv", "fm", "mel"):
        close(tm[k], jm[k])
    # the resolved-entry rule on the port's (clipped) gradients: one scale
    # a tree, so the share of the largest gradient is the unclipped one's
    for got, want in ((tstate.disc_params, jnew.disc_params),
                      (tstate.gen_params, jnew.gen_params)):
        np_of = lambda f: jax.tree.leaves(optim.map_tree(f, got))  # noqa: E731
        g_all = np_of(lambda t: np.abs(t.grad.numpy()))
        resolved = 1e-3 * max(float(g.max(initial=0.0)) for g in g_all)
        got_l = np_of(lambda t: t.detach().numpy())
        for p, w, g in zip(got_l, jax.tree.leaves(want), g_all):
            err = np.abs(p - np.asarray(w))
            assert err[g > resolved].max(initial=0.0) <= PARAM_ATOL
            assert err.max(initial=0.0) <= 2 * LR


def test_reseed_dead_codes_matches_jax():
    jc, tc = cfgs()
    gen = np_tree(jcodec.init_params(jax.random.PRNGKey(2), jc))
    feats = (np.random.RandomState(6).randn(2, 512, 5) * 0.05).astype(np.float32)
    want, n_want = jgan.reseed_dead_codes(gen, jc, jnp.asarray(feats),
                                          np.random.RandomState(9))
    tp = weights.from_jax(gen, device="cpu")
    before = [cb.data_ptr() for cb in tp["quantizer"]["codebooks"]]
    got, n_got = tgan.reseed_dead_codes(tp, tc, torch.from_numpy(feats),
                                        np.random.RandomState(9))
    assert n_got == n_want > 0
    for a, b in zip(got["quantizer"]["codebooks"], want["quantizer"]["codebooks"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # written in place: an optimizer over these leaves keeps them
    assert [cb.data_ptr() for cb in got["quantizer"]["codebooks"]] == before


def test_autoencode_matches_the_jax_training_generator():
    """autoencode against the JAX composition of scripts/train_tiny_s2s.py
    (encode_features -> quantize -> straight-through -> generate, VQ loss),
    with the encoder branch drawn non-trivially: the PCM within 1e-4 of its
    largest magnitude, the VQ loss within 1e-4 relative."""
    jc, tc = cfgs()
    gen = np_tree(jcodec.init_params(jax.random.PRNGKey(4), jc, with_encoder=True))
    x = wav(8, 2400)
    gt = np.zeros((1, 1, jc.global_code_num), np.int32)

    feats, gfeat = jcodec.encode_features(gen, jc, jnp.asarray(x))
    codes, _ = jcodec.quantize(gen["quantizer"], jc, feats, gfeat)
    quant = jcodec.quantizer_embed(gen["quantizer"], jc, codes)
    aux_j = jgan.vq_losses(quant, feats)
    gemb = jcodec.quantizer_embed_gst(gen["quantizer"], jc, jnp.asarray(gt))
    want = jcodec.generate(gen, jc, quant, gemb)

    got, aux = tgan.autoencode(weights.from_jax(gen, device="cpu"), tc,
                               torch.from_numpy(x), torch.from_numpy(gt).long())
    close(got, want)
    close(aux, aux_j)
