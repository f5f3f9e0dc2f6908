"""TiCodec GAN training: discriminators and losses (counterpart of
freeze_omni_tpu/training/codec_gan.py; models/decoder/ticodec/models.py:
257-426 of the reference).

HiFiGAN-style multi-period and multi-scale discriminators, LSGAN
adversarial losses, feature matching, a log-mel L1 reconstruction loss
(through the port's torch `fbank`, which autograd differentiates), the VQ
codebook/commitment losses (Quantizer.for_one_step, models.py:610-613), the
dead-code reseed, `autoencode` (the encode -> quantize -> decode generator
of scripts/train_tiny_s2s.py, with the VQ losses as its auxiliary loss) and
`gan_step`: one discriminator update, then one generator update, each with
its own clipped Adam (`optim.adam` + `optim.clip_by_global_norm_`,
optax.chain(clip_by_global_norm, adam)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import CodecConfig, FbankConfig
from ..frontend.fbank import fbank
from ..models import codec as codec_mod
from ..models.codec import _lrelu
from ..models.layers import _uniform, conv1d, conv1d_init
from ..utils.device import resolve_device
from . import optim

PERIODS = (2, 3, 5, 7, 11)

# (cin, cout, kernel, stride, groups) per scale-discriminator conv
MSD_SPECS = (
    (1, 128, 15, 1, 1), (128, 128, 41, 2, 4), (128, 256, 41, 2, 16),
    (256, 512, 41, 4, 16), (512, 1024, 41, 4, 16), (1024, 1024, 41, 1, 16),
    (1024, 1024, 5, 1, 1),
)


def _conv2d_k1_init(gen, cin: int, cout: int, k: int, device) -> dict:
    """(k, 1) kernel of the period discriminators."""
    bound = 1.0 / math.sqrt(cin * k)
    return {"w": _uniform(gen, (cout, cin, k, 1), bound, torch.float32, device),
            "b": _uniform(gen, (cout,), bound, torch.float32, device)}


def init_period_discriminator(gen, device=None) -> dict:
    chans = [(1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024)]
    return {"convs": [_conv2d_k1_init(gen, cin, cout, 5, device)
                      for cin, cout in chans],
            "post": _conv2d_k1_init(gen, 1024, 1, 3, device)}


def period_discriminator(p, x: torch.Tensor, period: int):
    """x: [B, 1, T] -> (score [B, n], fmaps): (5, 1) convs over the signal
    folded to [T / period, period] (models.py:257-307)."""
    B, C, T = x.shape
    pad = (period - T % period) % period
    if pad:
        x = F.pad(x, (0, pad), mode="reflect")
        T = T + pad
    x = x.reshape(B, C, T // period, period)
    fmaps = []
    for conv, s in zip(p["convs"], (3, 3, 3, 3, 1)):
        x = _lrelu(F.conv2d(x, conv["w"], conv["b"], stride=(s, 1),
                            padding=(2, 0)))
        fmaps.append(x)
    x = F.conv2d(x, p["post"]["w"], p["post"]["b"], padding=(1, 0))
    fmaps.append(x)
    return x.reshape(B, -1), fmaps


def init_scale_discriminator(gen, device=None) -> dict:
    return {"convs": [conv1d_init(gen, cin, cout, k, groups=g, device=device)
                      for cin, cout, k, s, g in MSD_SPECS],
            "post": conv1d_init(gen, 1024, 1, 3, device=device)}


def scale_discriminator(p, x: torch.Tensor):
    """x: [B, 1, T] -> (score, fmaps) (models.py:309-340)."""
    fmaps = []
    for conv, (_, _, k, s, g) in zip(p["convs"], MSD_SPECS):
        x = _lrelu(conv1d(conv, x, stride=s, padding=(k // 2, k // 2), groups=g))
        fmaps.append(x)
    x = conv1d(p["post"], x, padding=(1, 1))
    fmaps.append(x)
    return x.reshape(x.shape[0], -1), fmaps


def init_discriminators(gen: torch.Generator, device=None) -> dict:
    device = resolve_device(device)
    return {"mpd": [init_period_discriminator(gen, device) for _ in PERIODS],
            "msd": [init_scale_discriminator(gen, device) for _ in range(3)]}


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """Mean over windows of 4 with stride 2 and XLA's SAME zero padding
    (lax.reduce_window(add) / 4)."""
    T = x.shape[-1]
    out = -(-T // 2)
    total = max((out - 1) * 2 + 4 - T, 0)
    x = F.pad(x, (total // 2, total - total // 2))
    return F.avg_pool1d(x, 4, 2)


def run_discriminators(params, wav: torch.Tensor):
    """wav: [B, 1, T] -> [(score, fmaps)] over the 5 period and 3 scale
    discriminators."""
    outs = [period_discriminator(p, wav, period)
            for p, period in zip(params["mpd"], PERIODS)]
    x = wav
    for i, p in enumerate(params["msd"]):
        if i > 0:
            x = _avg_pool_same(x)
        outs.append(scale_discriminator(p, x))
    return outs


def discriminator_loss(real_outs, fake_outs) -> torch.Tensor:
    loss = 0.0
    for (dr, _), (dg, _) in zip(real_outs, fake_outs):
        loss = loss + torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
    return loss


def generator_adv_loss(fake_outs) -> torch.Tensor:
    return sum(torch.mean((1.0 - dg) ** 2) for dg, _ in fake_outs)


def feature_matching_loss(real_outs, fake_outs) -> torch.Tensor:
    loss = 0.0
    for (_, fr), (_, ff) in zip(real_outs, fake_outs):
        for r, f in zip(fr, ff):
            loss = loss + torch.mean(torch.abs(r - f))
    return 2.0 * loss


def mel_l1_loss(real: torch.Tensor, fake: torch.Tensor,
                sample_rate: int = 24000) -> torch.Tensor:
    """Log-mel L1 between waveforms [B, 1, T] (the HiFiGAN mel loss)."""
    cfg = FbankConfig(sample_rate=sample_rate, num_mel_bins=80,
                      frame_length_ms=1024 / sample_rate * 1000,
                      frame_shift_ms=256 / sample_rate * 1000,
                      preemphasis=0.0, remove_dc_offset=False)
    m_r = fbank(real[:, 0] * 32768.0, cfg)
    m_f = fbank(fake[:, 0] * 32768.0, cfg)
    return torch.mean(torch.abs(m_r - m_f))


def vq_losses(quantized: torch.Tensor, pre_quant: torch.Tensor,
              codebook_lambda: float = 1.0,
              commitment_lambda: float = 0.25) -> torch.Tensor:
    """Straight-through VQ losses (models.py:610-613)."""
    codebook = torch.mean((quantized - pre_quant.detach()) ** 2)
    commit = torch.mean((quantized.detach() - pre_quant) ** 2)
    return codebook_lambda * codebook + commitment_lambda * commit


def autoencode(gen_params: dict, cfg: CodecConfig, wav: torch.Tensor,
               global_tokens: torch.Tensor):
    """wav [B, 1, n] -> (reconstruction [B, 1, n], VQ loss): the encoder's
    features quantized to their nearest codewords, passed to the generator
    by the straight-through estimator, with the codebook/commitment losses
    returned for gan_step to add (without them the codebooks never leave
    their random init). global_tokens [1, 1, G] fix the style tokens."""
    feats, gfeat = codec_mod.encode_features(gen_params, cfg, wav)
    codes, _ = codec_mod.quantize(gen_params["quantizer"], cfg, feats.detach(),
                                  gfeat.detach())
    quant = codec_mod.quantizer_embed(gen_params["quantizer"], cfg, codes)
    aux = vq_losses(quant, feats)
    st = feats + (quant - feats).detach()
    gst = global_tokens.expand(wav.shape[0], *global_tokens.shape[1:])
    gemb = codec_mod.quantizer_embed_gst(gen_params["quantizer"], cfg, gst)
    return codec_mod.generate(gen_params, cfg, st, gemb), aux


@dataclass
class GanTrainState:
    """Generator and discriminator trees (autograd leaves), their
    optimizers and the step count; `gan_step` updates them in place."""

    gen_params: dict
    disc_params: dict
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer
    step: int = 0
    clip: float = 10.0


def init_gan_state(gen_params: dict, disc_params: dict, lr: float = 2e-4,
                   disc_lr: float = None, clip: float = 10.0) -> GanTrainState:
    """Copies both trees into autograd leaves under the JAX package's
    make_gan_optimizers settings: Adam(b1 0.8, b2 0.99) after global-norm
    clipping at `clip`, each with its own rate (the generator needs a high
    one at tiny dims, where the LSGAN discriminator diverges)."""
    g = optim.trainable(gen_params)
    d = optim.trainable(disc_params)
    return GanTrainState(g, d, optim.adam(g, lr, 0.8, 0.99),
                         optim.adam(d, lr if disc_lr is None else disc_lr,
                                    0.8, 0.99), 0, clip)


def reseed_dead_codes(gen_params: dict, cfg: CodecConfig,
                      features: torch.Tensor, rng: np.random.RandomState,
                      noise: float = 1e-3) -> Tuple[dict, int]:
    """Restart codebook entries that no feature in `features` maps to
    (k-means-style dead-code reinit): each unused entry becomes an actual
    residual feature plus `noise` x N(0, 1), drawn from `rng` as the JAX
    package draws them. On the host in numpy; the codebook tensors are
    written in place, so an optimizer over them keeps its leaves.

    features: [B, C, T] pre-quant encoder output. Returns (params, n_dead)."""
    C = features.shape[1]
    feats = features.detach().float().cpu().transpose(1, 2).reshape(-1, C).numpy()
    G = cfg.n_code_groups
    gd = C // G
    cbs = gen_params["quantizer"]["codebooks"]
    total_dead = 0
    residual = feats.copy()
    for r in range(cfg.residual_layers):
        cb_r = cbs[r].detach().cpu().numpy().copy()
        for g in range(G):
            cb = cb_r[g]
            x = residual[:, g * gd:(g + 1) * gd]
            d = (x ** 2).sum(1)[:, None] + (cb ** 2).sum(1)[None] - 2.0 * x @ cb.T
            idx = d.argmin(1)
            used = np.zeros(cb.shape[0], bool)
            used[np.unique(idx)] = True
            dead = ~used
            n_dead = int(dead.sum())
            if n_dead:
                picks = x[rng.randint(0, x.shape[0], n_dead)]
                cb_r[g, dead] = picks + noise * rng.randn(n_dead, gd).astype(cb.dtype)
                total_dead += n_dead
            residual[:, g * gd:(g + 1) * gd] = x - cb_r[g][idx]
        with torch.no_grad():
            cbs[r].copy_(torch.from_numpy(cb_r))
    return gen_params, total_dead


def gan_step(state: GanTrainState, cfg: CodecConfig, wav: torch.Tensor,
             gen_fn, adv_weight: float = 1.0) -> Tuple[GanTrainState, dict]:
    """One discriminator update, then one generator update against the
    updated discriminators. gen_fn(gen_params, wav) returns the
    reconstruction [B, 1, T], or (reconstruction, aux_loss) with aux_loss
    (the VQ losses) added to the generator's objective. adv_weight scales
    adv + fm; 0 is a pure-reconstruction warm phase."""
    def run_gen(gp):
        out = gen_fn(gp, wav)
        return out if isinstance(out, tuple) else (out, torch.zeros((), device=wav.device))

    d_leaves = optim.leaves(state.disc_params)
    with torch.no_grad():
        fake, _ = run_gen(state.gen_params)
    t = min(fake.shape[-1], wav.shape[-1])
    d_loss = discriminator_loss(run_discriminators(state.disc_params, wav[..., :t]),
                                run_discriminators(state.disc_params, fake[..., :t]))
    d_grads = list(torch.autograd.grad(d_loss, d_leaves))
    optim.clip_by_global_norm_(d_grads, state.clip)
    optim.set_grads(state.disc_params, d_grads)
    state.disc_opt.step()

    g_leaves = optim.leaves(state.gen_params)
    fake, aux = run_gen(state.gen_params)
    t = min(fake.shape[-1], wav.shape[-1])
    with torch.no_grad():   # the real features are constants of the generator
        real_outs = run_discriminators(state.disc_params, wav[..., :t])
    fake_outs = run_discriminators(state.disc_params, fake[..., :t])
    adv = generator_adv_loss(fake_outs)
    fm = feature_matching_loss(real_outs, fake_outs)
    mel = 45.0 * mel_l1_loss(wav[..., :t], fake[..., :t], cfg.sample_rate)
    g_loss = adv_weight * (adv + fm) + mel + aux
    g_grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        g_leaves, torch.autograd.grad(g_loss, g_leaves, allow_unused=True))]
    optim.clip_by_global_norm_(g_grads, state.clip)
    optim.set_grads(state.gen_params, g_grads)
    state.gen_opt.step()
    state.step += 1
    metrics = {"d_loss": d_loss, "g_loss": g_loss, "adv": adv, "fm": fm,
               "mel": mel, "aux": aux}
    return state, {k: v.detach() for k, v in metrics.items()}
