"""TiCodec VQ-VAE codec (counterpart of freeze_omni_tpu/models/codec.py;
models/decoder/ticodec/{models.py,vqvae.py} of the reference).

- `decode`: grouped/residual VQ embedding lookup + global-style-token
  embedding -> HiFiGAN-style generator (ConvTranspose upsampling x MRF
  resblocks, global feature injected at the matching channel depth) ->
  waveform (vqvae.py:37-42, models.py:169-242). The serving path.
- `encode`: the mirrored conv encoder with GroupNorm and the mid-depth
  global-token branch, then nearest-neighbour quantization (models.py:
  429-514, 540-615): voice prompts (tts.extract_global_tokens) and the codec
  round trip (bin/codec_tool.py).

Convolutions are plain PyTorch (cuDNN on the card) in NCW layout with weight
norm folded, as the JAX package leaves them to XLA. Upsample product 600:
40 Hz tokens -> 24 kHz.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import CodecConfig
from ..utils.device import resolve_device
from .layers import (_uniform, batch_norm_eval, batch_norm_init, conv1d,
                     conv1d_init, conv_transpose1d, conv_transpose1d_init,
                     embedding, linear, linear_init)

LRELU_SLOPE = 0.1


def _lrelu(x):
    return F.leaky_relu(x, LRELU_SLOPE)


def _get_padding(kernel: int, dilation: int = 1) -> int:
    return (kernel * dilation - dilation) // 2


def _resblock1_init(gen, channels: int, kernel: int, dilations, dtype,
                    device) -> dict:
    n = len(dilations)
    return {"convs1": [conv1d_init(gen, channels, channels, kernel, dtype=dtype,
                                   device=device) for _ in range(n)],
            "convs2": [conv1d_init(gen, channels, channels, kernel, dtype=dtype,
                                   device=device) for _ in range(n)]}


def init_params(cfg: CodecConfig, gen: torch.Generator, dtype=torch.float32,
                device=None, with_encoder: bool = False) -> dict:
    """Random weights drawn from `gen` on `device` (None: the card), in the
    JAX tree layout: the decode branch (generator + quantizer codebooks),
    and with `with_encoder` the encoder branch, drawn after every decode
    leaf so the decode weights of a seed do not depend on it."""
    device = resolve_device(device)
    uic = cfg.upsample_initial_channel
    ups, resblocks = [], []
    ch = uic
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        ups.append(conv_transpose1d_init(gen, uic // (2 ** i), uic // (2 ** (i + 1)),
                                         k, dtype=dtype, device=device))
        ch = uic // (2 ** (i + 1))
        for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            resblocks.append(_resblock1_init(gen, ch, rk, rd, dtype, device))
    generator = {
        "conv_pre": conv1d_init(gen, 512, uic, 7, dtype=dtype, device=device),
        "ups": ups,
        "resblocks": resblocks,
        "conv_post": conv1d_init(gen, ch, 1, 7, dtype=dtype, device=device),
    }
    group_dim = 512 // cfg.n_code_groups
    cb_bound = 1.0 / cfg.n_codes
    codebooks = [_uniform(gen, (cfg.n_code_groups, cfg.n_codes, group_dim),
                          cb_bound, dtype, device)
                 for _ in range(cfg.residual_layers)]
    g_dim = cfg.global_feature_dim // cfg.global_code_num
    gst = _uniform(gen, (cfg.global_code_num, cfg.n_codes, g_dim), cb_bound,
                   dtype, device)
    params = {"generator": generator,
              "quantizer": {"codebooks": codebooks, "gst": gst}}
    if with_encoder:
        params["encoder"] = _encoder_init(cfg, gen, dtype, device)
    return params


def _encoder_init(cfg: CodecConfig, gen, dtype, device) -> dict:
    """The encoder branch: the generator's stages mirrored (channels 32 ->
    32 * 2^n), a GroupNorm after every resblock, and the global-token
    encoder (models.py:429-514, 22-57)."""
    kw = dict(dtype=dtype, device=device)
    ups, resblocks, norms = [], [], []
    rev = list(reversed(list(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes))))
    for i, (_, k) in enumerate(rev):
        ups.append(conv1d_init(gen, 32 * 2 ** i, 32 * 2 ** (i + 1), k, **kw))
        ch = 32 * 2 ** (i + 1)
        for rk, rd in zip(reversed(cfg.resblock_kernel_sizes),
                          reversed(cfg.resblock_dilation_sizes)):
            resblocks.append(_resblock1_init(gen, ch, rk, rd, dtype, device))
            norms.append({"scale": torch.ones(ch, **kw),
                          "bias": torch.zeros(ch, **kw)})
    gfc = cfg.global_feature_conv
    return {
        "conv_pre": conv1d_init(gen, 1, 32, 7, **kw),
        "ups": ups,
        "resblocks": resblocks,
        "group_norms": norms,
        "conv_post": conv1d_init(gen, 512, 512, 3, **kw),
        "gte": {
            "conv1": conv1d_init(gen, gfc[0], gfc[1], gfc[3], bias=False, **kw),
            "conv2": conv1d_init(gen, gfc[1], gfc[1], gfc[3], bias=False, **kw),
            "conv3": conv1d_init(gen, gfc[1], gfc[2], gfc[3], bias=False, **kw),
            "fn": linear_init(gen, gfc[2], gfc[2], **kw),
            "bn": batch_norm_init(gfc[2], **kw),
        },
    }


# ---------------------------------------------------------------------------
# quantizer
# ---------------------------------------------------------------------------


def quantizer_embed(params, cfg: CodecConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes: [B, T, Nq] with Nq = residual_layers * n_code_groups ->
    [B, 512, T] (Quantizer.embed, models.py:661-702)."""
    G = cfg.n_code_groups
    out = 0.0
    for r in range(cfg.residual_layers):
        groups = [embedding({"w": params["codebooks"][r][g]},
                            codes[:, :, r * G + g].long()) for g in range(G)]
        out = out + torch.cat(groups, dim=-1)   # [B, T, 512]
    return out.transpose(1, 2)


def quantizer_embed_gst(params, cfg: CodecConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: [B, 1, G] -> [B, global_feature_dim] (embed_gst,
    models.py:703-715)."""
    groups = [embedding({"w": params["gst"][g]}, tokens[:, 0, g].long())
              for g in range(cfg.global_code_num)]
    return torch.cat(groups, dim=-1)


def codeword_distances(codebook: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """codebook [n, d], x [N, d] -> [N, n]: |x|^2 + |c|^2 - 2 x.c in f32, as
    the JAX version computes it. On the card the product is f32 unless the
    process turned TF32 on (torch.backends.cuda.matmul.allow_tf32, off by
    default), so the card and the CPU differ only by f32 rounding."""
    x, codebook = x.float(), codebook.float()
    return ((x * x).sum(1, keepdim=True) + (codebook * codebook).sum(1)
            - 2.0 * x @ codebook.T)


def _nearest(codebook: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """codebook [n, d], x [N, d] -> indices [N] of the nearest codewords
    (codeword_distances); the card and the CPU can pick differently only
    where two codewords are within f32 rounding of each other (a
    near-tie)."""
    return torch.argmin(codeword_distances(codebook, x), dim=1)


def quantize(params, cfg: CodecConfig, features: torch.Tensor,
             global_features: torch.Tensor):
    """features [B, 512, T], global [B, 128] -> (codes [B, T, Nq] int64,
    gst [B, 1, G] int64): residual groups, each the nearest codeword of
    what the earlier layers left."""
    B, C, T = features.shape
    G = cfg.n_code_groups
    gd = C // G
    residual = features.transpose(1, 2).reshape(-1, C)   # [B*T, 512]
    all_codes = []
    for r in range(cfg.residual_layers):
        qs = []
        for g in range(G):
            cb = params["codebooks"][r][g]
            idx = _nearest(cb, residual[:, g * gd:(g + 1) * gd])
            all_codes.append(idx)
            qs.append(cb[idx])
        residual = residual - torch.cat(qs, dim=-1)
    codes = torch.stack(all_codes, -1).reshape(B, T, -1)
    ggd = cfg.global_feature_dim // cfg.global_code_num
    gidx = [_nearest(params["gst"][g], global_features[:, g * ggd:(g + 1) * ggd])
            for g in range(cfg.global_code_num)]
    return codes, torch.stack(gidx, -1)[:, None, :]


# ---------------------------------------------------------------------------
# generator (decode)
# ---------------------------------------------------------------------------


def _resblock1(p, x, dilations, kernel: int):
    for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
        xt = conv1d(c1, _lrelu(x), padding=(_get_padding(kernel, d),) * 2,
                    dilation=d)
        xt = conv1d(c2, _lrelu(xt), padding=(_get_padding(kernel, 1),) * 2)
        x = xt + x
    return x


def generate(params, cfg: CodecConfig, quant: torch.Tensor,
             global_emb: torch.Tensor) -> torch.Tensor:
    """quant: [B, 512, T]; global_emb: [B, 128] -> waveform [B, 1, T*600]
    (Generator.forward, models.py:211-242)."""
    g = params["generator"]
    nk = len(cfg.resblock_kernel_sizes)
    x = conv1d(g["conv_pre"], quant, padding=(3, 3))
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = conv_transpose1d(g["ups"][i], _lrelu(x), stride=u, padding=(k - u) // 2)
        xs = None
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            r = _resblock1(g["resblocks"][i * nk + j], x, rd, rk)
            xs = r if xs is None else xs + r
        x = xs / nk
        if x.shape[1] == global_emb.shape[1]:
            x = x + global_emb[:, :, None]
    x = conv1d(g["conv_post"], _lrelu(x), padding=(3, 3))
    return torch.tanh(x)


def decode(params, cfg: CodecConfig, codes: torch.Tensor,
           global_tokens: torch.Tensor) -> torch.Tensor:
    """codes: [B, T, Nq] int; global_tokens: [B, 1, G] int -> [B, 1, T*600]
    (VQVAE.forward, vqvae.py:37-42)."""
    quant = quantizer_embed(params["quantizer"], cfg, codes)
    gemb = quantizer_embed_gst(params["quantizer"], cfg, global_tokens)
    return generate(params, cfg, quant, gemb)


# ---------------------------------------------------------------------------
# encoder (encode)
# ---------------------------------------------------------------------------


def _group_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: [B, C, T]; torch GroupNorm with C/16 groups (models.py:446-447),
    the group count derived from the channel dim as in the JAX version."""
    B, C, T = x.shape
    g = C // 16
    xg = x.reshape(B, g, C // g * T)
    mean = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, unbiased=False, keepdim=True)
    x = ((xg - mean) * torch.rsqrt(var + eps)).reshape(B, C, T)
    return x * p["scale"][None, :, None] + p["bias"][None, :, None]


def _global_token_encoder(p, cfg: CodecConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, gfc0, T] -> [B, gfc2] (models.py:22-57)."""
    gfc = cfg.global_feature_conv
    pad = ((gfc[3] - gfc[4]) // 2,) * 2
    for name in ("conv1", "conv2", "conv3"):
        x = _lrelu(conv1d(p[name], x, stride=gfc[4], padding=pad))
    x = _lrelu(linear(p["fn"], x.mean(dim=2)))
    return batch_norm_eval(p["bn"], x, eps=1e-5, channel_axis=1)


def encode_features(params, cfg: CodecConfig, wav: torch.Tensor):
    """wav: [B, 1, n] -> (features [B, 512, n/600], global [B, 128])
    (Encoder.forward, models.py:475-514)."""
    e = params["encoder"]
    nk = len(cfg.resblock_kernel_sizes)
    n_ups = len(cfg.upsample_rates)
    rev = list(reversed(list(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes))))
    rks = list(reversed(cfg.resblock_kernel_sizes))
    rds = list(reversed(cfg.resblock_dilation_sizes))
    x = conv1d(e["conv_pre"], wav, padding=(3, 3))
    global_features = None
    for i, (u, k) in enumerate(rev):
        x = conv1d(e["ups"][i], _lrelu(x), stride=u, padding=((k - u) // 2,) * 2)
        xs = None
        for j in range(nk):
            r = _resblock1(e["resblocks"][i * nk + j], x, rds[j], rks[j])
            r = _group_norm(e["group_norms"][i * nk + j], r)
            xs = r if xs is None else xs + r
        x = xs / nk
        if i == n_ups // 2 - 1:
            global_features = _global_token_encoder(e["gte"], cfg, x)
    # F.leaky_relu's default slope 0.01 here (models.py:493)
    x = conv1d(e["conv_post"], F.leaky_relu(x), padding=(1, 1))
    return x, global_features


def encode(params, cfg: CodecConfig, wav: torch.Tensor):
    """wav: [B, 1, n] -> (codes [B, T, Nq], global_tokens [B, 1, G])
    (VQVAE.encode, vqvae.py:44-57)."""
    feats, gfeat = encode_features(params, cfg, wav)
    return quantize(params["quantizer"], cfg, feats, gfeat)
