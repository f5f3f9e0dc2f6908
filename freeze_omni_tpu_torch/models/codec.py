"""TiCodec VQ-VAE codec, decode half (counterpart of
freeze_omni_tpu/models/codec.py; models/decoder/ticodec/{models.py,vqvae.py}
of the reference).

`decode`: grouped/residual VQ embedding lookup + global-style-token
embedding -> HiFiGAN-style generator (ConvTranspose upsampling x MRF
resblocks, global feature injected at the matching channel depth) ->
waveform (vqvae.py:37-42, models.py:169-242). Convolutions are plain PyTorch
(cuDNN on the card) in NCW layout with weight norm folded, as the JAX
package leaves them to XLA. Upsample product 600: 40 Hz tokens -> 24 kHz.

The encode half (`encode`, `quantize`, the encoder branch of init_params)
serves voice prompts and training and is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import CodecConfig
from ..utils.device import resolve_device
from .layers import (_uniform, conv1d, conv1d_init, conv_transpose1d,
                     conv_transpose1d_init, embedding)

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
                device=None) -> dict:
    """Random decode-branch weights (generator + quantizer codebooks) drawn
    from `gen` on `device` (None: the card), in the JAX tree layout."""
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
    return {"generator": generator,
            "quantizer": {"codebooks": codebooks, "gst": gst}}


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
