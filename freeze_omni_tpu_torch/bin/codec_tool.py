"""Codec encode/decode harness (counterpart of
freeze_omni_tpu/bin/codec_tool.py).

The role of the reference's VqvaeTester (models/decoder/ticodec/
vqvae_tester.py): round-trip a wav through the TiCodec encoder, quantizer
and generator and report the codes and the reconstruction.

Usage (the card by default; --device cpu runs on the CPU):
  python -m freeze_omni_tpu_torch.bin.codec_tool --input_wav in.wav \\
      [--output_wav out.wav] [--ckpt codec.pt] [--preset tiny] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description="TiCodec round-trip harness")
    p.add_argument("--preset", default="flagship", choices=["tiny", "flagship"])
    p.add_argument("--input_wav", required=True)
    p.add_argument("--output_wav", default=None)
    p.add_argument("--ckpt", default=None, help="reference codec final.pt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from .. import weights
    from ..config import flagship_system, tiny_system
    from ..frontend.wav import read_wav, resample, write_wav
    from ..models import codec as codec_mod
    from ..utils import checkpoint as ckpt_mod
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = (tiny_system() if args.preset == "tiny" else flagship_system()).tts.codec
    if args.ckpt:
        params = weights.from_jax(ckpt_mod.convert_codec(
            ckpt_mod.load_torch_state_dict(args.ckpt), cfg, with_encoder=True),
            device=device)
    else:
        params = codec_mod.init_params(
            cfg, torch.Generator(device=device).manual_seed(args.seed),
            device=device, with_encoder=True)

    wav, sr = read_wav(args.input_wav)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if sr != cfg.sample_rate:
        wav = resample(wav, sr, cfg.sample_rate)

    x = torch.from_numpy(np.asarray(wav, np.float32)[None, None, :]).to(device)
    with torch.no_grad():
        codes, gst = codec_mod.encode(params, cfg, x)
        recon = codec_mod.decode(params, cfg, codes, gst)
    recon = recon[0, 0].float().cpu().numpy()
    codes, gst = codes.cpu().numpy(), gst.cpu().numpy()

    n = min(len(wav), len(recon))
    err = float(np.sqrt(np.mean((wav[:n] - recon[:n]) ** 2)))
    print(f"input: {len(wav)} samples @ {cfg.sample_rate} Hz")
    print(f"codes: {codes.shape} (vocab {cfg.n_codes}), "
          f"global tokens: {gst.ravel().tolist()}")
    print(f"token rate: {cfg.sample_rate / cfg.upsample_rate:.1f} Hz")
    print(f"reconstruction rmse: {err:.4f} (random weights -> noise; "
          f"converted checkpoint -> speech)")
    if args.output_wav:
        write_wav(args.output_wav, recon, cfg.sample_rate)
        print(f"wrote {args.output_wav} ({len(recon)} samples)")
    return codes, gst, recon


if __name__ == "__main__":
    main()
