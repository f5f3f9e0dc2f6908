"""Convert reference checkpoints into a port-native system directory
(counterpart of freeze_omni_tpu/bin/convert_ckpt.py).

The reference loads four torch files and an HF model at every process
start, and quantizing the 7B adds more. This CLI does that work once, on
the host CPU:

    python -m freeze_omni_tpu_torch.bin.convert_ckpt \\
        --model_path /ckpts --llm_path /Qwen2-7B-Instruct \\
        --out /ckpts-native --quant 8

`serve --model_path /ckpts-native`, `asr_eval` and `qa_eval` detect the
native layout (`config.json` + `params.npz`) and restore the converted,
already quantized trees directly: no torch.load of the reference files, no
re-quantization.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        description="reference checkpoints -> port-native system")
    p.add_argument("--model_path", required=True,
                   help="reference checkpoint dir (audiollm/ decoder/ codec/)")
    p.add_argument("--llm_path", required=True,
                   help="HF Qwen2 dir (weights + tokenizer)")
    p.add_argument("--out", required=True, help="output dir")
    p.add_argument("--quant", default=8, type=int, choices=[0, 8, 4],
                   help="weight-only bits for the frozen backbone (0 = keep "
                        "the checkpoint's dtype)")
    args = p.parse_args(argv)

    from ..utils.factory import (build_system_from_reference,
                                 save_native_system)

    cfg, audiollm, tts, _ = build_system_from_reference(
        args.model_path, args.llm_path,
        quantize_llm_bits=args.quant or None, device="cpu")
    save_native_system(args.out, cfg, audiollm, tts, llm_path=args.llm_path)
    print(f"native system written to {args.out} "
          f"(llm {'int%d' % args.quant if args.quant else 'unquantized'})")


if __name__ == "__main__":
    main()
