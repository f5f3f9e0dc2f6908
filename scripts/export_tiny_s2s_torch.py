"""Write the PyTorch port's index of the trained tiny system.

The trained tiny speech-to-speech system lives in
`freeze_omni_tpu/assets/tiny_s2s/` as an orbax/OCDBT tree, which only JAX
reads. Its arrays sit there as zstd-compressed chunks, and a second,
port-native copy of them (27.7 MB) would double what the repository
carries. So this tool reads the tree with the JAX package's `load_native`
and writes, to `freeze_omni_tpu_torch/assets/tiny_s2s/`, a byte-for-byte
copy of the system's `config.json` and `chunks.json`
(`freeze_omni_tpu_torch.utils.checkpoint._save_chunk_index`): the tree's
shape and each leaf's dtype, shape and sha256. The port then loads the
system with `utils.factory.load_native_system`, with no JAX: it
decompresses the orbax files' zstd frames with the system's libzstd and
takes each leaf from the frame whose bytes hash to its sha256.

The index holds no timestamps and lists the leaves in the tree's order, so
running this again on the committed orbax tree rewrites a byte-identical
`chunks.json`.

Run from the repository's root:
  JAX_PLATFORMS=cpu python scripts/export_tiny_s2s_torch.py
"""

from __future__ import annotations

import os
import shutil
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "freeze_omni_tpu", "assets", "tiny_s2s")
DST = os.path.join(ROOT, "freeze_omni_tpu_torch", "assets", "tiny_s2s")


def main() -> None:
    sys.path.insert(0, ROOT)
    from freeze_omni_tpu.utils.checkpoint import load_native
    from freeze_omni_tpu_torch.utils.checkpoint import (_load_chunk_index,
                                                        _save_chunk_index)

    # load_native needs an absolute path (the orbax restore resolves it)
    params_dir = os.path.abspath(os.path.join(SRC, "params"))
    tree = load_native(params_dir)
    os.makedirs(DST, exist_ok=True)
    index = os.path.join(DST, "chunks.json")
    _save_chunk_index(index, tree, params_dir)
    _load_chunk_index(index)   # every leaf is found in the orbax frames
    shutil.copyfile(os.path.join(SRC, "config.json"),
                    os.path.join(DST, "config.json"))
    print(f"wrote {index} ({os.path.getsize(index)} bytes) and config.json")


if __name__ == "__main__":
    main()
