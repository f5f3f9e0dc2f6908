"""freeze_omni_tpu_torch: the PyTorch + CUDA port of freeze_omni_tpu for NVIDIA Hopper.

The JAX package beside it is the reference. This package keeps its module
layout, names and parameter layouts (linear `w` is [in, out], layer stacks are
[L, ...], int8 leaves are `w_q` + `scale`), so every function here has a
counterpart there and parity tests compare like with like.

It imports nothing of the JAX package and no JAX. Entry points take
`device=None`, which means the CUDA card; without one they raise. Tests pass
`device="cpu"`, where each kernel wrapper runs its plain PyTorch version.

    from freeze_omni_tpu_torch.config import flagship_system, tiny_system
    from freeze_omni_tpu_torch.runtime.engine import ServingEngine
"""

__version__ = "0.1.0"
