"""Build and load the hand-written CUDA kernels in csrc/.

Each `csrc/<name>.cu` exposes a plain C launch function. It is compiled with
nvcc for sm_90a into a shared library at first use and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, of every header in csrc/ and of
the flags, so an edited kernel or header is rebuilt and a built one is
reused. The build directory is
freeze_omni_tpu_torch/.kernel_build (listed in .gitignore). A missing nvcc or
a failed build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".kernel_build"
KERNELS = ("quant_matmul", "quant_matmul4", "prefill_quant", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.PyDLL] = {}
_workspaces: Dict[tuple, tuple] = {}


class KernelBuildFailure(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildFailure(
        "nvcc not found (PATH or $CUDA_HOME/bin); the port's CUDA kernels are "
        "built from freeze_omni_tpu_torch/csrc at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.name.encode() + header.read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc per source, all started together. Returns {name: {"path", "seconds",
    "ptxas"}}; "seconds" is 0.0 and "ptxas" empty for a library already
    built. Raises KernelBuildFailure with nvcc's output on any failure."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info: Dict[str, dict] = {}
    procs = {}
    nvcc = None
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            info[name] = {"path": str(out), "seconds": 0.0, "ptxas": ""}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        info[name] = {"path": str(out),
                      "seconds": time.perf_counter() - t0, "ptxas": log}
    if failures:
        raise KernelBuildFailure("\n".join(failures))
    return info


def load(name: str) -> ctypes.PyDLL:
    """The loaded library of kernel `name`, built first if needed. Loaded
    as a PyDLL: a launch function returns in microseconds without touching
    Python, so it keeps the GIL instead of releasing and retaking it on
    every launch, which costs time when other threads (a server's) are
    waiting for the GIL."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build([name])[name]["path"]
            lib = ctypes.PyDLL(path)
            _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def on_device(dev: int):
    """A context in which card `dev` is the current device, the launch
    functions' target: `torch.cuda.device(dev)` only where another card is
    current, since entering it costs the host microseconds a call."""
    if torch.cuda.current_device() == dev:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def workspace(dev: int, stream: int, n: int) -> int:
    """Device pointer of n float32s of split partials (K5's small path, the
    K1/K5 tile path, K2's split S): one buffer per (card, stream), grown on
    demand and reused, since launches on one stream run in order. A
    replaced buffer was allocated on this stream, so the caching allocator
    hands it out again only in this stream's order."""
    buf = _workspaces.get((dev, stream))
    if buf is None or buf[0].numel() < n:
        t = torch.empty(max(n, 1 << 20), dtype=torch.float32,
                        device=torch.device("cuda", dev))
        buf = _workspaces[(dev, stream)] = (t, t.data_ptr())
    return buf[1]


def release_workspace(dev: int, stream: int) -> None:
    """Give back the workspace of a stream that launches no more kernels
    (a CUDA-graph capture stream, once its graphs are gone), which would
    otherwise stay held for as long as the process runs."""
    _workspaces.pop((dev, stream), None)
