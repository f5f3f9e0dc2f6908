"""Global CMVN: stats loaders + apply (counterpart of
freeze_omni_tpu/frontend/cmvn.py; models/encoder/cmvn.py:7-107 of the
reference). Loaders return numpy mean and inverse stddev; apply is
(x - mean) * istd on tensors."""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import torch


def _finalize(means, variance, count) -> Tuple[np.ndarray, np.ndarray]:
    means = np.asarray(means, dtype=np.float64) / count
    variance = np.asarray(variance, dtype=np.float64) / count - means * means
    variance = np.maximum(variance, 1.0e-20)
    istd = 1.0 / np.sqrt(variance)
    return means.astype(np.float32), istd.astype(np.float32)


def load_json_cmvn(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path) as f:
        stats = json.load(f)
    return _finalize(stats["mean_stat"], stats["var_stat"], stats["frame_num"])


def load_kaldi_cmvn(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path) as f:
        arr = f.read().split()
    if not (arr[0] == "[" and arr[-2] == "0" and arr[-1] == "]"):
        raise ValueError(f"{path}: not a Kaldi text CMVN stats matrix")
    feat_dim = (len(arr) - 4) // 2
    means = [float(x) for x in arr[1 : feat_dim + 1]]
    count = float(arr[feat_dim + 1])
    variance = [float(x) for x in arr[feat_dim + 2 : 2 * feat_dim + 2]]
    return _finalize(means, variance, count)


def load_cmvn(path: str, is_json: bool) -> Tuple[np.ndarray, np.ndarray]:
    return load_json_cmvn(path) if is_json else load_kaldi_cmvn(path)


def apply_cmvn(x: torch.Tensor, mean: torch.Tensor, istd: torch.Tensor,
               norm_var: bool = True) -> torch.Tensor:
    """x: [..., feat_dim]."""
    x = x - mean
    if norm_var:
        x = x * istd
    return x
