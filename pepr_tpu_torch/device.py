"""Device resolution for the port's entry points: the card unless the
caller asks for the CPU, and never a quiet fall-back (the role of the
JAX package's `forward_impl`, `pepr_tpu/ops/likelihood.py:215-244`,
without the platform sniffing)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` or "cuda..." -> the CUDA device (raises if there is none);
    "cpu" -> the CPU.  On CUDA, TF32 is switched off for matmuls and
    cuDNN: the likelihood path runs in full float32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pepr_tpu_torch: a CUDA device was requested (the default) "
                "but torch.cuda.is_available() is False; pass device='cpu' "
                "to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
