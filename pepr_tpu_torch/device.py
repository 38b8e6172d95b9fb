"""Device resolution for the port's entry points: the card unless the
caller asks for the CPU, and never a quiet fall-back (the role of the
JAX package's `forward_impl`, `pepr_tpu/ops/likelihood.py:215-244`,
without the platform sniffing).  Under `torch.distributed` each rank
binds its own card (`rank_device`), and "cuda" then means that card."""

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


def rank_device(local_rank: int, local_world_size: int,
                backend: str) -> torch.device:
    """A rank's card, cuda:(local_rank % device_count), made the current
    device so that "cuda" and the kernels' launches mean it.  Several
    ranks may share a card under Gloo only: NCCL refuses two ranks on
    one card, so that case raises here, before any group is made."""
    resolve_device("cuda")
    count = torch.cuda.device_count()
    if backend == "nccl" and local_world_size > count:
        raise RuntimeError(
            f"pepr_tpu_torch: {local_world_size} ranks on this node share "
            f"{count} CUDA device(s), and NCCL cannot run two ranks on one "
            "card; start one rank per card or pass backend='gloo'")
    dev = torch.device("cuda", local_rank % count)
    torch.cuda.set_device(dev)
    return dev
