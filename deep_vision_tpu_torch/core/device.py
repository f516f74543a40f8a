"""Device selection for the port's entry points.

Every entry point runs on CUDA unless its caller passes ``device="cpu"``
(as the CPU tests do).  Asking for CUDA on a machine without a GPU
raises; nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a ``cuda`` request without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; the port runs on an "
            "NVIDIA GPU by default — pass device='cpu' (--device cpu) to "
            "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{dev}' (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        from deep_vision_tpu_torch.parallel import distributed

        if distributed.is_initialized():
            # a rank's card, which parallel.distributed.initialize made
            # the process's current one
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def configure_precision() -> None:
    """Float32 means float32: no TF32 in cuDNN convolutions or cuBLAS
    matmuls (cuDNN would otherwise run float32 convolutions in TF32 by
    default).  The bf16 and int8 serving paths are unaffected."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
