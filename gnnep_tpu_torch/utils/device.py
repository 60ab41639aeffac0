"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
GPU and no explicit CPU request they raise: they never drift to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means CUDA. A CUDA request without a usable GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run the plain PyTorch path on the CPU")
        set_precision_flags()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def set_precision_flags() -> None:
    """Full-precision float32 matrix products and convolutions: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
