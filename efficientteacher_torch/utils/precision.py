"""Mixed precision shared by the eval and train paths."""

from __future__ import annotations

import torch


def autocast(device: torch.device, dtype: torch.dtype):
    """`torch.autocast` on `device`'s type in `dtype` for bf16 and fp16;
    disabled for float32, where the model computes in its own dtype."""
    return torch.autocast(device.type, dtype=dtype,
                          enabled=dtype in (torch.bfloat16, torch.float16))
