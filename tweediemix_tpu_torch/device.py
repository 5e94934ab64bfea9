"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``; the CPU is used only when the
caller passes it (the tests do, and then every kernel wrapper takes its
plain version). Asking for CUDA on a host without it raises instead of
quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return device
