"""Device resolution for the port's entry points.

The entry points run on the card unless the caller asks for the CPU:
`None` means CUDA, and a missing CUDA device is an error, never a quiet
move to the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` -> cuda; raises when CUDA is wanted and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host")
    return dev
