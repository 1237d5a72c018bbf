"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: from the
command line with Marian's ``--cpu-threads N`` (N > 0), from Python with
``device="cpu"``. Without a card and without such a request they raise;
they never fall back to the CPU on their own.

float32 stays float32 on the card: TF32 is switched off for matrix
products and for cuDNN, so the port's f32 numbers are comparable with the
reference's and with its own CPU runs. bfloat16 products accumulate in
f32 throughout: cuBLAS may not reduce split-K partial sums in bf16, where
the reference's dots accumulate in f32 (``preferred_element_type``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def _pin_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: Optional[Union[str, torch.device]] = None,
                   cpu_threads: int = 0) -> torch.device:
    """The device an entry point runs on.

    ``device`` names it outright (``"cpu"``, ``"cuda"``, ``"cuda:1"``).
    Otherwise ``cpu_threads > 0`` asks for the CPU with that many
    threads, and anything else means the card, which must exist.
    """
    _pin_float32()
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        if dev.type == "cpu" and cpu_threads > 0:
            torch.set_num_threads(int(cpu_threads))
        return dev
    if cpu_threads and int(cpu_threads) > 0:
        torch.set_num_threads(int(cpu_threads))
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --cpu-threads N (command "
            "line) or device='cpu' (Python) to run on the CPU")
    return torch.device("cuda")
