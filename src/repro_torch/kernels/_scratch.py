"""Scratch memory the split kernels keep between calls.

The decode paths of ``lora_matmul``, ``segmented_lora_matmul`` and
``decode_attention`` split their reduction across thread blocks: each
block writes f32 partials to a workspace, and the last block of each
output tile, found by an int32 ticket counter that it resets, sums them.
So a call needs a workspace and tickets that are zero before it, and
leaves them zero.  Allocating them per call would cost host time on every
projection of every decode tick (and a memset for the tickets), so one
pair is kept per (device, stream) and grown when a call needs more.
Calls on one stream run in order and may share it; another stream gets
its own.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

_BUFFERS: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (the
    handle alone, without the ``torch.cuda.Stream`` object that
    ``current_stream`` builds on every call: ~4 us of host time per
    launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def buffers(device: torch.device, stream: int, n_floats: int,
            n_tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(workspace of at least ``n_floats`` float32, at least
    ``n_tickets`` int32 tickets, zero between launches) for kernels
    launched on ``stream`` of ``device``."""
    key = (device.index, stream)
    ws, tickets = _BUFFERS.get(key, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(max(n_floats, 1 << 16), dtype=torch.float32,
                         device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 1024), dtype=torch.int32,
                              device=device)
    _BUFFERS[key] = (ws, tickets)
    return ws, tickets
