"""Deterministic segment sums: the reduction every sparse assembly and
matvec of the port goes through (the supernodal fronts' extend-add and
sweeps, the sparse KKTs' assemblies, the sparse problems' matvecs).

- `segments(index, size)`: the (order, lengths) of a sum by `index`;
- `lengths_tensor(...)`: the lengths on a device, checked once, with their
  total kept on the host;
- `segment_sum(...)`: the sum itself, one sorted `torch.segment_reduce`
  (no atomics: two runs on the card give the same bits).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def lengths_tensor(lengths, total: int, device) -> torch.Tensor:
    """The segment lengths of a sum over `total` values as an int64 tensor
    on `device`, checked where the index lists are built (none negative,
    and they add up to `total`; ValueError otherwise), their total kept
    beside them on the host (the tensor's `segment_total`): `segment_sum`
    checks each call against it without reading the device."""
    lengths = np.asarray(lengths, np.int64)
    if lengths.size and lengths.min() < 0:
        raise ValueError(f"segment lengths hold a negative count ({lengths.min()})")
    if int(lengths.sum()) != total:
        raise ValueError(f"segment lengths add up to {int(lengths.sum())}, not {total}")
    t = torch.as_tensor(lengths, device=device)
    t.segment_total = int(total)
    return t


def segments(index: np.ndarray, size: int):
    """(order, lengths) for a deterministic segment sum by `index`: a stable
    sort of the entries by segment, and the entry count of each of the
    `size` segments.  `segment_sum(v, lengths, order)` then adds each
    segment's entries in their original order (as the JAX package's
    scatter-add on the CPU does); on the card it needs no atomics, so two
    runs give the same bits."""
    index = np.asarray(index, np.int64)
    order = np.argsort(index, kind="stable")
    return order, np.bincount(index, minlength=size)


def segment_sum(values: torch.Tensor, lengths: torch.Tensor,
                order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of `values` by segment along their last axis, through
    `segments`' (order, lengths) as tensors on the values' device (order
    None: `values` is already in segment order); an empty segment gives 0.
    Leading axes are lanes (a batch of instances sharing the index lists):
    each lane's sums are taken in the order of a single instance's.

    `lengths` come from `lengths_tensor`, checked there once: each call
    compares the values' count with their host-kept total, and
    `torch.segment_reduce` skips its own checks (`unsafe=True`), which read
    the lengths back from the device and so drain the card's queue.  The
    kernel and the order of the additions are the same, and so are the
    bits."""
    count = values.shape[-1] if order is None else order.shape[-1]
    total = getattr(lengths, "segment_total", None)
    if count != total:
        raise ValueError(f"segment_sum: {count} values against segment lengths of total "
                         f"{total} (lengths come from lengths_tensor)")
    lanes = values.shape[:-1]
    if values.shape[-1] == 0:
        return values.new_zeros(lanes + lengths.shape)
    if order is not None:
        values = values[..., order]
    if lanes:
        lengths = lengths.expand(lanes + lengths.shape)
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=-1, unsafe=True)
