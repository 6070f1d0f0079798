"""The state carried between the reference and the port.

This system has no weights: its state is the encoded problem. The reference's
`models/solver.pad_kernel_args` (and the port's) turn one schedule into six
padded numpy arrays; `fused_args_from_numpy` places them on a torch device
with the dtypes the fused solve takes, and `fused_outputs_to_numpy` brings the
fused solve's four outputs back as numpy, so a test compares like with like.
`upload_packed` is the one way numpy arrays reach a device: for the card, one
pinned buffer and one copy, counted. The market's state crosses too:
`market_ticks` rebuilds a feed's ticks from their wire form, and
`pricebook_state` / `pricebook_from_state` carry a PriceBook's fold.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def fused_args_from_numpy(
    vectors: np.ndarray,
    counts: np.ndarray,
    capacity: np.ndarray,
    total: np.ndarray,
    valid: np.ndarray,
    prices: np.ndarray,
    device,
) -> Tuple[torch.Tensor, ...]:
    """(vectors f32 [G, R], counts i32 [G], capacity f32 [T, R], total f32
    [T, R], valid bool [T], prices f32 [T]) on `device`."""
    arrays = (
        (vectors, np.float32),
        (counts, np.int32),
        (capacity, np.float32),
        (total, np.float32),
        (valid, np.bool_),
        (prices, np.float32),
    )
    return upload_packed([np.asarray(array, dtype=dtype) for array, dtype in arrays], device)


def fused_outputs_to_numpy(
    compact: torch.Tensor,
    objective: torch.Tensor,
    dense: torch.Tensor,
    lp: torch.Tensor,
) -> Tuple[np.ndarray, ...]:
    """The fused solve's (compact payload, LP objective, dense spill, flat LP
    assignment) as numpy, in the reference's dtypes (int32, float32, int32,
    float32)."""
    return tuple(
        tensor.detach().cpu().numpy() for tensor in (compact, objective, dense, lp)
    )


_ALIGN = 16  # bytes between arrays in upload_packed's buffer
_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def upload_packed(arrays, device) -> Tuple[torch.Tensor, ...]:
    """float32, int32 and bool numpy arrays as tensors on `device`. For the
    card they are packed into one pinned buffer and copied with ONE
    non-blocking host->device transfer, then viewed back one by one: the copy
    queues on the current stream and the host goes on, with no sync."""
    arrays = [np.ascontiguousarray(array) for array in arrays]
    device = torch.device(device)
    if device.type != "cuda":
        return tuple(torch.from_numpy(array).to(device) for array in arrays)
    offsets = []
    total = 0
    for array in arrays:
        offsets.append(total)
        total += -(-array.nbytes // _ALIGN) * _ALIGN
    upload_packed.copies += 1
    upload_packed.arrays += len(arrays)
    upload_packed.bytes += total
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    host_bytes = host.numpy()
    for array, offset in zip(arrays, offsets):
        host_bytes[offset : offset + array.nbytes] = array.reshape(-1).view(np.uint8)
    on_card = host.to(device, non_blocking=True)
    return tuple(
        on_card[offset : offset + array.nbytes].view(_TORCH_DTYPES[array.dtype]).view(array.shape)
        for array, offset in zip(arrays, offsets)
    )


# Host->device transfers to the card, the arrays and the (aligned) bytes
# they carried: a run reads them to show which arrays crossed (the fast path
# uploads no pod tensor, a warm solve no fleet array).
upload_packed.copies = 0
upload_packed.arrays = 0
upload_packed.bytes = 0


# --- market state -----------------------------------------------------------
#
# Both packages fold the same market history: the feed's ticks cross as their
# canonical wire form (MarketTick.encode), and a PriceBook's whole fold state
# as a plain dict.

_BOOK_FIELDS = (
    "_generation", "_risk_generation", "_last_seq", "_discount", "_depth", "_anchor",
    "_closed", "_closed_at", "_trend", "_risk_q", "_interruptions", "_last_tick_at",
)


def market_ticks(encoded: Sequence[str]) -> List:
    """The port's MarketTicks from their wire form (`MarketTick.encode()` of
    either package): the same seq, kind, pool, and float bits."""
    from karpenter_tpu_torch.market.feed import MarketTick

    ticks = []
    for line in encoded:
        seq, kind, instance_type, zone, discount, depth, at = line.split("|")
        ticks.append(MarketTick(
            seq=int(seq), kind=kind, instance_type=instance_type, zone=zone,
            discount=float(discount), depth=float(depth), at=float(at),
        ))
    return ticks


def pricebook_state(book) -> Dict[str, object]:
    """A PriceBook's fold state (either package's: they share the layout) as
    a dict of copies, read under the book's lock."""
    with book._lock:
        state = {name: copy.copy(getattr(book, name)) for name in _BOOK_FIELDS}
    state["reprice_threshold"] = book.reprice_threshold
    return state


def pricebook_from_state(state: Dict[str, object], clock=None):
    """The port's PriceBook holding `state` (from pricebook_state), on `clock`
    (the system clock by default): its generations, risks and the prices it
    advertises are the source book's."""
    from karpenter_tpu_torch.market.pricebook import PriceBook

    book = PriceBook(clock=clock, reprice_threshold=state["reprice_threshold"])
    with book._lock:
        for name in _BOOK_FIELDS:
            setattr(book, name, copy.copy(state[name]))
    return book
