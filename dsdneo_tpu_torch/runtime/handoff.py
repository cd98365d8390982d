"""Stream-ordered hand-offs between the host and the card.

A blocking copy from pageable host memory, and every ``.cpu()``, waits
for all the work queued on the stream before it, not only for the data
it moves.  The calls here make the host wait on the card only for data
it is about to read:

- :func:`copy_in`: a pinned host tensor copied with ``non_blocking=True``
  on a side stream of its device, returned with the copy's event for
  the stream that uses it to wait on.
- :func:`to_card`: a block from the host to the card.  Pinned memory
  goes through :func:`copy_in` and the current stream waits on the
  copy's event at once, so the copy runs beside the work already queued.
  Pageable memory (numpy, a plain CPU tensor) takes PyTorch's blocking
  copy: pinning a large block each call would cost more than it saves.
  A tensor already on the device passes.
- :func:`stage`: a small host array made each block, through a pinned
  tensor of PyTorch's caching host allocator, copied with
  ``non_blocking=True`` behind the work queued so far.
- :func:`queue_to_host`: copies of card tensors into fresh pinned host
  tensors, queued behind the work that makes them, with one event after
  them; :func:`fetch` and :func:`to_host` hand each copy over once,
  waiting on that event alone.  Fresh tensors mean no array a caller
  holds is overwritten.

Off the card each is the plain copy.  :func:`to_card` and :func:`fetch`
say what they took (a blocking copy, an event still pending), for the
caller to count.

A pinned source stays referenced by its copy: the caching host
allocator records the copy's event on the blocks it hands out
(``pin_memory()``, ``torch.empty(..., pin_memory=True)``) and reuses
none before it completes.  A caller that pins memory some other way
keeps it alive and unchanged until what the card computes from it has
been read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

_queued = WeakIdKeyDictionary()    # card tensor → (pinned host copy, event)
_side: dict = {}                   # device → the stream of copies to it


def copy_in(host: torch.Tensor, device) -> tuple[torch.Tensor,
                                                  torch.cuda.Event]:
    """Start copying the pinned CPU tensor ``host`` to the card
    ``device`` on a side stream of that device: returns the tensor on
    the card and the copy's event.  The stream that reads the tensor
    waits on the event first and then calls ``record_stream`` on it, so
    the side stream's pool hands its memory out again only after that
    stream is done with it."""
    dev = torch.cuda.current_stream(device).device
    side = _side.get(dev)
    if side is None:
        side = _side[dev] = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        y = host.to(dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(side)
    return y, ev


def to_card(x, device, dtype: torch.dtype | None = None
            ) -> tuple[torch.Tensor, bool]:
    """``x`` (a host array or a tensor) as a tensor of ``dtype`` on
    ``device``, and whether it took a blocking copy from the host.  A
    pinned CPU tensor bound for the card is copied on a side stream that
    the current stream waits on (:func:`copy_in`)."""
    device = torch.device(device)
    on_host = not isinstance(x, torch.Tensor) or x.device.type == "cpu"
    if device.type == "cuda" and isinstance(x, torch.Tensor):
        if x.device.type == "cuda" and (device.index is None
                                        or x.device.index == device.index):
            return (x if dtype is None else x.to(dtype)), False
        if on_host and x.is_pinned():
            y, ev = copy_in(x, device)
            cur = torch.cuda.current_stream(y.device)
            cur.wait_event(ev)
            y.record_stream(cur)
            return (y if dtype is None else y.to(dtype)), False
    return torch.as_tensor(x, dtype=dtype, device=device), on_host


def stage(a: np.ndarray, device) -> torch.Tensor:
    """A host array made this block as a tensor on ``device``: on the
    card through pinned memory, copied behind the work queued on the
    current stream (the caching host allocator keeps the pinned block
    until the copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def queue_to_host(*tensors) -> None:
    """Queue copies of the card tensors among ``tensors`` into fresh
    pinned host tensors behind the work queued on the current stream,
    and one event after them, for :func:`fetch`."""
    cards = [t for t in tensors if t is not None and t.is_cuda]
    if not cards:
        return
    copies = []
    for t in cards:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        copies.append(h)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(cards[0].device))
    for t, h in zip(cards, copies):
        _queued[t] = (h, ev)


class Took(NamedTuple):
    """What one :func:`fetch` took: ``handoffs`` results handed to the
    host (each queued event once, and a blocking ``.cpu()`` once);
    ``waited`` of them, those whose event was not yet complete when the
    host reached it and the blocking one, which waits for all that is
    queued; ``blocking`` 1 where a tensor had no queued copy."""
    handoffs: int
    waited: int
    blocking: int


def fetch(x) -> tuple[object, Took]:
    """Tensors to numpy arrays, as ``jax.device_get`` fetches (a tuple or
    list of them to a tuple; arrays and None pass): a tensor with a
    queued copy gives that copy once its event completes, any other a
    blocking ``.cpu()``; and what that took."""
    events: dict = {}

    def one(v):
        if v is None or isinstance(v, np.ndarray):
            return v
        if isinstance(v, (tuple, list)):
            return tuple(one(u) for u in v)
        got = _queued.pop(v, None)
        if got is None:
            events[None] = False
            return v.cpu().numpy()
        h, ev = got
        if id(ev) not in events:
            events[id(ev)] = ready = ev.query()
            if not ready:
                ev.synchronize()
        return h.numpy()

    out = one(x)
    return out, Took(len(events), sum(not r for r in events.values()),
                     int(None in events))


def to_host(x):
    """:func:`fetch`'s arrays alone."""
    return fetch(x)[0]
