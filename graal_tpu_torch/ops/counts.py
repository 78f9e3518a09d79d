"""Kernel launch counts kept on the card.

A kernel wrapper counts each launch in an int64 on the card: either the
kernel adds one to it itself (it is handed :meth:`LaunchCount.counter`'s
tensor), or the wrapper adds one right beside the launch, on the launch's
stream (:meth:`LaunchCount.add`). A CUDA graph captures either with the
launch, so every replay of a captured step counts its launches as the same
step run eagerly does (``core.graphs``). Reading a count copies it to the
host: a synchronisation, so a run reads its counts after it ends.
"""

from __future__ import annotations

import collections

import torch


class LaunchCount:
    """One wrapper's launches, by key (B1 and B3 key a launch by its (B, K),
    B2 and B4 by None): one int64 on the card per (device, key)."""

    def __init__(self):
        self.counters = {}

    def counter(self, device, key=None) -> torch.Tensor:
        """The int64 counter of ``key`` on ``device``, for a kernel that adds
        one to it itself at each launch (its ``data_ptr()`` goes to the
        kernel). A new key's counter is made outside any capture (a
        capture's first step runs eagerly, so its keys exist before the
        capture begins)."""
        slot = (device, key)
        counter = self.counters.get(slot)
        if counter is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"the first launch counted under {key} is in a capture: "
                                   "run the step eagerly before capturing it")
            counter = self.counters[slot] = torch.zeros((), dtype=torch.int64, device=device)
        return counter

    def add(self, device, key=None):
        """Count one launch on ``device``; called beside the launch of a
        kernel that does not count itself."""
        self.counter(device, key).add_(1)

    def by_key(self) -> collections.Counter:
        """Launches by key on every device (keys at zero left out)."""
        out = collections.Counter()
        for (_, key), counter in self.counters.items():
            out[key] += int(counter)
        return +out

    def reset(self):
        for counter in self.counters.values():
            counter.zero_()


class Counted:
    """A kernel wrapper's ``n_launches``, read from its ``launches``
    (a :class:`LaunchCount`); assigning 0 sets every counter to 0."""

    launches: LaunchCount

    @property
    def n_launches(self) -> int:
        return sum(self.launches.by_key().values())

    @n_launches.setter
    def n_launches(self, value: int):
        if value != 0:
            raise ValueError(f"a launch count is only set to 0, not {value}")
        self.launches.reset()
