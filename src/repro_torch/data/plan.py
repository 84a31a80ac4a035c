"""The device-resident data plane: `DataPlan` (port of
``repro/data/plan.py``).

`batch_iterator` gathers every batch on the host and copies it to the
card from pageable memory, a copy that waits for the card each step. A
`DataPlan` keeps the host out of the steady state:

* the client's arrays go to the device **once** (arrays already there are
  taken as they are), and
* the epoch-shuffle schedule is an index table, a pure function of
  ``(seed, n, batch_size)`` drawn with `batch_iterator`'s own permutation
  logic, so row ``s`` of the schedule is bitwise the ``s``-th batch the
  iterator would yield.

``take(k)`` hands the next ``k`` schedule rows to a consumer as a
``(k, batch_size)`` int32 device tensor and advances the cursor; the
batch gather happens on the device, inside the consumer
(`LocalTrainer.train_scanned` / `local_client_train_scanned`, which
capture the step in a CUDA graph). Rows reach the device in one copy per
window of rows, from pinned host memory without waiting
(``non_blocking=True``). A DataPlan is also an iterator: ``next(plan)``
gathers the same batch on the device from rows already there, so the
per-step loop (custom steps, callback runs) consumes the same stream
through the same cursor.

Like `batch_iterator` streams, a DataPlan is stateful: build fresh plans
per run; sharing the device arrays between plans is free."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import _ragged_error
from repro_torch.device import DeviceLike, resolve_device

Arrays = Dict[str, object]

# schedule rows copied to the device at once for `next` (one copy per
# window); `take` copies exactly the rows it hands out when they are not
# in the window already
ROW_WINDOW = 512


def _to_device(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


class DataPlan:
    """Device-resident client shard plus a deterministic epoch-shuffle
    schedule (see the module docstring).

    Construction uploads the arrays once; ``arrays`` is the device-side
    dict a consumer gathers from. The schedule extends lazily in whole
    epochs, so a plan serves any number of visits without a declared
    horizon. `device` defaults to the arrays' own device for tensors, else
    the CUDA device (`resolve_device`)."""

    def __init__(self, arrays: Arrays, batch_size: int, seed: int = 0,
                 drop_remainder: bool = True, scan: bool = True, *,
                 device: DeviceLike = None):
        first = next(iter(arrays.values()))
        n = len(first)
        if any(len(a) != n for a in arrays.values()):
            raise ValueError("DataPlan: arrays differ in length")
        self.n = n
        self.seed = seed
        self.batch_size = min(batch_size, n)
        if not drop_remainder and n % self.batch_size:
            raise _ragged_error(n, self.batch_size)
        # scan=False keeps the per-step loop over the device arrays (an
        # oracle/debug knob; the results are bitwise the same)
        self.scan = scan
        if device is None and isinstance(first, torch.Tensor):
            dev = first.device
        else:
            dev = resolve_device(device)
        self.device = dev
        self.arrays = {k: _to_device(a, dev) for k, a in arrays.items()}
        self._rng = np.random.default_rng(seed)
        self._sched = np.empty((0, self.batch_size), np.int64)
        self._cursor = 0
        self._window = None          # device rows [_win0, _win0 + len)
        self._win0 = 0

    @property
    def steps_per_epoch(self) -> int:
        return self.n // self.batch_size

    def _ensure(self, n_rows: int) -> None:
        """Extend the schedule to ≥ n_rows rows, whole epochs at a time —
        byte for byte `batch_iterator`'s permutation logic, all missing
        epochs drawn first and concatenated once."""
        per_epoch = self.steps_per_epoch
        epochs = [self._sched]
        have = len(self._sched)
        while have < n_rows:
            perm = self._rng.permutation(self.n)
            epochs.append(perm[:per_epoch * self.batch_size].reshape(
                per_epoch, self.batch_size))
            have += per_epoch
        if len(epochs) > 1:
            self._sched = np.concatenate(epochs)

    def _upload(self, lo: int, hi: int) -> torch.Tensor:
        """Schedule rows [lo, hi) as an int32 tensor on the plan's device:
        on CUDA one copy from pinned host memory that does not wait."""
        self._ensure(hi)
        rows = torch.from_numpy(self._sched[lo:hi].astype(np.int32))
        if self.device.type != "cuda":
            return rows.to(self.device)
        return rows.pin_memory().to(self.device, non_blocking=True)

    def _rows(self, k: int) -> torch.Tensor:
        """The next k rows on the device (a view of the window when it
        holds them), cursor untouched."""
        lo = self._cursor - self._win0
        if self._window is not None and 0 <= lo and \
                lo + k <= len(self._window):
            return self._window[lo:lo + k]
        return self._upload(self._cursor, self._cursor + k)

    def take(self, n_steps: int) -> torch.Tensor:
        """Consume the next ``n_steps`` schedule rows as an
        ``(n_steps, batch_size)`` int32 device tensor."""
        rows = self._rows(n_steps)
        self._cursor += n_steps
        return rows

    def peek_schedule(self, n_steps: int) -> np.ndarray:
        """The first ``n_steps`` schedule rows (host-side, cursor
        untouched) — the bitwise oracle the tests pin against
        `batch_iterator`."""
        self._ensure(n_steps)
        return self._sched[:n_steps].copy()

    # -- iterator protocol: drop-in for `batch_iterator` streams ------------

    def __iter__(self) -> "DataPlan":
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        lo = self._cursor - self._win0
        if self._window is None or not 0 <= lo < len(self._window):
            self._window = self._upload(self._cursor,
                                        self._cursor + ROW_WINDOW)
            self._win0, lo = self._cursor, 0
        row = self._window[lo]
        self._cursor += 1
        return gather(self.arrays, row)


def gather(arrays: Dict[str, torch.Tensor],
           row: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The batch of schedule row `row` (a (batch,) int32 tensor on the
    arrays' device), gathered on the device."""
    return {k: a.index_select(0, row) for k, a in arrays.items()}


def wants_scan(it) -> bool:
    """True when a client stream asks for the captured local phase."""
    return isinstance(it, DataPlan) and it.scan


def all_want_scan(its) -> bool:
    """True when every entry of a client-stream list is a scan-routed
    DataPlan."""
    return all(wants_scan(it) for it in its)


def stack_plan_arrays(plans: List[DataPlan],
                      pad_to: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
    """Stack B plans' device arrays along a new leading run axis. Plans
    whose shards differ in length are zero-padded to the longest (or
    ``pad_to``); the padding rows are never gathered, because each plan's
    schedule indexes only its own ``n``."""
    n_max = pad_to if pad_to is not None else max(p.n for p in plans)
    keys = list(plans[0].arrays)
    if any(list(p.arrays) != keys for p in plans):
        raise ValueError(
            "batched scanned execution requires structurally identical "
            "client shards across the run axis (same keys, trailing shapes "
            "and dtypes): the plans' keys differ")

    def pad(a):
        if a.shape[0] == n_max:
            return a
        out = a.new_zeros((n_max,) + tuple(a.shape[1:]))
        out[:a.shape[0]] = a
        return out

    out = {}
    for k in keys:
        leaves = [pad(p.arrays[k]) for p in plans]
        if len({(tuple(x.shape), x.dtype) for x in leaves}) != 1:
            raise ValueError(
                "batched scanned execution requires structurally identical "
                "client shards across the run axis (same keys, trailing "
                f"shapes and dtypes): {k!r} differs")
        out[k] = torch.stack(leaves)
    return out


def stack_plan_indices(plans: List[DataPlan], n_steps: int) -> torch.Tensor:
    """Advance every plan by ``n_steps`` and stack the consumed schedule
    rows into a ``(B, n_steps, batch_size)`` tensor."""
    rows = [p.take(n_steps) for p in plans]
    if len({tuple(r.shape) for r in rows}) != 1:
        raise ValueError(
            "batched scanned execution requires one batch size across the "
            f"run axis: {[tuple(r.shape) for r in rows]}")
    return torch.stack(rows)
