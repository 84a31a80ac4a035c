"""The FedELMY model pool (paper §3.2; port of ``ModelPool`` from
``repro/core/pool.py``): a fixed-capacity stack (S+1) of full member
parameters per leaf plus a live-member count. Functional like the
reference — `append` returns a new pool and leaves this one unchanged."""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]
F32 = torch.float32


class ModelPool(NamedTuple):
    """`members`: leaf name → (capacity, *leaf shape) tensor; `count`: the
    number of live members (the first `count` slots)."""
    members: Params
    count: int

    @classmethod
    def create(cls, m0: Params, capacity: int) -> "ModelPool":
        members = {}
        for k, p in m0.items():
            s = torch.zeros((capacity,) + tuple(p.shape), dtype=p.dtype,
                            device=p.device)
            s[0] = p.detach()
            members[k] = s
        return cls(members, 1)

    @property
    def capacity(self) -> int:
        return next(iter(self.members.values())).shape[0]

    def append(self, params: Params) -> "ModelPool":
        if self.count >= self.capacity:
            raise ValueError(f"pool is full ({self.capacity} members)")
        members = {}
        for k, s in self.members.items():
            s = s.clone()
            s[self.count] = params[k].detach().to(s.dtype)
            members[k] = s
        return ModelPool(members, self.count + 1)

    def mask(self) -> torch.Tensor:
        dev = next(iter(self.members.values())).device
        return (torch.arange(self.capacity, device=dev) < self.count).to(F32)

    def average(self) -> Params:
        """Eq. 5/6: masked mean over live members — weights mask/count,
        summed in f32 over the capacity axis."""
        w = self.mask() / float(self.count)
        out = {}
        for k, s in self.members.items():
            wf = w.reshape((self.capacity,) + (1,) * (s.dim() - 1))
            out[k] = torch.sum(s.to(F32) * wf, dim=0).to(s.dtype)
        return out

    def first(self) -> Params:
        """m_0^i — the d2 anchor."""
        return {k: s[0] for k, s in self.members.items()}
