"""Operation and byte counts of a training step, for its share of the
card's peaks.

Operations are counted from the step's equations, forward and backward,
at the cheapest order the equations allow. Bytes are the step's own
inputs read once and its outputs written once (the features, the
constants of the run it reads, the graph's CSR of every aggregation it
runs, the labels, the parameters and Adam's moments), not the
intermediates between equations: an implementation may keep those out of
device memory, and the least time has to stay a bound for any
implementation. The reference modules list their model's equations
through ``Work``."""

from __future__ import annotations

import dataclasses

import torch

F32 = 4
I32 = 4
I64 = 8


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def matmul(self, n: int, k: int, m: int, grad_input: bool = True
               ) -> "Work":
        """[n, k] @ [k, m] forward, the weight's gradient and, with
        ``grad_input``, the input's."""
        self.flops += 2.0 * n * k * m * (3 if grad_input else 2)
        return self

    def elementwise(self, elems: int, flops: float = 1.0) -> "Work":
        """``flops`` operations a value, forward and backward."""
        self.flops += 2.0 * flops * elems
        return self

    def aggregate(self, edges: int, width: int, backward: bool = True
                  ) -> "Work":
        """A weighted sum over ``edges`` of ``width``-wide rows, and its
        transpose in the backward."""
        self.flops += 2.0 * edges * width * (2 if backward else 1)
        return self

    def csr(self, edges: int, rows: int) -> "Work":
        """One aggregation direction's CSR read: row offsets and
        columns."""
        self.bytes += I32 * (edges + rows + 1)
        return self

    def read(self, nbytes: float) -> "Work":
        self.bytes += nbytes
        return self

    def adam(self, params: int) -> "Work":
        """Adam with L2 decay: read parameter, gradient and both moments,
        write parameter and moments."""
        self.flops += 14.0 * params
        self.bytes += F32 * 7 * params
        return self


def kernel_bytes(edges: int, rows: int, cols_read: int, width: int) -> float:
    """One aggregation kernel's least bytes, as ``chip_smoke.bound``
    counts them: the distinct input rows it gathers, its CSR, its
    output."""
    return F32 * (cols_read + rows) * width + I32 * (edges + rows + 1)


def distinct(ids: torch.Tensor) -> int:
    """How many distinct values ``ids`` holds."""
    return int(torch.unique(ids).numel())
