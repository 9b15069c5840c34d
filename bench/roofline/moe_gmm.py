"""The grouped per-expert product ``[E, C, D] x [E, D, F]`` of a MoE FFN:
operations and bytes for the rows the routing keeps (``rows``, summed over
the experts), not the capacity a kernel computes.  Frozen here.

Forward: ``2 rows D F`` operations; bytes: the kept rows' inputs, every
expert's weight, the kept rows' outputs.  Backward (dX and dW of one
product): ``4 rows D F``; bytes: x, w and dY read, dX and dW written.
"""


def forward(rows: float, experts: int, D: int, F: int, elem: int):
    return 2 * rows * D * F, elem * (rows * D + experts * D * F + rows * F)


def backward(rows: float, experts: int, D: int, F: int, elem: int):
    return 4 * rows * D * F, elem * (2 * rows * D + 2 * experts * D * F + rows * F)
