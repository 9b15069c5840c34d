"""Causal latent attention (MLA) as kernels B3 and B3-bwd run it: every
query head with its own key and value head, q and k heads of width ``dqk``
(the no-rope part and the rope part that all heads share), v heads of
``dv``.  The operations and bytes one call needs, for the call's shapes,
at the true widths.  Frozen here, so the yardstick does not move when the
program does.

Per visible (query, key) pair and query head: the forward takes ``Q K^T``
(``2 dqk``) and ``P V`` (``2 dv``); the backward recomputes ``Q K^T`` and
takes ``dP = dO V^T``, ``dV``, ``dQ`` and ``dK``: ``2 (3 dqk + 2 dv)``.
Bytes: each input read once, each output written once (the log-sum-exp in
f32).
"""


def pairs(S: int) -> int:
    """Visible (query, key) pairs of one causal row block of length S."""
    return S * (S + 1) // 2


def forward(B: int, S: int, H: int, dqk: int, dv: int, elem: int):
    flops = 2 * (dqk + dv) * H * B * pairs(S)
    # read q, k, v; write out and the lse
    nbytes = elem * B * S * H * (2 * dqk + 2 * dv) + 4 * B * H * S
    return flops, nbytes


def backward(B: int, S: int, H: int, dqk: int, dv: int, elem: int):
    flops = 2 * (3 * dqk + 2 * dv) * H * B * pairs(S)
    # read q, k, v, out, dout and the lse; write dq, dk, dv
    nbytes = elem * B * S * H * (2 * dqk + 3 * dv) + 4 * B * H * S \
        + elem * B * S * H * (2 * dqk + dv)
    return flops, nbytes
