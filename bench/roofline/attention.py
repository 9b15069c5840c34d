"""Causal (optionally windowed) GQA attention: the operations and bytes one
call needs, for the call's shapes.  Frozen here, so the yardstick does not
move when the program does.

Per visible (query, key) pair and query head: the forward takes ``Q K^T``
and ``P V``, ``4 hd`` operations; the backward recomputes ``Q K^T`` from the
saved log-sum-exp and takes ``dV``, ``dP``, ``dQ``, ``dK``, ``10 hd``.  Bytes:
each input read once, each output written once (the log-sum-exp in f32).
The head width is the model's (120 counts 120, whatever a kernel pads to).
"""


def pairs(S: int, window: int | None) -> int:
    """Visible (query, key) pairs of one causal row block of length S."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    w = window
    return w * (w + 1) // 2 + (S - w) * w


def forward(B: int, S: int, Hq: int, Hkv: int, hd: int, window, elem: int):
    flops = 4 * hd * Hq * B * pairs(S, window)
    nbytes = elem * B * S * hd * (2 * Hq + 2 * Hkv) + 4 * B * Hq * S
    return flops, nbytes


def backward(B: int, S: int, Hq: int, Hkv: int, hd: int, window, elem: int):
    flops = 10 * hd * Hq * B * pairs(S, window)
    # read q, k, v, out, dout and the lse; write dq, dk, dv
    nbytes = elem * B * S * hd * (3 * Hq + 2 * Hkv) + 4 * B * Hq * S \
        + elem * B * S * hd * (Hq + 2 * Hkv)
    return flops, nbytes
