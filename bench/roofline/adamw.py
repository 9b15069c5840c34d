"""One AdamW update over a model's parameters: the least bytes it moves,
each byte once.  Frozen here, apart from the program's optimizer.

Per element: the gradient and the parameter read at the parameter's width,
the two float32 moments read and written, the parameter written back: 22
bytes for a bfloat16 element, 28 for a float32 one.  ``leaves`` is a
reference's ``layout``: ``(path, shape, dtype name, init)``.
"""

_WIDTH = {"bfloat16": 2, "float16": 2, "float32": 4}
_MOMENTS = 2 * 4 * 2          # m and v, float32, read and written


def element_bytes(dtype: str) -> int:
    w = _WIDTH[dtype]
    return 3 * w + _MOMENTS


def least_bytes(leaves) -> int:
    total = 0
    for _, shape, dtype, *_ in leaves:
        n = 1
        for s in shape:
            n *= int(s)
        total += n * element_bytes(dtype)
    return total
