"""Where a run finds the program and keeps its caches.

:func:`setup` puts the checkout's ``src`` on ``sys.path`` and points every
build and kernel cache at a fixed directory inside the checkout
(``build/bench/``), so that only a checkout's first run builds.  An entry
point calls it before it imports torch.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
_CACHES = (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
           ("CUDA_CACHE_PATH", "nv"))


def setup() -> Path:
    """Returns the checkout's root."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    for var, sub in _CACHES:
        os.environ[var] = str(ROOT / "build" / "bench" / sub)
    return ROOT
