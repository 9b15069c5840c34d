"""The port stands alone: every ``repro_torch`` module imports with JAX and
the JAX package made unimportable, and its entry points refuse to run on a
machine without a GPU unless the caller asks for the CPU."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

SRC = Path(__file__).resolve().parents[1] / "src"


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_the_reference():
    mods = _modules()
    assert "repro_torch.serve.paged" in mods and "repro_torch.core.capture" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "assert all(sys.modules[k] is None for k in bad), bad\n"
        "print('ok', len(sys.argv))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")


def test_serve_engine_without_device_raises_without_a_gpu():
    _no_gpu()
    from repro_torch.api import serve_engine
    from repro_torch.configs import get_config

    cfg = get_config("gemma-2b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_engine(cfg, {}, None)


@pytest.mark.parametrize("entry", ["runtime", "init_params", "paged_cache"])
def test_entry_points_default_to_the_card(entry):
    _no_gpu()
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime

    cfg = get_config("gemma-2b", smoke=True)
    call = {"runtime": lambda: Runtime(),
            "init_params": lambda: transformer.init_params(cfg, 0),
            "paged_cache": lambda: transformer.init_paged_cache(cfg, 2, 32, n_pages=4,
                                                                page_size=8)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
