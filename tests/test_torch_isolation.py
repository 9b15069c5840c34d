"""The port stands alone: every ``repro_torch`` module imports with JAX and
the JAX package made unimportable, and its entry points refuse to run on a
machine without a GPU unless the caller asks for the CPU."""
import ast
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch

SRC = Path(__file__).resolve().parents[1] / "src"


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_the_reference():
    mods = _modules()
    assert {"repro_torch.serve.paged", "repro_torch.serve.engine", "repro_torch.core.capture",
            "repro_torch.launch.serve", "repro_torch.kernels.flash_attention.ops",
            "repro_torch.core.wavefront", "repro_torch.models.paper_nets",
            "repro_torch.kernels.lstm_cell.ops", "repro_torch.models.moe",
            "repro_torch.kernels.moe_gmm.ops", "repro_torch.models.mamba",
            "repro_torch.models.griffin", "repro_torch.kernels.ssm_scan.ops",
            "repro_torch.kernels.rglru_scan.ops", "repro_torch.optim.adamw",
            "repro_torch.optim.schedule", "repro_torch.models.api",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.store",
            "repro_torch.train.step", "repro_torch.train.trainer",
            "repro_torch.launch.train"} <= set(mods)
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


@pytest.mark.parametrize("entry", ["runtime", "init_params", "paged_cache", "cache",
                                   "slot_cache", "continuous_engine", "wave_engine",
                                   "paged_engine", "serve_cli", "lstm_params"])
def test_entry_points_default_to_the_card(entry):
    _no_gpu()
    from repro_torch.configs import get_config
    from repro_torch.core import wavefront
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.runtime import Runtime
    from repro_torch.serve import ContinuousEngine, PagedEngine, ServeConfig, ServeEngine

    cfg = get_config("gemma-2b", smoke=True)
    scfg = ServeConfig(max_batch=2, max_len=32)
    call = {"runtime": lambda: Runtime(),
            "init_params": lambda: transformer.init_params(cfg, 0),
            "paged_cache": lambda: transformer.init_paged_cache(cfg, 2, 32, n_pages=4,
                                                                page_size=8),
            "cache": lambda: transformer.init_cache(cfg, 2, 32),
            "slot_cache": lambda: transformer.init_cache(cfg, 2, 32, per_slot=True),
            "continuous_engine": lambda: ContinuousEngine(cfg, {}, scfg),
            "wave_engine": lambda: ServeEngine(cfg, {}, scfg),
            "paged_engine": lambda: PagedEngine(cfg, {}, scfg),
            "serve_cli": lambda: serve.main(["--arch", "gemma-2b", "--smoke"]),
            "lstm_params": lambda: wavefront.params_from_jax([{"b": np.zeros(4)}])}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("entry", ["init_params", "continuous", "wave", "paged", "serve_cli"])
def test_moe_entry_points_default_to_the_card(entry):
    _no_gpu()
    from repro_torch.api import serve_engine
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    call = {"init_params": lambda: transformer.init_params(cfg, 0),
            "continuous": lambda: serve_engine(cfg, {}, None),
            "wave": lambda: serve_engine(cfg, {}, None, continuous=False),
            "paged": lambda: serve_engine(cfg, {}, None, paged=True),
            "serve_cli": lambda: serve.main(["--arch", "granite-moe-1b-a400m", "--smoke"])}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
@pytest.mark.parametrize("entry", ["init_params", "slot_cache", "continuous", "wave",
                                   "serve_cli"])
def test_recurrent_entry_points_default_to_the_card(arch, entry):
    _no_gpu()
    from repro_torch.api import serve_engine
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = get_config(arch, smoke=True)
    call = {"init_params": lambda: transformer.init_params(cfg, 0),
            "slot_cache": lambda: transformer.init_cache(cfg, 2, 32, per_slot=True),
            "continuous": lambda: serve_engine(cfg, {}, None),
            "wave": lambda: serve_engine(cfg, {}, None, continuous=False),
            "serve_cli": lambda: serve.main(["--arch", arch, "--smoke"])}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("entry", ["init_train_state", "train_cli", "compile_lm_loss",
                                   "input_specs", "param_specs"])
def test_train_entry_points_default_to_the_card(entry):
    _no_gpu()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.train import step

    cfg = get_config("gemma-2b", smoke=True)
    shape = ShapeSpec("t", 8, 2, "train")
    call = {"init_train_state": lambda: step.init_train_state(cfg, 0),
            "train_cli": lambda: train.main(["--arch", "gemma-2b", "--smoke", "--steps", "1"]),
            "compile_lm_loss": lambda: step.compile_lm_loss(cfg, shape, backend="sim"),
            "input_specs": lambda: api.input_specs(cfg, shape),
            "param_specs": lambda: step.param_specs(cfg)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("flag,item", [(["--mesh", "2x1"], "A15"),
                                       (["--pinning", "auto"], "A13")])
def test_train_cli_refuses_what_is_not_ported(flag, item):
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match=item):
        train.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", *flag])


@pytest.mark.parametrize("kw", [{}, {"continuous": False}, {"paged": True}])
def test_serve_engine_kinds_raise_without_a_gpu(kw):
    _no_gpu()
    from repro_torch.api import serve_engine
    from repro_torch.configs import get_config

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_engine(get_config("gemma-2b", smoke=True), {}, None, **kw)


def test_scripts_import_nothing_of_jax_or_the_reference():
    """chip_smoke.py, the port's example and its kernel probes run on the
    card's machine, which has no JAX: no import statement of theirs, at any
    depth (chip_smoke imports inside its phases), names it or the
    reference."""
    for script in ("chip_smoke.py", "examples/torch_wavefront_lstm.py",
                   "examples/torch_train_lm.py", "scripts/torch_moe_gmm_probe.py",
                   "scripts/torch_scan_probe.py", "scripts/torch_train_probe.py",
                   "scripts/torch_family_bwd_probe.py"):
        for node in ast.walk(ast.parse((SRC.parent / script).read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "repro"), (script, name)


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    """A CPU tensor reaches the plain version through the custom op; the CUDA
    wrappers refuse CPU tensors rather than fall back."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd_cuda,
                                                     flash_attention_cuda, flash_attention_train,
                                                     flash_attention_train_cuda)
    from repro_torch.kernels.lstm_cell import lstm_cell_bwd_cuda
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_cuda

    q = torch.zeros((1, 4, 2, 16))
    assert flash_attention(q, q, q).shape == q.shape
    assert flash_attention_train(q, q, q).shape == q.shape
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_attention_train_cuda(q, q, q)
    with pytest.raises(ValueError, match="needs CUDA"):
        flash_attention_bwd_cuda(q, q, q, q, q, torch.zeros((1, 2, 4)))
    g = torch.zeros((3, 8))
    with pytest.raises(ValueError, match="needs CUDA"):
        lstm_cell_bwd_cuda(g, g, torch.zeros(8), g[:, :2], g[:, :2], g[:, :2])
    with pytest.raises(ValueError, match="needs CUDA"):
        decode_attention_cuda(q[:, 0], q, q, torch.zeros(4, dtype=torch.int32),
                              torch.tensor(0, dtype=torch.int32))
    x, w = torch.ones((2, 3, 4)), torch.ones((2, 4, 5))
    assert torch.equal(moe_gmm(x, w), torch.full((2, 3, 5), 4.0))
    with pytest.raises(ValueError, match="needs CUDA"):
        moe_gmm_cuda(x, w)
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_cuda

    a = torch.full((2, 3, 4, 5), 0.5)
    y, h = ssm_scan(a, a, torch.ones((2, 3, 5)))
    assert torch.equal(h, torch.full((2, 4, 5), 0.875)) and torch.equal(y[:, -1], 5 * h[..., 0])
    with pytest.raises(ValueError, match="needs CUDA"):
        ssm_scan_cuda(a, a, torch.ones((2, 3, 5)))
    hs, h = rglru_scan(a[..., 0], a[..., 0], torch.full((2, 4), 3.0))
    assert torch.equal(h, torch.full((2, 4), 1.25)) and torch.equal(hs[:, -1], h)
    with pytest.raises(ValueError, match="needs CUDA"):
        rglru_scan_cuda(a[..., 0], a[..., 0])


# a library's kernel behind a hand-written wrapper: BLAS / DNN headers and
# calls, and CUTLASS's ready-made device-level GEMMs
_LIBRARY_KERNELS = re.compile(
    r"#\s*include\s*[<\"](?:cublas\w*|cudnn\w*|cutlass/gemm/device/[^>\"]*)\.h\w*[>\"]"
    r"|\bcublas\w*\s*\(|\bcudnn\w*\s*\(|cutlass::gemm::device::")


def _kernel_sources() -> list[Path]:
    return sorted((SRC / "repro_torch" / "kernels").glob("*/csrc/*.cu*"))


def test_kernel_sources_are_written_by_hand():
    srcs = _kernel_sources()
    assert {p.name for p in srcs} >= {"paged_decode.cu", "dense_decode.cu", "flash_fwd.cu",
                                      "flash_bwd.cu", "lstm_cell.cu", "moe_gmm.cu",
                                      "ssm_scan.cu", "rglru_scan.cu"}
    found = {f"{p.relative_to(SRC)}:{m.group(0)}" for p in srcs
             for m in _LIBRARY_KERNELS.finditer(p.read_text())}
    assert not found, f"library kernels in the port's sources: {sorted(found)}"


@pytest.mark.parametrize("line", ["#include <cublas_v2.h>", '#include "cudnn.h"',
                                  "#include <cutlass/gemm/device/gemm.h>",
                                  "  cublasGemmEx(handle, a, b);", "cudnnConvolutionForward (h);",
                                  "using G = cutlass::gemm::device::Gemm<float>;"])
def test_library_guard_catches(line):
    assert _LIBRARY_KERNELS.search(line)
