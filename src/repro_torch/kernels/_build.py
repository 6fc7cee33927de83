"""Build the port's CUDA kernels from the sources in this checkout.

``on_cuda(t, name)`` is the wrappers' one device decision: a CUDA tensor
goes to the kernel, a CPU tensor to the plain version, and any other
device raises. ``load_extension()`` compiles every ``kernels/*/csrc/*.cu`` together
with the one PyTorch binding (``hype_score/csrc/binding.cpp``) for
Hopper (``sm_90a``) through ``torch.utils.cpp_extension.load``, into
``build/torch_ext`` at the repository root, at first use, and memoizes
the module for the process. Only the binding includes PyTorch's headers.
Nothing here runs at import time: a CPU-only machine never builds or
imports the extension. A failed build raises.
"""
from __future__ import annotations

import functools
import pathlib

_KERNELS = pathlib.Path(__file__).resolve().parent
REPO_ROOT = _KERNELS.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "torch_ext"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]


@functools.cache
def load_extension():
    """Compile (or reuse the build of) the extension; returns the module."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(str(p) for p in _KERNELS.glob("*/csrc/*.cu"))
    sources.append(str(_KERNELS / "hype_score" / "csrc" / "binding.cpp"))
    return load(name="repro_torch_kernels", sources=sources,
                build_directory=str(BUILD_DIR),
                extra_cflags=["-O2"], extra_cuda_cflags=CUDA_FLAGS)


def on_cuda(t, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not "
                         f"{t.device}")
    return t.device.type == "cuda"
