"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` for ``sm_90a`` into ``build/`` at the repository root (git-ignored),
at first use, with ``-I csrc`` for the shared headers (``csrc/sm90.cuh``). The
library's file name carries a hash of its source and of every header it
includes from ``csrc/``, so an edited source or header is rebuilt and a stale
library is never loaded. No PyTorch header is included, so a build takes
seconds.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return found


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

# What a kernel's C entry point returns besides a cudaError_t: the codes of
# csrc/sm90.cuh's kErrNoEncoder and kErrTensorMap (+ the CUresult).
ERR_NO_ENCODER, ERR_TENSOR_MAP = 20000, 20001


def launch_error(err: int) -> str:
    """What a non-zero return code of a kernel's C entry point says."""
    if err == ERR_NO_ENCODER:
        return "the driver offers no tensor-map encoder (cuTensorMapEncodeTiled)"
    if err > ERR_NO_ENCODER:
        return f"tensor-map encode failed: CUresult {err - ERR_TENSOR_MAP}"
    return f"cudaError {err}"


def sources(name: str):
    """``csrc/<name>.cu`` and every header it includes from ``csrc/`` ("..."
    includes, followed into the headers), each once, in the order met."""
    found = []

    def visit(path: Path):
        if path not in found:
            found.append(path)
            for inc in _INCLUDE.findall(path.read_bytes()):
                visit(CSRC / inc.decode())
    visit(CSRC / f"{name}.cu")
    return found


def traced(*tensors) -> bool:
    """Whether any of ``tensors`` holds no data: a meta tensor (the dry run's
    trace, ``launch/dryrun.py``) or a fake one (``FakeTensorMode``). Each
    launch function returns before it builds or calls its kernel when one
    does, with the outputs its wrapper has already allocated, which are what
    the kernel's launch allocates; nothing is counted as a launch. A real
    tensor never takes that return."""
    fake = sys.modules.get("torch._subclasses.fake_tensor")
    return any(t.is_meta or (fake is not None and isinstance(t, fake.FakeTensor))
               for t in tensors)


_fake_card = False


@contextlib.contextmanager
def fake_card():
    """While active, tensors without data (:func:`traced`) on any device take
    the kernels' route, as CUDA tensors do (:func:`on_card`): the dispatchers
    pick each kernel as on the card, the wrappers check and allocate as for a
    launch, and the launch functions return before the kernel. The dry run
    traces its steps on meta tensors under it. Real tensors are never on the
    card by it."""
    global _fake_card
    _fake_card = True
    try:
        yield
    finally:
        _fake_card = False


def fake_card_active() -> bool:
    """Whether :func:`fake_card` is active."""
    return _fake_card


def on_card(t) -> bool:
    """Whether ``t`` takes a kernel's route: a CUDA tensor, or one without data
    under :func:`fake_card`."""
    return t.device.type == "cuda" or (_fake_card and traced(t))


def base_aligned(t) -> bool:
    """Whether ``t``'s first element sits on a 16-byte boundary. A tensor
    without data has no address: its storage offset is read instead, on a
    storage the caching allocator would align to 512 bytes."""
    if traced(t):
        return t.storage_offset() * t.element_size() % 16 == 0
    return t.data_ptr() % 16 == 0


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no library yet, all at once (one
    ``nvcc`` per source, started together). Returns each source's compiler
    log (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, building it first if needed.
    Callers keep the handle (``flash_attention._kernel`` caches it)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
