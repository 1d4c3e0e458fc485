"""Build, load and count the hand-written CUDA kernels.

Each kernel is one build of a ``csrc/*.cu`` file, with its own defines
(one source may serve several kernels, e.g. the chunked, the aligned and
the merged pool's decode), and a plain C entry point named by the build
(``-DRPA_ENTRY=<symbol>``). It is compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``semi_pd_tpu_torch/_build/`` (a directory git ignores) and
loaded with ``ctypes``; the library's file name carries the kernel's name
and a hash of the source and the flags, so an edited source rebuilds.
Pointers and the CUDA stream cross as ``c_void_p``; every entry returns
``cudaGetLastError()`` and the Python wrapper raises when it is not 0.

A kernel may also be an instantiation of another build's library
(``CudaKernel.instantiation``: ALiBi's, which the aligned build's entry
launches when given slopes): it builds nothing of its own and has a name,
a TPU kernel and a launch count of its own.

A kernel's ``launches`` counts the launches that ran on the card. Under
a CUDA-graph capture (``record_launches``) a launch only records itself in
the capture's tally; each replay of the graph adds that tally
(``add_launches``), so a capture adds nothing and a replay adds what it
runs.

Importing this module builds nothing and needs no CUDA toolkit: the CPU
tests import every module of the package.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "semi_pd_tpu_torch are built from source at first use")


def sass_mma_counts(kernel: "CudaKernel", op: str = r"HG?MMA") -> Dict[str, int]:
    """Tensor-core instructions (HMMA from mma.sync, HGMMA from wgmma; ``op``
    "HGMMA" counts the latter alone) in each function of the kernel's built
    library, by mangled name, read from ``cuobjdump -sass`` (the CUDA
    toolkit's, beside nvcc)."""
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(kernel.lib_path())], capture_output=True,
                          text=True, check=True).stdout
    counts: Dict[str, int] = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(rf"\b{op}\.", line):
            counts[fn] += 1
    return counts


class CudaKernel:
    """One hand-written kernel: its source, the C entry point's signature,
    the TPU kernel it replaces, and ``launches``, the number of times its
    wrapper launched it (the wrapper adds one per launch and nowhere else)."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence,
                 replaces: str, defines: Sequence[str] = ()):
        self.name = name
        self.source = _PKG / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.defines = tuple(defines)
        self.launches = 0
        self._build_log = ""
        self._fn = None
        self.library: Optional[CudaKernel] = None  # the build it is an instantiation of

    def instantiation(self, name: str, replaces: str) -> "CudaKernel":
        """A kernel of this build's library that its C entry picks from its
        arguments (a template instantiation), counted apart: same source,
        flags, entry and argtypes; building it builds this one."""
        k = CudaKernel(name, str(self.source.relative_to(_PKG)), self.symbol, self.argtypes,
                       replaces, self.defines)
        k.library = self
        return k

    @property
    def build_log(self) -> str:
        return self.library.build_log if self.library else self._build_log

    @property
    def source_rel(self) -> str:
        return str(self.source.relative_to(_PKG.parent))

    def flags(self) -> Tuple[str, ...]:
        return NVCC_FLAGS + tuple(f"-D{d}" for d in (*self.defines,
                                                      f"RPA_ENTRY={self.symbol}"))

    def constants(self, *files: str) -> Dict[str, int]:
        """The ``constexpr int`` constants of ``files`` (names in the
        source's directory, in order) as this build compiles them
        (source_constants)."""
        return source_constants([self.source.parent / f for f in files], self.defines)

    def lib_path(self) -> Path:
        if self.library:
            return self.library.lib_path()
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(self.flags()).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[Tuple[subprocess.Popen, Path]]:
        """Start nvcc for this kernel unless its library is already built;
        returns (process, temporary output path) or None."""
        out = self.lib_path()
        if self.library or out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *self.flags(), "-o", tmp, str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, Path(tmp)

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        log, _ = proc.communicate()
        self._build_log = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source_rel}:\n{log}")
        os.replace(tmp, self.lib_path())  # atomic: concurrent builds agree

    def fn(self):
        """The loaded C entry point, building the library first if needed."""
        if self.library:
            return self.library.fn()
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.lib_path()))
            f = getattr(lib, self.symbol)
            f.argtypes = self.argtypes
            f.restype = ctypes.c_int
            self._fn = f
        return self._fn

    def launch(self, *args) -> None:
        err = self.fn()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with cudaError {err}")
        if _tally is not None:
            _tally[self.name] = _tally.get(self.name, 0) + 1
        else:
            self.launches += 1


def source_constants(files: Sequence, defines: Sequence[str] = ()) -> Dict[str, int]:
    """The ``constexpr int NAME = expr;`` lines of the source ``files``
    (paths, in order), evaluated as a build with ``defines`` (``NAME=value``
    strings, nvcc's -D) compiles them: the defines first, then each
    ``#define NAME value`` default a file states (behind ``#ifndef``), with
    C's integer division: the constants the tests and the tuning scripts
    hold the wrappers' plans to."""
    env: Dict[str, int] = {}
    for d in defines:
        name, _, value = d.partition("=")
        env[name] = int(value) if value.lstrip("-").isdigit() else 1
    for f in files:
        for line in Path(f).read_text().splitlines():
            m = re.match(r"#define (\w+) (-?\d+)$", line.strip())
            if m:
                env.setdefault(m.group(1), int(m.group(2)))
                continue
            m = re.match(r"constexpr int (\w+) = ([^;]+);", line)
            if m:
                env[m.group(1)] = eval(m.group(2).replace("/", "//"),  # noqa: S307
                                       {}, dict(env))
    return env


KERNELS: Dict[str, CudaKernel] = {}
# launches recorded instead of counted, while a graph is captured
_tally: Optional[Dict[str, int]] = None


@contextlib.contextmanager
def record_launches():
    """Within the block, each launch adds one to the yielded tally (kernel
    name -> launches) and nothing to its kernel's ``launches``: a CUDA-graph
    capture records launches without running them."""
    global _tally
    outer, _tally = _tally, {}
    try:
        yield _tally
    finally:
        _tally = outer


def add_launches(tally: Dict[str, int]) -> None:
    """Count a recorded tally as run (one replay of a captured graph)."""
    for name, n in tally.items():
        KERNELS[name].launches += n


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS[kernel.name] = kernel
    return kernel


def build_all() -> float:
    """Build every registered kernel in parallel (one nvcc per source, all
    started together) and load them. Returns the wall seconds taken."""
    # the wrapper modules register their kernels when imported
    import semi_pd_tpu_torch.ops.attention.ragged_paged_attention  # noqa: F401
    import semi_pd_tpu_torch.ops.attention.rpa_packed  # noqa: F401
    import semi_pd_tpu_torch.ops.attention.rpa_stream  # noqa: F401

    t0 = time.monotonic()
    ks = list(KERNELS.values())
    started = [(k, k.start_build()) for k in ks]
    for k, s in started:
        k.finish_build(s)
    for k in ks:
        k.fn()
    return time.monotonic() - t0


def cuda_stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
