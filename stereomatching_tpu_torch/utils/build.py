"""Build the native sources of ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` (a CUDA kernel) has a plain C interface (no
PyTorch headers), so ``nvcc`` compiles it in seconds into a shared
library that ``ctypes`` loads; ``csrc/<name>.cpp`` (the host codec,
``stereo_io.cpp``) is compiled the same way by the host C++ compiler
(``$CXX``, else ``c++`` or ``g++`` on ``PATH``) and linked with zlib.
The library goes to ``build/stereomatching_tpu_torch/`` at the root of
the checkout (listed in ``.gitignore``), named by a hash of its source
and flags: an edited source is rebuilt, an unchanged one is reused.
Nothing falls back: without the compiler the build raises.  A host
build imports no torch (the CLI's ``--tier oracle`` runs without it).

Threads of one process (one per device of a sharded mesh) may ask for a
library at once: ``load`` builds and loads each library once under a
lock, and every compiler writes a temporary file of its own process and
thread, renamed into place when it is complete, so processes that build
the same library at once each load a complete one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shlex
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stereomatching_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
CXX_LIBS = ("-lz",)


def find_nvcc() -> str:
    """Path of ``nvcc`` in the CUDA toolkit PyTorch's extension builder
    finds (``$CUDA_HOME``, else ``nvcc`` on ``PATH``, else the default
    install location).  Raises ``RuntimeError`` when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if nvcc is not None and os.access(nvcc, os.X_OK):
        return str(nvcc)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of stereomatching_tpu_torch cannot be built"
    )


def find_cxx() -> list[str]:
    """The host C++ compiler's command: ``$CXX`` (split as a shell
    would), else ``c++`` or ``g++`` on ``PATH``.  Raises ``RuntimeError``
    when ``$CXX`` names no program or there is none."""
    cxx = shlex.split(os.environ.get("CXX", ""))
    if cxx:
        if shutil.which(cxx[0]) is None:
            raise RuntimeError(f"$CXX={os.environ['CXX']!r} names no compiler; the host "
                               "codec of stereomatching_tpu_torch cannot be built")
        return cxx
    for name in ("c++", "g++"):
        if shutil.which(name):
            return [name]
    raise RuntimeError("no C++ compiler found (set CXX or put c++ or g++ on PATH); the "
                       "host codec of stereomatching_tpu_torch cannot be built")


def _host(name: str) -> bool:
    """Whether ``name`` is a host source (``csrc/<name>.cpp``)."""
    return (CSRC / f"{name}.cpp").exists()


def _target(name: str) -> Path:
    """Library path of ``csrc/<name>.cu`` or ``.cpp``, named by a hash of
    the source and the flags (and, for a ``.cu``, the ``*.cuh`` headers)."""
    if _host(name):
        h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
        h.update(" ".join(CXX_FLAGS + CXX_LIBS).encode())
    else:
        h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
        for hdr in sorted(CSRC.glob("*.cuh")):
            h.update(hdr.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list[str]:
    """The compiler command that builds ``csrc/<name>`` into ``out``."""
    if _host(name):
        return [*find_cxx(), *CXX_FLAGS, "-o", str(out), str(CSRC / f"{name}.cpp"), *CXX_LIBS]
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names) -> list[Path]:
    """Compile every ``csrc/<name>`` of ``names`` that has no up-to-date
    library in ``BUILD_DIR``, one compiler process per source, all
    started together -> the libraries' paths.  Raises ``RuntimeError``
    naming each source that failed, with the compiler's output."""
    outs = [_target(n) for n in names]
    todo = [(n, o) for n, o in zip(names, outs) if not o.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        jobs.append((_command(name, tmp), tmp, out))
    procs = [(cmd, tmp, out, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd, tmp, out in jobs]
    errors = []
    for cmd, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{Path(cmd[0]).name} failed (exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (plus the ``*.cuh`` it includes) or
    ``csrc/<name>.cpp`` into ``BUILD_DIR`` unless an up-to-date library
    is there -> its path."""
    return build_all([name])[0]


_LOAD_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>`` once per process;
    threads that ask at the same time wait for that one build."""
    with _LOAD_LOCK:
        return _load(name)


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))


def _cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program beside ``nvcc``."""
    return str(Path(find_nvcc()).parent / name)


def sass_counts(library: str | Path, ops=("LDS", "STS", "BAR"), order: bool = False) -> dict:
    """Instructions of the op names ``ops`` (e.g. ``LDG``, ``STG``,
    ``LDGSTS``, ``REDUX``, ``SHFL``; ``LDS``, ``STS`` and ``BAR`` by
    default) in the SASS of each kernel of a built library (``cuobjdump
    -sass``) -> ``parse_sass``'s dict, keyed by demangled kernel name."""
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    names = {}
    try:
        mangled = sorted(set(re.findall(r"Function : (\S+)", sass)))
        out = subprocess.run([_cuda_tool("cu++filt")], input="\n".join(mangled),
                             capture_output=True, text=True, check=True).stdout.split("\n")
        names = dict(zip(mangled, out))
    except (OSError, subprocess.CalledProcessError):
        pass
    return parse_sass(sass, ops, order, names)


_INST = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def parse_sass(sass: str, ops=("LDS", "STS", "BAR"), order: bool = False,
               names: dict | None = None) -> dict:
    """Count the instructions whose op name (the mnemonic before its first
    ``.``, so ``LDG`` does not count ``LDGSTS``; ``ALL`` counts every
    instruction) is in ``ops``, in each ``Function :`` section of
    ``cuobjdump -sass`` text -> {kernel name:
    {"total": counts, "loops": [(start, end, counts), ...]}}, counts being
    {op: n}; a loop is the address range from a backward branch's target
    to the branch, so nested loops appear inside their outer one.  With
    ``order`` each loop's counts also hold "order": the loop's matching op
    names in address order, space-separated (which loads a loop issues
    before its first ``REDUX``, say).  ``names`` maps mangled to shown
    kernel names."""
    names = names or {}
    result = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        insts = [(int(a, 16), op.split(".")[0], rest) for a, op, rest in _INST.findall(part)]

        def count(lo, hi, with_order=False):
            c = dict.fromkeys(ops, 0)
            seq = []
            for addr, op, _ in insts:
                if not lo <= addr <= hi:
                    continue
                if "ALL" in c:
                    c["ALL"] += 1
                if op in c and op != "ALL":
                    c[op] += 1
                    seq.append(op)
            if with_order:
                c["order"] = " ".join(seq)
            return c

        loops = []
        for addr, op, rest in insts:
            m = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and m and int(m.group(1), 16) <= addr:
                start = int(m.group(1), 16)
                loops.append((start, addr, count(start, addr, order)))
        result[names.get(name, name)] = {"total": count(0, 1 << 62), "loops": loops}
    return result


def resource_usage(library: str | Path) -> dict:
    """Registers, stack, shared and local memory of each kernel of a built
    library (``cuobjdump -res-usage``) -> {mangled kernel name: {"REG": n,
    "STACK": n, "SHARED": n, "LOCAL": n}}."""
    out = subprocess.run([_cuda_tool("cuobjdump"), "-res-usage", str(library)],
                         capture_output=True, text=True, check=True).stdout
    return {name: {k: int(v) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", res)}
            for name, res in re.findall(r"Function (\S+?):?\s*\n\s*(REG:[^\n]*)", out)}
