"""
Build and load the Hopper kernels of ``iscc_search_tpu_torch/csrc``.

The CUDA sources expose a plain C interface, so they compile with ``nvcc``
alone — no PyTorch headers — into one shared library that ``ctypes`` loads
(seconds per build, where a ``torch.utils.cpp_extension`` build of a file
that includes PyTorch's headers takes minutes). Each source compiles in its
own ``nvcc`` process, all started together, and one more links them. The
library is built at
first use into ``build/torch_kernels/<key>/`` beside the package (a
git-ignored directory), keyed by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads the existing library.
The repository's sources are the only inputs.

``python -m iscc_search_tpu_torch.ops._build [--sass NAME]`` builds the
library and prints ptxas's resource lines; with ``--sass`` it also prints,
for every kernel whose mangled name contains NAME, its machine instructions
counted by opcode (``cuobjdump -sass``, which needs no profiler).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libiscc_search_kernels.so"

# sm_90a (not sm_90): keeps wgmma/setmaxnreg available to later kernels.
# -Xptxas -v writes each kernel's registers, shared memory and spills into
# the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None  # the loaded library, once per process


def sources():
    # type: () -> list[Path]
    """The kernel sources (``*.cu``), sorted."""
    return sorted(CSRC_DIR.glob("*.cu"))


def build_key(defines=()):
    # type: (tuple[str, ...]) -> str
    """Hash of the flags, the ``-D`` defines and every source's and header's
    name and bytes."""
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for path in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path():
    # type: () -> str
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin/nvcc`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the Hopper kernels are "
        "built from iscc_search_tpu_torch/csrc with the CUDA toolkit"
    )


def build(defines=()):
    # type: (tuple[str, ...]) -> Path
    """Compile the kernels unless a library with the current key exists.

    Concurrent builders (several processes at first use) each compile into
    a private temporary directory and publish the library with an atomic
    rename.

    :param defines: ``NAME=value`` macros for a library apart from the
        port's own (``library()`` builds with none), under a key of its own
    :return: path of the shared library
    """
    out_dir = BUILD_ROOT / build_key(defines)
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    nvcc = nvcc_path()
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=str(out_dir), prefix="tmp") as tmp:
        objects = {src: str(Path(tmp) / f"{src.stem}.o") for src in sources()}
        compile_cmds = [[nvcc, *flags, "-c", "-o", obj, str(src)] for src, obj in objects.items()]
        link_cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(Path(tmp) / LIB_NAME), *objects.values()]
        log = []
        for batch in (compile_cmds, [link_cmd]):  # every source at once, then the link
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in batch]
            outputs = [proc.communicate()[0] for proc in procs]
            log += [" ".join(cmd) + "\n" + out for cmd, out in zip(batch, outputs)]
            (out_dir / "build.log").write_text("".join(log))
            for proc, out in zip(procs, outputs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}")
        os.replace(Path(tmp) / LIB_NAME, lib_path)
    return lib_path


def library():
    # type: () -> ctypes.CDLL
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def build_log():
    # type: () -> str
    """The compiler output of the current build (ptxas resource usage)."""
    path = BUILD_ROOT / build_key() / "build.log"
    return path.read_text() if path.is_file() else ""


_SASS_LINE = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_opcodes(name):
    # type: (str) -> dict[str, collections.Counter]
    """{mangled kernel name: Counter of SASS opcodes} for every kernel of
    the built library whose name contains ``name`` (``cuobjdump`` beside
    ``nvcc``)."""
    dump = subprocess.run(
        [str(Path(nvcc_path()).with_name("cuobjdump")), "-sass", str(build())],
        capture_output=True, text=True, check=True,
    ).stdout
    found = {}
    current = None
    for line in dump.splitlines():
        if "Function :" in line:
            function = line.split("Function :")[1].strip()
            current = found.setdefault(function, collections.Counter()) if name in function else None
        elif current is not None:
            m = _SASS_LINE.match(line)
            if m:
                current[m.group(1)] += 1
    return found


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build the Hopper kernels; print their resources and SASS opcodes.")
    parser.add_argument("--sass", metavar="NAME", action="append", default=[], help="kernels whose name contains NAME")
    args = parser.parse_args(argv)
    build()
    for line in build_log().splitlines():
        if any(word in line for word in ("Used", "spill", "Compiling entry", "arning")):
            print(line.strip())
    for name in args.sass:
        for function, counts in sass_opcodes(name).items():
            print(f"{function}: {sum(counts.values())} instructions")
            for opcode, count in counts.most_common():
                print(f"  {count:5d} {opcode}")


if __name__ == "__main__":
    main()
