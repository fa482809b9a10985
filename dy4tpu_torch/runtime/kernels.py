"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``dy4tpu_torch/csrc/<name>.cu`` is one shared library with a plain C
interface (no PyTorch headers), compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``dy4tpu_torch/_build/<hash of the sources>/``.  A plain
C file builds in seconds, where ``torch.utils.cpp_extension.load`` of a
file that includes PyTorch's headers takes minutes, and every machine
with a card starts with nothing built.

A missing ``nvcc`` or a failed build raises with the compiler's output:
there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

# kernel name -> extra nvcc flags.  The PLL recurrence must match its
# plain torch version bit for bit, so no multiply-add may be contracted
# into an FMA there (the source also spells the step with __f*_rn).
KERNELS: dict[str, tuple[str, ...]] = {
    "frontend": (),
    "frontend_rf": (),
    "pll": ("-fmad=false",),
    "rds_backend": (),
    "audio_rational": (),
    "channelizer": (),
    "fft": (),
    "fir": (),
}

# dynamic shared memory one thread block may take on Hopper (227 KB)
SMEM_MAX = 232448

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")

_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME and "
                       "/usr/local/cuda): the port's kernels cannot be "
                       "built on this machine")


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> list[str]:
    """The command line that builds kernel ``name`` into ``out``."""
    return [nvcc, *_ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", *KERNELS[name], "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_dir() -> Path:
    """``_build/<hash>``: the hash covers every source and header in
    ``csrc`` and the flags, so an edit builds afresh."""
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for name, flags in sorted(KERNELS.items()):
        h.update(" ".join((name, *_ARCH, *flags)).encode())
    return BUILD / h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return build_dir() / f"libdy4_{name}.so"


def build_all() -> dict[str, Path]:
    """Build every kernel that is not built yet, all ``nvcc`` runs at
    once.  Returns name -> library path; raises on any failure."""
    out = build_dir()
    todo = [n for n in KERNELS if not lib_path(n).is_file()]
    if todo:
        nvcc = find_nvcc()
        out.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            # build to a private name, then rename: a concurrent build of
            # the same sources never sees a half-written library
            tmp = out / f".libdy4_{name}.{os.getpid()}.so"
            procs[name] = (tmp, subprocess.Popen(
                nvcc_command(name, tmp, nvcc), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        errors = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"--- {name}.cu (exit {proc.returncode}):\n"
                              f"{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, lib_path(name))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return {n: lib_path(n) for n in KERNELS}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _libs[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of kernel ``name`` with its ``argtypes``
    set (``c_void_p`` for every pointer and the stream, so ctypes never
    cuts a pointer to 32 bits) and an ``int`` status result."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def require(t, name: str, shape, dtype=torch.float32,
            device: torch.device | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape`` and
    ``dtype`` (on ``device`` when given): what every kernel takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got one "
                         f"on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_smem(name: str, symbol: str, what: str, *geometry: int) -> None:
    """Raise ``ValueError`` with the figure when the thread block of
    kernel ``name`` at this geometry needs more shared memory than
    ``SMEM_MAX``; the library's ``symbol`` (int arguments, returning
    bytes) computes it with the kernel's own formula."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [ctypes.c_int] * len(geometry)
    fn.restype = ctypes.c_longlong
    need = fn(*geometry)
    if need > SMEM_MAX:
        raise ValueError(f"{what}: a thread block needs {need} bytes "
                         f"({need / 1024:.1f} KB) of shared memory at "
                         f"this geometry; the card allows {SMEM_MAX} "
                         f"(227 KB)")


def cli_device(spec: str) -> torch.device:
    """The device a command line's ``--device`` names.  Exits with an
    error when that is a CUDA device and torch finds none: a tool asked
    for the card never carries on on the CPU."""
    dev = torch.device(spec)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch finds no CUDA device on this "
                         "machine (pass --device cpu for the plain "
                         "versions on the CPU)")
    return dev


class Variant:
    """The launch count of one variant of a kernel wrapper (a template
    variant, or an epilogue chosen by a keyword), read as a wrapper's own
    ``launches`` is."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(status: int, what: str) -> None:
    """Raise when an entry point returned a nonzero ``cudaGetLastError``
    (a launch that was refused never runs, and a synchronize does not
    report it)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError "
                           f"{status}")
