"""The port's copies of dy4tpu's JAX-free host layer stay equal to it, and
the port imports nothing of dy4tpu.

The port may not import the ``dy4tpu`` package (its card machine has no
JAX, and the port stands alone), so it carries copies: ``config.py``,
``rds/*``, ``utils/io.py``, ``runtime/native.py`` and the C++ runtime it
builds.  Each copy must equal dy4tpu's source once the imports are mapped
(``dy4tpu.`` -> ``dy4tpu_torch.``); ``runtime/native.py`` differs only in
how it builds and finds its library.
"""

import ast
import dataclasses
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dy4tpu_torch"
COPIES = ["config.py", "rds/__init__.py", "rds/coding.py", "rds/decoder.py",
          "rds/app.py", "rds/fleet.py", "utils/io.py"]
_IMPORT = re.compile(r"^(\s*)(from|import) dy4tpu\.", re.M)


def _mapped(src: str) -> str:
    return _IMPORT.sub(r"\1\2 dy4tpu_torch.", src)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_dy4tpu_once_imports_are_mapped(rel):
    ours = (PORT / rel).read_text()
    ref = (REPO / "dy4tpu" / rel).read_text()
    assert ours == _mapped(ref)


def test_native_runtime_copy():
    """Every class and function of ``runtime/native.py`` but
    ``load_library`` (and the port's own build helper) is dy4tpu's, and
    the C++ source is byte-equal."""
    from dy4tpu.runtime import native as ref
    from dy4tpu_torch.runtime import native as ours

    names = [n for n, v in vars(ref).items()
             if (inspect.isfunction(v) or inspect.isclass(v))
             and v.__module__ == ref.__name__ and n != "load_library"]
    assert {"Ring", "NativeSource", "NativeSink", "available"} <= set(names)
    for n in names:
        assert inspect.getsource(getattr(ours, n)) == inspect.getsource(
            getattr(ref, n)), n
    assert ((PORT / "native" / "dy4_runtime.cpp").read_bytes()
            == (REPO / "native" / "dy4_runtime.cpp").read_bytes())


def test_modes_equal_dy4tpu():
    from dy4tpu import config as ref
    from dy4tpu_torch import config as ours
    import dy4tpu_torch

    assert sorted(ours.MODES) == sorted(ref.MODES)
    for m in ref.MODES:
        assert dataclasses.asdict(ours.MODES[m]) == dataclasses.asdict(
            ref.MODES[m]), m
    assert dy4tpu_torch.get_mode is ours.get_mode
    assert dy4tpu_torch.MODES is ours.MODES


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "b7_alone.py"]


@pytest.mark.parametrize("root", ["dy4tpu", "jax"])
def test_no_port_file_imports(root):
    """An AST scan of every file of the port, chip_smoke.py and
    b7_alone.py."""
    bad = []
    for f in _port_sources():
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(REPO)}:{node.lineno} {m}" for m in mods
                    if m == root or m.startswith(root + ".")]
    assert not bad, bad


def test_port_imports_and_cli_help_without_dy4tpu():
    """A process in which ``dy4tpu`` and ``jax`` cannot be imported
    imports every module of the port and runs
    ``python -m dy4tpu_torch --help``."""
    code = (
        "import pkgutil, runpy, sys\n"
        "sys.modules['dy4tpu'] = None\n"
        "sys.modules['jax'] = None\n"
        "import dy4tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    dy4tpu_torch.__path__, 'dy4tpu_torch.')\n"
        "    if m.name != 'dy4tpu_torch.__main__']\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "print('IMPORTED', len(names))\n"
        "sys.argv = ['dy4tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('dy4tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('EXIT', e.code)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n = int(r.stdout.split("IMPORTED ")[1].split()[0])
    assert n >= 30, r.stdout
    assert "EXIT 0" in r.stdout, r.stdout
    assert "--iqcorr" in r.stdout and "--device" in r.stdout
    assert "DY4TPU_PLL_SPAN" in r.stdout
