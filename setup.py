"""Build hook: compile the native dense-restart core into the package.

The C++ core (native/arnoldi_dense.cpp) is a plain shared library consumed
through ctypes (no Python C API), so it is built with a direct compiler
invocation rather than setuptools' Extension machinery.  The build is
best-effort: without a C++ toolchain the wheel ships pure-Python and the
solver uses the numpy dense layer (identical semantics, tested in CI with
ARNOLDI_NATIVE=0).  The library's file name carries the source's SHA-256,
as arnoldimethod_jax/dense/native.py expects; the source file is always
bundled so an installed package can rebuild at import time.
"""

import hashlib
import shutil
import subprocess
import sys
from pathlib import Path

from setuptools import setup
from setuptools.command.build_py import build_py

ROOT = Path(__file__).parent
SRC = ROOT / "native" / "arnoldi_dense.cpp"
PKG_DENSE = Path("arnoldimethod_jax") / "dense"


class BuildPyWithNative(build_py):
    def run(self):
        super().run()
        out_dir = Path(self.build_lib) / PKG_DENSE
        out_dir.mkdir(parents=True, exist_ok=True)
        # Bundle the source for import-time rebuilds on the target machine.
        shutil.copy2(SRC, out_dir / SRC.name)
        cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
        if cxx is None:
            print("arnoldimethod-jax: no C++ compiler; skipping native core",
                  file=sys.stderr)
            return
        digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
        target = out_dir / f"libarnoldi_dense-{digest}.so"
        cmd = [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-o",
               str(target), str(SRC)]
        try:
            subprocess.run(cmd, check=True)
            print(f"arnoldimethod-jax: built native core -> {target}")
        except subprocess.CalledProcessError as exc:
            print(f"arnoldimethod-jax: native build failed ({exc}); "
                  "continuing pure-Python", file=sys.stderr)


setup(cmdclass={"build_py": BuildPyWithNative})
