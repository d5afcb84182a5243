"""The port's kernel build on the CPU: no nvcc is needed to check which
sources a library lists, how its file name is hashed, and that the
planted-fault anchors of the on-card tests still point into the kernel
sources."""

import importlib.util
import re
import shutil
from pathlib import Path

import pytest

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as tfa


def _kernel_tests():
    """tests/test_torch_flash_kernels.py, imported by path (it imports
    neither jax nor ray_tpu)."""
    path = Path(__file__).with_name("test_torch_flash_kernels.py")
    spec = importlib.util.spec_from_file_location("_torch_flash_kernels",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_CU = sorted(p.name for p in _build.CSRC.glob("*.cu"))


@pytest.mark.parametrize("cu", _CU)
def test_every_include_is_listed_in_its_library(cu):
    """A header a .cu file includes is among its library's sources, so
    that an edit to the header changes the library's hash and rebuilds
    it."""
    libs = [sources for sources, _ in tfa._LIBS.values() if cu in sources]
    assert len(libs) == 1, f"{cu} belongs to {len(libs)} libraries"
    includes = re.findall(r'^#include "([^"]+)"',
                          (_build.CSRC / cu).read_text(), re.M)
    assert includes, f"{cu} includes no header of csrc/"
    for header in includes:
        assert (_build.CSRC / header).exists(), header
        assert header in libs[0], f"{cu} includes {header}, not listed"


def test_library_path_follows_the_header(tmp_path, monkeypatch):
    """library_path hashes every listed source, the header included: the
    same bytes give the same path, one changed byte of the header another
    one."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    sources = tfa._LIBS["flash_fwd"][0]
    before = _build.library_path("flash_fwd", sources)
    assert _build.library_path("flash_fwd", sources) == before
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path("flash_fwd", sources)
    assert after != before
    assert after.parent == before.parent


def test_build_compiles_only_the_cu_files(monkeypatch, tmp_path):
    """build() hands nvcc the .cu files of a library and an -I for csrc/,
    never a header as a compilation unit."""
    seen = []

    class Done:
        returncode = 0
        stderr = ""

    def fake_run(cmd, **kwargs):
        seen.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return Done()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    for name, (sources, _) in tfa._LIBS.items():
        out = _build.build(name, sources)
        assert out.exists()
    assert len(seen) == len(tfa._LIBS)
    for cmd in seen:
        units = [a for a in cmd if a.endswith((".cu", ".cuh"))]
        assert units and all(u.endswith(".cu") for u in units)
        assert f"-I{_build.CSRC}" in cmd


def _anchors():
    tests = _kernel_tests()
    out = [(name, "flash_bwd.cu", fault[0])
           for name, fault in tests._FAULTS.items()]
    out += [(name, "flash_fwd.cu", fault[0])
            for name, fault in tests._FWD_FAULTS.items()]
    return out


@pytest.mark.parametrize("name,source,anchor", _anchors(),
                         ids=[a[0] for a in _anchors()])
def test_planted_fault_anchor_occurs_once(name, source, anchor):
    """Each planted fault of the on-card tests inserts its line before an
    anchor that occurs exactly once in its kernel source."""
    assert (_build.CSRC / source).read_text().count(anchor) == 1, name
