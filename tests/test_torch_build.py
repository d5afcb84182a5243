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
from ray_tpu_torch.ops import paged_attention as pa


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


# Every kernel library of the port: {name: (sources, signatures)}.
_ALL_LIBS = {**tfa._LIBS, **pa._LIBS}


@pytest.mark.parametrize("cu", _CU)
def test_every_include_is_listed_in_its_library(cu):
    """A .cu file belongs to one library, and the headers of csrc/ it
    includes are exactly the headers its library lists, so that an edit
    to a header changes the library's hash and rebuilds it."""
    libs = [sources for sources, _ in _ALL_LIBS.values() if cu in sources]
    assert len(libs) == 1, f"{cu} belongs to {len(libs)} libraries"
    includes = re.findall(r'^#include "([^"]+)"',
                          (_build.CSRC / cu).read_text(), re.M)
    for header in includes:
        assert (_build.CSRC / header).exists(), header
        assert header in libs[0], f"{cu} includes {header}, not listed"
    assert set(includes) == {s for s in libs[0] if not s.endswith(".cu")}


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
    for name, (sources, _) in _ALL_LIBS.items():
        out = _build.build(name, sources)
        assert out.exists()
    assert len(seen) == len(_ALL_LIBS)
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
    out += [(name, "flash_simple.cu", fault[0])
            for name, fault in tests._SIMPLE_FAULTS.items()]
    return out


@pytest.mark.parametrize("name,source,anchor", _anchors(),
                         ids=[a[0] for a in _anchors()])
def test_planted_fault_anchor_occurs_once(name, source, anchor):
    """Each planted fault of the on-card tests inserts its line before an
    anchor that occurs exactly once in its kernel source."""
    assert (_build.CSRC / source).read_text().count(anchor) == 1, name


def test_simple_family_uses_no_tensor_cores():
    """The simple family is a true f32 computation (the f32 token gates
    need it): its source, comments aside, names no tensor-core
    instruction (mma, wgmma, tf32), and of hopper.cuh it takes only the
    cp.async helpers and the 16-bit widening."""
    code = re.sub(r"//[^\n]*", "", (_build.CSRC / "flash_simple.cu")
                  .read_text())
    assert not re.search(r"(?<![A-Za-z])mma|wgmma|tf32|TF32|HG?MMA", code)
    used = set(re.findall(r"hopper::(\w+)", code))
    assert used <= {"cp_async", "cp_async_commit", "cp_async_wait",
                    "unpack2"}, used
