"""The kernel build cache (``ops/_build.py``) on the CPU: no nvcc needed.

A library is named by the hash of its source, of every header beside it
in ``csrc/`` and of the flags, so an edited shared header rebuilds the
library instead of loading a stale one. The tests work on a copy of
``csrc/`` in ``tmp_path``.
"""

import re
import shutil

import pytest

from service_account_auth_improvements_tpu_torch.ops import _build

SOURCES = ("flash_fwd", "flash_bwd", "flash_wide")


@pytest.fixture
def csrc(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    return copy


@pytest.mark.parametrize("source", SOURCES)
def test_library_name_changes_with_shared_header(csrc, tmp_path, source):
    out = tmp_path / "build"
    first = _build.library_path(source, csrc, out)
    assert _build.library_path(source, csrc, out) == first
    header = csrc / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    second = _build.library_path(source, csrc, out)
    assert second != first
    assert second.parent == out


@pytest.mark.parametrize("source", SOURCES)
def test_library_name_changes_with_source_or_new_header(csrc, tmp_path,
                                                        source):
    out = tmp_path / "build"
    first = _build.library_path(source, csrc, out)
    (csrc / "extra.h").write_text("#pragma once\n")
    with_header = _build.library_path(source, csrc, out)
    assert with_header != first
    cu = csrc / f"{source}.cu"
    cu.write_bytes(cu.read_bytes() + b"\n")
    assert _build.library_path(source, csrc, out) not in (first, with_header)


def test_library_name_ignores_the_other_sources(csrc, tmp_path):
    """Editing one kernel's source does not rename the other's library."""
    out = tmp_path / "build"
    fwd = _build.library_path("flash_fwd", csrc, out)
    cu = csrc / "flash_bwd.cu"
    cu.write_bytes(cu.read_bytes() + b"\n")
    assert _build.library_path("flash_fwd", csrc, out) == fwd


@pytest.mark.parametrize("source", SOURCES)
def test_library_path_defaults_to_the_repo_build_dir(source):
    path = _build.library_path(source)
    assert path.parent == _build.BUILD_DIR
    assert re.fullmatch(rf"lib{source}-[0-9a-f]{{16}}\.so", path.name)
