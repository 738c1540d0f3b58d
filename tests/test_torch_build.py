"""The kernel build's cache key (``kernels/_build.py``): a library's file
name hashes its ``.cu`` source and every header that source includes, so an
edited header can never load a stale library. Runs on the CPU: nothing is
compiled."""
import shutil
from pathlib import Path

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path):
    return Path(shutil.copytree(_build.CSRC, tmp_path / "csrc"))


@pytest.mark.parametrize("name", ["flash_attn", "ragged_linear"])
def test_header_edit_changes_the_library(csrc, name):
    before = _build.lib_path(name, csrc)
    assert before == _build.lib_path(name, csrc)          # stable
    assert before == _build.lib_path(name)                # the copy is exact
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.lib_path(name, csrc) != before


def test_sources_without_the_header_keep_their_library(csrc):
    before = {n: _build.lib_path(n, csrc) for n in ("sgmv", "decode_attn")}
    (csrc / "hopper.cuh").write_text("// edited\n")
    assert before == {n: _build.lib_path(n, csrc) for n in before}


def test_sources_follow_includes_once(csrc):
    (csrc / "extra.cuh").write_text('#include "hopper.cuh"\n')
    src = csrc / "flash_attn.cu"
    src.write_text('#include "extra.cuh"\n' + src.read_text())
    assert [p.name for p in _build.sources("flash_attn", csrc)] == [
        "flash_attn.cu", "extra.cuh", "hopper.cuh"]
    before = _build.lib_path("flash_attn", csrc)
    (csrc / "extra.cuh").write_text('#include "hopper.cuh"\n// edited\n')
    assert _build.lib_path("flash_attn", csrc) != before
