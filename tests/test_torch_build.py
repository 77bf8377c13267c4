"""The kernel build's host side, checked without nvcc or a GPU: the ctypes
argument lists must match the C entry points in ``csrc/``, and the library
name must follow the sources' content."""

import ctypes
import re

import pytest
import torch

from multigridanisotropicdiffusion_tpu_torch.utils import build

C_TYPES = {
    "const void*": ctypes.c_void_p,
    "void*": ctypes.c_void_p,
    "int64_t": ctypes.c_int64,
    "double": ctypes.c_double,
    "int": ctypes.c_int,
}


def _entry_points():
    """``name -> [ctypes type per parameter]`` of every macro-generated
    ``extern "C" int mad_<name>_##SUF(...)`` in the sources."""
    out = {}
    for path in build.sources():
        text = path.read_text().replace("\\\n", " ")
        for name, params in re.findall(r'extern "C" int (mad_\w+)_##SUF\(([^)]*)\)', text):
            types = []
            for param in params.split(","):
                ctype = " ".join(param.split()[:-1]).replace(" *", "*")
                types.append(C_TYPES[ctype])
            out[name] = types
    return out


def test_ctypes_signatures_match_the_c_entry_points():
    entries = _entry_points()
    assert set(entries) == set(build.SIGNATURES)
    for name, argtypes in build.SIGNATURES.items():
        assert list(argtypes) == entries[name], name


@pytest.mark.parametrize("name,source", [("mad_conv_y", "conv.cu"), ("mad_conv_x", "conv.cu"),
                                         ("mad_fd_hessian", "vesselness.cu")])
def test_the_b10_b11_entry_points_are_declared(name, source):
    """The per-axis convolutions (B10) and the standalone FD Hessian (B11):
    declared in their sources and given ctypes argument lists."""
    text = (build.CSRC_DIR / source).read_text()
    assert f'extern "C" int {name}_##SUF(' in text
    assert _entry_points()[name] == list(build.SIGNATURES[name])


def test_every_storage_type_is_instantiated():
    text = (build.CSRC_DIR / "common.cuh").read_text()
    suffixes = re.findall(r"^\s*MACRO\((\w+), \w+\)", text, re.MULTILINE)
    assert sorted(suffixes) == sorted(build.DTYPE_SUFFIX.values())


def test_library_name_follows_sources_and_flags(monkeypatch):
    assert [p.suffix for p in build.sources()].count(".cu") == 7
    name = build.library_path().name
    assert name == build.library_path().name
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path().name != name
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_unsupported_dtype_is_refused_before_any_build():
    with pytest.raises(TypeError):
        build.kernel("mad_stencil_residual", torch.float16)
