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
                                         ("mad_fd_hessian", "vesselness.cu"),
                                         ("mad_hessian_vesselness", "vesselness.cu")])
def test_the_b10_b11_entry_points_are_declared(name, source):
    """The per-axis convolutions (B10), the standalone FD Hessian (B11) and
    the Hessian stack's eigenvalues, vesselness and select (B15): declared in
    their sources and given ctypes argument lists."""
    text = (build.CSRC_DIR / source).read_text()
    assert f'extern "C" int {name}_##SUF(' in text
    assert _entry_points()[name] == list(build.SIGNATURES[name])


def test_the_b16_entry_point_is_declared_for_float32_and_float64():
    """The Galerkin product (B16): declared in its source with the ctypes
    argument list, built for float32 and float64 only (bfloat16 refused
    before any build), and its tile the host plan's."""
    from multigridanisotropicdiffusion_tpu_torch.ops import cuda_galerkin

    text = (build.CSRC_DIR / "galerkin_product.cu").read_text()
    name = "mad_galerkin_product"
    assert f'extern "C" int {name}_##SUF(' in text
    assert _entry_points()[name] == list(build.SIGNATURES[name])
    made = re.findall(r"^MAD_GALERKIN_ENTRY\((\w+), \w+\)", text, re.MULTILINE)
    assert sorted(made) == sorted(build.DTYPE_SUFFIX[d] for d in build.ENTRY_DTYPES[name])
    with pytest.raises(TypeError):
        build.kernel(name, torch.bfloat16)
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert (int(consts["kTx"]), int(consts["kTy"]), int(consts["kCols"]),
            int(consts["kAlign"]), int(consts["kTaps"])) == (
        cuda_galerkin.TILE_X, cuda_galerkin.TILE_Y, cuda_galerkin.COLS,
        cuda_galerkin.ALIGN, cuda_galerkin.TAPS)
    assert "constexpr int kRows = 2 * kTy + 2;" in text
    assert cuda_galerkin.ROWS == 2 * cuda_galerkin.TILE_Y + 2


def test_the_fused_sweep_entry_point_is_declared():
    """The compressed operator's fused red-black sweep (B17): declared in
    its source with the ctypes argument list, for every storage type, with
    the residual's arguments (planes, x, b, out, the shape, planes per
    block, stream)."""
    text = (build.CSRC_DIR / "stencil_compressed.cu").read_text()
    name = "mad_stencil_sweep"
    assert f'extern "C" int {name}_##SUF(' in text
    assert _entry_points()[name] == list(build.SIGNATURES[name])
    assert build.SIGNATURES[name] == build.SIGNATURES["mad_stencil_residual"]
    assert name not in build.ENTRY_DTYPES
    assert "MAD_FOR_EACH_TYPE(MAD_STENCIL_ENTRY)" in text


def test_every_storage_type_is_instantiated():
    text = (build.CSRC_DIR / "common.cuh").read_text()
    suffixes = re.findall(r"^\s*MACRO\((\w+), \w+\)", text, re.MULTILINE)
    assert sorted(suffixes) == sorted(build.DTYPE_SUFFIX.values())


def test_library_name_follows_sources_and_flags(monkeypatch):
    assert [p.suffix for p in build.sources()].count(".cu") == 8
    name = build.library_path().name
    assert name == build.library_path().name
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path().name != name
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_unsupported_dtype_is_refused_before_any_build():
    with pytest.raises(TypeError):
        build.kernel("mad_stencil_residual", torch.float16)


def test_build_lock_excludes_a_second_process(tmp_path):
    """Two processes that take the build lock at once hold it one after the
    other (ranks that start together build once)."""
    from .torch_dist_workers import build_lock_worker, run_ranks

    log = tmp_path / "held"
    run_ranks(build_lock_worker, 2, tmp_path, str(tmp_path / "build"), str(log), timeout=60)
    spans = sorted(tuple(map(float, (tmp_path / f"held.{r}").read_text().split()))
                   for r in range(2))
    assert spans[0][1] <= spans[1][0], spans
    assert (tmp_path / "build" / ".lock").exists()
