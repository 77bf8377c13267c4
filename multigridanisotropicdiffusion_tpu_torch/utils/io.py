"""Lightweight image IO for the test workloads.

Counterpart of ``multigridanisotropicdiffusion_tpu.utils.io``, a copy: it
reads and writes numpy arrays (pass ``tensor.cpu().numpy()`` to the
writers).

The reference relies on ITK's readers/writers (JPEG for the 2D tests,
MetaImage .mhd/.zraw for the VED volumes).  Here: PIL for 2D images and a
self-contained MetaImage implementation (text header + optionally
zlib-compressed raw block).

Axis convention: MetaImage stores the first listed dimension (x) fastest; we
return a C-ordered array of shape ``(DimSize[-1], ..., DimSize[0])`` — i.e.
axis 0 is the slowest (z) — with ``spacing`` reordered to match the array
axes.  All solver code is axis-order agnostic, so parity with the reference
only requires spacing to stay aligned with its axis.
"""

from __future__ import annotations

import os
import zlib
from typing import NamedTuple, Tuple

import numpy as np

_METAIMAGE_DTYPES = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_METAIMAGE_NAMES = {np.dtype(v): k for k, v in _METAIMAGE_DTYPES.items()}


class MetaImage(NamedTuple):
    """A loaded volume: C-ordered data (axis 0 slowest) + matching spacing.

    Orientation metadata (``direction``/``offset``/``center_of_rotation``)
    is kept in the FILE's (x-first) axis convention, exactly as ITK stores
    it: ``direction`` is the row-major ``TransformMatrix`` reshaped to
    (NDims, NDims), ``offset`` the physical origin.  The reference's VED
    test program re-applies the input volume's direction to the output
    (the reference's test/itkVEDTest_GS.cxx:106-125); pass these fields back
    to :func:`write_meta_image` to do the same."""

    data: np.ndarray
    spacing: Tuple[float, ...]
    header: dict
    direction: np.ndarray | None = None
    offset: Tuple[float, ...] | None = None
    center_of_rotation: Tuple[float, ...] | None = None


def read_meta_image(path: str) -> MetaImage:
    """Read a MetaImage (.mhd header + raw/zraw data file)."""
    header: dict = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or "=" not in line:
                continue
            key, _, value = line.partition("=")
            header[key.strip()] = value.strip()

    ndims = int(header["NDims"])
    dim_size = [int(v) for v in header["DimSize"].split()]
    spacing = [float(v) for v in header.get("ElementSpacing", "1 " * ndims).split()]
    dtype = np.dtype(_METAIMAGE_DTYPES[header.get("ElementType", "MET_SHORT")])
    msb = header.get("BinaryDataByteOrderMSB", "False").lower() == "true"
    compressed = header.get("CompressedData", "False").lower() == "true"

    data_file = header["ElementDataFile"]
    if data_file == "LOCAL":
        raise ValueError("inline (LOCAL) MetaImage data is not supported")
    data_path = os.path.join(os.path.dirname(os.path.abspath(path)), data_file)
    with open(data_path, "rb") as f:
        raw = f.read()
    if compressed:
        raw = zlib.decompress(raw)

    arr = np.frombuffer(raw, dtype=dtype.newbyteorder(">" if msb else "<"))
    n = int(np.prod(dim_size))
    if arr.size != n:
        raise ValueError(f"data size {arr.size} != DimSize product {n}")
    direction = None
    if "TransformMatrix" in header:
        vals = [float(v) for v in header["TransformMatrix"].split()]
        direction = np.asarray(vals).reshape(ndims, ndims)
    offset = None
    if "Offset" in header:
        offset = tuple(float(v) for v in header["Offset"].split())
    center = None
    if "CenterOfRotation" in header:
        center = tuple(float(v) for v in header["CenterOfRotation"].split())

    # x fastest in the file -> C-order shape (z, y, x)
    arr = arr.reshape(tuple(reversed(dim_size)))
    return MetaImage(
        data=np.ascontiguousarray(arr),
        spacing=tuple(reversed(spacing)),
        header=header,
        direction=direction,
        offset=offset,
        center_of_rotation=center,
    )


def write_meta_image(
    path: str,
    data: np.ndarray,
    spacing: Tuple[float, ...] | None = None,
    compressed: bool = True,
    extra_header: dict | None = None,
    direction: np.ndarray | None = None,
    offset: Tuple[float, ...] | None = None,
    center_of_rotation: Tuple[float, ...] | None = None,
    like: "MetaImage | None" = None,
) -> None:
    """Write a MetaImage pair (.mhd + .raw/.zraw).

    ``data`` follows the same convention as :func:`read_meta_image`
    (axis 0 slowest); DimSize is written reversed (x first).

    ``direction``/``offset``/``center_of_rotation`` are written as
    ``TransformMatrix``/``Offset``/``CenterOfRotation`` in the file's
    x-first convention (the form :func:`read_meta_image` returns them in).
    ``like`` copies all three (and spacing, unless given) from a source
    :class:`MetaImage` — the reference VED test program's "re-apply the input
    direction to the output" step (itkVEDTest_GS.cxx:106-125) in one
    argument.
    """
    if like is not None:
        direction = like.direction if direction is None else direction
        offset = like.offset if offset is None else offset
        if center_of_rotation is None:
            center_of_rotation = like.center_of_rotation
        if spacing is None:
            spacing = like.spacing
    data = np.ascontiguousarray(data)
    ndims = data.ndim
    if spacing is None:
        spacing = (1.0,) * ndims
    base = os.path.splitext(path)[0]
    ext = ".zraw" if compressed else ".raw"
    data_file = os.path.basename(base) + ext

    raw = data.astype(data.dtype.newbyteorder("<"), copy=False).tobytes()
    payload = zlib.compress(raw) if compressed else raw
    with open(base + ext, "wb") as f:
        f.write(payload)

    lines = [
        "ObjectType = Image",
        f"NDims = {ndims}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
    ]
    if compressed:
        lines.append(f"CompressedDataSize = {len(payload)}")
    if direction is not None:
        d = np.asarray(direction, dtype=float)
        if d.shape != (ndims, ndims):
            raise ValueError(
                f"direction must be ({ndims}, {ndims}), got {d.shape}"
            )
        lines.append(
            "TransformMatrix = " + " ".join(repr(float(v)) for v in d.ravel())
        )
    if offset is not None:
        lines.append("Offset = " + " ".join(repr(float(v)) for v in offset))
    if center_of_rotation is not None:
        lines.append(
            "CenterOfRotation = "
            + " ".join(repr(float(v)) for v in center_of_rotation)
        )
    for key, value in (extra_header or {}).items():
        lines.append(f"{key} = {value}")
    lines.append("ElementSpacing = " + " ".join(str(s) for s in reversed(spacing)))
    lines.append("DimSize = " + " ".join(str(s) for s in reversed(data.shape)))
    lines.append(f"ElementType = {_METAIMAGE_NAMES[np.dtype(data.dtype)]}")
    lines.append(f"ElementDataFile = {data_file}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_image_2d(path: str, dtype=np.float64) -> np.ndarray:
    """Read a 2D image (jpg/png/...) as grayscale."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), dtype=dtype)


def write_image_2d(path: str, data: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.clip(np.asarray(data), 0, 255).astype(np.uint8)).save(path)
