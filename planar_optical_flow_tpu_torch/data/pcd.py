"""PCD (Point Cloud Data) reader and writer.

Counterpart of ``planar_optical_flow_tpu/data/pcd.py``: the three encodings
JRDB uses, ``ascii``, ``binary`` and ``binary_compressed`` (LZF, fields
stored one after the other). LZF is decoded by the native library
(:mod:`planar_optical_flow_tpu_torch.data.native`; ``native.status()`` says
whether it serves) where it is available, else by the Python decoder; a
corrupt stream raises ``ValueError`` in either.
"""

from __future__ import annotations

import numpy as np

from planar_optical_flow_tpu_torch.data import native

_TYPE_MAP = {
    ("F", 4): "f4", ("F", 8): "f8",
    ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4", ("I", 8): "i8",
    ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4", ("U", 8): "u8",
}


def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """LZF decompression (liblzf format): native where available, else
    :func:`_lzf_decompress_py`."""
    out = native.lzf_decompress(data, expected_size)
    if out is not None:
        return out
    return _lzf_decompress_py(data, expected_size)


def _lzf_decompress_py(data: bytes, expected_size: int) -> bytes:
    bad = ValueError(
        "corrupt LZF stream (out-of-range back-reference, truncated "
        "run, or output overflow)")
    out = bytearray(expected_size)
    i, o, n = 0, 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            run = ctrl + 1
            if i + run > n or o + run > expected_size:
                raise bad
            out[o:o + run] = data[i:i + run]
            i += run
            o += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                if i >= n:
                    raise bad
                length += data[i]
                i += 1
            if i >= n:
                raise bad
            ref = o - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            if ref < 0 or o + length + 2 > expected_size:
                raise bad
            for _ in range(length + 2):  # may overlap: byte by byte
                out[o] = out[ref]
                o += 1
                ref += 1
    return bytes(out[:o])


def lzf_compress(data: bytes) -> bytes:
    """A valid LZF stream of literal runs only (no size win: the writer's
    format round trip)."""
    out = bytearray()
    for i in range(0, len(data), 32):
        chunk = data[i:i + 32]
        out.append(len(chunk) - 1)
        out.extend(chunk)
    return bytes(out)


def _parse_header(f):
    meta = {}
    while True:
        raw = f.readline()
        if not raw:
            raise ValueError("unexpected EOF in PCD header (no DATA line)")
        line = raw.decode("ascii", errors="ignore").strip()
        if not line or line.startswith("#"):
            continue
        key, _, rest = line.partition(" ")
        key = key.upper()
        meta[key] = rest.split()
        if key == "DATA":
            break
    missing = [k for k in ("FIELDS", "SIZE", "TYPE", "POINTS")
               if k not in meta]
    if missing:
        raise ValueError(f"malformed PCD header: missing {missing}")
    return meta


def _dtype_from_meta(meta) -> np.dtype:
    fields = meta["FIELDS"]
    sizes = [int(s) for s in meta["SIZE"]]
    types = meta["TYPE"]
    counts = [int(c) for c in meta.get("COUNT", ["1"] * len(fields))]
    if not (len(fields) == len(sizes) == len(types) == len(counts)):
        raise ValueError(
            f"malformed PCD header: FIELDS/SIZE/TYPE/COUNT lengths differ "
            f"({len(fields)}/{len(sizes)}/{len(types)}/{len(counts)})")
    spec = []
    pad = 0
    for name, size, typ, cnt in zip(fields, sizes, types, counts):
        if name == "_":
            name, pad = f"_pad{pad}", pad + 1
        try:
            base = _TYPE_MAP[(typ, size)]
        except KeyError:
            raise ValueError(
                f"unsupported PCD field type TYPE={typ!r} SIZE={size} "
                f"for field {name!r}") from None
        spec.append((name, base, (cnt,)) if cnt > 1 else (name, base))
    return np.dtype(spec)


def _read_ascii(f, dtype, n):
    rows = np.loadtxt(f.read().decode("ascii").splitlines(),
                      dtype=np.float64, ndmin=2)
    width = sum(int(np.prod(dtype[name].shape)) if dtype[name].shape else 1
                for name in dtype.names)
    if rows.shape != (n, width):
        raise ValueError(
            f"malformed ascii PCD body: expected ({n}, {width}) values for "
            f"POINTS {n}, got {rows.shape}")
    out = np.zeros(n, dtype=dtype)
    col = 0
    for name in dtype.names:
        shape = dtype[name].shape
        w = int(np.prod(shape)) if shape else 1
        vals = rows[:, col:col + w]
        out[name] = vals.reshape((n,) + shape) if shape else vals[:, 0]
        col += w
    return out


def _read_binary(f, dtype, n):
    buf = f.read(n * dtype.itemsize)
    if len(buf) < n * dtype.itemsize:
        raise ValueError(
            f"truncated binary PCD body: expected {n * dtype.itemsize} "
            f"bytes, got {len(buf)}")
    return np.frombuffer(buf, dtype=dtype, count=n).copy()


def _read_compressed(f, dtype, n):
    sizes = f.read(8)
    if len(sizes) < 8:
        raise ValueError("truncated binary_compressed PCD: missing "
                         "compressed/uncompressed size header")
    comp_size, uncomp_size = (int(s) for s in np.frombuffer(sizes, "u4"))
    if uncomp_size != n * dtype.itemsize:
        raise ValueError(
            f"binary_compressed PCD size mismatch: header declares "
            f"{uncomp_size} uncompressed bytes, POINTS {n} x itemsize "
            f"{dtype.itemsize} = {n * dtype.itemsize}")
    comp = f.read(comp_size)
    if len(comp) < comp_size:
        raise ValueError(
            f"truncated binary_compressed PCD body: expected {comp_size} "
            f"bytes, got {len(comp)}")
    raw = lzf_decompress(comp, uncomp_size)
    if len(raw) != uncomp_size:
        raise ValueError(
            f"corrupt binary_compressed PCD: LZF stream decoded to "
            f"{len(raw)} bytes, header declares {uncomp_size}")
    out = np.zeros(n, dtype=dtype)
    off = 0
    for name in dtype.names:  # column-major: one field after another
        sub = dtype[name]
        nbytes = sub.itemsize * n
        out[name] = np.frombuffer(raw[off:off + nbytes], dtype=sub.base
                                  ).reshape((n,) + sub.shape)
        off += nbytes
    return out


_READERS = {"ascii": _read_ascii, "binary": _read_binary,
            "binary_compressed": _read_compressed}


def read_pcd(path: str) -> np.ndarray:
    """Read a PCD file -> structured array with the declared fields."""
    with open(path, "rb") as f:
        meta = _parse_header(f)
        mode = meta["DATA"][0].lower()
        if mode not in _READERS:
            raise ValueError(f"unsupported PCD DATA mode {mode!r}")
        return _READERS[mode](f, _dtype_from_meta(meta),
                              int(meta["POINTS"][0]))


def read_pcd_xyz(path: str) -> np.ndarray:
    """Read a PCD and return ``(N, 3)`` float32 xyz."""
    pc = read_pcd(path)
    return np.stack([pc["x"], pc["y"], pc["z"]], axis=1).astype(np.float32)


def write_pcd(path: str, xyz: np.ndarray, mode: str = "binary"):
    """Write an xyz point cloud as PCD (ascii | binary | binary_compressed)."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    n = len(xyz)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {mode}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if mode == "ascii":
            np.savetxt(f, xyz, fmt="%.6f")
        elif mode == "binary":
            rec = np.zeros(n, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4")])
            rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
            f.write(rec.tobytes())
        elif mode == "binary_compressed":
            raw = b"".join(np.ascontiguousarray(xyz[:, i]).tobytes()
                           for i in range(3))
            comp = lzf_compress(raw)
            f.write(np.asarray([len(comp), len(raw)], dtype="u4").tobytes())
            f.write(comp)
        else:
            raise ValueError(mode)
