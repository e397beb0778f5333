"""VTK unstructured-grid output on the host (counterpart of
sctl_tpu/tree/vtu.py; reference: include/sctl/vtudata.hpp:23-57,
vtudata.txx — `VTUData` container and parallel .pvtu/.vtu writer;
Tree::WriteTreeVTK tree.txx:806, PtTree::WriteParticleVTK tree.hpp:277).

Writes XML .vtu files with base64-encoded binary data; `write_pvtu`
emits the master file referencing per-rank pieces.  Pure numpy, the
same bytes as the JAX package's writer.
"""

from __future__ import annotations

import base64
import struct
from typing import Dict, Optional

import numpy as np

_VTK_VERTEX = 1
_VTK_QUAD = 9
_VTK_HEXAHEDRON = 12


def _b64(arr: np.ndarray) -> str:
    raw = np.ascontiguousarray(arr).tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


class VTUData:
    """Unstructured-grid container (reference: VTUData, vtudata.hpp)."""

    def __init__(self):
        self.coord: Optional[np.ndarray] = None      # (N, 3) f32
        self.point_data: Dict[str, np.ndarray] = {}
        self.connect: np.ndarray = np.zeros(0, np.int32)
        self.offset: np.ndarray = np.zeros(0, np.int32)
        self.types: np.ndarray = np.zeros(0, np.uint8)
        self.cell_data: Dict[str, np.ndarray] = {}

    def add_points(self, X, **point_data):
        """Vertex cells for a point cloud."""
        X = np.asarray(X, np.float32).reshape(-1, 3)
        base = 0 if self.coord is None else len(self.coord)
        self.coord = X if self.coord is None else np.concatenate(
            [self.coord, X])
        n = len(X)
        self.connect = np.concatenate(
            [self.connect, base + np.arange(n, dtype=np.int32)])
        start = self.offset[-1] if len(self.offset) else 0
        self.offset = np.concatenate(
            [self.offset, start + 1 + np.arange(n, dtype=np.int32)])
        self.types = np.concatenate(
            [self.types, np.full(n, _VTK_VERTEX, np.uint8)])
        for k, v in point_data.items():
            v = np.asarray(v, np.float32).reshape(n, -1)
            prev = self.point_data.get(k)
            self.point_data[k] = v if prev is None else np.concatenate(
                [prev, v])

    def add_quads(self, X, conn, **point_data):
        """Quad cells over shared vertices (surface meshes; reference
        VTUData usage in SphericalHarmonics::WriteVTK,
        sph_harm.txx:371-455).  X (N, 3) vertices, conn (C, 4)."""
        X = np.asarray(X, np.float32).reshape(-1, 3)
        conn = np.asarray(conn, np.int32).reshape(-1, 4)
        base = 0 if self.coord is None else len(self.coord)
        self.coord = X if self.coord is None else np.concatenate(
            [self.coord, X])
        n = len(conn)
        self.connect = np.concatenate(
            [self.connect, (base + conn).ravel().astype(np.int32)])
        start = self.offset[-1] if len(self.offset) else 0
        self.offset = np.concatenate(
            [self.offset,
             start + 4 * (1 + np.arange(n, dtype=np.int32))])
        self.types = np.concatenate(
            [self.types, np.full(n, _VTK_QUAD, np.uint8)])
        for k, v in point_data.items():
            v = np.asarray(v, np.float32).reshape(len(X), -1)
            prev = self.point_data.get(k)
            self.point_data[k] = v if prev is None else np.concatenate(
                [prev, v])

    def add_boxes(self, lo, hi, **cell_data):
        """Axis-aligned hexahedra (tree-box visualization)."""
        lo = np.asarray(lo, np.float32).reshape(-1, 3)
        hi = np.asarray(hi, np.float32).reshape(-1, 3)
        n = len(lo)
        corners = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                            [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                           np.float32)
        pts = lo[:, None, :] + corners[None] * (hi - lo)[:, None, :]
        base = 0 if self.coord is None else len(self.coord)
        self.coord = (pts.reshape(-1, 3) if self.coord is None
                      else np.concatenate([self.coord,
                                           pts.reshape(-1, 3)]))
        conn = (base + np.arange(n * 8)).astype(np.int32)
        self.connect = np.concatenate([self.connect, conn])
        start = self.offset[-1] if len(self.offset) else 0
        self.offset = np.concatenate(
            [self.offset,
             start + 8 * (1 + np.arange(n, dtype=np.int32))])
        self.types = np.concatenate(
            [self.types, np.full(n, _VTK_HEXAHEDRON, np.uint8)])
        for k, v in cell_data.items():
            v = np.asarray(v, np.float32).reshape(n, -1)
            prev = self.cell_data.get(k)
            self.cell_data[k] = v if prev is None else np.concatenate(
                [prev, v])

    def write_vtu(self, path: str):
        """Write one serial .vtu piece (reference: VTUData::WriteVTK)."""
        if not path.endswith(".vtu"):
            path += ".vtu"
        n_pts = 0 if self.coord is None else len(self.coord)
        n_cells = len(self.types)
        parts = [
            '<?xml version="1.0"?>',
            '<VTKFile type="UnstructuredGrid" version="0.1" '
            'byte_order="LittleEndian">',
            "<UnstructuredGrid>",
            f'<Piece NumberOfPoints="{n_pts}" '
            f'NumberOfCells="{n_cells}">',
            "<Points>",
            '<DataArray type="Float32" NumberOfComponents="3" '
            'format="binary">',
            _b64(self.coord if self.coord is not None
                 else np.zeros((0, 3), np.float32)),
            "</DataArray>", "</Points>",
        ]
        if self.point_data:
            parts.append("<PointData>")
            for k, v in self.point_data.items():
                parts += [
                    f'<DataArray type="Float32" Name="{k}" '
                    f'NumberOfComponents="{v.shape[1]}" '
                    'format="binary">', _b64(v), "</DataArray>"]
            parts.append("</PointData>")
        if self.cell_data:
            parts.append("<CellData>")
            for k, v in self.cell_data.items():
                parts += [
                    f'<DataArray type="Float32" Name="{k}" '
                    f'NumberOfComponents="{v.shape[1]}" '
                    'format="binary">', _b64(v), "</DataArray>"]
            parts.append("</CellData>")
        parts += [
            "<Cells>",
            '<DataArray type="Int32" Name="connectivity" '
            'format="binary">', _b64(self.connect), "</DataArray>",
            '<DataArray type="Int32" Name="offsets" format="binary">',
            _b64(self.offset), "</DataArray>",
            '<DataArray type="UInt8" Name="types" format="binary">',
            _b64(self.types), "</DataArray>",
            "</Cells>", "</Piece>", "</UnstructuredGrid>", "</VTKFile>"]
        with open(path, "w") as f:
            f.write("\n".join(parts))

    @staticmethod
    def write_pvtu(path: str, n_pieces: int, point_fields=(),
                   cell_fields=()):
        """Master file referencing per-rank pieces (rank-0 only;
        reference: vtudata.txx parallel writer)."""
        if path.endswith(".pvtu"):
            path = path[:-5]
        name = path.split("/")[-1]
        parts = [
            '<?xml version="1.0"?>',
            '<VTKFile type="PUnstructuredGrid" version="0.1" '
            'byte_order="LittleEndian">',
            '<PUnstructuredGrid GhostLevel="0">',
            "<PPoints>",
            '<PDataArray type="Float32" NumberOfComponents="3"/>',
            "</PPoints>"]
        if point_fields:
            parts.append("<PPointData>")
            for k, nc in point_fields:
                parts.append(f'<PDataArray type="Float32" Name="{k}" '
                             f'NumberOfComponents="{nc}"/>')
            parts.append("</PPointData>")
        if cell_fields:
            parts.append("<PCellData>")
            for k, nc in cell_fields:
                parts.append(f'<PDataArray type="Float32" Name="{k}" '
                             f'NumberOfComponents="{nc}"/>')
            parts.append("</PCellData>")
        for r in range(n_pieces):
            parts.append(f'<Piece Source="{name}_{r:04d}.vtu"/>')
        parts += ["</PUnstructuredGrid>", "</VTKFile>"]
        with open(path + ".pvtu", "w") as f:
            f.write("\n".join(parts))


def write_particle_vtk(path: str, X, values=None):
    """PtTree::WriteParticleVTK equivalent (tree.hpp:277)."""
    v = VTUData()
    kw = {} if values is None else {"value": values}
    v.add_points(X, **kw)
    v.write_vtu(path)


def write_tree_vtk(path: str, tree):
    """Tree::WriteTreeVTK equivalent (tree.txx:806): leaf boxes of a 3-D
    `PtTree` (leaf_keys, leaf_levels, offset, scale) as hexahedra
    colored by level."""
    from . import morton as mt
    if getattr(tree, "dim", 3) != 3:
        raise ValueError("write_tree_vtk: box visualization is 3-D")
    D = mt.MAX_DEPTH_3D
    lat = mt.morton_decode(tree.leaf_keys).astype(np.float64)
    side01 = 0.5 ** tree.leaf_levels.astype(np.float64)
    lo01 = lat / (1 << D)
    lo = lo01 * tree.scale + tree.offset
    hi = (lo01 + side01[:, None]) * tree.scale + tree.offset
    v = VTUData()
    v.add_boxes(lo, hi, level=tree.leaf_levels.astype(np.float32))
    v.write_vtu(path)
