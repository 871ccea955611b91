"""UPGMA clustering + heatmap/dendrogram rendering.

Parity: src/algo/FullHeatMap.java — O(n^3) greedy average-linkage
clustering (clusterObjects :221-296, distanceBetweenGroups :297-308) with
leaf order from the in-order traversal (renumber :323-333).  Rendering is
re-done without a plotting library: a PNG of the cells and the dendrogram
(numpy pixels, zlib, struct) and a hand-written SVG that also carries the
sample labels and the cell values.
"""

from __future__ import annotations

import struct
import zlib
from xml.sax.saxutils import escape

import numpy as np


class _Node:
    __slots__ = ("no", "left", "right", "distance", "leafs")

    def __init__(self, no=-1, left=None, right=None, distance=0.0):
        self.no = no
        self.left = left
        self.right = right
        self.distance = distance
        self.leafs = 1 if no >= 0 else left.leafs + right.leafs


def upgma_tree(dist: np.ndarray) -> _Node:
    """Greedy average-linkage agglomeration, ties broken like the
    reference (first (i, j) in row-major scan order)."""
    n = len(dist)
    nodes: list[_Node | None] = [_Node(no=i) for i in range(n)]
    d = np.asarray(dist, dtype=np.float64).copy()
    groups = [[i] for i in range(n)]
    count = n
    root = nodes[0] if n else None
    while count > 1:
        best = (np.inf, -1, -1)
        for i in range(n):
            if nodes[i] is None:
                continue
            for j in range(i + 1, n):
                if nodes[j] is not None and d[i, j] < best[0]:
                    best = (d[i, j], i, j)
        mind, i, j = best
        root = _Node(left=nodes[i], right=nodes[j], distance=mind)
        nodes[i], nodes[j] = root, None
        groups[i] = groups[i] + groups[j]
        groups[j] = []
        g1 = groups[i]
        for ii in range(n):
            d[ii, j] = d[j, ii] = -1
            if ii != i and nodes[ii] is not None:
                g2 = groups[ii]
                v = float(np.mean(dist[np.ix_(g1, g2)]))
                d[ii, i] = d[i, ii] = v
        count -= 1
    return root


def _leaves(node: _Node, out: list[int]) -> None:
    if node is None:
        return
    if node.no >= 0:
        out.append(node.no)
        return
    _leaves(node.left, out)
    _leaves(node.right, out)


def upgma_order(dist: np.ndarray) -> list[int]:
    """Permutation of sample indices in dendrogram leaf order."""
    if len(dist) == 0:
        return []
    if len(dist) == 1:
        return [0]
    out: list[int] = []
    _leaves(upgma_tree(dist), out)
    return out


def _dendrogram_segments(node: _Node, y_of: dict[int, float], x_scale: float):
    """Line segments ((x0, y0), (x1, y1)) of the left-side dendrogram;
    x = 0 at leaves, growing with merge distance."""
    segs = []

    def rec(nd):
        if nd.no >= 0:
            return 0.0, y_of[nd.no]
        xl, yl = rec(nd.left)
        xr, yr = rec(nd.right)
        x = nd.distance * x_scale
        segs.append(((xl, yl), (x, yl)))
        segs.append(((xr, yr), (x, yr)))
        segs.append(((x, yl), (x, yr)))
        return x, (yl + yr) / 2.0

    rec(node)
    return segs


# viridis, sampled at 0, 1/4, 1/2, 3/4, 1 (linear in between)
_VIRIDIS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                     [94, 201, 98], [253, 231, 37]], dtype=np.float64)
_CELL = 40          # cell side, pixels
_DENDRO = 160       # dendrogram panel width, pixels
_MARGIN = 8


def _colors(d: np.ndarray, invert: bool) -> np.ndarray:
    """[..., 3] uint8 viridis colors for distances scaled to [0, max]."""
    t = d / max(1e-12, float(d.max())) if d.size else d
    t = np.clip(1.0 - t if invert else t, 0.0, 1.0)
    x = t * (len(_VIRIDIS) - 1)
    i = np.minimum(x.astype(np.int64), len(_VIRIDIS) - 2)
    f = (x - i)[..., None]
    rgb = _VIRIDIS[i] * (1.0 - f) + _VIRIDIS[i + 1] * f
    return np.rint(rgb).astype(np.uint8)


def _segments(dist: np.ndarray, perm: list[int]):
    """Dendrogram segments in pixels: leaves at the panel's right edge,
    merge distance growing to the left."""
    n = len(perm)
    if n < 2:
        return []
    tree = upgma_tree(np.asarray(dist, dtype=np.float64))
    pos_in_perm = {s: i for i, s in enumerate(perm)}
    top = max(tree.distance, 1e-12)
    segs = _dendrogram_segments(tree, {s: pos_in_perm[s] for s in range(n)},
                                (_DENDRO - 2 * _MARGIN) / top)
    px = lambda x, y: (_DENDRO - 1 - int(round(x)),
                       _MARGIN + int((y + 0.5) * _CELL))
    return [(px(*a), px(*b)) for a, b in segs]


def _png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of an [h, w, 3] uint8 array."""
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), dtype=np.uint8)   # filter byte 0 per row
    raw[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def render_heatmap(dist: np.ndarray, names: list[str], png_path: str,
                   svg_path: str | None = None, renumber: bool = True,
                   invert_colors: bool = False,
                   colors: list[str] | None = None,
                   fmt: str = "%.4f") -> list[int]:
    """Write heatmap + dendrogram PNG (and SVG); returns the permutation."""
    n = len(names)
    perm = upgma_order(dist) if (renumber and n > 1) else list(range(n))
    d = np.asarray(dist, dtype=np.float64)[np.ix_(perm, perm)]
    cells = _colors(d, invert_colors)
    segs = _segments(dist, perm)
    x0 = _DENDRO                     # heatmap's left edge
    width = x0 + n * _CELL + _MARGIN
    height = n * _CELL + 2 * _MARGIN

    img = np.full((height, width, 3), 255, dtype=np.uint8)
    img[_MARGIN:_MARGIN + n * _CELL, x0:x0 + n * _CELL] = np.repeat(
        np.repeat(cells, _CELL, axis=0), _CELL, axis=1)
    for (xa, ya), (xb, yb) in segs:       # axis-aligned by construction
        img[min(ya, yb):max(ya, yb) + 1, min(xa, xb):max(xa, xb) + 1] = 0
    with open(png_path, "wb") as fh:
        fh.write(_png_bytes(img))

    if svg_path:
        label_w = 12 + 7 * max((len(s) for s in names), default=0)
        out = [f'<svg xmlns="http://www.w3.org/2000/svg" '
               f'width="{width + label_w}" height="{height + label_w}" '
               f'font-family="sans-serif">',
               f'<rect width="100%" height="100%" fill="white"/>']
        for (xa, ya), (xb, yb) in segs:
            out.append(f'<line x1="{xa}" y1="{ya}" x2="{xb}" y2="{yb}" '
                       f'stroke="black"/>')
        dmax = float(d.max()) if n else 0.0
        for i in range(n):
            for j in range(n):
                x, y = x0 + j * _CELL, _MARGIN + i * _CELL
                r, g, b = (int(c) for c in cells[i, j])
                ink = "white" if d[i, j] > dmax * 0.5 else "black"
                out.append(f'<rect x="{x}" y="{y}" width="{_CELL}" '
                           f'height="{_CELL}" fill="#{r:02x}{g:02x}{b:02x}"/>')
                out.append(f'<text x="{x + _CELL / 2}" y="{y + _CELL / 2}" '
                           f'font-size="10" fill="{ink}" text-anchor="middle" '
                           f'dominant-baseline="middle">'
                           f'{escape(fmt % d[i, j])}</text>')
        ink = colors or ["#000000"] * n
        for i, s in enumerate(perm):
            y = _MARGIN + i * _CELL + _CELL / 2
            x = x0 + n * _CELL + 4
            out.append(f'<text x="{x}" y="{y}" font-size="9" '
                       f'fill="{escape(ink[s])}" dominant-baseline="middle">'
                       f'{escape(names[s])}</text>')
            xb, yb = x0 + i * _CELL + _CELL / 2, height + 4
            out.append(f'<text x="{xb}" y="{yb}" font-size="9" '
                       f'transform="rotate(90 {xb} {yb})">'
                       f'{escape(names[s])}</text>')
        out.append("</svg>")
        with open(svg_path, "w") as fh:
            fh.write("\n".join(out) + "\n")
    return perm
