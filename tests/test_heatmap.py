"""The dependency-free heatmap writer (viz/heatmap.py): PNG and SVG."""

import struct
import zlib

import numpy as np

from metafast_jax.viz import heatmap as H

D = np.array([[0.0, 0.5691, 0.2981],
              [0.5691, 0.0, 0.8448],
              [0.2981, 0.8448, 0.0]])
NAMES = ["meta_1", "meta<2>", "meta_3"]


def _chunks(png: bytes):
    pos, out = 8, []
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        tag, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", png[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + data) & 0xFFFFFFFF
        out.append((tag, data))
        pos += 12 + n
    return out


def test_png_header_and_cells(tmp_path):
    png_path = tmp_path / "h.png"
    perm = H.render_heatmap(D, NAMES, str(png_path))
    assert perm == [0, 2, 1]
    png = png_path.read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    chunks = _chunks(png)
    assert [c[0] for c in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, ctype, _, _, _ = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (depth, ctype) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8)
    img = raw.reshape(h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)
    assert (raw.reshape(h, -1)[:, 0] == 0).all()        # filter bytes
    # the diagonal cell (distance 0) is viridis' dark end, the largest
    # distance its bright end
    cell = lambda i, j: img[H._MARGIN + i * H._CELL + H._CELL // 2,
                            H._DENDRO + j * H._CELL + H._CELL // 2]
    assert cell(0, 0).tolist() == [68, 1, 84]
    assert cell(1, 2).tolist() == [253, 231, 37]        # d(3, 2) = 0.8448
    # the dendrogram panel holds black line pixels
    assert (img[:, :H._DENDRO] == 0).all(axis=2).any()


def test_svg_carries_labels_and_values(tmp_path):
    svg_path = tmp_path / "h.svg"
    H.render_heatmap(D, NAMES, str(tmp_path / "h.png"), str(svg_path),
                     fmt="%.3f", colors=["#ff0000", "#00ff00", "#0000ff"])
    svg = svg_path.read_text()
    assert svg.startswith("<svg") and svg.rstrip().endswith("</svg>")
    assert "meta&lt;2&gt;" in svg and "meta_1" in svg
    for v in ("0.569", "0.298", "0.845", "0.000"):
        assert f">{v}</text>" in svg
    assert 'fill="#0000ff"' in svg                      # label colours
    assert svg.count("<line ") == 6                     # two merges
